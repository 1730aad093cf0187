"""North-star benchmark: 262,144 PE pairs (2x100 bp) vs a REAL 3 Gbp
genome on ONE chip — chunk-cycled device-built indexes, global loci past
2^31, PE orphan rescue, chunked SNP calling, per-(chunk,block)
checkpointing (VERDICT r2 item 1).

Inputs come from scripts/ref_3gbp_pipeline.sh's directory (g.npy +
r1.fa/r2.fa with truth descriptors) so the reference row measured by that
script and this row share identical inputs.

Usage: python scripts/bench_3gbp.py [--dir /root/data3g] [--chroms 24]
       [--max-chunk 256000000] [--skip-snps]
Writes BENCH_3G.json at the repo root and prints it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def load_reads(path):
    from biokanga.seq.fasta import read_blocks

    names, rows = [], []
    for blk in read_blocks(path, block_size=65536):
        names.extend(blk.names)
        rows.append(blk.codes)
    L = max(r.shape[1] for r in rows)
    mat = np.full((sum(len(r) for r in rows), L), 4, np.int8)
    ofs = 0
    for r in rows:
        mat[ofs : ofs + len(r), : r.shape[1]] = r
        ofs += len(r)
    return names, mat


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="/root/data3g")
    ap.add_argument("--chroms", type=int, default=24)
    ap.add_argument("--batch", type=int, default=32_768)
    ap.add_argument("--max-chunk", type=int, default=256_000_000)
    ap.add_argument("--lut-bases", type=int, default=13)
    ap.add_argument("--skip-snps", action="store_true")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint dir (resumable sweep)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from biokanga.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    from biokanga.align.params import AlignParams
    from biokanga.align.pe import PEAligner, PEParams, classify_pairs
    from biokanga.align.pipeline import pad_rows
    from biokanga.index.device_build import DeviceBuildChunkedAligner
    from biokanga.parallel.chunked import merge_chunk_results
    from biokanga.seq.encode import revcomp
    from biokanga.sim.simreads import SimReadTruth

    t_setup = time.monotonic()
    codes = np.load(os.path.join(args.dir, "g.npy"), mmap_mode="r")
    n = len(codes)
    per = n // args.chroms
    bounds = [per * i for i in range(args.chroms)] + [n]
    seqs = [(f"chr{i + 1}", codes[bounds[i]:bounds[i + 1]])
            for i in range(args.chroms)]

    names1, r1 = load_reads(os.path.join(args.dir, "r1.fa"))
    names2, r2 = load_reads(os.path.join(args.dir, "r2.fa"))
    n_pairs = len(r1)
    L = r1.shape[1]
    len1 = np.full(n_pairs, L, np.int32)
    len2 = np.full(n_pairs, L, np.int32)
    print(f"setup: {n/1e9:.2f} Gbp genome, {n_pairs} pairs "
          f"({time.monotonic() - t_setup:.0f}s)", flush=True)

    params = AlignParams(batch_size=args.batch)
    pe = PEParams(pair_min_len=100, pair_max_len=600)
    ca = DeviceBuildChunkedAligner(
        seqs, params, max_chunk=args.max_chunk, overlap=2048,
        lut_bases=args.lut_bases,
    )
    ca.time_builds = True  # benches report chunk_build_s
    print(f"chunks: {ca.num_chunks} x <= {args.max_chunk/1e6:.0f} Mbp "
          f"(pad {ca.pad_n/1e6:.0f} Mbp)", flush=True)

    B = args.batch
    blocks = []
    for mat, lens in ((r1, len1), (r2, len2)):
        for i in range(0, n_pairs, B):
            blocks.append(pad_rows(mat[i : i + B], lens[i : i + B]))
    nb = len(blocks) // 2

    # ---- sweep 1: GLOBAL two-level — fast pass per (chunk, block),
    # classic cycle only for globally-unresolved reads ------------------
    from biokanga.parallel.chunked import two_level_chunk_sweep

    t0 = time.monotonic()

    def prog(phase, k):
        print(f"{phase} chunk {k + 1}/{ca.num_chunks} "
              f"({time.monotonic() - t0:.0f}s)", flush=True)

    merged = two_level_chunk_sweep(ca, blocks,
                                   checkpoint_dir=args.checkpoint,
                                   progress=prog)
    build_s = list(getattr(ca, "build_s", []))  # per engine_for build
    t_sweep = time.monotonic() - t0

    # ---- PE classify + orphan rescue grouped by anchor chunk -----------
    t1 = time.monotonic()
    res1 = merged[:nb]
    res2 = merged[nb:]
    starts = ca.entry_starts
    cls_blocks = []
    orphan_rows = {}  # chunk -> list of (pair_block, row, which)
    for pb in range(nb):
        c = classify_pairs(res1[pb], res2[pb],
                           blocks[pb][1], blocks[nb + pb][1], starts, pe)
        cls_blocks.append(c)
        for which, anch in ((1, res1[pb]), (2, res2[pb])):
            rows = np.nonzero(c[f"orphan{which}"])[0]
            if len(rows) == 0:
                continue
            ak = np.clip(np.searchsorted(ca.bases, anch["locus"][rows],
                                         side="right") - 1,
                         0, ca.num_chunks - 1)
            for k in np.unique(ak):
                orphan_rows.setdefault(int(k), []).extend(
                    (pb, int(r), which) for r in rows[ak == k])
    n_rescued = 0
    from types import SimpleNamespace
    for k, items in sorted(orphan_rows.items()):
        # windowed rescue needs only the packed rows — no suffix sort
        codes_d, pg, es_k = ca.packed_chunk(k)
        shim = SimpleNamespace(
            didx=SimpleNamespace(packed=pg,
                                 entry_starts=jnp.asarray(
                                     es_k.astype(np.int32))),
            params=params,
        )
        pea = PEAligner(shim, pe)
        a_loc = np.empty(len(items), np.int64)
        a_rc = np.empty(len(items), bool)
        m_reads = np.full((len(items), L), 4, np.int8)
        m_len = np.empty(len(items), np.int32)
        for j, (pb, r, which) in enumerate(items):
            anch = res1[pb] if which == 1 else res2[pb]
            mate_mat = blocks[nb + pb][0] if which == 1 else blocks[pb][0]
            ml = int((blocks[nb + pb][1] if which == 1
                      else blocks[pb][1])[r])
            a_loc[j] = anch["locus"][r] - int(ca.bases[k])
            a_rc[j] = anch["is_rc"][r]
            m_len[j] = ml
            # FR orientation (align/pe.py _pair_and_rescue): anchor
            # forward => mate hits the reverse strand, scan its revcomp
            row = mate_mat[r, :ml]
            m_reads[j, :ml] = row if a_rc[j] else revcomp(row)
        a_len = np.full(len(items), L, np.int32)
        out = pea.rescue(a_loc.astype(np.int32), a_rc, a_len, m_reads,
                         m_len, False)
        ok = np.asarray(out["ok"])
        for j, (pb, r, which) in enumerate(items):
            if not ok[j]:
                continue
            mres = res2[pb] if which == 1 else res1[pb]
            anch = res1[pb] if which == 1 else res2[pb]
            mres["unique"][r] = True
            mres["locus"][r] = int(out["locus"][j]) + int(ca.bases[k])
            mres["is_rc"][r] = not anch["is_rc"][r]
            mres["best_mm"][r] = out["mm"][j]
            n_rescued += 1
    # final classification
    n_proper = n_orphan = 0
    for pb in range(nb):
        c = classify_pairs(res1[pb], res2[pb],
                           blocks[pb][1], blocks[nb + pb][1], starts, pe)
        n_proper += int(c["proper"].sum())
        n_orphan += int(c["orphan1"].sum() + c["orphan2"].sum())
    t_pe = time.monotonic() - t1
    total_align_s = t_sweep + t_pe
    reads_per_s = 2 * n_pairs / total_align_s

    # ---- truth check ----------------------------------------------------
    def truth_ok(names, resl, which):
        ok = tot = 0
        for pb in range(nb):
            res = resl[pb]
            base = pb * B
            m = min(B, n_pairs - base)
            for i in range(m):
                t = SimReadTruth.parse(names[base + i])
                if t is None:
                    continue
                tot += 1
                if not res["unique"][i]:
                    continue
                ei = [int(x) for x in range(args.chroms)
                      if f"chr{x + 1}" == t.chrom][0]
                want = bounds[ei] + t.start - 1
                ok += int(res["locus"][i] == want)
        return ok, tot

    ok1, tot1 = truth_ok(names1, res1, 1)
    ok2, tot2 = truth_ok(names2, res2, 2)

    out = {
        "metric": "north_star_pe_reads_per_sec_per_chip_3gbp",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "detail": {
            "genome_bp": int(n),
            "chroms": args.chroms,
            "num_chunks": ca.num_chunks,
            "chunk_build_s": [round(t, 1) for t in build_s],
            "sweep_s": round(t_sweep, 1),
            "pe_rescue_s": round(t_pe, 1),
            "total_align_s": round(total_align_s, 1),
            "n_pairs": n_pairs,
            "proper_pairs_frac": round(n_proper / n_pairs, 4),
            "rescued_mates": n_rescued,
            "truth_correct_mate1": round(ok1 / max(tot1, 1), 4),
            "truth_correct_mate2": round(ok2 / max(tot2, 1), 4),
            "max_locus_past_2p31": bool(int(ca.bases[-1]) > 2**31),
        },
    }

    print(json.dumps(out), flush=True)          # crash-safe partial row
    with open(os.path.join(REPO, "BENCH_3G.json"), "w") as f:
        json.dump(out, f, indent=1)

    # ---- chunked SNP calling (second sweep) -----------------------------
    if not args.skip_snps:
        from biokanga.align.snp import (ChunkedPileup, SNPParams,
                                            write_snps_csv)

        t2 = time.monotonic()
        # pileup needs ONLY the chunk's genome codes — drop every live
        # reference to the resident index (engine/pea didx ~3.7 GB) and
        # upload codes per chunk (index + planes together need the
        # memory of both)
        ca._engine = None
        engine = None
        try:
            del pea
        except NameError:
            pass
        sp = SNPParams()
        cp = ChunkedPileup(
            ca.bases, [p[2] for p in ca.plans],
            np.asarray([p[1] for p in ca.plans], np.int64), ca.overlap,
        )
        all_blocks = blocks
        all_res = res1 + res2
        for k in range(ca.num_chunks):
            codes_k, es_k, own_k = ca._chunk_codes(k)
            genome_d = jax.device_put(codes_k)
            pad_n = int(genome_d.shape[0])
            cp.start_chunk(k, pad_n)
            esl = np.clip(ca.entry_starts - ca.bases[k], 0,
                          ca.plans[k][2])
            for (codes_b, lens_b), res in zip(all_blocks, all_res):
                chunk = np.clip(
                    np.searchsorted(ca.bases, res["locus"],
                                    side="right") - 1,
                    0, ca.num_chunks - 1)
                acc = res["unique"] & (chunk == k)
                if not acc.any():
                    continue
                aligned = codes_b.copy()
                for i in np.nonzero(res["is_rc"] & acc)[0]:
                    L0 = int(lens_b[i])
                    aligned[i, :L0] = revcomp(codes_b[i, :L0])
                cp.add_batch(genome_d,
                             (res["locus"] - ca.bases[k]).astype(np.int64),
                             aligned, lens_b, acc)
            cp.finish_chunk(genome_d, esl, sp)
            del genome_d
            print(f"snp chunk {k + 1}/{ca.num_chunks}", flush=True)

        def ref_base(e, loci):
            return int(codes[bounds[e] + int(loci)])

        calls = cp.finalize_calls(ref_base, [nm for nm, _ in seqs],
                                  ca.entry_starts, sp)
        write_snps_csv(os.path.join(args.dir, "ours_snps.csv"), calls)
        out["detail"]["snp_sweep_s"] = round(time.monotonic() - t2, 1)
        out["detail"]["snp_calls"] = len(calls)
        with open(os.path.join(REPO, "BENCH_3G.json"), "w") as f:
            json.dump(out, f, indent=1)

    print(json.dumps(out))
    with open(os.path.join(REPO, "BENCH_3G.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
