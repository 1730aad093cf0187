"""BASELINE config 3: 10M PE reads vs a human-chr1-scale (250 Mbp)
genome + SNP calling (VERDICT r2 item 5b).

Real-chip part: one 250 Mbp device-built chunk (the large-table gather
regime), 10M pairs through the fused PE path, SNP pileup on the accepted
hits.  The index-sharded psum-merge part of this config is validated by
`dryrun_multichip` on a virtual mesh, and on real cards by
`chip_smoke.py --four-cards`.

Prints one JSON line.  --pairs scales the read count for wall-clock.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10_000_000)
    ap.add_argument("--mbp", type=float, default=250.0)
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--snp-sample-pairs", type=int, default=1_000_000,
                    help="pairs carried through the SNP pileup (truth "
                    "SNPs planted uniformly; pileup cost is per-read)")
    a = ap.parse_args()

    from biokanga.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    from biokanga.align.params import AlignParams
    from biokanga.align.pe import PEAligner, PEParams
    from biokanga.align.pipeline import AlignEngine
    from biokanga.index.device_build import device_build_index
    from biokanga.sim.simreads import random_genome, simulate_reads

    gbp = int(a.mbp * 1e6)
    L = 100
    seqs = random_genome([("chr1", gbp)], seed=61)
    codes = seqs[0][1]

    t0 = time.monotonic()
    didx = device_build_index(codes, np.array([0, gbp], np.int64))
    t_build = time.monotonic() - t0

    params = AlignParams(batch_size=a.batch)
    engine = AlignEngine(didx, params)
    pea = PEAligner(engine, PEParams(pair_min_len=100, pair_max_len=600))

    batch = a.batch
    lens = np.full(batch, L, np.int32)
    # simulate in blocks to bound host RAM (10M pairs = 2 GB int8)
    blk_pairs = 512 * 1024
    n = (a.pairs // batch) * batch
    t_sim = 0.0
    t0_all = time.monotonic()
    n_proper = 0
    n_correct = 0
    done = 0
    pending = None  # (handle, truths, reads1 or None)
    warm = False
    t_align0 = None
    kept = []       # first snp_sample_pairs: (reads1, res1) for pileup

    def harvest(p):
        nonlocal n_proper, n_correct
        res, tt, keep_r1 = p
        out = pea.finish_pairs(res)
        n_proper += int(out["proper"].sum())
        ok = out["proper"]
        n_correct += int(
            (out["res1"]["locus"][ok]
             == np.array([t.start - 1 for t in tt])[ok]).sum())
        if keep_r1 is not None:
            kept.append((keep_r1, out["res1"]))

    while done < n:
        m = min(blk_pairs, n - done)
        ts = time.monotonic()
        names, reads, truths = simulate_reads(
            seqs, m, read_len=L, sub_rate=0.01, seed=100 + done,
            pe=True, insert_min=200, insert_max=500,
        )
        t_sim += time.monotonic() - ts
        r1, r2 = reads[0::2], reads[1::2]
        t1 = truths[0::2]
        if not warm:
            pea.align_pairs(r1[:batch], lens, r2[:batch], lens)
            warm = True
            t_align0 = time.monotonic()
        for i in range(0, m, batch):
            nxt = pea.launch_pairs(r1[i:i + batch], lens,
                                   r2[i:i + batch], lens)
            if pending is not None:
                harvest(pending)
            keep = (r1[i:i + batch]
                    if (done + i) < a.snp_sample_pairs else None)
            pending = (nxt, t1[i:i + batch], keep)
        done += m
        print(f"{done}/{n} pairs, {time.monotonic()-t0_all:.0f}s",
              flush=True)
    if pending is not None:
        harvest(pending)
    t_align = time.monotonic() - t_align0

    # ---- SNP pileup over the retained sample (single-chunk ChunkedPileup;
    # uint16 planes, device-side candidate compaction) -------------------
    import jax

    from biokanga.align.snp import ChunkedPileup, SNPParams
    from biokanga.seq.encode import revcomp

    # free the resident index before allocating pileup planes
    del pea, engine, didx
    snp_par = SNPParams()
    t0 = time.monotonic()
    cp = ChunkedPileup(np.array([0, gbp]), [gbp], np.array([gbp]), 0)
    genome_d = jax.device_put(codes)
    cp.start_chunk(0, gbp)
    esl = np.array([0, gbp], np.int64)
    for reads1, res in kept:
        acc = res["unique"]
        aligned = reads1.copy()
        for i in np.nonzero(res["is_rc"] & acc)[0]:
            aligned[i, :L] = revcomp(reads1[i, :L])
        cp.add_batch(genome_d, res["locus"].astype(np.int64), aligned,
                     np.full(len(reads1), L, np.int32), acc)
    cp.finish_chunk(genome_d, esl, snp_par)

    def ref_base(e, loci):
        return int(codes[int(loci)])

    calls = cp.finalize_calls(ref_base, ["chr1"],
                              np.array([0, gbp], np.int64), snp_par)
    n_called = len(calls)
    t_snp = time.monotonic() - t0

    out = {
        "metric": "cfg3_pe_reads_per_sec_per_chip_250mbp",
        "value": round(2 * n / t_align, 1),
        "unit": "reads/s",
        "detail": {
            "genome_bp": gbp, "n_pairs": n,
            "chunk_build_s": round(t_build, 2),
            "sim_s": round(t_sim, 1),
            "align_s_incl_sim_overlap": round(t_align, 1),
            "proper_frac": round(n_proper / n, 4),
            "truth_correct_frac": round(n_correct / max(n_proper, 1), 4),
            "snp_sample_pairs": a.snp_sample_pairs,
            "snp_call_s": round(t_snp, 1),
            "snp_rows_called": int(n_called),
        },
    }
    with open(os.path.join(REPO, "BENCH_CFG3.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
