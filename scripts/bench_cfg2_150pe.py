"""BASELINE config 2: 1M x 2x150 bp PE vs a yeast-scale (~12 Mbp) genome
(VERDICT r2 item 5a).

150 bp exercises the multi-row packed extension path
(ops/extend_packed.py strided multi-row gathers).  Measures per-chip PE
throughput AND insert-size distribution parity vs the reference binary's
PE stats on the SAME reads (TLEN columns of both SAM outputs; reference
computes the same observed-insert in ReportAlignStats,
biokanga/Aligner.cpp:5340).

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REF_BIN = os.path.join(REPO, "refbuild", "bin", "biokanga")


def tlen_stats(sam_path):
    """One positive TLEN per QNAME, primary alignments only (ADVICE r3:
    -M5 multi-hit/duplicate records doubled the distribution's n)."""
    seen = set()
    tl = []
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fld = line.split("\t")
            if int(fld[1]) & 0x900:
                continue
            t = int(fld[8])
            if t > 0 and fld[0] not in seen:
                seen.add(fld[0])
                tl.append(t)
    tl = np.asarray(tl, np.int64)
    if len(tl) == 0:
        return {"n": 0}
    hist, _ = np.histogram(tl, bins=np.arange(150, 651, 25))
    return {"n": int(len(tl)), "mean": round(float(tl.mean()), 2),
            "std": round(float(tl.std()), 2),
            "p5": int(np.percentile(tl, 5)),
            "p50": int(np.percentile(tl, 50)),
            "p95": int(np.percentile(tl, 95)),
            "hist25": hist.tolist()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=1_000_000)
    ap.add_argument("--mbp", type=float, default=12.0)
    ap.add_argument("--dir", default="/tmp/bench_cfg2")
    ap.add_argument("--skip-ref", action="store_true")
    a = ap.parse_args()
    os.makedirs(a.dir, exist_ok=True)

    from biokanga.align.params import AlignParams
    from biokanga.align.pe import PEAligner, PEParams
    from biokanga.align.pipeline import AlignEngine
    from biokanga.index.build import build_index
    from biokanga.index.device import to_device
    from biokanga.seq.fasta import write_fasta
    from biokanga.sim.simreads import random_genome, simulate_reads
    from biokanga.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    gbp = int(a.mbp * 1e6)
    L = 150
    seqs = random_genome([("chr1", gbp)], seed=52)
    names, reads, truths = simulate_reads(
        seqs, a.pairs, read_len=L, sub_rate=0.01, seed=53,
        pe=True, insert_min=250, insert_max=550,
    )
    r1, r2 = reads[0::2], reads[1::2]
    t0 = time.monotonic()
    idx = build_index(seqs)
    t_index = time.monotonic() - t0

    batch = 16384
    params = AlignParams(batch_size=batch)
    engine = AlignEngine(to_device(idx), params)
    pea = PEAligner(engine, PEParams(pair_min_len=150, pair_max_len=650))
    lens = np.full(batch, L, np.int32)
    pea.align_pairs(r1[:batch], lens, r2[:batch], lens)  # warmup/compile

    n = (a.pairs // batch) * batch
    t0 = time.monotonic()
    n_proper = 0
    inserts = []
    loci1 = np.zeros(n, np.int64)
    uniq = np.zeros(n, bool)

    def harvest(res, i0):
        nonlocal n_proper
        sl = slice(i0, i0 + batch)
        n_proper += int(res["proper"].sum())
        inserts.append(np.asarray(res["insert"])[res["proper"]])
        loci1[sl] = res["res1"]["locus"]
        uniq[sl] = res["proper"]

    pending = None
    pend_i = 0
    for i in range(0, n, batch):
        nxt = pea.launch_pairs(r1[i:i + batch], lens, r2[i:i + batch], lens)
        if pending is not None:
            harvest(pea.finish_pairs(pending), pend_i)
        pending, pend_i = nxt, i
    if pending is not None:
        harvest(pea.finish_pairs(pending), pend_i)
    dt = time.monotonic() - t0
    ins = np.concatenate(inserts) if inserts else np.zeros(0, np.int64)

    # truth check on mate 1
    t1 = truths[0::2]
    starts = np.array([t.start - 1 for t in t1], np.int64)[: n]
    correct = int((uniq & (loci1 == starts)).sum())
    ours_ins = {"n": int(len(ins)), "mean": round(float(ins.mean()), 2),
                "std": round(float(ins.std()), 2),
                "p5": int(np.percentile(ins, 5)),
                "p50": int(np.percentile(ins, 50)),
                "p95": int(np.percentile(ins, 95))}

    out = {
        "metric": "cfg2_pe150_reads_per_sec_per_chip",
        "value": round(2 * n / dt, 1),
        "unit": "reads/s",
        "detail": {
            "genome_bp": gbp, "read_len": L, "n_pairs": n,
            "proper_frac": round(n_proper / n, 4),
            "truth_correct_mate1": round(correct / max(n_proper, 1), 4),
            "index_build_s": round(t_index, 2),
            "align_s": round(dt, 2),
            "insert_stats_ours": ours_ins,
        },
    }

    if not a.skip_ref:
        # reference on the same reads (subsample 128k pairs for wall time;
        # the insert DISTRIBUTION is what must match, not the count)
        m = min(n, 131072)
        write_fasta(os.path.join(a.dir, "r1.fa"),
                    ((names[2 * i], r1[i]) for i in range(m)))
        write_fasta(os.path.join(a.dir, "r2.fa"),
                    ((names[2 * i + 1], r2[i]) for i in range(m)))
        gfa = os.path.join(a.dir, "g.fa")
        with open(gfa, "w") as f:
            f.write(">chr1\n")
            s = "".join("ACGTN"[c] for c in seqs[0][1])
            for i in range(0, len(s), 70):
                f.write(s[i:i + 70] + "\n")
        t0 = time.monotonic()
        subprocess.run([REF_BIN, "index", "-i", "g.fa", "-o", "g.sfx",
                        "-r", "t", "-T2", "-F", "idx.log"], cwd=a.dir,
                       check=True, capture_output=True, timeout=3600)
        t_ref_idx = time.monotonic() - t0
        t0 = time.monotonic()
        subprocess.run([REF_BIN, "align", "-i", "r1.fa", "-u", "r2.fa",
                        "-U1", "-d", "150", "-D", "650", "-I", "g.sfx",
                        "-o", "ref.sam", "-M5", "-T2", "-F", "aln.log"],
                       cwd=a.dir, check=True, capture_output=True,
                       timeout=7200)
        t_ref = time.monotonic() - t0
        ref_ins = tlen_stats(os.path.join(a.dir, "ref.sam"))
        out["detail"]["ref"] = {
            "n_pairs": m, "align_s": round(t_ref, 2),
            "index_s": round(t_ref_idx, 2),
            "reads_per_sec_T2": round(2 * m / t_ref, 1),
            "insert_stats": ref_ins,
        }
        out["vs_baseline"] = round(
            (2 * n / dt) / max(2 * m / t_ref, 1e-9), 3)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
