"""PacBio EC at scale: 500 x 10 kb simulated long reads, measured
error-rate reduction (VERDICT round-1 item 6 done-criterion).

Error proxy: truth-32-mer recovery rate (fraction of each corrected
read's 32-mers present in its true source window) before vs after
correction.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def kmer_set(s: np.ndarray, k: int = 32):
    packs = set()
    v = 0
    mask = (1 << (2 * k)) - 1
    run = 0
    for b in s:
        if b >= 4:
            run = 0
            v = 0
            continue
        v = ((v << 2) | int(b)) & mask
        run += 1
        if run >= k:
            packs.add(v)
    return packs


def kmer_recovery(read: np.ndarray, truth_kmers: set, k: int = 32) -> float:
    n = tot = 0
    v = 0
    mask = (1 << (2 * k)) - 1
    run = 0
    for b in read:
        if b >= 4:
            run = 0
            v = 0
            continue
        v = ((v << 2) | int(b)) & mask
        run += 1
        if run >= k:
            tot += 1
            n += v in truth_kmers
    return n / max(tot, 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=500)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--genome-kb", type=int, default=200)
    ap.add_argument("--err", type=float, default=0.05)
    args = ap.parse_args()

    from biokanga.pacbio.ecreads import ECParams, ec_reads

    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, size=args.genome_kb * 1000, dtype=np.int8)
    L = args.read_len
    reads, truths = [], []
    for i in range(args.reads):
        st = int(rng.integers(0, len(genome) - L))
        w = genome[st : st + L].copy()
        truths.append(w.copy())
        # PacBio-ish errors: subs + 1bp indels at args.err combined rate
        r = []
        for b in w:
            x = rng.random()
            if x < args.err * 0.4:          # sub
                r.append((b + rng.integers(1, 4)) % 4)
            elif x < args.err * 0.7:        # insertion
                r.append(b)
                r.append(rng.integers(0, 4))
            elif x < args.err:              # deletion
                continue
            else:
                r.append(b)
        reads.append(np.array(r, np.int8))

    t0 = time.monotonic()
    corrected, stats = ec_reads(reads, ECParams())
    dt = time.monotonic() - t0

    pre = post = 0.0
    for i in range(args.reads):
        tk = kmer_set(truths[i])
        pre += kmer_recovery(reads[i], tk)
        post += kmer_recovery(corrected[i], tk)
    pre /= args.reads
    post /= args.reads

    print(json.dumps({
        "metric": "pacbio_ec_kmer32_recovery",
        "value": round(post, 4),
        "unit": "frac",
        "detail": {
            "pre_correction": round(pre, 4),
            "n_reads": args.reads,
            "read_len": L,
            "err_rate": args.err,
            "overlaps_used": stats["overlaps_used"],
            "seconds": round(dt, 1),
        },
    }))


if __name__ == "__main__":
    main()
