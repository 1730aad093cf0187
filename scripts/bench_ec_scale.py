"""EC at scale: 5,000 x 10 kb reads (50 Mbp raw, 10x the round-2/4
head-to-head shape) through the target-chunked ec_reads
path (VERDICT r4 item 9: prove the scale features do what they were
built for).

The 10,000-read rc-doubled index (100 Mbp) is target-chunked so index
residency stays bounded; correction quality is scored as 32-mer truth
recovery over a 250-read sample (full scoring is O(n * L) host work
that would dominate the bench).  Writes BENCH_EC_SCALE.json.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from bench_ec_headtohead import gen_reads  # noqa: E402
from bench_ecreads import kmer_recovery, kmer_set  # noqa: E402


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=5000)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--genome-kb", type=int, default=2000)
    ap.add_argument("--err", type=float, default=0.07)
    ap.add_argument("--target-chunk", type=int, default=2500)
    ap.add_argument("--max-targets", type=int, default=24)
    a = ap.parse_args()

    from biokanga.pacbio.ecreads import ECParams, ec_reads
    from biokanga.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    reads, truths = gen_reads(a.reads, a.read_len, a.genome_kb, a.err)
    total_bp = int(sum(len(r) for r in reads))
    t0 = time.monotonic()
    corrected, stats = ec_reads(
        reads, ECParams(max_targets=a.max_targets),
        target_chunk=a.target_chunk)
    wall = time.monotonic() - t0

    rng = np.random.default_rng(1)
    sample = rng.choice(a.reads, size=min(250, a.reads), replace=False)
    pre = post = 0.0
    for i in sample:
        tk = kmer_set(truths[i])
        pre += kmer_recovery(reads[i], tk)
        post += kmer_recovery(corrected[i], tk)
    row = {
        "metric": "pacbio_ec_scale_reads_per_chip_run",
        "value": round(total_bp / wall / 1e6, 3),
        "unit": "Mbp/s",
        "detail": {
            "n_reads": a.reads, "read_len": a.read_len,
            "total_bp": total_bp, "wall_s": round(wall, 1),
            "target_chunk": a.target_chunk,
            "target_chunks": stats.get("target_chunks"),
            "max_targets": a.max_targets,
            "overlaps_used": stats["overlaps_used"],
            "kmer32_pre": round(pre / len(sample), 4),
            "kmer32_post": round(post / len(sample), 4),
            "sample_n": int(len(sample)),
            "vs_round4_total_bp": round(total_bp / 5_000_000, 1),
        },
    }
    with open(os.path.join(REPO, "BENCH_EC_SCALE.json"), "w") as f:
        json.dump(row, f, indent=1)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
