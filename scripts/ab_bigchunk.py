"""A/B: big-genome sweep rate vs chunk size (VERDICT r3 item 4).

Random 64 B row gathers slow down once the table outgrows the device's
on-chip caches; the 256 Mbp default chunk puts the packed-row table at
125 MB.  Smaller chunks shrink it (and with lut_bases=12 the LUT too)
at the cost of more chunk cycles.

Aligns the SAME 32k x 100 bp readset against the SAME 250 Mbp genome
through the real two_level_chunk_sweep at several (max_chunk, lut_bases)
configs and reports end-to-end sweep reads/s (timed around the whole
sweep incl. device chunk builds, and separately sweep-only).

Usage: python scripts/ab_bigchunk.py [--mbp 250] [--batch 32768]
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
    ap.add_argument("--mbp", type=float, default=250.0)
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--reads", type=int, default=32768)
    args = ap.parse_args()

    from biokanga.align.params import AlignParams
    from biokanga.align.pipeline import pad_rows
    from biokanga.index.device_build import DeviceBuildChunkedAligner
    from biokanga.parallel.chunked import two_level_chunk_sweep
    from biokanga.sim.simreads import simulate_reads
    from biokanga.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    n = int(args.mbp * 1e6)
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=n, dtype=np.int8)
    seqs = [("chr1", codes)]
    _, reads, _ = simulate_reads(seqs, args.reads, read_len=100,
                                 sub_rate=0.01, seed=5)
    lengths = np.full(args.reads, 100, np.int32)
    B = args.batch
    blocks = [pad_rows(reads[i: i + B], lengths[i: i + B])
              for i in range(0, args.reads, B)]

    configs = [
        ("1x250M lut13 (old default)", 256_000_000, 13),
        ("3x84M lut13", 112_000_000, 13),
        ("3x84M lut12", 112_000_000, 12),
        ("2x125M lut13", 208_000_000, 13),
    ]
    results = {}
    for name, max_chunk, lut_bases in configs:
        ca = DeviceBuildChunkedAligner(seqs, max_chunk=max_chunk,
                                       lut_bases=lut_bases,
                                       params=AlignParams(batch_size=B))
        ca.time_builds = True  # benches report chunk_build_s
        # epoch 1 pays every jit compile; epoch 2 is the steady state
        # (the regime the 10M-pair cfg3 run actually lives in)
        for epoch in range(2):
            ca.build_s.clear()
            t0 = time.monotonic()
            merged = two_level_chunk_sweep(ca, blocks)
            nu = sum(int(r["unique"].sum()) for r in merged)
            wall = time.monotonic() - t0
            builds = sum(ca.build_s)
        rate = args.reads / wall
        results[name] = {
            "wall_s": round(wall, 2), "build_s": round(builds, 2),
            "sweep_only_s": round(wall - builds, 2),
            "reads_per_s": round(rate, 0),
            "sweep_only_reads_per_s": round(
                args.reads / max(wall - builds, 1e-9), 0),
            "num_chunks": ca.num_chunks, "unique": nu,
        }
        print(json.dumps({"config": name, **results[name]}), flush=True)
        del ca, merged

    best = max(results, key=lambda k: results[k]["reads_per_s"])
    print(json.dumps({"metric": "bigchunk_ab", "winner": best,
                      **results[best]}))


if __name__ == "__main__":
    main()
