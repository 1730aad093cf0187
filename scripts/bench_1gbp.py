"""Big-genome benchmark: align reads vs a >=1 Gbp genome on ONE chip.

The VERDICT round-1 'break the 2^31 wall' done-criterion: a >=1 Gbp genome
aligned on the device via genome-range chunk cycling with device-side
index builds (index/device_build.py).  Prints one JSON line.

Usage: python scripts/bench_1gbp.py [--gbp 1.0] [--reads 262144]
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbp", type=float, default=1.0)
    ap.add_argument("--reads", type=int, default=262_144)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32_768)
    ap.add_argument("--max-chunk", type=int, default=256_000_000)
    ap.add_argument("--lut-bases", type=int, default=13)
    args = ap.parse_args()

    import jax

    from biokanga.align.params import AlignParams
    from biokanga.index.device_build import DeviceBuildChunkedAligner
    from biokanga.sim.simreads import simulate_reads
    from biokanga.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    n_bp = int(args.gbp * 1e9)
    t0 = time.monotonic()
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=n_bp, dtype=np.int8)
    seqs = [("chr1", codes)]
    t_gen = time.monotonic() - t0

    _, reads, truths = simulate_reads(
        seqs, args.reads, read_len=args.read_len, sub_rate=0.01, seed=5
    )
    lengths = np.full(len(reads), args.read_len, np.int32)
    blocks = [
        (reads[i : i + args.batch], lengths[i : i + args.batch])
        for i in range(0, len(reads), args.batch)
    ]

    params = AlignParams(batch_size=args.batch)
    ca = DeviceBuildChunkedAligner(
        seqs, params, max_chunk=args.max_chunk, lut_bases=args.lut_bases
    )
    ca.time_builds = True  # benches report chunk_build_s
    build_times = []

    t_all = time.monotonic()
    # GLOBAL two-level sweep (round-3 parallel/chunked path): fast pass
    # per (chunk, block) double-buffered, classic cycle only for the
    # globally-unresolved remainder — replaces the round-2 per-chunk
    # align_with_rescue, which re-ran the classic pass for every read
    # whose home chunk was elsewhere ((K-1)/K of all dispatches)
    from biokanga.parallel.chunked import two_level_chunk_sweep

    ca.build_s.clear()
    merged = two_level_chunk_sweep(ca, blocks)
    n_unique = n_correct = 0
    ti = 0
    for b, (r, l) in enumerate(blocks):
        res = merged[b]
        n_unique += int(res["unique"].sum())
        for i in range(len(r)):
            t = truths[ti]
            ti += 1
            if res["unique"][i]:
                n_correct += int(res["locus"][i] == t.start - 1)
    dt = time.monotonic() - t_all
    build_times = list(ca.build_s)
    rps = len(reads) / dt

    sweep_s = dt - sum(build_times)
    out = {
        "metric": "big_genome_reads_per_sec_per_chip",
        "value": round(rps, 1),
        "unit": "reads/s",
        "detail": {
            "genome_bp": n_bp,
            "num_chunks": ca.num_chunks,
            "chunk_build_s": [round(t, 2) for t in build_times],
            "genome_gen_s": round(t_gen, 1),
            "total_align_s": round(dt, 1),
            "sweep_only_s": round(sweep_s, 1),
            "sweep_only_reads_per_s": round(len(reads) / sweep_s, 1),
            "n_reads": len(reads),
            "unique_frac": round(n_unique / len(reads), 4),
            "correct_frac_of_unique": round(
                n_correct / max(n_unique, 1), 4
            ),
            "device": str(jax.devices()[0]),
        },
    }
    with open(os.path.join(REPO, "BENCH_BIG.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
