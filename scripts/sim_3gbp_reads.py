"""Simulate the north-star PE read set straight from the 3 Gbp .npy codes
(no 3 GB FASTA parse), writing r1.fa/r2.fa with simreads truth
descriptors.  The SAME files feed the reference binary and this program's run,
so both comparison rows measure identical inputs (VERDICT r2 item 1).

Usage: python scripts/sim_3gbp_reads.py DIR [--pairs 262144] [--chroms 24]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--pairs", type=int, default=262_144)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--chroms", type=int, default=24)
    ap.add_argument("--sub-rate", type=float, default=0.01)
    ap.add_argument("--insert-min", type=int, default=200)
    ap.add_argument("--insert-max", type=int, default=500)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()

    from biokanga.seq.fasta import write_fasta
    from biokanga.sim.simreads import simulate_reads

    codes = np.load(os.path.join(args.dir, "g.npy"), mmap_mode="r")
    n = len(codes)
    per = n // args.chroms
    bounds = [per * i for i in range(args.chroms)] + [n]
    seqs = [(f"chr{i + 1}", np.asarray(codes[bounds[i]:bounds[i + 1]]))
            for i in range(args.chroms)]

    names, reads, truths = simulate_reads(
        seqs, args.pairs, read_len=args.read_len, sub_rate=args.sub_rate,
        seed=args.seed, pe=True, insert_min=args.insert_min,
        insert_max=args.insert_max,
    )
    write_fasta(os.path.join(args.dir, "r1.fa"),
                ((names[i], reads[i]) for i in range(0, len(names), 2)))
    write_fasta(os.path.join(args.dir, "r2.fa"),
                ((names[i], reads[i]) for i in range(1, len(names), 2)))
    print(f"wrote {args.pairs} pairs ({len(names)} reads)")


if __name__ == "__main__":
    main()
