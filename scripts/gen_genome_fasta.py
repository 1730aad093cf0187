"""Write a uniform-random genome as BOTH int8 codes (.npy) and FASTA.

Used by the 3 Gbp north-star benchmark (VERDICT r2 item 1): the .npy codes
feed the chunk-cycled device run (memory-mapped, no 3 GB FASTA parse) and the
FASTA derived from the SAME array feeds the reference binary
(refbuild/bin/biokanga), so both rows measure identical inputs.

Usage: python scripts/gen_genome_fasta.py OUTDIR --bp 3000000000 --seed 31
Writes OUTDIR/g.npy and OUTDIR/g.fa.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

LINE = 70


def gen_codes(path_npy: str, n_bp: int, seed: int,
              chunk: int = 100_000_000) -> None:
    rng = np.random.default_rng(seed)
    out = np.lib.format.open_memmap(path_npy, mode="w+", dtype=np.int8,
                                    shape=(n_bp,))
    done = 0
    while done < n_bp:
        m = min(chunk, n_bp - done)
        out[done : done + m] = rng.integers(0, 4, size=m, dtype=np.int8)
        done += m
    out.flush()


def codes_to_fasta(path_npy: str, path_fa: str, name: str = "chr1",
                   chunk: int = 70_000_000, chroms: int = 1) -> None:
    """With chroms > 1 the codes array is emitted as `chroms` equal-size
    entries chr1..chrN (human-like multi-chromosome shape; also keeps each
    reference-side sequence well under 2^31 — refbuild simreads segfaults
    on a single 3 Gbp entry)."""
    codes = np.load(path_npy, mmap_mode="r")
    n_bp = len(codes)
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    nl = np.uint8(10)
    per = n_bp // chroms
    bounds = [per * i for i in range(chroms)] + [n_bp]
    with open(path_fa, "wb") as f:
        for ci in range(chroms):
            nm = name if chroms == 1 else f"chr{ci + 1}"
            f.write(f">{nm}\n".encode())
            done, end = bounds[ci], bounds[ci + 1]
            while done < end:
                m = min(chunk, end - done)
                if done + m < end:
                    m -= m % LINE
                b = lut[codes[done : done + m]]
                full = (m // LINE) * LINE
                rows = b[:full].reshape(-1, LINE)
                block = np.empty((rows.shape[0], LINE + 1), dtype=np.uint8)
                block[:, :LINE] = rows
                block[:, LINE] = nl
                block.tofile(f)
                if full < m:
                    b[full:].tofile(f)
                    f.write(b"\n")
                done += m


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--bp", type=int, default=3_000_000_000)
    ap.add_argument("--seed", type=int, default=31)
    ap.add_argument("--name", default="chr1")
    ap.add_argument("--chroms", type=int, default=1)
    a = ap.parse_args()
    os.makedirs(a.outdir, exist_ok=True)
    npy = os.path.join(a.outdir, "g.npy")
    if not os.path.exists(npy):
        gen_codes(npy, a.bp, a.seed)
    codes_to_fasta(npy, os.path.join(a.outdir, "g.fa"), a.name,
                   chroms=a.chroms)


if __name__ == "__main__":
    main()
