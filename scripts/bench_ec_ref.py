"""Reference pacbiokanga ecreads on the BENCH_EC input (VERDICT r2 item 7).

Generates the IDENTICAL simulated PacBio readset as scripts/bench_ecreads.py
(same rng seed and error process), writes it as FASTA, runs
`refbuild/bin/pacbiokanga ecreads -T2` on it, and scores the corrected
output with the same truth-32-mer recovery metric — the reference
comparison row for BENCH_EC.json.

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
sys.path.insert(0, os.path.join(REPO, "scripts"))
REF_BIN = os.path.join(REPO, "refbuild", "bin", "pacbiokanga")

from bench_ecreads import kmer_recovery, kmer_set  # noqa: E402


def gen_reads(n_reads, L, genome_kb, err):
    """Identical generator to bench_ecreads.main (seed 3)."""
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, size=genome_kb * 1000, dtype=np.int8)
    reads, truths = [], []
    for i in range(n_reads):
        st = int(rng.integers(0, len(genome) - L))
        w = genome[st : st + L].copy()
        truths.append(w.copy())
        r = []
        for b in w:
            x = rng.random()
            if x < err * 0.4:
                r.append((b + rng.integers(1, 4)) % 4)
            elif x < err * 0.7:
                r.append(b)
                r.append(rng.integers(0, 4))
            elif x < err:
                continue
            else:
                r.append(b)
        reads.append(np.array(r, np.int8))
    return reads, truths


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=500)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--genome-kb", type=int, default=200)
    ap.add_argument("--err", type=float, default=0.05)
    ap.add_argument("--dir", default="/tmp/bench_ec_ref")
    a = ap.parse_args()
    os.makedirs(a.dir, exist_ok=True)

    from biokanga.seq.fasta import read_seqs, write_fasta

    reads, truths = gen_reads(a.reads, a.read_len, a.genome_kb, a.err)
    names = [f"read{i:06d}" for i in range(a.reads)]
    write_fasta(os.path.join(a.dir, "pb.fa"), zip(names, reads))

    t0 = time.monotonic()
    r = subprocess.run(
        [REF_BIN, "ecreads", "-i", "pb.fa", "-o", "corr.fa",
         "-l", "500", "-S", "500", "-b", "500", "-T2", "-F", "ec.log"],
        cwd=a.dir, capture_output=True, text=True, timeout=14400,
    )
    dt = time.monotonic() - t0
    if r.returncode != 0:
        print(json.dumps({"metric": "pacbio_ec_ref_row", "error":
                          (r.stdout + r.stderr)[-800:]}))
        return

    # corrected reads keep (a form of) the source name; match by token
    corr = {}
    for rec in read_seqs(os.path.join(a.dir, "corr.fa")):
        for tok in rec.name.replace("|", " ").split():
            if tok.startswith("read"):
                corr.setdefault(tok[:10], []).append(rec.codes)
                break

    pre = post = 0.0
    n_out = 0
    for i in range(a.reads):
        tk = kmer_set(truths[i])
        pre += kmer_recovery(reads[i], tk)
        cs = corr.get(names[i], [])
        if cs:
            n_out += 1
            post += max(kmer_recovery(c, tk) for c in cs)
    pre /= a.reads
    post_per_output = post / max(n_out, 1)

    print(json.dumps({
        "metric": "pacbio_ec_ref_kmer32_recovery",
        "value": round(post_per_output, 4),
        "unit": "frac",
        "detail": {
            "pre_correction": round(pre, 4),
            "n_reads_in": a.reads,
            "n_reads_corrected_out": n_out,
            "read_len": a.read_len,
            "err_rate": a.err,
            "seconds_T2": round(dt, 1),
            "binary": "refbuild/bin/pacbiokanga ecreads",
        },
    }))


if __name__ == "__main__":
    main()
