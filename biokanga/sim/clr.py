"""PacBio CLR-like long-read simulator and k-mer recovery scoring.

Error model: of all error events, 10% are substitutions, 60% insertions
and 30% deletions — the indel-dominated profile the reference's
PBErrCorrect SW defaults assume.  With burst=True the rate is modulated
along the read like real CLR noise: about 20% of each read lies in
high-noise windows at 3x the base rate, the rest at 0.5x.
"""
from __future__ import annotations

import numpy as np


def mutate_clr(w: np.ndarray, rate: np.ndarray, rng) -> np.ndarray:
    """One CLR-noised copy of w (int8 codes 0..3); rate is per base."""
    x = rng.random(len(w))
    sub = x < rate * 0.1
    ins = (x >= rate * 0.1) & (x < rate * 0.7)
    dele = (x >= rate * 0.7) & (x < rate)
    base = w.copy()
    base[sub] = (w[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    cnt = np.where(dele, 0, np.where(ins, 2, 1))
    out = np.repeat(base, cnt).astype(np.int8)
    out[np.cumsum(cnt)[ins] - 1] = rng.integers(0, 4, int(ins.sum()))
    return out


def clr_reads(n_reads: int, L: int, genome_kb: int, err: float,
              seed: int = 3, burst: bool = False):
    """(reads, truths): n_reads CLR-noised reads of L true bases each,
    sampled from a random genome of genome_kb kbp."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_kb * 1000, dtype=np.int8)
    reads, truths = [], []
    for _ in range(n_reads):
        st = int(rng.integers(0, len(genome) - L))
        w = genome[st: st + L].copy()
        truths.append(w)
        rate = np.full(L, err)
        if burst:
            rate[:] = err * 0.5
            covered = 0
            while covered < 0.2 * L:
                b0 = int(rng.integers(0, L))
                bl = int(rng.integers(200, 800))
                rate[b0: b0 + bl] = err * 3.0
                covered += min(bl, L - b0)
        reads.append(mutate_clr(w, rate, rng))
    return reads, truths


def kmer_codes(s: np.ndarray, k: int = 32) -> np.ndarray:
    """2-bit packed codes of every N-free k-mer of s (k <= 32)."""
    s = np.asarray(s)
    if len(s) < k:
        return np.zeros(0, np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(s, k)
    ok = (win < 4).all(axis=1)
    sh = (2 * np.arange(k - 1, -1, -1)).astype(np.uint64)
    codes = (np.where(win < 4, win, 0).astype(np.uint64) << sh).sum(
        axis=1, dtype=np.uint64)
    return codes[ok]


def kmer_recovery(read: np.ndarray, truth: np.ndarray, k: int = 32) -> float:
    """Share of the read's k-mers that occur in its true source."""
    rc = kmer_codes(read, k)
    if len(rc) == 0:
        return 0.0
    return float(np.isin(rc, kmer_codes(truth, k)).mean())


def clr_pairs(n: int, La: int, W: int, err: float = 0.07, seed: int = 0):
    """n (query, CLR-noised copy) SW pairs of La-base queries, with band
    centres within W/2 and every 7th query cut short, as the EC step
    builds them.  Returns (a, b, alen, blen, diag)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (n, La), dtype=np.int8)
    Lb = La + La // 8
    b = np.full((n, Lb), 4, np.int8)
    blen = np.zeros(n, np.int32)
    alen = np.full(n, La, np.int32)
    for p in range(n):
        t = mutate_clr(a[p], np.full(La, err), rng)[:Lb]
        b[p, :len(t)] = t
        blen[p] = len(t)
    alen[::7] = La - rng.integers(0, La // 2, len(alen[::7]))
    diag = rng.integers(-W // 2, W // 2, n).astype(np.int32)
    return a, b, alen, blen, diag
