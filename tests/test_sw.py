"""Banded SW kernel vs full-DP numpy oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

from biokanga.ops.sw import (
    banded_sw_batch,
    sw_score_numpy,
    traceback,
)
from biokanga.seq.encode import revcomp


def _run(a_list, b_list, W, diag=None):
    B = len(a_list)
    La = max(len(x) for x in a_list)
    Lb = max(len(x) for x in b_list)
    a = np.full((B, La), 4, np.int8)
    b = np.full((B, Lb), 4, np.int8)
    alen = np.zeros(B, np.int32)
    blen = np.zeros(B, np.int32)
    for i, (x, y) in enumerate(zip(a_list, b_list)):
        a[i, : len(x)] = x
        b[i, : len(y)] = y
        alen[i] = len(x)
        blen[i] = len(y)
    dg = np.zeros(B, np.int32) if diag is None else np.asarray(diag, np.int32)
    return banded_sw_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(alen), jnp.asarray(blen),
        jnp.asarray(dg), W, La, Lb,
    )


def test_score_matches_oracle_small():
    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(8):
        a = rng.integers(0, 4, size=60).astype(np.int8)
        # b = noisy copy of a segment with indels
        b = list(a[10:50])
        for _ in range(4):
            p = rng.integers(0, len(b))
            r = rng.random()
            if r < 0.4:
                b[p] = (b[p] + 1) % 4
            elif r < 0.7:
                b.insert(p, rng.integers(0, 4))
            else:
                del b[p]
        pairs.append((a, np.array(b, np.int8)))
    W = 70  # wide band == full matrix for these sizes
    best, bi, bk, moves = _run([p[0] for p in pairs], [p[1] for p in pairs], W)
    best = np.asarray(best)
    for i, (a, b) in enumerate(pairs):
        assert best[i] == sw_score_numpy(a, b), f"pair {i}"


def test_perfect_match_score():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 4, size=100).astype(np.int8)
    best, bi, bk, moves = _run([a], [a.copy()], W=16)
    assert int(np.asarray(best)[0]) == 100  # match=1 x 100


def test_banded_with_offset_diag():
    rng = np.random.default_rng(9)
    b = rng.integers(0, 4, size=500).astype(np.int8)
    a = b[200:300].copy()  # a aligns at j-i = 200
    best, bi, bk, moves = _run([a], [b], W=16, diag=[200])
    assert int(np.asarray(best)[0]) == 100


def test_traceback_reconstructs_alignment():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, size=80).astype(np.int8)
    b = np.concatenate([a[:40], a[45:]]).astype(np.int8)  # 5bp deletion in b
    W = 32
    best, bi, bk, moves = _run([a], [b], W)
    steps, path, ops = traceback(np.asarray(moves)[0], int(np.asarray(bi)[0]),
                                 int(np.asarray(bk)[0]), 0, W)
    assert ops.count("D") == 5          # 5 query bases unmatched in b
    assert ops.count("M") >= 70
    # matched pairs are true equalities except at mismatch positions
    n_eq = sum(1 for i, j in path if a[i] == b[j])
    assert n_eq >= 70
