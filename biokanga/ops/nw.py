"""Batched Needleman-Wunsch global alignment (Gotoh affine gaps).

Parity role: CNeedlemanWunsch (libbiokanga/NeedlemanWunsch.h:10-13
default scores match +1, mismatch -1, gap-open -3, gap-extend -1) used
by legacy comparative tools; the PB suite's local SW lives in ops/sw.py.

Design: DP rows advance under `lax.scan` with the whole batch as a
vectorised leading dimension. The within-row horizontal Gotoh state
Y[j] = max(M[j-1]+open, Y[j-1]+ext) is a max-plus linear recurrence,
solved in closed form per row as ext*j + cummax(M[j-1]+open-ext*j) —
so every scan step is pure vector ops (one (B, N) row per step) and XLA
keeps the VPU lanes full instead of the reference's per-cell scalar
loop. Scores only (no traceback): callers needing paths use the banded
SW kernel's traceback.
"""
from __future__ import annotations

import numpy as np

NW_MATCH = 1
NW_MISMATCH = -1
NW_GAP_OPEN = -3
NW_GAP_EXT = -1
_NEG = -(1 << 20)  # cNWScoreMsk clamp scale (NeedlemanWunsch.h:16)


def nw_score_batch(a: np.ndarray, b: np.ndarray,
                   match: int = NW_MATCH, mismatch: int = NW_MISMATCH,
                   gap_open: int = NW_GAP_OPEN,
                   gap_ext: int = NW_GAP_EXT) -> np.ndarray:
    """Global alignment scores for B sequence pairs.

    a: (B, La) int8 codes, b: (B, Lb); codes >= 4 never match.
    Returns (B,) int32 scores. Opening a gap costs gap_open + gap_ext,
    extending costs gap_ext (Gotoh; matches the reference's separate
    open/extend penalties).
    """
    import jax
    import jax.numpy as jnp

    a = jnp.asarray(a, dtype=jnp.int8)
    b = jnp.asarray(b, dtype=jnp.int8)
    B, La = a.shape
    Lb = b.shape[1]
    go = gap_open + gap_ext
    ge = gap_ext

    sub = jnp.where(
        (a[:, None, :] == b[:, :, None]) & (a[:, None, :] < 4),
        match, mismatch).astype(jnp.int32)  # (B, Lb, La)

    j = jnp.arange(La + 1, dtype=jnp.int32)
    m0 = jnp.where(j == 0, 0, _NEG)
    y0 = jnp.where(j == 0, _NEG, go + ge * (j - 1))
    M0 = jnp.broadcast_to(m0, (B, La + 1)).astype(jnp.int32)
    Y0 = jnp.broadcast_to(y0, (B, La + 1)).astype(jnp.int32)
    X0 = jnp.full((B, La + 1), _NEG, dtype=jnp.int32)
    ge_j = (ge * j[1:]).astype(jnp.int32)  # (La,)

    def row_step(carry, sub_row):
        Mp, Xp, Yp = carry
        # vertical state (gap consuming b), incl. column 0 boundary
        X = jnp.maximum(Mp + go, Xp + ge)
        # match state from the previous row's diagonal best
        diag = jnp.maximum(jnp.maximum(Mp, Xp), Yp)[:, :-1]
        M = jnp.concatenate(
            [jnp.full((B, 1), _NEG, jnp.int32), diag + sub_row], axis=1)
        best_mx = jnp.maximum(M, X)
        # horizontal state: Y[j] = ge*j + cummax_k<=j (bestMX[k-1]+go-ge*k)
        u = best_mx[:, :-1] + go - ge_j[None, :] + 0  # k = 1..La uses col k-1
        run = jax.lax.cummax(u, axis=1)
        Y = jnp.concatenate(
            [jnp.full((B, 1), _NEG, jnp.int32),
             run + ge_j[None, :]], axis=1)
        return (M, X, Y), None

    (M, X, Y), _ = jax.lax.scan(
        row_step, (M0, X0, Y0), jnp.swapaxes(sub, 0, 1))
    final = jnp.maximum(jnp.maximum(M[:, -1], X[:, -1]), Y[:, -1])
    return np.asarray(final)


def nw_score_numpy(a: np.ndarray, b: np.ndarray,
                   match: int = NW_MATCH, mismatch: int = NW_MISMATCH,
                   gap_open: int = NW_GAP_OPEN,
                   gap_ext: int = NW_GAP_EXT) -> int:
    """Scalar reference implementation (test oracle) — full Gotoh with
    three state matrices."""
    a = np.asarray(a)
    b = np.asarray(b)
    la, lb = a.size, b.size
    go = gap_open + gap_ext
    M = np.full((lb + 1, la + 1), _NEG, dtype=np.int64)
    Ix = np.full_like(M, _NEG)
    Iy = np.full_like(M, _NEG)
    M[0, 0] = 0
    for j in range(1, la + 1):
        Iy[0, j] = go + gap_ext * (j - 1)
    for i in range(1, lb + 1):
        Ix[i, 0] = go + gap_ext * (i - 1)
    for i in range(1, lb + 1):
        for j in range(1, la + 1):
            s = match if (a[j - 1] == b[i - 1] and a[j - 1] < 4) \
                else mismatch
            best_prev = max(M[i - 1, j - 1], Ix[i - 1, j - 1],
                            Iy[i - 1, j - 1])
            M[i, j] = best_prev + s
            Ix[i, j] = max(M[i - 1, j] + go, Ix[i - 1, j] + gap_ext)
            Iy[i, j] = max(max(M[i, j - 1], Ix[i, j - 1]) + go,
                           Iy[i, j - 1] + gap_ext)
    return int(max(M[lb, la], Ix[lb, la], Iy[lb, la]))
