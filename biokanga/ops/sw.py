"""Banded affine Smith-Waterman (batched, with traceback).

Batched re-design of the PacBio suite's SW engine (CSSW::Align,
pacbiokanga/SSW.cpp:992 — full SW with tracebacks, anchor drops and
cell-skipping heuristics; default scoring tuned for PacBio error
profiles, SSW.h:1-30).  Instead of per-cell pointer chasing we run a
row-wise banded DP in band coordinates (k = j - i + W):

  - diagonal move keeps k, up move is k+1, left move is k-1
  - the intra-row horizontal (F) dependency is resolved EXACTLY with a
    single running-max scan ("lazy-F"): F[k] = max_{k'<k}(H[k'] - open
    - (k-k')*ext) = cummax(H + k*ext) - k*ext - open, so every row
    update is pure vector ops — no sequential inner loop
  - rows advance under jax.lax.scan, the whole batch of alignment pairs
    vectorised on the leading axis

Traceback stores 2-bit move codes per (row, band) cell and is decoded on
host (alignment pairs in error correction are modest-length overlaps;
the full-length path uses blockwise recompute later).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(10**7)

# default PacBio-ish scoring (cf. SSW.h defaults: match 1, mismatch -1,
# gap open -3, gap extend -1 in the reference's SW service)
DEFAULT_MATCH = 1
DEFAULT_MISMATCH = -1
DEFAULT_GAP_OPEN = -3
DEFAULT_GAP_EXT = -1

# traceback codes
TB_STOP, TB_DIAG, TB_UP, TB_LEFT = 0, 1, 2, 3


@partial(jax.jit, static_argnames=("W", "La", "Lb"))
def banded_sw_batch(
    a: jax.Array,       # (B, La) int8 query codes
    b: jax.Array,       # (B, Lb) int8 target codes
    alen: jax.Array,    # (B,)
    blen: jax.Array,    # (B,)
    diag: jax.Array,    # (B,) band centre: expected j - i
    W: int, La: int, Lb: int,
    match: int = DEFAULT_MATCH,
    mismatch: int = DEFAULT_MISMATCH,
    gap_open: int = DEFAULT_GAP_OPEN,
    gap_ext: int = DEFAULT_GAP_EXT,
):
    """Returns (best_score, best_i, best_k, moves) where moves is
    (B, La, 2W+1) uint8 traceback codes. Band: j in
    [i + diag - W, i + diag + W]."""
    B = a.shape[0]
    K = 2 * W + 1
    ks = jnp.arange(K, dtype=jnp.int32)

    def row_step2(carry, i):
        H_prev, E_prev, best, best_i, best_k = carry
        j = i + diag[:, None] + (ks[None, :] - W)
        in_j = (j >= 0) & (j < blen[:, None])
        in_i = (i < alen)[:, None]
        bj = jnp.take_along_axis(b, jnp.clip(j, 0, Lb - 1), axis=1)
        ai = a[:, i][:, None]
        sub = jnp.where((ai == bj) & (ai < 4) & (bj < 4), match, mismatch)

        # shift helpers in band coords
        up = lambda x: jnp.concatenate(
            [x[:, 1:], jnp.full((B, 1), NEG, x.dtype)], axis=1
        )
        # E (vertical, consuming a-row): from row i-1 at band k+1
        E = jnp.maximum(up(H_prev) + gap_open, up(E_prev) + gap_ext)
        Hd = H_prev + sub              # diagonal from (i-1, j-1): same k
        H0 = jnp.maximum(jnp.maximum(Hd, E), sub * 0)  # local SW floor 0
        H0 = jnp.maximum(H0, jnp.where(sub > 0, sub, 0))
        # exact lazy-F horizontal pass: F[k] = max_{k'<k} H[k'] + open
        #   + (k - k') * ext  ==> cummax(H - k*ext) + k*ext + open...
        base = H0 + (-gap_ext) * ks[None, :]  # H - k*ext with ext negative
        run = jax.lax.cummax(base, axis=1)
        run_prev = jnp.concatenate(
            [jnp.full((B, 1), NEG, run.dtype), run[:, :-1]], axis=1
        )
        F = run_prev + gap_ext * ks[None, :] + gap_open - gap_ext
        H = jnp.maximum(H0, F)
        H = jnp.maximum(H, 0)
        H = jnp.where(in_j & in_i, H, NEG)
        E = jnp.where(in_j & in_i, E, NEG)

        moves = jnp.zeros((B, K), dtype=jnp.uint8)
        moves = jnp.where(H == 0, TB_STOP, moves)
        moves = jnp.where((H == F) & (H > 0), TB_LEFT, moves)
        moves = jnp.where((H == E) & (H > 0), TB_UP, moves)
        moves = jnp.where((H == Hd) & (H > 0), TB_DIAG, moves)

        rb = jnp.max(H, axis=1)
        rk = jnp.argmax(H, axis=1).astype(jnp.int32)
        better = rb > best
        best = jnp.where(better, rb, best)
        best_i = jnp.where(better, i, best_i)
        best_k = jnp.where(better, rk, best_k)
        return (H, E, best, best_i, best_k), moves

    # virtual row -1: all zeros inside band (local alignment can start
    # anywhere) — encode as 0 so the first diagonal move scores from 0
    H0 = jnp.zeros((B, K), dtype=jnp.int32)
    E0 = jnp.full((B, K), NEG, dtype=jnp.int32)
    best0 = jnp.zeros(B, dtype=jnp.int32)
    (Hl, El, best, best_i, best_k), moves = jax.lax.scan(
        row_step2, (H0, E0, best0, jnp.zeros(B, jnp.int32),
                    jnp.zeros(B, jnp.int32)),
        jnp.arange(La, dtype=jnp.int32),
    )
    moves = jnp.transpose(moves, (1, 0, 2))  # (B, La, K)
    return best, best_i, best_k, moves


def traceback(
    moves: np.ndarray, best_i: int, best_k: int, diag: int, W: int,
):
    """Decode one pair's traceback.

    Returns (steps, path, ops):
      steps — list of (op, i, j): 'M' consumes both (i=query, j=target),
              'D' consumes query i only, 'I' consumes target j only
      path  — the (i, j) pairs of the 'M' steps
      ops   — the op string
    """
    i, k = int(best_i), int(best_k)
    steps = []
    while i >= 0:
        mv = int(moves[i, k])
        j = i + diag + (k - W)
        if mv == TB_DIAG:
            steps.append(("M", i, j))
            i -= 1  # k unchanged
        elif mv == TB_UP:
            steps.append(("D", i, j))  # query base i unaligned
            i -= 1
            k += 1
            if k >= moves.shape[1]:
                break
        elif mv == TB_LEFT:
            steps.append(("I", i, j))  # target base j unaligned
            k -= 1
            if k < 0:
                break
        else:
            break
    steps.reverse()
    path = [(i, j) for op, i, j in steps if op == "M"]
    ops = "".join(op for op, _, _ in steps)
    return steps, path, ops


@partial(jax.jit, static_argnames=("W", "La"))
def traceback_align_batch(
    moves: jax.Array,    # (B, La, 2W+1) uint8 traceback codes
    best_i: jax.Array,   # (B,)
    best_k: jax.Array,   # (B,)
    diag: jax.Array,     # (B,)
    b: jax.Array,        # (B, Lb) int8 target codes
    blen: jax.Array,     # (B,)
    W: int, La: int,
):
    """Device-side traceback decode for a whole pair batch (vmapped
    while_loop; the 2-bit move planes NEVER leave HBM — at long-read
    scale the moves array is ~2 MB/pair, far beyond what a host decode
    could afford to transfer).

    Returns per probe position i:
      out      (B, La) int8 — 0..3 aligned target base, 4 = target N,
               5 = probe base deleted (target gap), 6 = not covered
      ins_cnt  (B, La+1) int32 — target bases inserted AFTER probe pos i-1
      ins_base (B, La+1, 4) int32 — per-base insertion votes
    """
    K = 2 * W + 1
    Lb = b.shape[1]

    def one(mv, bi, bk, dg, bseq, bl):
        out0 = jnp.full((La,), 6, jnp.int8)
        insc0 = jnp.zeros((La + 1,), jnp.int32)
        insb0 = jnp.zeros((La + 1, 4), jnp.int32)

        def cond(st):
            i, k, out, insc, insb, done = st
            return (~done) & (i >= 0) & (k >= 0) & (k < K)

        def body(st):
            i, k, out, insc, insb, done = st
            code = mv[i, k]
            j = i + dg + k - W
            jc = jnp.clip(j, 0, Lb - 1)
            tb = bseq[jc].astype(jnp.int8)
            tb = jnp.where(tb < 4, tb, 4)
            in_j = (j >= 0) & (j < bl)
            is_d = (code == TB_DIAG) & in_j
            is_u = code == TB_UP
            is_l = (code == TB_LEFT) & in_j
            ic = jnp.clip(i, 0, La - 1)
            newv = jnp.where(is_d, tb, jnp.where(is_u, jnp.int8(5),
                                                 out[ic]))
            out = out.at[ic].set(
                jnp.where(is_d | is_u, newv, out[ic])
            )
            ip = jnp.clip(i + 1, 0, La)
            insc = insc.at[ip].add(jnp.where(is_l, 1, 0))
            tbc = jnp.clip(tb, 0, 3)
            insb = insb.at[ip, tbc].add(jnp.where(is_l, 1, 0))
            i = jnp.where(is_d | is_u, i - 1, i)
            k = jnp.where(is_u, k + 1, jnp.where(code == TB_LEFT, k - 1, k))
            done = done | (code == TB_STOP) | (
                (code == TB_LEFT) & ~is_l
            ) | ((code == TB_DIAG) & ~is_d)
            return i, k, out, insc, insb, done

        i0 = bi.astype(jnp.int32)
        k0 = bk.astype(jnp.int32)
        st = jax.lax.while_loop(
            cond, body, (i0, k0, out0, insc0, insb0, jnp.bool_(False))
        )
        return st[2], st[3], st[4]

    return jax.vmap(one)(moves, best_i, best_k, diag, b, blen)


def sw_score_numpy(a, b, match=DEFAULT_MATCH, mismatch=DEFAULT_MISMATCH,
                   gap_open=DEFAULT_GAP_OPEN, gap_ext=DEFAULT_GAP_EXT):
    """Reference full (unbanded) affine local SW score — test oracle."""
    la, lb = len(a), len(b)
    H = np.zeros((la + 1, lb + 1), np.int32)
    E = np.full((la + 1, lb + 1), NEG, np.int32)
    F = np.full((la + 1, lb + 1), NEG, np.int32)
    best = 0
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            s = match if (a[i - 1] == b[j - 1] and a[i - 1] < 4
                          and b[j - 1] < 4) else mismatch
            E[i][j] = max(H[i - 1][j] + gap_open, E[i - 1][j] + gap_ext)
            F[i][j] = max(H[i][j - 1] + gap_open, F[i][j - 1] + gap_ext)
            H[i][j] = max(0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
            best = max(best, H[i][j])
    return int(best)
