"""Column-aligned traceback decode over PACKED move planes.

Replaces ops/sw.traceback_align_batch for the EC consensus path
(CSSW::GenConsensusFromMAF role, pacbiokanga/SSW.cpp:2115) with a
structure XLA runs well: instead of a vmapped while_loop whose every
iteration scatter-updates (B, La) buffers (measured ~1.4 ms/step on the
chip — the loop carries the whole output), the walk is re-expressed as
ONE reverse scan over 16-row move WORDS:

  - the path visits each query row exactly once vertically (a row's
    consecutive LEFT moves are consumed together, then one DIAG/UP
    leaves the row), so per row the decode needs only the landing lane
    l(k) = last non-LEFT lane <= k — a single lane-axis cummax;
  - target bases come from the normalize_band windows (bwin[i + k] =
    b[i + k - W + diag]) as dynamic SLICES, never gathers;
  - outputs stack as scan ys — no scatter anywhere.

Outputs are bit-identical to traceback_align_batch on the same move
codes (tests/test_sw_moves.py asserts it).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .sw import TB_DIAG, TB_LEFT, TB_UP


@partial(jax.jit, static_argnames=("W", "La"))
def traceback_cols_packed(
    mv: jax.Array,      # (B, La//16, KP) int32 packed 2-bit codes
    best_i: jax.Array,  # (B,)
    best_k: jax.Array,  # (B,)
    bwin: jax.Array,    # (B, T) int32 normalized band windows
    W: int, La: int,
):
    """Decode per-probe-column alignments from packed move planes.

    Returns (out (B, La) int8: 0..3 target base, 4 target N, 5 probe
    base deleted, 6 not covered; ins_cnt (B, La+1) int32; ins_base
    (B, La+1, 4) int32) — the traceback_align_batch contract.
    """
    B, Wd, KP = mv.shape
    K = 2 * W + 1
    ks = jnp.arange(KP, dtype=jnp.int32)[None, :]
    bi = best_i.astype(jnp.int32)
    bk = best_k.astype(jnp.int32)

    def word_step(carry, w):
        k, active = carry
        word = jax.lax.dynamic_slice_in_dim(mv, w, 1, axis=1)[:, 0]
        # band windows for the 16 rows of this word: bwin[i + k],
        # i = 16w + r, k < KP  ->  one (KP + 16)-wide slice
        bw16 = jax.lax.dynamic_slice_in_dim(bwin, w * 16, KP + 16, axis=1)
        outs, inscs, insbs = [], [], []
        for r in range(15, -1, -1):
            i = w * 16 + r
            codes = (word >> (2 * r)) & 3
            start_here = i == bi
            k = jnp.where(start_here & ~active, bk, k)
            active = active | start_here
            isL = codes == TB_LEFT
            last_non_l = jax.lax.cummax(jnp.where(~isL, ks, -1), axis=1)
            kc = jnp.clip(k, 0, KP - 1)[:, None]
            land = jnp.take_along_axis(last_non_l, kc, axis=1)[:, 0]
            ok_land = active & (land >= 0)
            code2 = jnp.take_along_axis(codes, jnp.clip(land, 0, KP - 1
                                                        )[:, None],
                                        axis=1)[:, 0]
            is_d = ok_land & (code2 == TB_DIAG)
            is_u = ok_land & (code2 == TB_UP)
            tbrow = bw16[:, r: r + KP]
            tb_land = jnp.take_along_axis(
                tbrow, jnp.clip(land, 0, KP - 1)[:, None], axis=1)[:, 0]
            tb_land = jnp.where(tb_land < 4, tb_land, 4)
            outs.append(jnp.where(
                is_d, tb_land,
                jnp.where(is_u, 5, 6)).astype(jnp.int8))
            ins_m = (active[:, None] & (ks > land[:, None])
                     & (ks <= k[:, None]) & (ks < K))
            inscs.append(jnp.sum(ins_m, axis=1, dtype=jnp.int32))
            tb4 = jnp.clip(jnp.where(tbrow < 4, tbrow, 4), 0, 3)
            insbs.append(jnp.stack(
                [jnp.sum(ins_m & (tb4 == c), axis=1, dtype=jnp.int32)
                 for c in range(4)], axis=1))
            k = jnp.where(is_d, land, jnp.where(is_u, land + 1, k))
            active = active & (is_d | is_u) & (k >= 0) & (k < K)
        # outs collected r=15..0 -> ascending row order is reversed
        return (k, active), (jnp.stack(outs[::-1], 1),
                             jnp.stack(inscs[::-1], 1),
                             jnp.stack(insbs[::-1], 1))

    (k, active), (o, ic, ib) = jax.lax.scan(
        word_step,
        (jnp.zeros(B, jnp.int32), jnp.zeros(B, bool)),
        jnp.arange(Wd - 1, -1, -1, dtype=jnp.int32),
    )
    # scan ys are in iteration order (w = Wd-1 .. 0): flip then flatten
    out = jnp.moveaxis(o[::-1], 0, 1).reshape(B, Wd * 16)[:, :La]
    insc_rows = jnp.moveaxis(ic[::-1], 0, 1).reshape(B, Wd * 16)[:, :La]
    insb_rows = jnp.moveaxis(ib[::-1], 0, 1).reshape(B, Wd * 16, 4)[:, :La]
    # LEFT runs consumed at row i are recorded after probe pos i-1,
    # i.e. at index i+1 of the (La+1)-long insertion planes
    ins_cnt = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), insc_rows], axis=1)
    ins_base = jnp.concatenate(
        [jnp.zeros((B, 1, 4), jnp.int32), insb_rows], axis=1)
    return out, ins_cnt, ins_base
