"""Hamming seed-extension: score candidate loci against reads.

The batched reformulation of the reference's innermost hot loop — the
per-candidate byte-wise mismatch counting inside
CSfxArrayV3::LocateCoreMultiples (libbiokanga/SfxArrayV2.cpp:5693+).
Instead of pointer-chasing one candidate at a time, we gather genome
windows for ALL (read, candidate) pairs of a batch at once and reduce
mismatch counts on the VPU.  This dense path is pure XLA (gather +
compare + reduce); the production fast path is the 2-bit packed variant
in ops/extend_packed.py (one 64-byte row gather per candidate), kept in
lockstep by tests/test_extend_packed.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

MM_INVALID = 255  # mismatch sentinel for masked/invalid candidates


def hamming_extend(
    genome: jax.Array,       # (n,) int8 genome codes (N = 4)
    entry_starts: jax.Array,  # (E+1,) int32/int64 entry boundaries
    loci: jax.Array,         # (B, C) int32 candidate window starts
    valid: jax.Array,        # (B, C) bool candidate validity
    reads: jax.Array,        # (B, L) int8 read codes (padded with N)
    lengths: jax.Array,      # (B,) int32 true read lengths
):
    """Return (B, C) uint8 mismatch counts; MM_INVALID where masked.

    A candidate is additionally masked when its window [locus, locus+len)
    is not fully contained in one entry (the reference prevents cross-entry
    matches with eBaseEOS separators; we concatenate without separators and
    mask here instead).
    """
    n = genome.shape[0]
    B, L = reads.shape

    # window containment in a single entry (single-shard index < 2^31 bases)
    starts32 = entry_starts.astype(jnp.int32)
    ent_a = jnp.searchsorted(starts32, loci, side="right") - 1
    last = loci + (lengths[:, None] - 1)
    ent_b = jnp.searchsorted(starts32, last, side="right") - 1
    in_bounds = (loci >= 0) & (last < n) & (ent_a == ent_b)
    valid = valid & in_bounds

    # gather genome windows: (B, C, L)
    win_idx = jnp.clip(loci[..., None] + jnp.arange(L, dtype=jnp.int32), 0, n - 1)
    win = genome[win_idx]

    r = reads[:, None, :]
    pos_in_read = jnp.arange(L, dtype=jnp.int32)
    live = pos_in_read[None, None, :] < lengths[:, None, None]
    mism = ((win != r) | (win >= 4) | (r >= 4)) & live
    mm = jnp.sum(mism, axis=2, dtype=jnp.int32)
    return jnp.where(valid, jnp.minimum(mm, MM_INVALID - 1), MM_INVALID).astype(
        jnp.uint8
    )


def best_hit_reduce(mm: jax.Array, max_tot_mm: jax.Array, mm_delta: jax.Array):
    """Order-independent reformulation of the reference's accumulator trio
    (LowMMCnt / NxtLowMMCnt / LowHitInstances, SfxArrayV2.cpp:5693+ and the
    eHRhits/eHRMMDelta/eHRHitInsts acceptance enum, SfxArrayV2.h:70-77).

    mm: (B, C) uint8 mismatch counts (MM_INVALID = masked).
    Returns dict with per-read:
      best      (B,) uint8 lowest mismatch count
      best_idx  (B,) int32 argmin candidate index
      inst      (B,) int32 number of candidates at `best`
      next_mm   (B,) uint8 second-lowest mismatch VALUE (MM_INVALID if none)
      unique    (B,) bool accepted as uniquely aligned
    Acceptance: best <= MaxTotMM  AND  inst == 1  AND next - best >= MMDelta,
    exactly the reference's Hamming-margin rule.
    """
    mm_i = mm.astype(jnp.int32)
    best = jnp.min(mm_i, axis=1)
    best_idx = jnp.argmin(mm_i, axis=1).astype(jnp.int32)
    is_best = mm_i == best[:, None]
    inst = jnp.sum(is_best, axis=1, dtype=jnp.int32)
    next_mm = jnp.min(jnp.where(is_best, MM_INVALID, mm_i), axis=1)
    unique = (
        (best <= max_tot_mm)
        & (inst == 1)
        & ((next_mm - best) >= mm_delta)
    )
    any_hit = best <= max_tot_mm
    return {
        "best": best.astype(jnp.uint8),
        "best_idx": best_idx,
        "inst": inst,
        # canonical next_mm: saturated at best + MMDelta (see
        # align/pipeline.py accept stage for the rationale)
        "next_mm": jnp.minimum(
            jnp.minimum(next_mm, best + mm_delta), MM_INVALID
        ).astype(jnp.uint8),
        "unique": unique,
        "any_hit": any_hit,
    }
