"""Batched seed-range lookup on the 32-base-bounded suffix array.

Replaces the reference's per-core pointer-chasing binary search
(CSfxArrayV3::LocateFirstExact/LocateLastExact,
libbiokanga/SfxArrayV2.cpp:7765,7914) with a fixed-trip, fully batched
binary search over (hi, lo) uint32 key pairs, seeded by a direct-address
prefix LUT.  Every step is a dense gather over the whole query batch —
the XLA-friendly reformulation of "binary search per seed".
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# 31 halvings always converge for n < 2^31 elements (fallback bound).
_MAX_BSEARCH_STEPS = 31


def _lower_bound(key_hi, key_lo, lo0, hi0, q_hi, q_lo, strict: bool, steps: int):
    """First index i in [lo0, hi0] with key[i] > q (strict) or >= q.

    All args batched; fixed trip count so the loop is XLA-unrollable.
    """

    def body(_, state):
        lo, hi = state
        mid = (lo + hi) >> 1
        kh = key_hi[mid]
        kl = key_lo[mid]
        if strict:
            gt = (kh > q_hi) | ((kh == q_hi) & (kl > q_lo))
        else:
            gt = (kh > q_hi) | ((kh == q_hi) & (kl >= q_lo))
        new_hi = jnp.where(gt, mid, hi)
        new_lo = jnp.where(gt, lo, mid + 1)
        # when lo == hi we are converged; keep stable
        done = lo >= hi
        return jnp.where(done, lo, new_lo), jnp.where(done, hi, new_hi)

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo0, hi0))
    return lo


@partial(jax.jit, static_argnames=("lut_bases", "core_len", "max_steps"))
def seed_range_lookup(
    key_hi: jax.Array,   # (n,) uint32 sorted keys (primary)
    key_lo: jax.Array,   # (n,) uint32 sorted keys (secondary)
    lut: jax.Array,      # (4^P + 1,) int32 bucket starts
    lut_bases: int,
    q_lo_hi: jax.Array,  # query lower bound, hi word  (any batch shape)
    q_lo_lo: jax.Array,  # query lower bound, lo word
    q_hi_hi: jax.Array,  # query upper bound, hi word
    q_hi_lo: jax.Array,  # query upper bound, lo word
    core_len: int = 0,        # static: query prefix length (0 = unknown)
    max_steps: int = _MAX_BSEARCH_STEPS,  # static: log2 bound on LUT bucket
):
    """Return (start, end) index ranges: all i with qlow <= key[i] <= qhigh.

    Fast path: when the query prefix is no longer than the LUT prefix
    (core_len <= lut_bases), the range is EXACTLY a run of LUT buckets —
    two LUT loads, no binary search at all.  Otherwise a fixed-trip
    binary search confined to one bucket; `max_steps` should be
    ceil(log2(max_bucket_size + 1)) + 1, computed host-side at index load.
    """
    P = lut_bases
    shift = jnp.uint32(32 - 2 * P)
    pfx_lo = (q_lo_hi >> shift).astype(jnp.int32)
    pfx_hi = (q_hi_hi >> shift).astype(jnp.int32)
    lo0 = lut[pfx_lo]
    hi0 = lut[pfx_hi + 1]
    if 0 < core_len <= P:
        return lo0, hi0
    steps = min(max_steps, _MAX_BSEARCH_STEPS)
    start = _lower_bound(
        key_hi, key_lo, lo0, hi0, q_lo_hi, q_lo_lo, strict=False, steps=steps
    )
    end = _lower_bound(
        key_hi, key_lo, lo0, hi0, q_hi_hi, q_hi_lo, strict=True, steps=steps
    )
    return start, end


@partial(jax.jit, static_argnames=("k", "stride", "S", "H", "lut_bases",
                                   "max_steps"))
def rolling_seed_lookup(
    key_hi, key_lo, lut, pos_rows, seqs: jax.Array,
    k: int, stride: int, S: int, H: int, lut_bases: int, max_steps: int,
):
    """Batched seed lookup with ROLLING k-mer keys: k shifted adds over
    the whole (B, L) sequence matrix, then a strided slice at the core
    offsets — compile cost O(k), independent of the number of cores, so
    multi-Mbp queries (Blitz, 16 Mbp envelope Blitz.h:59-60) and long-read
    probes trace instantly.  k <= 16 (one key word).

    Returns (pos (B, S, H) int32 candidate positions, valid (B, S, H),
    size (B, S) true range sizes — for over-occurrence suppression)."""
    assert 1 <= k <= 16
    B, L = seqs.shape
    b = jnp.where(seqs >= 4, 0, seqs).astype(jnp.uint32)
    bp = jnp.pad(b, ((0, 0), (0, k)))
    isn = jnp.pad(seqs >= 4, ((0, 0), (0, k)))
    key = jnp.zeros((B, L), jnp.uint32)
    nwin = jnp.zeros((B, L), bool)
    for j in range(k):
        key = key + (bp[:, j : j + L] << jnp.uint32(2 * (15 - j)))
        nwin = nwin | isn[:, j : j + L]
    q_hi = key[:, ::stride][:, :S]
    has_n = nwin[:, ::stride][:, :S]
    pad_hi = jnp.uint32((1 << (2 * (16 - k))) - 1)
    zero = jnp.zeros_like(q_hi)
    ones = jnp.full_like(q_hi, 0xFFFFFFFF)
    start, end = seed_range_lookup(
        key_hi, key_lo, lut, lut_bases, q_hi, zero, q_hi | pad_hi, ones,
        core_len=k, max_steps=max_steps,
    )
    size = jnp.where(has_n, 0, end - start)
    pos_flat = pos_rows.reshape(-1)
    j = jnp.arange(H, dtype=jnp.int32)
    idx = start[..., None] + j
    pos = pos_flat[jnp.clip(idx, 0, pos_flat.shape[0] - 1)]
    valid = j[None, None, :] < jnp.minimum(size, H)[..., None]
    return pos, valid, size


def pack_read_kmers(codes: jax.Array, offsets, k: int):
    """Pack k bases at each static offset of each read into query bounds.

    codes: (B, L) int8 device array; offsets: static tuple of core offsets.
    Returns (q_lo_hi, q_lo_lo, q_hi_hi, q_hi_lo), each (B, S) uint32, plus
    (B, S) bool `has_n` marking cores containing an N (those never match in
    the reference — commdefs.h eBaseN semantics — and are masked out).
    """
    assert 1 <= k <= 32
    B = codes.shape[0]
    S = len(offsets)
    # (B, S, k) base codes via STATIC slices (offsets are compile-time
    # constants) — no per-element gathers
    bases = jnp.stack(
        [codes[:, o : o + k] for o in offsets], axis=1
    ).astype(jnp.int32)
    has_n = jnp.any(bases >= 4, axis=2)
    b2 = jnp.where(bases >= 4, 0, bases).astype(jnp.uint32)

    k_hi = min(k, 16)
    shifts_hi = jnp.uint32(2) * (jnp.uint32(15) - jnp.arange(k_hi, dtype=jnp.uint32))
    hi = jnp.sum(b2[..., :k_hi] << shifts_hi, axis=2, dtype=jnp.uint32)
    if k > 16:
        k_lo = k - 16
        shifts_lo = jnp.uint32(2) * (
            jnp.uint32(15) - jnp.arange(k_lo, dtype=jnp.uint32)
        )
        lo = jnp.sum(b2[..., 16:] << shifts_lo, axis=2, dtype=jnp.uint32)
        pad_lo = jnp.uint32((1 << (2 * (32 - k))) - 1)
        return hi, lo, hi, lo | pad_lo, has_n
    else:
        pad_hi = jnp.uint32((1 << (2 * (16 - k))) - 1)
        zero = jnp.zeros_like(hi)
        ones = jnp.full_like(hi, 0xFFFFFFFF)
        return hi, zero, hi | pad_hi, ones, has_n
