"""All-loci short approximate matching via one-hot convolution.

Parity role: FindShortApproxMatches/ (1,614 LoC standalone tool): locate
EVERY genome locus where a short query matches within a mismatch budget.

Design: instead of the reference's per-locus scalar scan, the
match count at every offset is a correlation between the one-hot genome
and one-hot queries — a single `lax.conv_general_dilated` whose
contraction (4 channels x query width) is a matrix product.  mismatches(o) =
W - sum_j onehot_g[o+j] . onehot_q[j].  The genome is scanned in
overlapping chunks so arbitrary genome sizes stream through a fixed
compiled shape.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..seq.encode import revcomp


@functools.partial(jax.jit, static_argnames=("W",))
def _conv_mm_chunk(gchunk: jax.Array, q1hot: jax.Array, W: int) -> jax.Array:
    """gchunk (L,) int8; q1hot (B, 4, W) f32 -> (B, L-W+1) mismatch counts."""
    g1hot = (gchunk[None, :] == jnp.arange(4, dtype=gchunk.dtype)[:, None])
    g1hot = g1hot.astype(jnp.bfloat16)[None]          # (1, 4, L)
    out = jax.lax.conv_general_dilated(
        g1hot, q1hot.astype(jnp.bfloat16),
        window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
    )                                                  # (1, B, L-W+1)
    return (W - out[0]).astype(jnp.int32)


def find_short_matches(
    genome: np.ndarray,
    queries: list[np.ndarray],
    max_mm: int = 2,
    both_strands: bool = True,
    chunk: int = 1 << 20,
) -> list[tuple[int, int, str, int]]:
    """Return (query_idx, locus, strand, mismatches) for every hit.

    All queries must share one width W (pad the caller's set per width
    group); N bases (code 4) in genome or query never match any channel,
    so they count as mismatches — matching the reference's eBaseN
    handling.
    """
    W = len(queries[0])
    if any(len(q) != W for q in queries):
        raise ValueError("all queries must share one width")
    qs = [np.asarray(q, np.int8) for q in queries]
    strands = [(q, "+") for q in qs]
    if both_strands:
        strands += [(revcomp(q), "-") for q in qs]
    B = len(strands)
    q1hot = np.zeros((B, 4, W), np.float32)
    for b, (q, _) in enumerate(strands):
        for c in range(4):
            q1hot[b, c] = q == c
    q1hot_d = jnp.asarray(q1hot)

    L = len(genome)
    hits: list[tuple[int, int, str, int]] = []
    step = max(chunk - W + 1, 1)
    width = min(chunk, L)  # one compiled shape for all chunks (tail padded)
    for s in range(0, max(L - W + 1, 1), step):
        seg = np.asarray(genome[s: s + width], np.int8)
        valid = len(seg) - W + 1
        if valid <= 0:
            break
        if len(seg) < width:
            seg = np.concatenate(
                [seg, np.full(width - len(seg), 4, np.int8)])
        mm = np.asarray(_conv_mm_chunk(jnp.asarray(seg), q1hot_d, W))
        bidx, oidx = np.nonzero(mm[:, :valid] <= max_mm)
        for b, o in zip(bidx, oidx):
            _, strand = strands[b]
            hits.append((b % len(qs), s + int(o), strand, int(mm[b, o])))
    hits.sort(key=lambda h: (h[0], h[1], h[2]))
    return hits
