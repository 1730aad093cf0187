"""Genome-wide minimum Hamming distance sweep.

Capability match for the `uhamming` tool (uhamming/uhamming.cpp): for
every genome locus, the minimum Hamming distance between the K-length
window at that locus and every other K-length window in the genome
(optionally including reverse-complement windows).  The reference
distributes the O(N^2) sweep across up to 10,000 nodes by static shift
ranges (-n/-N, uhamming.cpp:222-238) and merges partial .hmg files
(mode 3).

Design: the sweep is organised by DIAGONAL SHIFT d — for each
d, mismatch indicators m[i] = (g[i] != g[i+d]) and K-windowed sums are
pure O(N) vector ops (no gathers), and Ham(i, i+d) updates both loci at
once (symmetry).  Shift ranges partition across chips exactly like the
reference's node partitioning; partial minima merge with elementwise min
(the reference's file-merge mode becomes a jnp.minimum / psum-style
reduction).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

H_INVALID = 255  # loci whose window leaves the entry


@partial(jax.jit, static_argnames=("K", "block"))
def _sweep_block(g, valid, hmin, d0, K: int, block: int):
    """Process shifts [d0, d0+block). g: (n,) int8; valid: (n,) bool
    (window fully inside one entry); hmin: (n,) uint8."""
    n = g.shape[0]

    def body(t, hmin):
        d = d0 + t
        gs = jnp.roll(g, -d)
        m = (g != gs) | (g >= 4) | (gs >= 4)
        # windowed sum of K consecutive indicators
        c = jnp.cumsum(m.astype(jnp.int32))
        w = c - jnp.concatenate([jnp.zeros(K, jnp.int32), c[:-K]])
        # w[i+K-1] = mismatches of windows (i, i+d); align to window start
        w = jnp.roll(w, -(K - 1))
        # pair validity: both windows in range and valid
        i_ok = valid & jnp.roll(valid, -d) & (
            jnp.arange(n, dtype=jnp.int32) + d + K <= n
        )
        w8 = jnp.where(i_ok, jnp.minimum(w, H_INVALID), H_INVALID).astype(
            jnp.uint8
        )
        hmin = jnp.minimum(hmin, w8)
        # symmetric update at i+d: value w[i] applies to locus i+d
        wd = jnp.where(
            jnp.roll(i_ok, d), jnp.roll(w8, d), jnp.uint8(H_INVALID)
        )
        hmin = jnp.minimum(hmin, wd)
        return hmin

    return jax.lax.fori_loop(0, block, body, hmin)


def window_validity(entry_starts: np.ndarray, n: int, K: int) -> np.ndarray:
    """valid[i] == window [i, i+K) fully inside one entry."""
    valid = np.zeros(n, dtype=bool)
    for e in range(len(entry_starts) - 1):
        a, b = int(entry_starts[e]), int(entry_starts[e + 1])
        if b - a >= K:
            valid[a : b - K + 1] = True
    return valid


def hamming_sweep(
    codes: np.ndarray,
    entry_starts: np.ndarray,
    K: int = 100,
    shift_lo: int = 1,
    shift_hi: int | None = None,
    block: int = 256,
    include_rc: bool = True,
) -> np.ndarray:
    """Min-Hamming per locus over shifts [shift_lo, shift_hi).

    shift_lo/shift_hi partition the sweep for multi-node operation
    (reference -n numnodes -N node static ranges).  include_rc also
    compares each window against reverse-complement windows (crick).
    """
    n = len(codes)
    if shift_hi is None:
        shift_hi = n - K + 1
    shift_hi = min(shift_hi, n - K + 1)
    g = jnp.asarray(codes)
    valid = jnp.asarray(window_validity(entry_starts, n, K))
    hmin = jnp.full(n, H_INVALID, dtype=jnp.uint8)

    d = shift_lo
    while d < shift_hi:
        blk = min(block, shift_hi - d)
        hmin = _sweep_block(g, valid, hmin, jnp.int32(d), K, int(blk))
        d += blk

    if include_rc:
        # watson windows vs crick windows == compare g against revcomp(g):
        # window at i on watson vs rc-window starting at j in rc coords.
        rc = jnp.where(g[::-1] >= 4, g[::-1], 3 - g[::-1]).astype(g.dtype)
        # rc-window [j, j+K) maps to genome window [n-j-K, n-j):
        # valid_rc[j] = valid[n-j-K]
        valid_rc = jnp.roll(valid[::-1], -(K - 1))
        # all relative shifts between the two sequences, O(N) each
        hmin = _cross_sweep(g, rc, valid, valid_rc, hmin, K, block)
    return np.asarray(hmin)


def _cross_sweep(g, h, vg, vh, hmin, K, block):
    """Min-Hamming of g-windows vs ALL h-windows (h = revcomp genome).
    Alignment shift d in [-(n-K), n-K]: g[i] vs h[i+d]."""
    n = g.shape[0]

    @partial(jax.jit, static_argnames=("K", "blk"))
    def run(g, h, vg, vh, hmin, d0, K: int, blk: int):
        def body(t, hmin):
            d = d0 + t  # h index offset; compare g[i] with h[i+d]
            hs = jnp.roll(h, -d)
            vs = jnp.roll(vh, -d)
            m = (g != hs) | (g >= 4) | (hs >= 4)
            c = jnp.cumsum(m.astype(jnp.int32))
            w = c - jnp.concatenate([jnp.zeros(K, jnp.int32), c[:-K]])
            w = jnp.roll(w, -(K - 1))
            idx = jnp.arange(n, dtype=jnp.int32)
            ok = vg & vs & (idx + d >= 0) & (idx + d + K <= n)
            w8 = jnp.where(ok, jnp.minimum(w, H_INVALID), H_INVALID).astype(
                jnp.uint8
            )
            return jnp.minimum(hmin, w8)

        return jax.lax.fori_loop(0, blk, body, hmin)

    d = -(n - K)
    top = n - K + 1
    while d < top:
        blk = min(block, top - d)
        hmin = run(g, h, vg, vh, hmin, jnp.int32(d), K, int(blk))
        d += blk
    return hmin


def merge_partials(partials: list[np.ndarray]) -> np.ndarray:
    """Mode-3 merge of per-node partial minima (uhamming.cpp:222)."""
    out = partials[0].copy()
    for p in partials[1:]:
        np.minimum(out, p, out=out)
    return out


def save_hmg(path: str, hmin: np.ndarray, entry_names, entry_starts, K: int):
    meta = {"K": K, "entry_names": list(entry_names)}
    np.savez(path, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             hmin=hmin, entry_starts=np.asarray(entry_starts))


def load_hmg(path: str):
    with np.load(path) as z:
        meta = json.loads(z["meta"].tobytes().decode())
        return z["hmin"], meta["entry_names"], z["entry_starts"], meta["K"]


def write_hamming_csv(path: str, hmin, entry_names, entry_starts):
    """CSV transform (role of the HammingDist tool, HammingDist/)."""
    starts = np.asarray(entry_starts)
    with open(path, "w") as f:
        f.write('"Chrom","Loci","Hamming"\n')
        for e, name in enumerate(entry_names):
            a, b = int(starts[e]), int(starts[e + 1])
            for i in range(a, b):
                if hmin[i] != H_INVALID:
                    f.write(f'"{name}",{i - a},{int(hmin[i])}\n')
