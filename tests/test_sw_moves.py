"""Packed-moves banded SW (ops/sw_moves.py): the plain-JAX engine against
the lax.scan kernel and the numpy full-matrix oracle, the wrapper's band
windows and padding, the engine choice by platform, and — on a GPU only —
the CUDA kernel against the plain engine."""
import jax.numpy as jnp
import numpy as np
import pytest

from biokanga.ops.sw import (
    banded_sw_batch,
    sw_score_numpy,
    traceback_align_batch,
)
from biokanga.ops.sw_moves import (
    MAX_W,
    band_cells,
    banded_sw_moves,
    normalize_band,
    round_rows,
    sw_moves_cuda,
    sw_moves_impl,
    sw_moves_ref,
)
from biokanga.ops.sw_trace import traceback_cols_packed


def _noisy_pair(rng, L, err):
    a = rng.integers(0, 4, L, np.int8)
    out = []
    for c in a:
        r = rng.random()
        if r < err * 0.3:
            continue
        if r < err * 0.6:
            out.append(rng.integers(0, 4))
        if rng.random() < err * 0.4:
            out.append((c + 1 + rng.integers(0, 3)) % 4)
        else:
            out.append(c)
    return a, np.array(out, np.int8)


def _pair_batch(seed, B, La, Lb, err, max_diag):
    rng = np.random.default_rng(seed)
    a = np.full((B, La), 4, np.int8)
    alen = np.zeros(B, np.int32)
    b = np.full((B, Lb), 4, np.int8)
    blen = np.zeros(B, np.int32)
    diag = np.zeros(B, np.int32)
    for p in range(B):
        q, nb = _noisy_pair(rng, La - rng.integers(0, 32), err)
        nb = nb[:Lb]
        a[p, : len(q)] = q
        alen[p] = len(q)
        b[p, : len(nb)] = nb
        blen[p] = len(nb)
        diag[p] = rng.integers(-max_diag, max_diag)
    return a, b, alen, blen, diag


def test_matches_scan_kernel_banded():
    """best, best_i and best_k all equal the scan kernel's (same tie
    rule: earliest row, then lowest band cell)."""
    rng = np.random.default_rng(3)
    B, La, Lb, W = 4, 192, 224, 24
    a = rng.integers(0, 4, (B, La), np.int8)
    b = np.full((B, Lb), 4, np.int8)
    blen = np.zeros(B, np.int32)
    diag = np.zeros(B, np.int32)
    for p in range(B):
        _, nb = _noisy_pair(rng, La, 0.08)
        nb = nb[:Lb]
        b[p, : len(nb)] = rng.integers(0, 4, len(nb), np.int8) \
            if p == 3 else nb
        blen[p] = len(nb)
        diag[p] = rng.integers(-8, 8)
    a[1] = b[1, :La]              # perfect diagonal pair
    alen = np.full(B, La, np.int32)
    want = banded_sw_batch(a, b, alen, blen, diag, W, La, Lb)[:3]
    got = banded_sw_moves(a, b, alen, blen, diag, W, platform="cpu")[:3]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(g))


def test_matches_numpy_oracle_wide_band():
    rng = np.random.default_rng(9)
    La = 96
    a, nb = _noisy_pair(rng, La, 0.1)
    Lb = len(nb)
    W = max(La, Lb)  # band covers the full matrix -> equals full SW
    got = banded_sw_moves(
        a[None, :], nb[None, :], np.array([La], np.int32),
        np.array([Lb], np.int32), np.array([0], np.int32), W,
        platform="cpu")[0]
    assert int(got[0]) == sw_score_numpy(a, nb)


def test_respects_blen_and_alen():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, (1, 64), np.int8)
    b = np.concatenate([a[0][:48], rng.integers(0, 4, 16, np.int8)])
    got_full = banded_sw_moves(
        a, b[None, :], np.array([64], np.int32), np.array([64], np.int32),
        np.array([0], np.int32), 8, platform="cpu")[0]
    got_cut = banded_sw_moves(
        a, b[None, :], np.array([32], np.int32), np.array([64], np.int32),
        np.array([0], np.int32), 8, platform="cpu")[0]
    assert int(got_cut[0]) == 32  # truncated query caps the chain
    assert int(got_full[0]) >= 48


def test_moves_kernel_and_packed_traceback_match_scan_path():
    """banded_sw_moves + traceback_cols_packed reproduce the scan path
    (banded_sw_batch + traceback_align_batch) bit-for-bit: same best
    cells AND same per-column decode outputs, with interior Ns and a
    query length that is not a multiple of 16."""
    B, La, Lb, W = 6, 250, 288, 24
    a, b, alen, blen, diag = _pair_batch(11, B, La, Lb, 0.12, 10)
    a[3, 40:44] = 4
    want_best, want_i, want_k, moves = banded_sw_batch(
        a, b, alen, blen, diag, W, La, Lb)
    w_out, w_insc, w_insb = traceback_align_batch(
        moves, want_i, want_k, jnp.asarray(diag), jnp.asarray(b),
        jnp.asarray(blen), W, La)
    best, bi, bk, mv, bwin = banded_sw_moves(a, b, alen, blen, diag, W,
                                             platform="cpu")
    assert mv.shape == (B, round_rows(La) // 16, band_cells(W))
    for w, g in ((want_best, best), (want_i, bi), (want_k, bk)):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(g))
    g_out, g_insc, g_insb = traceback_cols_packed(
        mv, bi, bk, jnp.asarray(bwin, jnp.int32), W, La)
    np.testing.assert_array_equal(np.asarray(g_out), np.asarray(w_out))
    np.testing.assert_array_equal(np.asarray(g_insc), np.asarray(w_insc))
    np.testing.assert_array_equal(np.asarray(g_insb), np.asarray(w_insb))


@pytest.mark.parametrize("W,cells", [(1, 32), (15, 32), (16, 64),
                                     (24, 64), (96, 224), (127, 256)])
def test_band_cells_whole_warps(W, cells):
    assert band_cells(W) == cells
    assert band_cells(W) >= 2 * W + 1


@pytest.mark.parametrize("La,rows", [(1, 16), (16, 16), (250, 256),
                                     (10_000, 10_000)])
def test_round_rows(La, rows):
    assert round_rows(La) == rows


@pytest.mark.parametrize("W,max_diag", [(8, 4), (24, 40), (96, 200)])
def test_normalize_band_windows(W, max_diag):
    """bwin[p, t] = b[p, t - W + diag[p]] inside [0, blen), 4 outside;
    width La + KP; bounds jlo = -diag, jhi = blen - diag."""
    rng = np.random.default_rng(W)
    B, La, Lb = 5, 64, 80
    b = rng.integers(0, 4, (B, Lb)).astype(np.int8)
    blen = rng.integers(1, Lb + 1, B).astype(np.int32)
    diag = rng.integers(-max_diag, max_diag, B).astype(np.int32)
    bwin, jlo, jhi = normalize_band(b, blen, diag, La, W)
    assert bwin.shape == (B, La + band_cells(W)) and bwin.dtype == np.int8
    for p in range(B):
        for t in range(bwin.shape[1]):
            s = t - W + diag[p]
            want = b[p, s] if 0 <= s < blen[p] else 4
            assert bwin[p, t] == want
    np.testing.assert_array_equal(jlo, -diag)
    np.testing.assert_array_equal(jhi, blen - diag)


@pytest.mark.parametrize("platform,want", [("gpu", sw_moves_cuda),
                                           ("cpu", sw_moves_ref)])
def test_engine_by_platform(platform, want):
    assert sw_moves_impl(platform) is want


@pytest.mark.parametrize("platform", ["rocm", "neuron", "METAL", ""])
def test_engine_other_platforms_raise(platform):
    with pytest.raises(ValueError, match="no banded SW engine"):
        sw_moves_impl(platform)


def test_cuda_engine_rejects_wide_band():
    """The kernel keeps at most 256 band cells per pair; wider bands
    are refused before anything is built or launched."""
    a = jnp.zeros((1, 16), jnp.int8)
    bw = jnp.zeros((1, 16 + band_cells(MAX_W + 1)), jnp.int8)
    z = jnp.zeros((1,), jnp.int32)
    with pytest.raises(ValueError, match="W <="):
        sw_moves_cuda(a, bw, z, z, z, MAX_W + 1)


@pytest.mark.gpu
def test_cuda_kernel_matches_ref(gpu_device):
    from biokanga.sim.clr import clr_pairs

    W, La = 96, 2048
    a, b, alen, blen, diag = clr_pairs(64, La, W, seed=4)
    bwin, jlo, jhi = normalize_band(b, blen, diag, La, W)
    args = tuple(map(jnp.asarray, (a, bwin, alen, jlo, jhi)))
    for g, w in zip(sw_moves_cuda(*args, W), sw_moves_ref(*args, W)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
