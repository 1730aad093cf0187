"""Banded Smith-Waterman with packed 2-bit move planes — the EC SW engine.

One contract, two implementations:

  sw_moves_ref   plain JAX: lax.scan over 16-row move words, the band as
                 a (B, KP) vector per row.  Runs on the CPU, and is the
                 reference the kernel is checked against.
  sw_moves_cuda  CUDA kernel (native/sw_moves.cu) called through jax.ffi:
                 one warp per pair, the band in registers, the lazy-F
                 prefix max as a warp scan.  Runs on the GPU.

sw_moves_impl(platform) picks one by platform: "gpu" -> kernel, "cpu" ->
plain JAX, anything else raises.  Nothing falls back from one to the
other.

Both take the pair batch in normalised band coordinates (normalize_band):
row i of pair p reads the target window bwin[p, i : i + KP], so band
cell k of row i is target position j = i + k - W relative to the band
centre, and [jlo, jhi) bounds the true target.  Scores, best cell and
move codes follow ops/sw.banded_sw_batch (same lazy-F row recurrence, N
handling and local floor); the move code of cell (i, k) is packed 16 rows
per int32, mv[p, i // 16, k] bit 2 * (i % 16), and decodes with
ops/sw_trace.traceback_cols_packed.

Build the CUDA library ahead of time with `python -m biokanga.ops.sw_moves`
(otherwise it is built at first use); it lands in <repo>/build/.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .sw import (
    DEFAULT_GAP_EXT,
    DEFAULT_GAP_OPEN,
    DEFAULT_MATCH,
    DEFAULT_MISMATCH,
    NEG,
    TB_DIAG,
    TB_LEFT,
    TB_STOP,
    TB_UP,
)

ROWS_PER_WORD = 16
MAX_W = 127  # the kernel keeps at most 8 band cells per lane (256 cells)

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_CU_SRC = os.path.join(_REPO, "native", "sw_moves.cu")
_BUILD_DIR = os.path.join(_REPO, "build")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_TARGET = "biokanga_sw_moves"
_registered = False


def band_cells(W: int) -> int:
    """Band width KP: the 2W+1 cells rounded up to whole warps (32)."""
    return -(-(2 * W + 1) // 32) * 32


def round_rows(La: int) -> int:
    """Query rows padded to whole move words."""
    return -(-La // ROWS_PER_WORD) * ROWS_PER_WORD


def normalize_band(b: np.ndarray, blen, diag, La: int, W: int):
    """Per-pair target band windows for La (a multiple of 16) query rows.

    Returns (bwin (B, La + KP) int8 with bwin[p, t] = b[p, t - W +
    diag[p]] and 4 outside [0, blen), jlo, jhi int32): the window every
    row of the SW step and of traceback_cols_packed reads."""
    b = np.asarray(b)
    blen = np.asarray(blen, np.int64)
    B, Lb = b.shape
    T = La + band_cells(W)
    off = np.asarray(diag, np.int64) - W          # source of column 0
    lpad = int(max(0, -off.min(initial=0)))
    rpad = int(max(0, off.max(initial=0) + T - Lb))
    bp = np.full((B, lpad + Lb + rpad), 4, np.int8)
    live = np.arange(Lb)[None, :] < blen[:, None]
    bp[:, lpad: lpad + Lb] = np.where(live, b, 4)
    win = np.lib.stride_tricks.sliding_window_view(bp, T, axis=1)
    bwin = np.ascontiguousarray(win[np.arange(B), off + lpad])
    jlo = (-np.asarray(diag)).astype(np.int32)
    jhi = (blen - np.asarray(diag)).astype(np.int32)
    return bwin, jlo, jhi


@partial(jax.jit, static_argnames=("W", "match", "mismatch", "gap_open",
                                   "gap_ext"))
def sw_moves_ref(a, bwin, alen, jlo, jhi, W: int,
                 match: int = DEFAULT_MATCH, mismatch: int = DEFAULT_MISMATCH,
                 gap_open: int = DEFAULT_GAP_OPEN,
                 gap_ext: int = DEFAULT_GAP_EXT):
    """Plain-JAX packed-moves SW over normalised band windows.

    a: (B, La) query codes, La % 16 == 0; bwin: (B, La + KP) from
    normalize_band.  Returns (best, best_i, best_k (B,) int32, mv
    (B, La // 16, KP) int32)."""
    B, La = a.shape
    KP = band_cells(W)
    K = 2 * W + 1
    ks = jnp.arange(KP, dtype=jnp.int32)[None, :]
    a = a.astype(jnp.int32)
    bw = bwin.astype(jnp.int32)
    alen = alen.astype(jnp.int32)[:, None]
    jlo = jlo.astype(jnp.int32)[:, None]
    jhi = jhi.astype(jnp.int32)[:, None]
    neg_col = jnp.full((B, 1), NEG, jnp.int32)

    def up(x):  # cell k reads k + 1 of the previous row
        return jnp.concatenate([x[:, 1:], neg_col], axis=1)

    def word_step(carry, w):
        H, E, best, bi, bk = carry
        a16 = jax.lax.dynamic_slice_in_dim(a, w * 16, 16, axis=1)
        bw16 = jax.lax.dynamic_slice_in_dim(bw, w * 16, KP + 16, axis=1)
        word = jnp.zeros((B, KP), jnp.int32)
        for r in range(16):
            i = w * 16 + r
            ai = a16[:, r: r + 1]
            bj = bw16[:, r: r + KP]
            E = jnp.maximum(up(H) + gap_open, up(E) + gap_ext)
            sub = jnp.where((ai == bj) & (ai < 4) & (bj < 4), match,
                            mismatch)
            Hd = H + sub
            H0 = jnp.maximum(jnp.maximum(Hd, E), 0)
            H0 = jnp.maximum(H0, jnp.where(sub > 0, sub, 0))
            run = jax.lax.cummax(H0 - gap_ext * ks, axis=1)
            run_prev = jnp.concatenate([neg_col, run[:, :-1]], axis=1)
            F = run_prev + gap_ext * ks + gap_open - gap_ext
            Hn = jnp.maximum(jnp.maximum(H0, F), 0)
            j = i + ks - W
            inb = (j >= jlo) & (j < jhi) & (ks < K) & (i < alen)
            Hn = jnp.where(inb, Hn, NEG)
            E = jnp.where(inb, E, NEG)
            pos = Hn > 0
            code = jnp.where(
                pos & (Hn == Hd), TB_DIAG,
                jnp.where(pos & (Hn == E), TB_UP,
                          jnp.where(pos & (Hn == F), TB_LEFT, TB_STOP)))
            word = word | (code << (2 * r))
            rb = jnp.max(Hn, axis=1)
            rk = jnp.argmax(Hn, axis=1).astype(jnp.int32)
            better = rb > best
            best = jnp.where(better, rb, best)
            bi = jnp.where(better, i, bi)
            bk = jnp.where(better, rk, bk)
            H = Hn
        return (H, E, best, bi, bk), word

    z = jnp.zeros((B,), jnp.int32)
    init = (jnp.zeros((B, KP), jnp.int32), jnp.full((B, KP), NEG, jnp.int32),
            z, z, z)
    (_, _, best, bi, bk), words = jax.lax.scan(
        word_step, init, jnp.arange(La // 16, dtype=jnp.int32))
    return best, bi, bk, jnp.moveaxis(words, 0, 1)


def build_cuda_library() -> str:
    """Compile native/sw_moves.cu for sm_90a into build/ (once per source
    version; the file name carries a hash of the source and flags)."""
    with open(_CU_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(_BUILD_DIR, f"libsw_moves-{tag[:12]}.so")
    if os.path.exists(out):
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    r = subprocess.run(
        [nvcc, *_NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp,
         _CU_SRC],
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        os.remove(tmp)
        raise RuntimeError(f"nvcc failed on {_CU_SRC}:\n{r.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _register_cuda_target() -> None:
    global _registered
    if _registered:
        return
    lib = ctypes.cdll.LoadLibrary(build_cuda_library())
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.BiokangaSwMoves), platform="CUDA")
    _registered = True


def sw_moves_cuda(a, bwin, alen, jlo, jhi, W: int,
                  match: int = DEFAULT_MATCH,
                  mismatch: int = DEFAULT_MISMATCH,
                  gap_open: int = DEFAULT_GAP_OPEN,
                  gap_ext: int = DEFAULT_GAP_EXT):
    """The sw_moves_ref contract on the GPU (native/sw_moves.cu)."""
    if W > MAX_W:
        raise ValueError(f"sw_moves kernel supports W <= {MAX_W}, got {W}")
    _register_cuda_target()
    B, La = a.shape
    i32 = jnp.int32
    out = jax.ffi.ffi_call(_TARGET, (
        jax.ShapeDtypeStruct((B,), i32),
        jax.ShapeDtypeStruct((B,), i32),
        jax.ShapeDtypeStruct((B,), i32),
        jax.ShapeDtypeStruct((B, La // 16, band_cells(W)), i32),
    ))(a.astype(jnp.int8), bwin.astype(jnp.int8), alen.astype(i32),
       jlo.astype(i32), jhi.astype(i32), W=np.int64(W),
       match=np.int64(match), mismatch=np.int64(mismatch),
       gap_open=np.int64(gap_open), gap_ext=np.int64(gap_ext))
    return tuple(out)


def sw_moves_impl(platform: str):
    """The SW engine for a JAX platform name: "gpu" runs the CUDA kernel,
    "cpu" the plain-JAX path; other platforms have none."""
    if platform == "gpu":
        return sw_moves_cuda
    if platform == "cpu":
        return sw_moves_ref
    raise ValueError(f"no banded SW engine for platform {platform!r}")


def banded_sw_moves(a, b, alen, blen, diag, W,
                    match=DEFAULT_MATCH, mismatch=DEFAULT_MISMATCH,
                    gap_open=DEFAULT_GAP_OPEN, gap_ext=DEFAULT_GAP_EXT,
                    platform: str | None = None):
    """Host wrapper: batched banded SW with packed move planes.

    a: (B, La) query codes; b: (B, Lb) targets; diag: per-pair band
    centre (expected j - i).  Returns (best, best_i, best_k, mv, bwin) —
    scores bit-equal to ops/sw.banded_sw_batch; decode the columns with
    ops/sw_trace.traceback_cols_packed(mv, best_i, best_k, bwin, W, La).
    """
    assert match + gap_open < 0, (
        "custom scoring with match + gap_open >= 0 breaks the lazy-F "
        "out-of-band invariant; use ops/sw.banded_sw_batch"
    )
    a = np.asarray(a)
    B, La = a.shape
    lap = round_rows(La)
    if lap != La:
        a = np.pad(a, ((0, 0), (0, lap - La)), constant_values=4)
    bwin, jlo, jhi = normalize_band(b, blen, diag, lap, W)
    fn = sw_moves_impl(platform or jax.default_backend())
    best, bi, bk, mv = fn(
        jnp.asarray(a.astype(np.int8)), jnp.asarray(bwin),
        jnp.asarray(np.asarray(alen, np.int32)), jnp.asarray(jlo),
        jnp.asarray(jhi), W, match, mismatch, gap_open, gap_ext,
    )
    return best, bi, bk, mv, bwin


if __name__ == "__main__":
    print(build_cuda_library())
