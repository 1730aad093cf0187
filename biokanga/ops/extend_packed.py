"""Packed Hamming extension: 2-bit genome rows + XOR/popcount.

Performance reformulation of ops/extend.hamming_extend (same contract):
the genome is pre-packed 2 bits/base into OVERLAPPING rows of 16 uint32
words (256 bases per row, stride 128 bases), so a candidate window of up
to 128 bases is covered by exactly ONE 64-byte row gather, so a
candidate costs one row fetch however its window falls; all
subsequent word extraction is static selects (no per-element gathers),
and mismatch counting is XOR + OR + population_count.

This implements the SURVEY §7.3 kernel plan ("gather genome windows and
popcount-XOR 2-bit-packed lanes") and reproduces the reference's
extension semantics (byte-wise mismatch count in LocateCoreMultiples,
libbiokanga/SfxArrayV2.cpp:5693+) with the N rule: any position where
either side is N counts as a mismatch (genome N lanes are carried in a
separate 2-bit "N plane", only materialised when the genome contains Ns).

Reads longer than 128 bases use the strided multi-row gather
(gather_window_words): rows overlap with stride 2 in row index =
256 bases, so K = ceil((W+8)/16) row gathers cover any window of W
packed words contiguously — the per-candidate HBM traffic stays one
64-byte aligned row per 256 window bases, matching the reference's
150 bp-PE envelope (biokanga/Aligner.h:16) up to MAX_PACKED_READ_LEN.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

MM_INVALID = 255

BASES_PER_WORD = 16
ROW_STRIDE_BASES = 128          # row i starts at base 128*i
ROW_WORDS = 16                  # 256 bases per (overlapping) row
MAX_PACKED_READ_LEN = 4096      # multi-row gather cap (see PAD_ROWS)
# genome rows padded past the end so r0 + 2*(K-1) stays in-bounds for the
# largest multi-row window: W = 4096/16 = 256 words -> K = 17 -> 32 rows
PAD_ROWS = 40


@dataclass
class PackedGenome:
    rows: jax.Array           # (R, 16) uint32 overlapping rows, N packed as 0
    n_rows: jax.Array | None  # (R, 16) uint32 — 0b11 lanes at N positions
    length: int               # genome length in bases

    @property
    def has_n(self) -> bool:
        return self.n_rows is not None


def _pack_words(v: np.ndarray) -> np.ndarray:
    """(16k,) uint32 base codes -> (k,) uint32 packed words, MSB-first."""
    v = v.reshape(-1, BASES_PER_WORD)
    words = np.zeros(v.shape[0], dtype=np.uint32)
    for j in range(BASES_PER_WORD):
        words |= v[:, j] << np.uint32(2 * (15 - j))
    return words


def _overlap_rows(words: np.ndarray) -> np.ndarray:
    """(W,) words -> (W//8, 16) overlapping rows: row i = words[8i : 8i+16]."""
    W = len(words)
    R = W // 8
    out = np.zeros((R, ROW_WORDS), dtype=np.uint32)
    for j in range(ROW_WORDS):
        src = words[j : j + 8 * R : 8]
        out[: len(src), j] = src
    return out


def pack_genome(codes: np.ndarray) -> PackedGenome:
    """Host-side packing of int8 codes into PackedGenome (numpy)."""
    n = len(codes)
    # enough full rows that row (n >> 7) + the widest multi-row window exist
    n_words = 8 * ((n // ROW_STRIDE_BASES) + PAD_ROWS)
    total = n_words * BASES_PER_WORD
    b = np.zeros(total, dtype=np.uint32)
    b[:n] = codes.astype(np.uint32)
    is_n = b >= 4
    b[is_n] = 0

    rows = _overlap_rows(_pack_words(b))
    if is_n[:n].any():
        n_rows = _overlap_rows(
            _pack_words(np.where(is_n, np.uint32(3), np.uint32(0)))
        )
    else:
        n_rows = None
    return PackedGenome(
        rows=jnp.asarray(rows),
        n_rows=None if n_rows is None else jnp.asarray(n_rows),
        length=n,
    )


def pack_reads(reads: jax.Array, lengths: jax.Array):
    """Pack (B, L) int8 reads (N=4, padded) into (B, W) uint32 code words and
    (B, W) uint32 N-plane words, W = ceil(L/16)."""
    B, L = reads.shape
    W = -(-L // BASES_PER_WORD)
    pad = W * BASES_PER_WORD - L
    r = reads.astype(jnp.uint32)
    if pad:
        r = jnp.pad(r, ((0, 0), (0, pad)), constant_values=4)
    is_n = r >= 4
    codes = jnp.where(is_n, 0, r).reshape(B, W, BASES_PER_WORD)
    nlane = jnp.where(is_n, jnp.uint32(3), jnp.uint32(0)).reshape(
        B, W, BASES_PER_WORD
    )
    shifts = jnp.uint32(2) * (jnp.uint32(15) - jnp.arange(16, dtype=jnp.uint32))
    pack = lambda v: jnp.sum(v << shifts, axis=2, dtype=jnp.uint32)
    return pack(codes), pack(nlane)


def _extract_aligned_words(row: jax.Array, s: jax.Array, W: int):
    """row: (..., 16) uint32 (one overlapping row); s: (...,) start base
    offset in [0, 128). Returns (..., W) uint32 windows aligned to the base
    boundary.  Word selection uses static selects over the 8 possible word
    offsets — NO per-element gathers.
    """
    s16 = (s >> 4).astype(jnp.int32)           # word offset 0..7
    sh = (jnp.uint32(2) * (s & 15).astype(jnp.uint32))[..., None]  # 0..30
    w = jnp.zeros(row.shape[:-1] + (W + 1,), dtype=jnp.uint32)
    for t in range(8):
        w = jnp.where((s16 == t)[..., None], row[..., t : t + W + 1], w)
    hi = w[..., :W] << sh
    lo = jnp.where(sh > 0, w[..., 1 : W + 1] >> (jnp.uint32(32) - sh), 0)
    return hi | lo


def rows_for_words(W: int) -> int:
    """Number of stride-2 overlapping rows needed to cover a W-word window
    at any in-row offset (word offset 0..7): rows r0, r0+2, ... r0+2(K-1)
    are contiguous words[8*r0 : 8*r0 + 16*K]; need 8 + W <= 16*K."""
    return -(-(W + 8) // 16)


def gather_window_words(rows: jax.Array, loci: jax.Array, W: int):
    """Gather (..., W) uint32 base-aligned window words starting at base
    `loci` from overlapping packed rows.  One 64-byte row gather per 256
    window bases; word/bit alignment is static selects (no per-element
    gathers).  Out-of-range loci read clamped rows — callers mask those
    candidates invalid."""
    R = rows.shape[0]
    r0 = jnp.clip(loci >> 7, 0, R - 1)
    s = (loci & 127).astype(jnp.int32)
    K = rows_for_words(W)
    if K == 1:
        row = rows[r0]
    else:
        row = jnp.concatenate(
            [rows[jnp.clip(r0 + 2 * k, 0, R - 1)] for k in range(K)],
            axis=-1,
        )
    return _extract_aligned_words(row, s, W)


def hamming_extend_packed(
    pg: PackedGenome,
    entry_starts: jax.Array,   # (E+1,) int32
    loci: jax.Array,           # (B, C) int32
    valid: jax.Array,          # (B, C) bool
    rcodes: jax.Array,         # (B, W) uint32 packed read code words
    rnlane: jax.Array,         # (B, W) uint32 packed read N-plane words
    lengths: jax.Array,        # (B,) int32
):
    """(B, C) uint8 mismatch counts; MM_INVALID where masked. Same contract
    as ops/extend.hamming_extend but HBM-gather-optimal."""
    B, C = loci.shape
    W = rcodes.shape[1]
    assert W <= MAX_PACKED_READ_LEN // BASES_PER_WORD, (
        "packed path supports reads <= MAX_PACKED_READ_LEN bases"
    )
    n = pg.length

    # entry containment (identical to the dense path)
    starts32 = entry_starts.astype(jnp.int32)
    ent_a = jnp.searchsorted(starts32, loci, side="right") - 1
    last = loci + (lengths[:, None] - 1)
    ent_b = jnp.searchsorted(starts32, last, side="right") - 1
    valid = valid & (loci >= 0) & (last < n) & (ent_a == ent_b)

    win = gather_window_words(pg.rows, loci, W)  # (B, C, W)

    x = win ^ rcodes[:, None, :]
    x = x | rnlane[:, None, :]
    if pg.n_rows is not None:
        x = x | gather_window_words(pg.n_rows, loci, W)

    lanes = (x | (x >> 1)) & jnp.uint32(0x55555555)

    # mask lanes beyond the read's true length: word j covers bases
    # [16j, 16j+16); keep the first clamp(len-16j, 0, 16) lanes (MSB-first)
    wb = jnp.arange(W, dtype=jnp.int32) * 16     # (W,)
    v = jnp.clip(lengths[:, None] - wb[None, :], 0, 16).astype(jnp.uint32)
    lane_mask = jnp.where(
        v == 0,
        jnp.uint32(0),
        (jnp.uint32(0x55555555) << (jnp.uint32(2) * (jnp.uint32(16) - v)))
        & jnp.uint32(0xFFFFFFFF),
    )  # (B, W)
    lanes = lanes & lane_mask[:, None, :]

    mm = jnp.sum(
        jax.lax.population_count(lanes), axis=-1, dtype=jnp.int32
    )
    return jnp.where(valid, jnp.minimum(mm, MM_INVALID - 1), MM_INVALID).astype(
        jnp.uint8
    )


def hamming_extend_packed_win(
    pg: PackedGenome,
    entry_starts: jax.Array,   # (E+1,) int32
    loci: jax.Array,           # (B, C) int32
    valid: jax.Array,          # (B, C) bool
    rcodes: jax.Array,         # (B, W) uint32 packed read code words
    rnlane: jax.Array,         # (B, W) uint32 packed read N-plane words
    win: jax.Array,            # (B, C) int32 PER-CANDIDATE window length
):
    """hamming_extend_packed with a PER-CANDIDATE compare window: counts
    mismatches over the first win[b, c] bases of read b vs the genome at
    loci[b, c].  Built for suffix-prefix overlap verification (assembly):
    each candidate dovetail has its own overlap length.  Windows are
    additionally bounded by the packed read width; the candidate must lie
    within one entry over its whole window (the concatenated-reads
    "genome" separates reads as entries, so cross-read windows are
    rejected exactly like cross-chromosome alignments).

    Returns (B, C) int32 mismatch counts, MM_WIN_INVALID (2^30) where
    masked — int32 because long-window counts exceed uint8."""
    B, C = loci.shape
    W = rcodes.shape[1]
    n = pg.length

    starts32 = entry_starts.astype(jnp.int32)
    win = jnp.clip(win, 0, W * BASES_PER_WORD)
    last = loci + win - 1
    ent_a = jnp.searchsorted(starts32, loci, side="right") - 1
    ent_b = jnp.searchsorted(starts32, last, side="right") - 1
    valid = valid & (loci >= 0) & (last < n) & (ent_a == ent_b) & (win > 0)

    gwin = gather_window_words(pg.rows, loci, W)  # (B, C, W)
    x = gwin ^ rcodes[:, None, :]
    x = x | rnlane[:, None, :]
    if pg.n_rows is not None:
        x = x | gather_window_words(pg.n_rows, loci, W)
    lanes = (x | (x >> 1)) & jnp.uint32(0x55555555)

    # per-candidate lane mask: word j keeps clamp(win - 16j, 0, 16) lanes
    wb = jnp.arange(W, dtype=jnp.int32) * 16
    v = jnp.clip(win[..., None] - wb[None, None, :], 0, 16).astype(jnp.uint32)
    lane_mask = jnp.where(
        v == 0,
        jnp.uint32(0),
        (jnp.uint32(0x55555555) << (jnp.uint32(2) * (jnp.uint32(16) - v)))
        & jnp.uint32(0xFFFFFFFF),
    )  # (B, C, W)
    lanes = lanes & lane_mask
    mm = jnp.sum(jax.lax.population_count(lanes), axis=-1, dtype=jnp.int32)
    return jnp.where(valid, mm, jnp.int32(1) << 30)
