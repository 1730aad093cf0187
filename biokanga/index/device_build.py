"""Device-side index build: keys, suffix sort, LUT and packed rows all on
the device — the SURVEY §7.1 layer-2 "jax.lax.sort build" path.

Why: the reference builds its suffix array with a multithreaded host qsort
(CSfxArrayV3::SfxBlock2Disk -> CMTqsort, libbiokanga/SfxArrayV2.cpp:414-470,
9451-9490); a device sort of the key tuples replaces it, and, just as
important, a device-built chunk never crosses the host<->device link: only
the raw 2-bit-able int8 codes are uploaded (n bytes), not the 13n-byte
index.  This makes genome-scale chunk cycling practical: upload slice ->
build on device -> align all batches -> drop -> next chunk
(DeviceBuildChunkedAligner), the big-genome single-chip path.

The sort is (key_hi, key_lo, pos) with num_keys=3, i.e. ties break by
position ascending — bit-identical to the host build's stable lexsort.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..align.params import AlignParams
from ..ops.extend_packed import (
    BASES_PER_WORD,
    PAD_ROWS,
    ROW_STRIDE_BASES,
    ROW_WORDS,
    PackedGenome,
)
from .device import MAX_CAND_PER_CORE, DeviceIndex


@partial(jax.jit, static_argnames=("lut_bases", "with_n", "with_keys"))
def _build_arrays(codes: jax.Array, lut_bases: int, with_n: bool = True,
                  with_keys: bool = True):
    """codes (n,) int8 (N=4) -> (pos_rows, key_hi, key_lo, lut, pk_rows,
    pk_nrows) — the whole index build as one compiled graph.

    with_n=False skips the N-plane entirely (pk_nrows=None): callers that
    know the INTERIOR is N-free and bound validity by the true sequence
    length (PackedGenome.length) don't need the plane to reject the
    N-padded tail — and extension then gathers ONE table per candidate
    instead of two (the big-chunk regime is gather-issue bound).

    with_keys=False builds a LUT-ONLY index: the suffix order is sorted
    on the 16-base hi key alone (2-operand sort instead of 3 — the sort
    is the whole build cost at 250 Mbp) and key arrays are 1-element
    dummies.  Valid whenever every lookup's core_len <= lut_bases (the
    LUT fast path answers ranges with two loads and never reads keys,
    ops/lookup.py); AlignEngine enforces this at dispatch.  Saves ~2 GB
    HBM per 250 Mbp chunk and ~2x build time — the chunk-cycled
    big-genome configuration."""
    n = codes.shape[0]
    b = jnp.where(codes >= 4, 0, codes).astype(jnp.uint32)
    is_n = (codes >= 4).astype(jnp.uint32)

    # 32-base bounded keys: hi packs bases [i, i+16), lo packs [i+16, i+32)
    bp = jnp.concatenate([b, jnp.zeros(32, jnp.uint32)])
    hi = jnp.zeros(n + 16, dtype=jnp.uint32)
    for j in range(16):
        hi = hi + (
            jax.lax.dynamic_slice(bp, (j,), (n + 16,))
            << jnp.uint32(2 * (15 - j))
        )
    lo = hi[16 : n + 16]
    hi = hi[:n]

    # LUT: bucket starts by P-base prefix via scatter-count + cumsum over
    # the UNSORTED keys (identical to searchsorted over the sorted keys,
    # one streaming pass instead of 4^P binary searches)
    P = lut_bases
    bucket = (hi >> jnp.uint32(32 - 2 * P)).astype(jnp.int32)
    cnt = jnp.zeros(4**P, jnp.int32).at[bucket].add(1)
    lut = jnp.concatenate([
        jnp.zeros(1, jnp.int32),
        jnp.cumsum(cnt, dtype=jnp.int32),
    ])

    pos = jnp.arange(n, dtype=jnp.int32)
    if with_keys:
        key_hi, key_lo, order = jax.lax.sort((hi, lo, pos), dimension=0,
                                             num_keys=3)
    else:
        key_hi, order = jax.lax.sort((hi, pos), dimension=0, num_keys=1)
        key_hi = key_hi[:1]
        key_lo = key_hi

    # tail-padded row layout for aligned candidate gathers
    pad = MAX_CAND_PER_CORE + (-(n + MAX_CAND_PER_CORE) % 64)
    pos_padded = jnp.concatenate([order, jnp.zeros(pad, jnp.int32)])
    pos_rows = pos_padded.reshape(-1, 64)

    pk_rows, pk_nrows = _packed_rows(b, is_n, with_n)
    return pos_rows, key_hi, key_lo, lut, pk_rows, pk_nrows


def _packed_rows(b, is_n, with_n: bool):
    """Packed 2-bit overlapping rows (ops/extend_packed.pack_genome on
    device) — traced helper shared by the full build and the packed-only
    build."""
    n = b.shape[0]
    n_words = 8 * (n // ROW_STRIDE_BASES + PAD_ROWS)
    total = n_words * BASES_PER_WORD
    bb = jnp.concatenate([b, jnp.zeros(total - n, jnp.uint32)])
    nn = jnp.concatenate(
        [is_n * jnp.uint32(3), jnp.full(total - n, 3, jnp.uint32)]
    )

    def pack_words(v):
        v = v.reshape(-1, BASES_PER_WORD)
        shifts = jnp.uint32(2) * (
            jnp.uint32(15) - jnp.arange(16, dtype=jnp.uint32)
        )
        return jnp.sum(v << shifts, axis=1, dtype=jnp.uint32)

    def overlap_rows(words):
        R = n_words // 8
        wp = jnp.concatenate([words, jnp.zeros(16, jnp.uint32)])
        return jnp.stack(
            [jax.lax.dynamic_slice(wp, (j,), (n_words,))[::8][:R]
             for j in range(ROW_WORDS)],
            axis=1,
        )

    pk_rows = overlap_rows(pack_words(bb))
    pk_nrows = overlap_rows(pack_words(nn)) if with_n else None
    return pk_rows, pk_nrows


@partial(jax.jit, static_argnames=("with_n",))
def _pack_only(codes: jax.Array, with_n: bool = True):
    """Packed rows alone — no suffix sort, no LUT (PE windowed rescue and
    SNP pileup consume just these)."""
    b = jnp.where(codes >= 4, 0, codes).astype(jnp.uint32)
    is_n = (codes >= 4).astype(jnp.uint32)
    return _packed_rows(b, is_n, with_n)


def device_build_index(
    codes: np.ndarray,
    entry_starts: np.ndarray,
    lut_bases: int = 12,
    owned: int | None = None,
    device=None,
    true_len: int | None = None,
    with_keys: bool = True,
) -> DeviceIndex:
    """Build a DeviceIndex directly on device from host int8 codes.

    Only the codes cross the host->device link; keys/sort/LUT/packed rows
    are computed on-chip.  `owned` sets the genome-range chunk ownership
    limit (index/chunked.py semantics).  `true_len` is the real sequence
    length when `codes` arrives N-padded to a fixed shape (chunk cycling):
    PackedGenome.length then bounds valid windows, and when the interior
    [0, true_len) is N-free the N-plane is skipped — one gather per
    extension candidate instead of two."""
    n = len(codes)
    codes_h = np.asarray(codes, np.int8)
    tl = n if true_len is None else int(true_len)
    interior_has_n = bool(np.any(codes_h[:tl] >= 4))
    codes_d = jax.device_put(codes_h, device)
    pos_rows, key_hi, key_lo, lut, pk_rows, pk_nrows = _build_arrays(
        codes_d, lut_bases, with_n=interior_has_n, with_keys=with_keys
    )
    max_bucket = int(jnp.max(jnp.diff(lut)))
    steps = max(1, int(np.ceil(np.log2(max_bucket + 1))) + 1)
    return DeviceIndex(
        genome=codes_d,
        entry_starts=jax.device_put(
            np.asarray(entry_starts, np.int32), device
        ),
        pos_rows=pos_rows,
        key_hi=key_hi,
        key_lo=key_lo,
        lut=lut,
        lut_bases=lut_bases,
        entry_names=[],
        packed=PackedGenome(rows=pk_rows, n_rows=pk_nrows, length=tl),
        max_bsearch_steps=steps,
        owned=None if owned is None else jnp.asarray(np.int32(owned)),
    )


class DeviceBuildChunkedAligner:
    """Big-genome single-chip driver: cycle genome-range chunks through
    HBM, building each chunk's index ON DEVICE (upload = codes only),
    align every read block against it, then merge exactly
    (parallel/chunked.merge_chunk_results).  The batched form of the
    reference's block-at-a-time SetTargBlock sweep
    (libbiokanga/SfxArrayV2.cpp:1903) at >2^31-base scale.
    """

    def __init__(self, seqs: list[tuple[str, np.ndarray]],
                 params: AlignParams | None = None,
                 max_chunk: int = 256_000_000, overlap: int = 2048,
                 lut_bases: int = 12, device=None,
                 with_keys: bool | None = None):
        from .chunked import plan_chunks

        self.params = params or AlignParams()
        self.lut_bases = lut_bases
        self.device = device
        # LUT-only chunks (no key arrays) whenever the classic core ladder
        # fits inside the LUT prefix — ~2x faster chunk builds and ~2 GB
        # less HBM each; AlignEngine.launch rejects any deeper core
        self.with_keys = with_keys
        self.overlap = overlap
        self.entry_names = [nm for nm, _ in seqs]
        starts = np.zeros(len(seqs) + 1, np.int64)
        for i, (_, s) in enumerate(seqs):
            starts[i + 1] = starts[i] + len(s)
        self.entry_starts = starts
        total = int(starts[-1])
        self._codes = (
            seqs[0][1] if len(seqs) == 1
            else np.concatenate([s for _, s in seqs])
        )
        self.plans = plan_chunks(total, max_chunk, overlap)
        self.bases = np.asarray([p[0] for p in self.plans], np.int64)
        # pad every chunk to the max slice length so ONE compiled graph
        # serves all chunks (N-pad; see index/chunked.pad_chunk_arrays)
        self.pad_n = (max(p[2] for p in self.plans) // 128 + 1) * 128
        self._engine = None
        self.build_s: list[float] = []  # wall per engine_for chunk build
        # opt-in build timing (forces a device sync per chunk build;
        # benches that report chunk_build_s set this)
        self.time_builds: bool = False

    @property
    def num_chunks(self) -> int:
        return len(self.plans)

    @property
    def ci(self):
        """Duck-typed ChunkedIndex view: exposes bases/num_chunks/
        entry_starts/entry_names/overlap so the chunk-generic drivers
        (parallel/chunked.ChunkedPEAligner etc.) run unmodified on
        device-built chunks."""
        return self

    def chunk_codes_view(self, k: int) -> np.ndarray:
        """Host codes of chunk k's owned+overlap slice (for ref-base
        lookups in SNP finalisation)."""
        base, _, slice_len = self.plans[k]
        return self._codes[base : base + slice_len]

    def engine_for(self, k: int):
        """Build chunk k ON DEVICE and return the shared AlignEngine
        pointed at it (same contract as ChunkedAligner.engine_for; the
        compiled graphs are reused because every chunk pads to pad_n)."""
        import time as _time

        from ..align.pipeline import AlignEngine

        t0 = _time.monotonic()
        didx = self.build_chunk(k)
        if self.time_builds:
            # opt-in sync purely for timing: the wait serializes host
            # dispatch of the following sweep against the build (ADVICE
            # r4) — production sweeps keep the async overlap
            jax.block_until_ready(didx.pos_rows)
        if len(self.build_s) >= 4096:
            del self.build_s[: 2048]  # bound unattended growth
        self.build_s.append(_time.monotonic() - t0)
        if self._engine is None:
            self._engine = AlignEngine(didx, self.params)
        else:
            self._engine.didx = didx
        return self._engine

    def _chunk_codes(self, k: int):
        base, own, slice_len = self.plans[k]
        codes = np.full(self.pad_n, 4, np.int8)
        codes[:slice_len] = self._codes[base : base + slice_len]
        es = np.clip(self.entry_starts - base, 0, slice_len)
        return codes, es.astype(np.int64), own

    def _auto_with_keys(self) -> bool:
        if self.with_keys is not None:
            return self.with_keys
        # keys are only read when a lookup's core exceeds the LUT prefix.
        # classic core_len = max(ladder, read_len // (max_tot_mm + delta))
        # and the read-length term is <= ~10 for any subs_per100 >= 10, so
        # lut_bases >= 13 >= ladder covers every dispatch of the
        # big-genome chunk configs; smaller LUTs (or exact-match mode,
        # whose core is the whole read) keep the key arrays.  The
        # AlignEngine.launch guard catches any residual mismatch.
        from ..align.params import min_core_len

        if self.params.max_subs_per100 == 0:
            return True
        delta = 1 if self.params.min_edit_dist == 1 else 2
        read_term = max(
            L // (min(max(1, int(0.5 + L * self.params.max_subs_per100
                              / 100.0)), 63) + delta)
            for L in range(20, 4097)
        )
        need = max(min_core_len(self.pad_n, self.params.mode),
                   min(read_term, 32))
        return need > self.lut_bases

    def build_chunk(self, k: int) -> DeviceIndex:
        codes, es, own = self._chunk_codes(k)
        return device_build_index(codes, es, self.lut_bases, owned=own,
                                  device=self.device,
                                  true_len=self.plans[k][2],
                                  with_keys=self._auto_with_keys())

    def packed_chunk(self, k: int):
        """Packed rows + genome codes + local entry starts for chunk k
        WITHOUT the suffix sort — all that PE windowed rescue and SNP
        pileup need.  Orders of magnitude cheaper than build_chunk (no
        250M-element sort)."""
        from ..ops.extend_packed import PackedGenome

        codes, es, own = self._chunk_codes(k)
        codes_d = jax.device_put(codes, self.device)
        pk_rows, pk_nrows = _pack_only(
            codes_d, with_n=bool(np.any(codes[: self.plans[k][2]] >= 4))
        )
        return codes_d, PackedGenome(
            rows=pk_rows, n_rows=pk_nrows, length=self.plans[k][2]
        ), es

    def align_blocks(self, blocks, progress=None,
                     checkpoint_dir: str | None = None):
        """Chunk-major streaming; returns merged dicts per block (int64
        global loci).  checkpoint_dir: resumable sweep — completed
        (chunk, block) cells load from disk, the chunk index is only
        rebuilt when a chunk still has missing cells."""
        from ..align.pipeline import AlignEngine
        from ..parallel.chunked import merge_chunk_results

        ckpt = None
        if checkpoint_dir:
            from ..utils.checkpoint import SweepCheckpoint, config_signature

            sig = config_signature(
                [self.bases, np.asarray([p[1] for p in self.plans]),
                 self.params, self.lut_bases,
                 [(r.shape, int(l.sum())) for r, l in blocks]]
            )
            ckpt = SweepCheckpoint(checkpoint_dir, sig)

        engine = None
        per_block = [[] for _ in blocks]
        for k in range(self.num_chunks):
            need = [b for b in range(len(blocks))
                    if ckpt is None or not ckpt.has(k, b)]
            if need:
                didx = self.build_chunk(k)
                if engine is None:
                    engine = AlignEngine(didx, self.params)
                else:
                    engine.didx = didx
            for b, (reads, lengths) in enumerate(blocks):
                if ckpt is not None and b not in need:
                    per_block[b].append(ckpt.load(k, b))
                    continue
                res = engine.align_with_rescue(reads, lengths)
                if ckpt is not None:
                    ckpt.save(k, b, res)
                per_block[b].append(res)
            if progress:
                progress(k)
        out = []
        for b, (reads, lengths) in enumerate(blocks):
            res = merge_chunk_results(per_block[b], self.bases, lengths,
                                      self.params)
            out.append(res)
        return out

    def align(self, reads: np.ndarray, lengths: np.ndarray) -> dict:
        return self.align_blocks([(reads, lengths)])[0]
