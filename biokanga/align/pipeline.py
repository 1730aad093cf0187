"""The aligner pipeline: seed -> candidates -> Hamming extend -> accept.

Batched re-expression of CAligner::LocateCoredApprox / ProcCoredApprox /
CSfxArrayV3::AlignReads (biokanga/Aligner.cpp:8651,8943;
libbiokanga/SfxArrayV2.cpp:7663): instead of worker threads pulling
4096-read blocks and chasing one candidate at a time, whole read batches
flow through dense, jit-compiled stages:

  1. pack core k-mers at the reference's slide offsets (both strands)
  2. batched SA range lookup per core (ops/lookup.py)
  3. gather up to H candidate loci per core, diagonal-dedup per read
  4. Hamming-extend all candidates at once (ops/extend.py)
  5. order-independent best/next-best reduction with the reference's
     MMDelta margin acceptance

Candidate caps (H) replace the reference's per-core iteration cap
(MaxIter=50000, SfxArrayV2.h:12); reads whose cores overflowed H without
producing an accepted hit are re-run through a wider "rescue" pass,
mirroring the reference's progressive-sensitivity driver.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..index.device import DeviceIndex
from ..ops.extend import MM_INVALID, hamming_extend
from ..ops.extend_packed import (
    MAX_PACKED_READ_LEN,
    hamming_extend_packed,
    pack_reads,
)
from ..ops.lookup import pack_read_kmers, seed_range_lookup
from .params import AlignParams, DerivedParams

_I32_MAX = np.int32(2**31 - 1)


def sort_rows(*operands):
    """Sort each row of (B, C) int32 candidate matrices ascending, by
    the operands as keys in order (lexicographic; row-major, unpadded).
    Invalid candidates carry INT32_MAX and so sort last."""
    return jax.lax.sort(operands if len(operands) > 1 else operands[0],
                        dimension=1, num_keys=len(operands))


def _host_pack_2bit(reads: np.ndarray):
    """Host-side 2-bit pack of a (B, L) int8 code batch for upload.

    The host packs 4 bases/byte plus an N bitmap and the device graph
    unpacks — 2.7-4x fewer host->device bytes than raw int8 codes
    (whether that pays on a given host link is a measurement, not a
    given).  Returns (codes2 uint8
    (B, ceil(L/4)), nmask uint8 (B, ceil(L/8)) | None), or None when the
    batch holds codes > 4 (colorspace etc.) and must upload raw.
    """
    if reads.size == 0 or reads.max(initial=0) > 4:
        return None
    isn = reads == 4
    c = np.where(isn, 0, reads).astype(np.uint8)
    B, L = c.shape
    lp = -(-L // 4) * 4
    if lp != L:
        c = np.pad(c, ((0, 0), (0, lp - L)))
    c = c.reshape(B, lp // 4, 4)
    codes2 = (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
              | (c[:, :, 3] << 6)).astype(np.uint8)
    nmask = None
    if isn.any():
        nmask = np.packbits(isn, axis=-1, bitorder="little")
    return codes2, nmask


def _device_unpack_2bit(codes2: jax.Array, nmask, L: int) -> jax.Array:
    """Inverse of _host_pack_2bit, traced into the align graph (fuses
    into the first consumer; negligible vs the gather stages)."""
    B = codes2.shape[0]
    shifts = (jnp.arange(4, dtype=jnp.uint8) * 2)[None, None, :]
    c = ((codes2[:, :, None] >> shifts) & 3).reshape(B, -1)[:, :L]
    c = c.astype(jnp.int8)
    if nmask is not None:
        bits = (nmask[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
        isn = bits.reshape(B, -1)[:, :L]
        c = jnp.where(isn.astype(bool), jnp.int8(4), c)
    return c


def _rc_reads(reads: jax.Array, lengths: jax.Array,
              uniform: bool = False) -> jax.Array:
    """Per-read reverse complement keeping padding at the tail.

    uniform=True (all reads exactly fill the padded width — the common
    case, known statically on host) skips the per-row roll, which would
    otherwise cost a per-element gather."""
    L = reads.shape[1]
    flipped = reads[:, ::-1]
    rc = jnp.where(flipped >= 4, flipped, 3 - flipped).astype(reads.dtype)
    if uniform:
        return rc
    # rc currently has (L - len) pad codes at the front; roll left per read
    col = (jnp.arange(L, dtype=jnp.int32)[None, :] + (L - lengths)[:, None]) % L
    return jnp.take_along_axis(rc, col, axis=1)


def _strand_candidates(
    didx_arrays, seq, dp: DerivedParams, H: int, cand_cap: int, owned=None,
    occ_skip: bool = False,
):
    """Candidate loci for one strand: (B, C) loci + validity, C <= cand_cap.

    Steps: pack cores -> LUT/binary-search range -> contiguous slice-gather
    of up to H SA positions per core -> diagonal dedup (sort + neighbour
    mask) -> compact to the first cand_cap unique loci (invalid sentinels
    sort last, so slicing keeps all real candidates unless they exceed the
    cap, which raises the overflow flag -> rescue pass).

    `occ_skip` — the over-occurring-seed rule (the batched form of the
    reference's InitOverOccKMers / MaxIter suppression, SfxArrayV2.h:12,
    Blitz.cpp:1053): a core whose SA range exceeds H contributes ZERO
    candidates instead of an arbitrary H-truncated prefix.  Enumeration
    from the surviving cores is then COMPLETE, so accepts (best / margin /
    instance counts over discovered hits) are exact for every hit that
    exact-matches at least one non-over-occurring core — which is all the
    reference itself sees under its per-core iteration cap.  Reads with a
    skipped core still raise `overflow` and ladder through the rescue
    passes (rescue_ladder).  occ_skip=False keeps the plain truncating
    semantics (final rescue step, assembly overlap enumeration).

    `owned` (traced int32 scalar, optional): alignments must START below
    this local offset — the genome-range chunk ownership rule (loci in the
    overlap tail belong to the next chunk; cf. uhamming's static sweep
    partitioning, /root/reference/uhamming/uhamming.cpp:222-238).
    """
    key_hi, key_lo, lut, pos_rows, lut_bases, max_steps = didx_arrays
    S = len(dp.offsets)
    qlh, qll, qhh, qhl, has_n = pack_read_kmers(seq, dp.offsets, dp.core_len)
    start, end = seed_range_lookup(
        key_hi, key_lo, lut, lut_bases, qlh, qll, qhh, qhl,
        core_len=dp.core_len, max_steps=max_steps,
    )
    size = end - start
    # N-containing cores produce junk lookup ranges; they are already
    # excluded from candidates below and must not count as over-occurring
    overflow = (size > H) & (~has_n)
    if occ_skip:
        size = jnp.where(overflow, jnp.int32(0), size)
    # candidate runs are read with ALIGNED 64-int ROW gathers (instead
    # of one dynamic slice per core) and the true start extracted with
    # static selects: a 4-way
    # select of the 16-aligned (H+16)-wide window, then a 16-way select
    # for the fine offset.  General for any H: nrows rows cover the worst
    # 48 + (H+16) span; the pos table's MAX_CAND_PER_CORE (=4096) zero
    # pad keeps the window in-bounds for H up to ~4000.
    R2 = pos_rows.shape[0]
    nrows = (H + 127) // 64
    r0 = jnp.clip(start >> 6, 0, R2 - nrows)          # (B, S)
    wide = jnp.concatenate(
        [pos_rows[r0 + t] for t in range(nrows)], axis=-1
    )  # (B, S, 64*nrows)
    a16 = ((start & 63) >> 4)[..., None]              # 0..3
    WL = H + 16
    w64 = jnp.zeros(start.shape + (WL,), dtype=jnp.int32)
    for t in range(4):
        w64 = jnp.where(a16 == t, wide[..., 16 * t : 16 * t + WL], w64)
    frac = (start & 15)[..., None]
    pos = jnp.zeros(start.shape + (H,), dtype=jnp.int32)
    for t in range(16):
        pos = jnp.where(frac == t, w64[..., t : t + H], pos)
    j = jnp.arange(H, dtype=jnp.int32)
    in_range = j[None, None, :] < jnp.minimum(size, H)[..., None]
    offs = jnp.asarray(dp.offsets, dtype=jnp.int32)
    diag = pos - offs[None, :, None]
    valid = in_range & (~has_n[..., None]) & (diag >= 0)
    if owned is not None:
        valid = valid & (diag < owned)

    B = seq.shape[0]
    flat = jnp.where(valid, diag, _I32_MAX).reshape(B, S * H)
    # diagonal dedup: identical loci discovered via different cores are one
    # alignment (the reference dedups via its per-thread tsIdentNode hash,
    # SfxArrayV2.h:15-16); sort + neighbour-mask is the batched equivalent.
    with jax.named_scope("dedup_sort"):
        srt = sort_rows(flat)
    dup = jnp.concatenate(
        [jnp.zeros((B, 1), dtype=bool), srt[:, 1:] == srt[:, :-1]], axis=1
    )
    v = (srt != _I32_MAX) & (~dup)
    C = min(cand_cap, S * H)
    if C < S * H:
        trunc = jnp.any(v[:, C:], axis=1)
        srt, v = srt[:, :C], v[:, :C]
    else:
        trunc = jnp.zeros((B,), dtype=bool)
    if occ_skip:
        # n_over: per-read count of SKIPPED (over-occurring) cores — feeds
        # the skip-aware pigeonhole resolution bound (exact_resolved):
        # enumeration is complete for every hit with mm <= n_disjoint -
        # n_over - 1, so accepts within that bound are exact
        n_over = jnp.sum(overflow.astype(jnp.int32), axis=1)
    else:
        n_over = jnp.zeros((B,), dtype=jnp.int32)
        trunc = trunc | jnp.any(overflow, axis=1)
    return srt, v, n_over, trunc


def align_core(genome, entry_starts, pos_rows, key_hi, key_lo, lut,
               reads, lengths, owned, packed, *, ap: AlignParams,
               dp: DerivedParams, H: int, cand_cap: int, strand: str,
               uniform: bool, lut_bases: int, max_steps: int,
               occ_skip: bool = True):
    """The full per-index alignment dataflow as one traced function —
    shared verbatim by the single-device engine (AlignEngine) and the
    multi-chip sharded step (parallel/sharded.py), so their per-chunk
    results are identical by construction."""
    arrays = (key_hi, key_lo, lut, pos_rows, lut_bases, max_steps)
    # per-read mismatch budget from ACTUAL read length — the
    # reference computes MaxTotMM per read (Aligner.cpp:9084-9090)
    if ap.max_subs_per100 == 0:
        max_tot_mm = jnp.zeros_like(lengths)
    else:
        max_tot_mm = jnp.clip(
            jnp.floor(
                lengths * (ap.max_subs_per100 / 100.0) + 0.5
            ).astype(jnp.int32),
            1,
            63,
        )
    strands = []
    if strand in ("both", "sense"):
        strands.append((reads, False))
    if strand in ("both", "antisense"):
        strands.append((_rc_reads(reads, lengths, uniform), True))

    loci_parts, valid_parts, mm_parts = [], [], []
    n_over = trunc = None
    for seq, is_rc in strands:
        loci, vmask, s_over, s_trunc = _strand_candidates(
            arrays, seq, dp, H, cand_cap, owned, occ_skip=occ_skip)
        if packed is not None:
            rcodes, rnlane = pack_reads(seq, lengths)
            mm = hamming_extend_packed(
                packed, entry_starts, loci, vmask, rcodes, rnlane,
                lengths,
            )
        else:
            mm = hamming_extend(
                genome, entry_starts, loci, vmask, seq, lengths
            )
        loci_parts.append(loci)
        valid_parts.append(vmask)
        mm_parts.append(mm)
        # a hidden hit lives on ONE strand, so the pigeonhole bound needs
        # the worst single strand: max of per-strand skipped-core counts
        n_over = s_over if n_over is None else jnp.maximum(n_over, s_over)
        trunc = s_trunc if trunc is None else (trunc | s_trunc)

    loci_all = jnp.concatenate(loci_parts, axis=1)
    mm_all = jnp.concatenate(mm_parts, axis=1)
    C1 = loci_parts[0].shape[1]

    # ONE two-key sort by (mm*2 | rc, locus) yields everything the
    # acceptance rule needs (fused replacement for the former
    # best_hit_reduce + multi-hit sort pair — the reduce re-scanned
    # the same matrix the sort orders anyway):
    #   column 0     -> best mm / locus / strand
    #   column 1     -> next-best mm; margin < MMDelta iff inst > 1
    #                   OR true margin fails — exactly the reference
    #                   LowMMCnt/NxtLowMMCnt rule (SfxArrayV2.h:70-77)
    #   columns 0..K -> multi-hit loci (AssignMultiMatches input,
    #                   Aligner.cpp:5109)
    # rc rides in the key's low bit (sense sorts first at equal mm,
    # matching the reference's sense-then-antisense traversal).
    K = max(1, ap.max_multi)
    Ctot = mm_all.shape[1]
    if strand == "both":
        rc_col = (jnp.arange(Ctot, dtype=jnp.int32) >= C1).astype(
            jnp.int32
        )[None, :]
    else:
        rc_col = jnp.full((1, Ctot), int(strand == "antisense"),
                          jnp.int32)
    key = mm_all.astype(jnp.int32) * 2 + rc_col
    with jax.named_scope("final_sort"):
        s_key, s_loci = sort_rows(key, loci_all)
    best = s_key[:, 0] >> 1
    is_rc_hit = (s_key[:, 0] & 1).astype(jnp.bool_)
    locus = s_loci[:, 0]
    next_mm = s_key[:, 1] >> 1
    inst = jnp.sum(mm_all.astype(jnp.int32) == best[:, None],
                   axis=1, dtype=jnp.int32)
    any_hit = best <= max_tot_mm
    unique = any_hit & (
        (next_mm - best) >= jnp.int32(ap.min_edit_dist)
    )
    # next_mm is CANONICAL only up to the accept margin: saturate at
    # best + MMDelta.  Beyond the margin the raw second-best value is a
    # junk-candidate artefact that depends on discovery order/candidate
    # budget (true in the reference too — NxtLowMMCnt under progressive
    # sensitivity, SfxArrayV2.cpp:7663-7760), so saturation is what makes
    # single-level, two-level-fast-pass, chunked and sharded engines
    # bit-identical.  Saturation composes with the min-based chunk merge
    # (parallel/chunked.py merge_chunk_results).
    next_sat = jnp.minimum(next_mm, best + jnp.int32(ap.min_edit_dist))
    # ml_* rows are VALID HITS only: rows whose mm exceeds the per-read
    # budget are junk-candidate artefacts, masked to (locus=-1, mm=255).
    # Contract: the tied-best prefix (mm == best_mm) is exact — that is
    # what multi-hit assignment consumes, and all the reference itself
    # retains (Aligner.cpp:5109) — while rows in (best, MaxTotMM] are
    # best-effort under params.fast_pass (complete when fast_pass=False).
    ml_key = s_key[:, :K]
    ml_mm_rows = ml_key >> 1
    ml_ok = ml_mm_rows <= max_tot_mm[:, None]
    return {
        "unique": unique,
        "any_hit": any_hit,
        "best_mm": jnp.minimum(best, MM_INVALID).astype(jnp.uint8),
        "next_mm": jnp.minimum(next_sat, MM_INVALID).astype(jnp.uint8),
        "inst": inst,
        "locus": locus,
        "is_rc": is_rc_hit,
        "overflow": (n_over > 0) | trunc,
        "n_over": n_over,
        "cap_trunc": trunc,
        "ml_loci": jnp.where(ml_ok, s_loci[:, :K], -1),
        "ml_mm": jnp.where(
            ml_ok, jnp.minimum(ml_mm_rows, 255), 255).astype(jnp.uint8),
        "ml_rc": jnp.where(ml_ok, (ml_key & 1) != 0, False),
    }


class AlignEngine:
    """Compiles and runs the batch alignment for one DeviceIndex."""

    def __init__(self, didx: DeviceIndex, params: AlignParams | None = None):
        self.didx = didx
        self.params = params or AlignParams()
        self._jitted = {}

    def _fn(self, dp: DerivedParams, H: int, strand: str, use_packed: bool,
            cand_cap: int, uniform: bool, upload: str = "raw",
            read_len: int = 0, occ_skip: bool = True):
        has_owned = self.didx.owned is not None
        pk0 = self.didx.packed if use_packed else None
        key = (dp, H, strand, use_packed, cand_cap, uniform, has_owned,
               pk0.length if pk0 is not None else 0,
               pk0 is not None and pk0.has_n,
               self.didx.lut_bases, self.didx.max_bsearch_steps,
               upload, read_len, occ_skip)
        if key in self._jitted:
            return self._jitted[key]
        didx = self.didx
        lut_bases = didx.lut_bases
        max_steps = didx.max_bsearch_steps
        # packed genome STATICS (length, has_n); its arrays are passed as
        # args so one compiled fn serves every equal-shaped chunk
        # (biokanga/index/chunked.py)
        pk = didx.packed if use_packed else None
        pk_len = pk.length if pk is not None else 0
        pk_has_n = pk is not None and pk.has_n
        ap = self.params

        def run(genome, entry_starts, pos_rows, key_hi, key_lo, lut,
                reads, lengths, *rest):
            from ..ops.extend_packed import PackedGenome
            owned = packed = None
            rest = list(rest)
            if upload == "p2":
                reads = _device_unpack_2bit(reads, None, read_len)
            elif upload == "p2n":
                reads = _device_unpack_2bit(reads, rest.pop(0), read_len)
            if has_owned:
                owned = rest.pop(0)
            if use_packed:
                pk_rows = rest.pop(0)
                pk_nrows = rest.pop(0) if pk_has_n else None
                packed = PackedGenome(rows=pk_rows, n_rows=pk_nrows,
                                      length=pk_len)
            return align_core(
                genome, entry_starts, pos_rows, key_hi, key_lo, lut,
                reads, lengths, owned, packed,
                ap=ap, dp=dp, H=H, cand_cap=cand_cap, strand=strand,
                uniform=uniform, lut_bases=lut_bases, max_steps=max_steps,
                occ_skip=occ_skip,
            )

        jitted = jax.jit(run)
        self._jitted[key] = jitted
        return jitted

    def launch(self, reads: np.ndarray, lengths: np.ndarray, H=None,
               cand_cap=None, dp=None, occ_skip: bool = True,
               uniform: bool | None = None):
        """Dispatch one batch asynchronously; returns (device dict, dp).

        `uniform=None` derives the all-rows-full-length flag from the
        data; passing False pins the general (per-row roll) graph so
        padded and full chunks share ONE compiled shape (align_many /
        rescue_ladder keep their graph count constant this way)."""
        B, L = reads.shape
        if dp is None:
            dp = self.params.derive(int(L), self.didx.ladder_len)
        if (self.didx.key_hi.shape[0] == 1
                and dp.core_len > self.didx.lut_bases):
            raise ValueError(
                f"LUT-only index (built with_keys=False) cannot serve "
                f"core_len {dp.core_len} > lut_bases {self.didx.lut_bases}"
            )
        H = int(H or self.params.cand_per_core)
        if cand_cap is None:
            cand_cap = self.params.max_cand_per_strand
        use_packed = self.didx.packed is not None and L <= MAX_PACKED_READ_LEN
        if uniform is None:
            uniform = bool(np.all(lengths == L))
        packed_up = _host_pack_2bit(np.asarray(reads))
        if packed_up is None:
            upload, up_args = "raw", (jnp.asarray(reads),)
        else:
            codes2, nmask = packed_up
            if nmask is None:
                upload, up_args = "p2", (jnp.asarray(codes2),)
            else:
                upload = "p2n"
                up_args = (jnp.asarray(codes2), jnp.asarray(nmask))
        fn = self._fn(dp, H, self.params.strand, use_packed, int(cand_cap),
                      uniform, upload=upload, read_len=int(L),
                      occ_skip=occ_skip)
        d = self.didx
        args = (
            d.genome, d.entry_starts, d.pos_rows, d.key_hi, d.key_lo, d.lut,
            up_args[0], jnp.asarray(lengths),
        ) + up_args[1:]
        if d.owned is not None:
            args = args + (d.owned,)
        if use_packed:
            args = args + (d.packed.rows,)
            if d.packed.has_n:
                args = args + (d.packed.n_rows,)
        out = fn(*args)
        return out, dp

    def align_batch(self, reads: np.ndarray, lengths: np.ndarray, H=None,
                    cand_cap=None, dp=None, occ_skip: bool = True,
                    uniform: bool | None = None):
        """reads: (B, L) int8 host array. Returns host-side result dict."""
        out, dp = self.launch(reads, lengths, H=H, cand_cap=cand_cap, dp=dp,
                              occ_skip=occ_skip, uniform=uniform)
        res = {k: np.array(v) for k, v in jax.device_get(out).items()}
        res["derived"] = dp
        return res

    def _fast_params(self, reads):
        """FastPassParams for this batch shape, or None (two-level off /
        not applicable)."""
        if self.didx.packed is None:
            return None
        return self.params.derive_fast(
            int(reads.shape[1]), self.didx.ladder_len, self.didx.lut_bases
        )

    def launch_primary(self, reads: np.ndarray, lengths: np.ndarray):
        """Dispatch the PRIMARY pass (two-level fast pass when available,
        classic otherwise) asynchronously.  Pair with finish_primary."""
        fp = self._fast_params(reads)
        if fp is None:
            out, dp = self.launch(reads, lengths)
        else:
            out, dp = self.launch(reads, lengths, H=fp.H,
                                  cand_cap=fp.cand_cap, dp=fp.dp)
        return (reads, lengths, out, dp, fp)

    def finish_primary(self, state) -> dict:
        """Device-get a launch_primary dispatch and complete it to the
        full align_with_rescue semantics: rerun fast-pass-unresolved reads
        through the classic pass, then the wide rescue pass."""
        reads, lengths, out, dp, fp = state
        res = {k: np.array(v) for k, v in jax.device_get(out).items()}
        res["derived"] = dp
        if fp is None:
            self.rescue_pass(reads, lengths, res)
            return res
        # skip-aware resolution: a skipped (over-occurring) core weakens
        # the pigeonhole guarantee by one, so the bound charges n_over
        # (exactly the classic exact_resolved rule applied to long cores)
        bound = fp.resolved_bound(lengths, self.params.min_edit_dist)
        resolved = (
            res["best_mm"].astype(np.int32) + res["n_over"] <= bound
        ) & (~res["cap_trunc"])
        res["overflow"] = np.zeros_like(res["overflow"])
        res["n_over"] = np.zeros_like(res["n_over"])
        res["cap_trunc"] = np.zeros_like(res["cap_trunc"])
        rows = np.nonzero(~resolved)[0]
        if len(rows):
            sub_r, sub_l = pad_rows(reads[rows], lengths[rows])
            sub = self.align_batch(sub_r, sub_l)
            self.rescue_pass(sub_r, sub_l, sub)
            for k in RESULT_KEYS + ("overflow", "n_over", "cap_trunc"):
                res[k][rows] = sub[k][: len(rows)]
        return res

    def launch_fast(self, reads: np.ndarray, lengths: np.ndarray):
        """Dispatch ONLY the fast (or classic, if no fast params) pass —
        no per-chunk unresolved rerun and no rescue.  For chunk-sweep
        drivers that resolve GLOBALLY: per-chunk fall-through wastes a
        classic pass on every read whose home is another chunk (~(K-1)/K
        of the sweep), while the two-level exactness bound only needs the
        GLOBAL best (parallel/chunked.two_level_chunk_sweep)."""
        fp = self._fast_params(reads)
        if fp is None:
            out, dp = self.launch(reads, lengths)
        else:
            out, dp = self.launch(reads, lengths, H=fp.H,
                                  cand_cap=fp.cand_cap, dp=fp.dp)
        return (out, dp, fp)

    def finish_fast(self, state) -> dict:
        out, dp, fp = state
        res = {k: np.array(v) for k, v in jax.device_get(out).items()}
        res["derived"] = dp
        return res

    def align_stream(self, blocks):
        """Double-buffered batch driver: keeps one batch in flight so host
        transfer/dispatch overlaps device compute (the batched analogue of the
        reference's loader-thread pipelining, Aligner.cpp:4820,10394).

        Runs the full two-level + rescue flow per block (identical output
        to align_with_rescue); the fast pass of block i+1 is on device
        while block i's unresolved tail/rescue reruns dispatch.

        blocks: iterator of (reads, lengths); yields host result dicts.
        """
        pending = None
        for reads, lengths in blocks:
            state = self.launch_primary(reads, lengths)
            if pending is not None:
                yield self.finish_primary(pending)
            pending = state
        if pending is not None:
            yield self.finish_primary(pending)

    def align_many(self, blocks):
        """Full align_with_rescue semantics over MANY blocks with
        cross-block batching of the classic and rescue stages: fast
        passes stream double-buffered, then ALL unresolved reads
        concatenate into fixed 16k-row classic dispatches, then ONE
        rescue ladder over the classic residue.  Per-read results are
        identical to align_with_rescue (the rules are per-read); the win
        is one compiled shape per stage and ~8x fewer host syncs — this
        is what makes repeat-dense genomes fast (BENCH_REPEAT).

        blocks: list of (reads, lengths); returns list of result dicts.
        """
        fast = []
        pend = None
        for reads, lengths in blocks:
            st = self.launch_fast(reads, lengths)
            if pend is not None:
                fast.append(self.finish_fast(pend))
            pend = st
        if pend is not None:
            fast.append(self.finish_fast(pend))
        med = self.params.min_edit_dist
        unres = []
        for b, ((reads, lengths), res) in enumerate(zip(blocks, fast)):
            fp = self._fast_params(reads)
            if fp is None:
                rows = np.nonzero(inexact_rows(res, lengths, med))[0]
            else:
                bound = fp.resolved_bound(lengths, med)
                resolved = (
                    res["best_mm"].astype(np.int32) + res["n_over"]
                    <= bound
                ) & (~res["cap_trunc"])
                rows = np.nonzero(~resolved)[0]
            res["overflow"][:] = False
            res["n_over"][:] = 0
            res["cap_trunc"][:] = False
            if len(rows):
                unres.append((b, rows))
        if unres:
            sub_r = np.concatenate([blocks[b][0][r] for b, r in unres])
            sub_l = np.concatenate([blocks[b][1][r] for b, r in unres])
            CH = 16384
            parts, pend = [], None
            for s in range(0, len(sub_r), CH):
                k_n = min(CH, len(sub_r) - s)
                r = np.full((CH, sub_r.shape[1]), 4, sub_r.dtype)
                l = np.zeros(CH, sub_l.dtype)
                r[:k_n] = sub_r[s: s + k_n]
                l[:k_n] = sub_l[s: s + k_n]
                st = self.launch(r, l, uniform=False)
                if pend is not None:
                    o, dp = pend
                    d = {k: np.array(v)
                         for k, v in jax.device_get(o).items()}
                    d["derived"] = dp
                    parts.append(d)
                pend = (st[0], st[1])
            o, dp = pend
            d = {k: np.array(v) for k, v in jax.device_get(o).items()}
            d["derived"] = dp
            parts.append(d)
            ns = [min(CH, len(sub_r) - s)
                  for s in range(0, len(sub_r), CH)]
            sub = {k: np.concatenate(
                [p[k][:n] for p, n in zip(parts, ns)])
                for k in parts[0] if k != "derived"}
            sub["derived"] = parts[0]["derived"]
            self.rescue_pass(sub_r, sub_l, sub)
            ofs = 0
            for b, rows in unres:
                for k in RESULT_KEYS + _LADDER_KEYS:
                    fast[b][k][rows] = sub[k][ofs: ofs + len(rows)]
                ofs += len(rows)
        return fast

    def align_with_rescue(self, reads: np.ndarray, lengths: np.ndarray):
        """Primary pass + wider rescue pass for overflowed, unaccepted reads
        (the batched analogue of the reference's progressive sensitivity in
        CSfxArrayV3::AlignReads, SfxArrayV2.cpp:7663-7760).

        With params.fast_pass (default) the primary pass is the two-level
        flow: a LONG-core pass resolves the typical read with an order of
        magnitude fewer candidates (params.derive_fast documents the
        exactness proof); unresolved reads rerun through the classic
        reference-core pass — output-equivalent by construction and
        regression-tested against the single-level engine
        (tests/test_two_level.py)."""
        return self.finish_primary(self.launch_primary(reads, lengths))

    def rescue_pass(self, reads: np.ndarray, lengths: np.ndarray,
                    res: dict) -> None:
        """Apply the progressive rescue ladder in place (rescue_ladder)."""
        def run(r, l, H, cap, skip):
            return self.align_batch(r, l, H=H, cand_cap=cap, occ_skip=skip,
                                    uniform=False)

        return rescue_ladder(run, reads, lengths, res, self.params)

    def warm_ladder(self, L: int, classic_rows: int = 16384) -> None:
        """Pre-compile the classic + rescue-ladder graph shapes with
        empty dispatches so a production run's timed region contains no
        compilation (the ladder shapes are canonical: see rescue_ladder
        fixed-shape dispatch notes)."""
        p = self.params
        for rows, H, cap, skip in (
            (classic_rows, None, None, True),
            (2048, p.rescue_mid_H, p.rescue_mid_cap, True),
            (512, p.rescue_cand_per_core, 8 * p.max_cand_per_strand,
             False),
        ):
            r = np.full((rows, L), 4, np.int8)
            l = np.zeros(rows, np.int32)
            self.align_batch(r, l, H=H, cand_cap=cap, occ_skip=skip,
                             uniform=False)


RESULT_KEYS = ("unique", "any_hit", "best_mm", "next_mm", "inst",
               "locus", "is_rc", "ml_loci", "ml_mm", "ml_rc")
_LADDER_KEYS = ("overflow", "n_over", "cap_trunc")


def inexact_rows(res: dict, lengths, min_edit_dist: int):
    """Rows whose result is NOT provably exact under the skip-aware
    pigeonhole bound (see _strand_candidates occ_skip):

        exact  iff  no candidate-cap truncation AND
                    (no core skipped  OR
                     best_mm + n_over + MMDelta <= length // core_len)

    With no skips the enumeration was complete, so even a no-hit row is
    exactly 'unmapped'.  With skips, any hidden hit has mm >=
    n_disjoint - n_over, so results within the bound keep their best /
    margin / tied-best instances.  Inexact rows — including ones
    currently flagged unique — ladder through deeper rescue passes.
    """
    n = np.asarray(lengths, np.int32) // np.int32(res["derived"].core_len)
    best = res["best_mm"].astype(np.int32)
    exact = (~res["cap_trunc"]) & (
        (res["n_over"] == 0)
        | (best + res["n_over"] + np.int32(min_edit_dist) <= n)
    )
    return ~exact


def rescue_ladder(run, reads, lengths, res: dict, params: AlignParams,
                  extra_keys=()):
    """Progressive-sensitivity rescue for INEXACT reads — the batched
    form of the reference's ladder (CSfxArrayV3::AlignReads,
    SfxArrayV2.cpp:7663-7760) with its over-occurring-seed suppression
    (InitOverOccKMers / MaxIter, SfxArrayV2.h:12):

      step 1  medium-width COMPLETE enumeration (occ_skip at
              rescue_mid_H): exact accepts for moderately repetitive
              reads, dispatched in large batches;
      step 2  full-width TRUNCATING pass (first rescue_cand_per_core SA
              positions per core) for the still-inexact residue — except
              reads already classified excessive-multi at mm==0, where
              deeper enumeration can only add ties (the reference drops
              these as >MaxMulti hits, Aligner.cpp:5109).

    `run(reads, lengths, H, cand_cap, occ_skip) -> host result dict` is
    the dispatch closure (single-engine align_batch or the sharded SPMD
    step), so the ladder is identical across drivers.  Mutates `res` in
    place and returns it.
    """
    keys = RESULT_KEYS + _LADDER_KEYS + tuple(extra_keys)
    p = params
    need = inexact_rows(res, lengths, p.min_edit_dist)
    if not need.any():
        return res
    if p.rescue_mid_H > p.cand_per_core:
        rows = np.nonzero(need)[0]
        CH1 = 2048
        for s in range(0, len(rows), CH1):
            sub_rows = rows[s: s + CH1]
            k_n = len(sub_rows)
            # fixed-shape dispatches (tail padded to CH1 with empty
            # reads): every ladder invocation reuses ONE compiled graph
            sub_r = np.full((CH1, reads.shape[1]), 4, reads.dtype)
            sub_l = np.zeros(CH1, lengths.dtype)
            sub_r[:k_n] = reads[sub_rows]
            sub_l[:k_n] = lengths[sub_rows]
            sub = run(sub_r, sub_l, p.rescue_mid_H, p.rescue_mid_cap, True)
            for k in keys:
                res[k][sub_rows] = sub[k][:k_n]
    multi0 = (res["any_hit"] & (res["best_mm"] == 0)
              & (res["inst"] > p.max_multi))
    need2 = inexact_rows(res, lengths, p.min_edit_dist) & ~multi0
    if need2.any():
        rows = np.nonzero(need2)[0]
        # fixed 512-row dispatches (padded with empty reads): one compiled
        # shape regardless of how many reads overflowed, and the wide-H
        # extension temp stays bounded (its size grows with rows x
        # cand_cap)
        CH = 512
        cap = 8 * p.max_cand_per_strand
        for s in range(0, len(rows), CH):
            sub_rows = rows[s: s + CH]
            k_n = len(sub_rows)
            r = np.full((CH, reads.shape[1]), 4, reads.dtype)
            l = np.zeros(CH, lengths.dtype)
            r[:k_n] = reads[sub_rows]
            l[:k_n] = lengths[sub_rows]
            sub = run(r, l, p.rescue_cand_per_core, cap, False)
            for k in keys:
                res[k][sub_rows] = sub[k][:k_n]
    return res


class ExtendedAligner:
    """Adds micro-indel and splice-junction fall-through passes to an
    AlignEngine (the -a/-A aligner modes; CSfxArrayV3::AlignReads
    progressive fall-through, SfxArrayV2.cpp:7663-7760).

    Reads unaccepted by the Hamming pass are re-seeded; their candidate
    diagonals feed the device indel/splice scans (align/splice_indel.py).
    """

    def __init__(self, engine: AlignEngine, micro_indel_len: int = 0,
                 splice_junct_len: int = 0, splice_cand_cap: int = 24):
        self.engine = engine
        self.micro_indel_len = min(micro_indel_len, 20)
        self.splice_junct_len = min(splice_junct_len, 100_000)
        self.splice_cand_cap = splice_cand_cap
        self._cand_jit = {}

    def _candidates(self, reads_d, lengths_d, dp, H, cand_cap, strand_rc,
                    uniform):
        key = (dp, H, cand_cap, strand_rc, uniform)
        fn = self._cand_jit.get(key)
        if fn is None:
            didx = self.engine.didx
            arrays = (didx.key_hi, didx.key_lo, didx.lut, didx.pos_rows,
                      didx.lut_bases, didx.max_bsearch_steps)

            def run(reads, lengths):
                seq = _rc_reads(reads, lengths, uniform) if strand_rc else reads
                loci, vmask, _, _ = _strand_candidates(
                    arrays, seq, dp, H, cand_cap, occ_skip=True)
                rcodes, rnlane = pack_reads(seq, lengths)
                return loci, vmask, rcodes, rnlane

            fn = jax.jit(run)
            self._cand_jit[key] = fn
        return fn(reads_d, lengths_d)

    def align(self, reads: np.ndarray, lengths: np.ndarray):
        eng = self.engine
        res = eng.align_with_rescue(reads, lengths)
        res["cigar_op"] = np.zeros(len(reads), dtype=np.int32)  # 0 = pure M
        res["op_len"] = np.zeros(len(reads), dtype=np.int32)
        res["split"] = np.zeros(len(reads), dtype=np.int32)
        if not (self.micro_indel_len or self.splice_junct_len):
            return res

        left = np.nonzero(~res["unique"] & ~res["any_hit"])[0]
        if len(left) == 0:
            return res
        sub_r, sub_l = pad_rows(reads[left], lengths[left])
        best = self.scan_rows(sub_r, sub_l)
        if best is None:
            return res
        acc = np.nonzero(best["ok"] & (best["score"] > -(1 << 20)))[0]
        acc = acc[acc < len(left)]  # drop pad rows
        gi = left[acc]
        res["unique"][gi] = True
        res["any_hit"][gi] = True
        res["locus"][gi] = best["locus"][acc]
        res["is_rc"][gi] = best["is_rc"][acc]
        res["best_mm"][gi] = np.minimum(best["mm"][acc], 255).astype(np.uint8)
        res["split"][gi] = best["split"][acc]
        res["cigar_op"][gi] = best["op"][acc]
        res["op_len"][gi] = best["gaplen"][acc]
        return res

    def scan_rows(self, sub_r: np.ndarray, sub_l: np.ndarray):
        """Indel/splice fall-through scans for one padded row block;
        returns the per-row best-candidate dict (or None) — shared by the
        single-index align() and the chunked driver."""
        from .splice_indel import indel_scan, splice_scan

        eng = self.engine
        B, L = sub_r.shape
        dp = eng.params.derive(int(L), eng.didx.ladder_len)
        didx = eng.didx
        pg = didx.packed
        uniform = bool(np.all(sub_l == L))

        # normalized candidate-result schema:
        #   ok, score, mm, split, locus, is_rc, op (signed indel or 1<<30
        #   splice marker), gaplen (splice N length)
        best = None
        for is_rc in (False, True):
            loci, vmask, rcodes, rnlane = self._candidates(
                jnp.asarray(sub_r), jnp.asarray(sub_l), dp,
                eng.params.cand_per_core, self.splice_cand_cap, is_rc,
                uniform,
            )
            outs = []
            if self.micro_indel_len:
                o = indel_scan(
                    pg.rows, pg.n_rows if pg.has_n else pg.rows, pg.has_n,
                    pg.length, didx.entry_starts, loci, vmask, rcodes,
                    rnlane, jnp.asarray(sub_l), L, self.micro_indel_len,
                )
                o = {k: np.asarray(v) for k, v in jax.device_get(o).items()}
                locus = np.take_along_axis(
                    np.asarray(loci), o["cand"][:, None], 1
                )[:, 0]
                outs.append({
                    "ok": o["ok"], "score": o["score"], "mm": o["mm"],
                    "split": o["split"], "locus": locus,
                    "op": o["indel"].astype(np.int64),
                    "gaplen": np.zeros(B, np.int64),
                })
            if self.splice_junct_len:
                o = splice_scan(
                    pg.rows, pg.n_rows if pg.has_n else pg.rows, pg.has_n,
                    pg.length, didx.entry_starts, loci, vmask, rcodes,
                    rnlane, jnp.asarray(sub_l), L, self.splice_junct_len,
                )
                o = {k: np.asarray(v) for k, v in jax.device_get(o).items()}
                outs.append({
                    "ok": o["ok"], "score": o["score"], "mm": o["mm"],
                    "split": o["split"], "locus": o["locus5"],
                    "op": np.full(B, 1 << 30, np.int64),
                    "gaplen": (o["locus3"] - o["locus5"]).astype(np.int64),
                })
            for o in outs:
                o["is_rc"] = np.full(B, is_rc)
                o["score"] = np.where(o["ok"], o["score"], -(1 << 20))
                if best is None:
                    best = o
                else:
                    better = o["score"] > best["score"]
                    best = {
                        k: np.where(better, o[k], best[k]) for k in best
                    }

        return best


def cigar_for(length: int, cigar_op: int, op_len: int, split: int) -> str:
    """CIGAR string from the extended-aligner encodings."""
    if cigar_op == 0:
        return f"{length}M"
    if cigar_op == 1 << 30:  # splice: N gap of op_len at split
        return f"{split}M{op_len}N{length - split}M"
    g = int(cigar_op)
    if g > 0:  # genome deletion
        return f"{split}M{g}D{length - split}M"
    j = -g     # read insertion
    return f"{split}M{j}I{length - split - j}M"


def pad_rows(reads: np.ndarray, lengths: np.ndarray, target: int | None = None):
    """Pad a read block to a power-of-two row count (min 64) with N-filled
    rows of length 0, so jit shapes come from a small bucket set."""
    B = reads.shape[0]
    if target is None:
        target = 64
        while target < B:
            target *= 2
    if B == target:
        return reads, lengths
    pr = np.full((target, reads.shape[1]), 4, dtype=reads.dtype)
    pr[:B] = reads
    pl = np.zeros(target, dtype=lengths.dtype)
    pl[:B] = lengths
    return pr, pl
