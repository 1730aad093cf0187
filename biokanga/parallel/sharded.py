"""Multi-chip sharded alignment over a jax.sharding.Mesh.

Batched replacement for the reference's two distribution mechanisms
(SURVEY.md §2.7): worker-thread read-batch parallelism (ThreadedIterReads,
biokanga/Aligner.cpp:9636) and the BKS TCP work-server RPC
(pacbiokanga/BKSRequester.cpp) become SPMD over a device mesh:

  mesh axes: ('dp', 'sp')
    dp — read batches data-parallel (the 128-thread pool analogue)
    sp — the GENOME sharded by RANGE: each sp shard holds one genome-range
         chunk (biokanga/index/chunked.py) — its slice's codes, packed
         rows, bounded-key SA and LUT — and runs the IDENTICAL single-chip
         align dataflow (align/pipeline.align_core) against its chunk.

Chunk ownership (alignment start < owned) makes per-shard candidate sets
disjoint, so the cross-shard merge is EXACT: all_gather the per-read
summaries (best/next/inst/locus/strand + the top-K multi-hit list) over
'sp' and reduce with the same lexicographic-min rules the host-side
sequential-chunk merge uses (parallel/chunked.merge_chunk_results) — a
few KB of interconnect traffic per batch replacing the reference's 64 MB BKS TCP
payloads.  Nothing is replicated: HBM per chip is one chunk + one dp read
block, so capacity scales linearly with n_sp (the >2^31-base path).

Global loci are (chunk, local int32) pairs on device; the host composes
int64 global coordinates (ShardedAligner.align).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..align.params import AlignParams
from ..align.pipeline import align_core, pad_rows
from ..index.chunked import ChunkedIndex, pad_chunk_arrays
from ..ops.extend import MM_INVALID
from ..ops.extend_packed import PackedGenome, pack_genome


def make_mesh(n_dp: int, n_sp: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= n_dp * n_sp
    return Mesh(devices[: n_dp * n_sp].reshape(n_dp, n_sp), ("dp", "sp"))


@dataclass
class ChunkShardedIndex:
    """One genome-range chunk resident per 'sp' shard (leading axis n_sp)."""

    genome: jax.Array        # (n_sp, pad_n) int8
    entry_starts: jax.Array  # (n_sp, pad_E+1) int32
    pos_rows: jax.Array      # (n_sp, R64, 64) int32
    key_hi: jax.Array        # (n_sp, pad_n) uint32
    key_lo: jax.Array        # (n_sp, pad_n) uint32
    lut: jax.Array           # (n_sp, 4^P+1) int32
    pk_rows: jax.Array       # (n_sp, R, 16) uint32 packed genome rows
    pk_nrows: jax.Array      # (n_sp, R, 16) uint32 N-plane rows
    owned: jax.Array         # (n_sp, 1) int32 ownership limits
    bases: np.ndarray        # (n_sp,) int64 global chunk offsets (host)
    slice_lens: np.ndarray   # (n_sp,) int64 real (unpadded) slice lengths
    entry_starts_global: np.ndarray  # (E+1,) int64 (host)
    entry_names: list[str]
    lut_bases: int
    max_bsearch_steps: int
    pad_n: int
    pk_len: int

    @property
    def n_sp(self) -> int:
        return self.genome.shape[0]

    @property
    def total_len(self) -> int:
        return int(self.entry_starts_global[-1])


def shard_chunked_index(ci: ChunkedIndex, mesh: Mesh) -> ChunkShardedIndex:
    """Stack per-chunk padded arrays along a leading axis sharded over 'sp'.

    ci.num_chunks must equal mesh 'sp' size (build with num_chunks=n_sp)."""
    from ..index.device import MAX_CAND_PER_CORE

    n_sp = mesh.shape["sp"]
    assert ci.num_chunks == n_sp, (
        f"chunk count {ci.num_chunks} != sp shards {n_sp}; build the index "
        "with build_chunked_index(..., num_chunks=n_sp)"
    )
    pad_n, pad_E, steps = ci.pad_shapes()

    g_l, es_l, pr_l, kh_l, kl_l, lut_l, pkr_l, pkn_l, own_l = (
        [], [], [], [], [], [], [], [], []
    )
    pk_len = None
    for k in range(n_sp):
        codes, es, pos, khi, klo, lut = pad_chunk_arrays(
            ci.chunks[k], pad_n, pad_E
        )
        pg = pack_genome(codes)
        assert pg.n_rows is not None  # pad N guarantees the plane
        pk_len = pg.length
        pos_padded = np.concatenate(
            [pos, np.zeros(MAX_CAND_PER_CORE, np.int32)]
        )
        n64 = len(pos_padded) // 64
        g_l.append(codes)
        es_l.append(es.astype(np.int32))
        pr_l.append(pos_padded[: n64 * 64].reshape(n64, 64))
        kh_l.append(khi)
        kl_l.append(klo)
        lut_l.append(lut)
        pkr_l.append(np.asarray(pg.rows))
        pkn_l.append(np.asarray(pg.n_rows))
        own_l.append([np.int32(ci.owned[k])])

    put = lambda a, spec: jax.device_put(
        np.stack(a), NamedSharding(mesh, spec)
    )
    return ChunkShardedIndex(
        genome=put(g_l, P("sp", None)),
        entry_starts=put(es_l, P("sp", None)),
        pos_rows=put(pr_l, P("sp", None, None)),
        key_hi=put(kh_l, P("sp", None)),
        key_lo=put(kl_l, P("sp", None)),
        lut=put(lut_l, P("sp", None)),
        pk_rows=put(pkr_l, P("sp", None, None)),
        pk_nrows=put(pkn_l, P("sp", None, None)),
        owned=put(own_l, P("sp", None)),
        bases=ci.bases.copy(),
        slice_lens=np.asarray([c.total_len for c in ci.chunks], np.int64),
        entry_starts_global=ci.entry_starts.copy(),
        entry_names=list(ci.entry_names),
        lut_bases=ci.chunks[0].lut_bases,
        max_bsearch_steps=steps,
        pad_n=pad_n,
        pk_len=pk_len,
    )


def _bind_index(mapped, mesh: Mesh, in_specs, sidx: ChunkShardedIndex):
    """step(reads, lengths): the jitted shard_map step called with the
    sharded index arrays as ARGUMENTS (closed-over device arrays would be
    embedded in the compiled program as constants, GBs at 100 Mbp
    chunks), its input shardings stated rather than inferred."""
    jitted = jax.jit(mapped, in_shardings=tuple(
        NamedSharding(mesh, spec) for spec in in_specs))

    def step(reads, lengths):
        return jitted(
            sidx.genome, sidx.entry_starts, sidx.pos_rows, sidx.key_hi,
            sidx.key_lo, sidx.lut, sidx.pk_rows, sidx.pk_nrows, sidx.owned,
            reads, lengths,
        )

    return step


def build_sharded_align_fn(
    mesh: Mesh,
    sidx: ChunkShardedIndex,
    params: AlignParams,
    dp_params,
    H: int,
    cand_cap: int | None = None,
    uniform: bool = True,
    occ_skip: bool = True,
):
    """Jitted SPMD align step: (reads (B, L) sharded over dp, lengths (B,))
    -> merged per-read result dict (replicated over sp, sharded over dp)
    with EXACT single-index semantics; loci come back as (chunk, local).
    """
    from jax import shard_map

    ap = params
    n_sp = sidx.n_sp
    lut_bases = sidx.lut_bases
    max_steps = sidx.max_bsearch_steps
    pk_len = sidx.pk_len
    Kml = max(1, ap.max_multi)

    def local_step(genome, entry_starts, pos_rows, key_hi, key_lo, lut,
                   pk_rows, pk_nrows, owned, reads, lengths):
        packed = PackedGenome(rows=pk_rows[0], n_rows=pk_nrows[0],
                              length=pk_len)
        res = align_core(
            genome[0], entry_starts[0], pos_rows[0], key_hi[0], key_lo[0],
            lut[0], reads, lengths, owned[0, 0], packed,
            ap=ap, dp=dp_params, H=H,
            cand_cap=cand_cap or ap.max_cand_per_strand,
            strand=ap.strand, uniform=uniform,
            lut_bases=lut_bases, max_steps=max_steps, occ_skip=occ_skip,
        )

        # ---- exact merge over 'sp' (device twin of
        # parallel/chunked.merge_chunk_results; see module docstring) ----
        g = lambda a: jax.lax.all_gather(a, "sp")
        best = g(res["best_mm"].astype(jnp.int32))       # (n_sp, B)
        nxt = g(res["next_mm"].astype(jnp.int32))
        inst = g(res["inst"])
        rc = g(res["is_rc"].astype(jnp.int32))
        loc = g(res["locus"])
        ovf = jnp.any(g(res["overflow"]), axis=0)
        # exactness composition mirrors the host merge: worst-chunk skip
        # count, any-chunk cap truncation
        n_over = jnp.max(g(res["n_over"]), axis=0)
        cap_trunc = jnp.any(g(res["cap_trunc"]), axis=0)

        okey = best * 2 + rc
        cur_key = okey[0]
        cur_loc = loc[0]
        kstar = jnp.zeros_like(cur_key)
        for k in range(1, n_sp):
            # chunk order IS global-locus order at equal (mm, strand):
            # strictly-less suffices (earlier chunk wins ties)
            better = okey[k] < cur_key
            kstar = jnp.where(better, k, kstar)
            cur_key = jnp.where(better, okey[k], cur_key)
            cur_loc = jnp.where(better, loc[k], cur_loc)
        b_star = cur_key >> 1
        is_best = best == b_star[None, :]
        inst_star = jnp.sum(jnp.where(is_best, inst, 0), axis=0)
        take = lambda a: jnp.take_along_axis(a, kstar[None, :], axis=0)[0]
        inst_star = jnp.where(b_star >= MM_INVALID, take(inst), inst_star)
        next_star = jnp.min(jnp.where(is_best, nxt, best), axis=0)
        next_star = jnp.where(inst_star >= 2, b_star, next_star)
        # canonical saturation at best + MMDelta — device twin of the
        # host merge (parallel/chunked.py merge_chunk_results)
        next_star = jnp.minimum(
            next_star, b_star + jnp.int32(ap.min_edit_dist))

        if ap.max_subs_per100 == 0:
            mtm = jnp.zeros_like(lengths)
        else:
            mtm = jnp.clip(
                jnp.floor(lengths * (ap.max_subs_per100 / 100.0) + 0.5
                          ).astype(jnp.int32), 1, 63)
        any_hit = b_star <= mtm
        unique = any_hit & ((next_star - b_star) >= jnp.int32(
            ap.min_edit_dist))

        # top-K multi-hit union: 3-key sort (mm*2+rc, chunk, local locus)
        mlk = g(res["ml_mm"].astype(jnp.int32) * 2
                + res["ml_rc"].astype(jnp.int32))        # (n_sp, B, Kml)
        mll = g(res["ml_loci"])
        B = reads.shape[0]
        chunk_ids = jnp.broadcast_to(
            jnp.arange(n_sp, dtype=jnp.int32)[:, None, None], mlk.shape
        )
        flat = lambda a: jnp.moveaxis(a, 1, 0).reshape(B, n_sp * Kml).T
        s_key, s_chunk, s_loc = jax.lax.sort(
            (flat(mlk), flat(chunk_ids), flat(mll)), dimension=0, num_keys=3
        )
        return {
            "unique": unique,
            "any_hit": any_hit,
            "best_mm": jnp.minimum(b_star, MM_INVALID).astype(jnp.uint8),
            "next_mm": jnp.minimum(next_star, MM_INVALID).astype(jnp.uint8),
            "inst": inst_star,
            "locus": cur_loc,
            "chunk": kstar,
            "is_rc": (cur_key & 1).astype(jnp.bool_),
            "overflow": ovf,
            "n_over": n_over,
            "cap_trunc": cap_trunc,
            "ml_loci": s_loc[:Kml].T,
            "ml_chunk": s_chunk[:Kml].T,
            "ml_mm": jnp.minimum(s_key[:Kml] >> 1, 255).astype(jnp.uint8).T,
            "ml_rc": (s_key[:Kml] & 1).astype(jnp.bool_).T,
        }

    vec = {"unique": P("dp"), "any_hit": P("dp"), "best_mm": P("dp"),
           "next_mm": P("dp"), "inst": P("dp"), "locus": P("dp"),
           "chunk": P("dp"), "is_rc": P("dp"), "overflow": P("dp"),
           "n_over": P("dp"), "cap_trunc": P("dp"),
           "ml_loci": P("dp", None), "ml_chunk": P("dp", None),
           "ml_mm": P("dp", None), "ml_rc": P("dp", None)}
    in_specs = (
        P("sp", None),          # genome
        P("sp", None),          # entry_starts
        P("sp", None, None),    # pos_rows
        P("sp", None),          # key_hi
        P("sp", None),          # key_lo
        P("sp", None),          # lut
        P("sp", None, None),    # pk_rows
        P("sp", None, None),    # pk_nrows
        P("sp", None),          # owned
        P("dp", None),          # reads
        P("dp"),                # lengths
    )
    mapped = shard_map(local_step, mesh=mesh, in_specs=in_specs,
                       out_specs=vec, check_vma=False)
    return _bind_index(mapped, mesh, in_specs, sidx)


def build_sharded_fallthrough_fn(
    mesh: Mesh,
    sidx: ChunkShardedIndex,
    params: AlignParams,
    dp_params,
    micro_indel_len: int,
    splice_junct_len: int,
    cand_cap: int = 24,
):
    """SPMD micro-indel/splice fall-through: every 'sp' shard scans the
    leftover reads against ITS resident chunk (align/splice_indel.py
    kernels on the shard-local packed rows), winners argmax-merge by
    score over 'sp' — the mesh realisation of the -a/-A AlignReads
    fall-through (SfxArrayV2.cpp:7663-7760).  Leftover rows are few, so
    reads replicate across the whole mesh for this pass."""
    from jax import shard_map

    from ..align.pipeline import _rc_reads, _strand_candidates
    from ..align.splice_indel import indel_scan, splice_scan
    from ..ops.extend_packed import pack_reads

    ap = params
    n_sp = sidx.n_sp
    lut_bases = sidx.lut_bases
    max_steps = sidx.max_bsearch_steps
    pk_len = sidx.pk_len
    NEG = jnp.int32(-(1 << 20))

    def local_step(genome, entry_starts, pos_rows, key_hi, key_lo, lut,
                   pk_rows, pk_nrows, owned, reads, lengths):
        arrays = (key_hi[0], key_lo[0], lut[0], pos_rows[0], lut_bases,
                  max_steps)
        B, L = reads.shape
        es = entry_starts[0]
        rows_pg = pk_rows[0]
        nrows_pg = pk_nrows[0]
        best = None
        for is_rc in (False, True):
            seq = _rc_reads(reads, lengths) if is_rc else reads
            # NO owned mask here: a junction's 3' segment may live in the
            # overlap tail; duplicate finds across shards merge by score
            # (earlier shard wins ties), matching the chunked driver
            loci, vmask, _, _ = _strand_candidates(
                arrays, seq, dp_params, ap.cand_per_core, cand_cap,
                occ_skip=True,
            )
            rcodes, rnlane = pack_reads(seq, lengths)
            outs = []
            if micro_indel_len:
                o = indel_scan(rows_pg, nrows_pg, True, pk_len, es, loci,
                               vmask, rcodes, rnlane, lengths, L,
                               micro_indel_len)
                locus = jnp.take_along_axis(loci, o["cand"][:, None],
                                            1)[:, 0]
                outs.append({
                    "ok": o["ok"], "score": o["score"], "mm": o["mm"],
                    "split": o["split"], "locus": locus,
                    "op": o["indel"].astype(jnp.int32),
                    "gaplen": jnp.zeros(B, jnp.int32),
                })
            if splice_junct_len:
                o = splice_scan(rows_pg, nrows_pg, True, pk_len, es, loci,
                                vmask, rcodes, rnlane, lengths, L,
                                splice_junct_len)
                outs.append({
                    "ok": o["ok"], "score": o["score"], "mm": o["mm"],
                    "split": o["split"], "locus": o["locus5"],
                    "op": jnp.full(B, 1 << 30, jnp.int32),
                    "gaplen": (o["locus3"] - o["locus5"]).astype(jnp.int32),
                })
            for o in outs:
                o["is_rc"] = jnp.full(B, is_rc, jnp.bool_)
                o["score"] = jnp.where(o["ok"], o["score"], NEG)
                if best is None:
                    best = o
                else:
                    better = o["score"] > best["score"]
                    best = {k: jnp.where(better, o[k], best[k])
                            for k in best}

        # merge over 'sp': winner shard by score (earlier shard at ties)
        g = lambda a: jax.lax.all_gather(a, "sp")
        scores = g(best["score"])                   # (n_sp, B)
        ks = jnp.argmax(scores, axis=0).astype(jnp.int32)
        take = lambda a: jnp.take_along_axis(g(a), ks[None, :], axis=0)[0]
        return {
            "ok": take(best["ok"].astype(jnp.int32)).astype(jnp.bool_)
            & (jnp.max(scores, axis=0) > NEG),
            "score": jnp.max(scores, axis=0),
            "mm": take(best["mm"]),
            "split": take(best["split"]),
            "locus": take(best["locus"]),
            "chunk": ks,
            "is_rc": take(best["is_rc"].astype(jnp.int32)).astype(
                jnp.bool_),
            "op": take(best["op"]),
            "gaplen": take(best["gaplen"]),
        }

    out_specs = {k: P() for k in ("ok", "score", "mm", "split", "locus",
                                  "chunk", "is_rc", "op", "gaplen")}
    in_specs = (
        P("sp", None), P("sp", None), P("sp", None, None),
        P("sp", None), P("sp", None), P("sp", None),
        P("sp", None, None), P("sp", None, None), P("sp", None),
        P(), P(),
    )
    mapped = shard_map(local_step, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    return _bind_index(mapped, mesh, in_specs, sidx)


def build_sharded_pileup_fn(mesh: Mesh, sidx: ChunkShardedIndex):
    """SPMD SNP pileup, chunk-sharded: each (dp, sp) device scatter-adds
    its dp block's accepted alignments THAT LIVE IN ITS CHUNK into local
    per-locus planes, then planes merge with a psum over 'dp' — the
    collective replacement for the reference's per-thread pileup merge
    (ProcessSNPs, Aligner.cpp:7609), with memory sharded over 'sp' (the
    tiled-pileup answer to full-genome (n,4) planes).

    Inputs (sharded over dp): chunk (B,), local loci (B,), aligned seqs
    (B, L), lengths (B,), accept (B,).  Output (sharded over sp):
    (n_sp, pad_n, 4) counts + (n_sp, pad_n) match/mismatch planes in LOCAL
    chunk coordinates; combine_pileup_planes folds them to global.
    """
    from jax import shard_map

    n = sidx.pad_n

    def local(genome, chunk, loci, seqs, lengths, accept):
        genome = genome[0]
        B, L = seqs.shape
        my = jax.lax.axis_index("sp").astype(jnp.int32)
        pos = loci[:, None] + jnp.arange(L, dtype=jnp.int32)
        live = (
            (accept & (chunk == my))[:, None]
            & (jnp.arange(L, dtype=jnp.int32)[None, :] < lengths[:, None])
            & (seqs < 4) & (pos >= 0) & (pos < n)
        )
        posc = jnp.clip(pos, 0, n - 1)
        base = jnp.clip(seqs, 0, 3).astype(jnp.int32)
        counts = jnp.zeros((n, 4), jnp.int32).at[
            posc.ravel(), base.ravel()
        ].add(live.ravel().astype(jnp.int32))
        ref = genome[posc]
        is_mm = (base != ref) & live
        match = jnp.zeros(n, jnp.int32).at[posc.ravel()].add(
            (live & ~is_mm).ravel().astype(jnp.int32)
        )
        mismatch = jnp.zeros(n, jnp.int32).at[posc.ravel()].add(
            is_mm.ravel().astype(jnp.int32)
        )
        counts = jax.lax.psum(counts, "dp")
        match = jax.lax.psum(match, "dp")
        mismatch = jax.lax.psum(mismatch, "dp")
        return counts[None], match[None], mismatch[None]

    mapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("sp", None), P("dp"), P("dp"), P("dp", None), P("dp"),
                  P("dp")),
        out_specs=(P("sp", None, None), P("sp", None), P("sp", None)),
        check_vma=False,
    )

    jitted = jax.jit(mapped)

    def step(chunk, loci, seqs, lengths, accept):
        return jitted(sidx.genome, chunk, loci, seqs, lengths, accept)

    return step


def combine_pileup_planes(planes: np.ndarray, sidx: ChunkShardedIndex):
    """Fold per-chunk local pileup planes ((n_sp, pad_n, ...) host array)
    into one global array ((total, ...)).  Overlap-tail contributions (an
    accepted alignment's window extending past its chunk's owned range)
    land at the same global coordinates as the next chunk's head — plain
    addition is exact because every aligned base is recorded exactly once,
    in the chunk that accepted its alignment."""
    total = sidx.total_len
    out = np.zeros((total,) + planes.shape[2:], planes.dtype)
    for k in range(planes.shape[0]):
        b = int(sidx.bases[k])
        sl = int(min(sidx.slice_lens[k], total - b))
        out[b : b + sl] += planes[k, :sl]
    return out


class ShardedAligner:
    """Host driver for the SPMD step: batches, the overflow rescue pass,
    and int64 global-locus composition — mirrors AlignEngine.align_with_rescue
    so multi-chip results equal the single-chip engine's exactly."""

    def __init__(self, mesh: Mesh, ci: ChunkedIndex,
                 params: AlignParams | None = None):
        self.mesh = mesh
        self.params = params or AlignParams()
        self.sidx = shard_chunked_index(ci, mesh)
        self._fns = {}

    def _fn(self, L: int, H: int, cand_cap: int, uniform: bool,
            occ_skip: bool = True):
        key = (L, H, cand_cap, uniform, occ_skip)
        if key not in self._fns:
            dp = self.params.derive(L, self.sidx.total_len)
            self._fns[key] = (
                build_sharded_align_fn(
                    self.mesh, self.sidx, self.params, dp, H,
                    cand_cap=cand_cap, uniform=uniform, occ_skip=occ_skip,
                ),
                dp,
            )
        return self._fns[key]

    def _run(self, reads, lengths, H, cand_cap, occ_skip: bool = True):
        B, L = reads.shape
        uniform = bool(np.all(lengths == L))
        fn, dp = self._fn(int(L), int(H), int(cand_cap), uniform, occ_skip)
        out = fn(jnp.asarray(reads), jnp.asarray(lengths))
        # np.array (copy): device_get views are read-only and the rescue/
        # fall-through passes mutate these in place
        res = {k: np.array(v) for k, v in jax.device_get(out).items()}
        res["derived"] = dp
        return res

    def align(self, reads: np.ndarray, lengths: np.ndarray) -> dict:
        ap = self.params
        res = self._run(reads, lengths, ap.cand_per_core,
                        ap.max_cand_per_strand)
        from ..align.pipeline import rescue_ladder

        rescue_ladder(
            lambda r, l, H, cap, skip: self._run(r, l, H, cap, skip),
            reads, lengths, res, ap, extra_keys=("chunk", "ml_chunk"),
        )
        # compose int64 global loci from (chunk, local)
        bases = self.sidx.bases
        res["locus"] = bases[res["chunk"]] + res["locus"].astype(np.int64)
        ml = res["ml_loci"].astype(np.int64)
        res["ml_loci"] = np.where(
            ml >= 0, bases[res["ml_chunk"]] + ml, -1)
        return res

    def align_extended(self, reads: np.ndarray, lengths: np.ndarray,
                       micro_indel_len: int = 0,
                       splice_junct_len: int = 0) -> dict:
        """align() + the SPMD micro-indel/splice fall-through for reads
        the Hamming pass could not accept (-a/-A on the mesh)."""
        res = self.align(reads, lengths)
        B = len(reads)
        res["cigar_op"] = np.zeros(B, np.int64)
        res["op_len"] = np.zeros(B, np.int64)
        res["split"] = np.zeros(B, np.int32)
        if not (micro_indel_len or splice_junct_len):
            return res
        left = np.nonzero(~res["unique"] & ~res["any_hit"])[0]
        if len(left) == 0:
            return res
        from ..align.pipeline import pad_rows

        sub_r, sub_l = pad_rows(reads[left], lengths[left])
        key = (sub_r.shape[1], micro_indel_len, splice_junct_len,
               "fallthrough")
        if key not in self._fns:
            dp = self.params.derive(int(sub_r.shape[1]),
                                    self.sidx.total_len)
            self._fns[key] = (
                build_sharded_fallthrough_fn(
                    self.mesh, self.sidx, self.params, dp,
                    micro_indel_len, splice_junct_len,
                ),
                dp,
            )
        fn, _ = self._fns[key]
        out = {k: np.asarray(v) for k, v in jax.device_get(
            fn(jnp.asarray(sub_r), jnp.asarray(sub_l))).items()}
        acc = np.nonzero(out["ok"])[0]
        acc = acc[acc < len(left)]
        gi = left[acc]
        res["unique"][gi] = True
        res["any_hit"][gi] = True
        res["locus"][gi] = (self.sidx.bases[out["chunk"][acc]]
                            + out["locus"][acc].astype(np.int64))
        res["is_rc"][gi] = out["is_rc"][acc]
        res["best_mm"][gi] = np.minimum(out["mm"][acc], 255).astype(
            np.uint8)
        res["split"][gi] = out["split"][acc]
        res["cigar_op"][gi] = out["op"][acc]
        res["op_len"][gi] = out["gaplen"][acc]
        return res
