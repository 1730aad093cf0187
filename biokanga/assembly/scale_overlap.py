"""Genome-scale suffix-prefix overlap discovery (device-batched).

The round-2 assembler (assembly/overlap.py) verified candidates with
per-candidate HOST loops — fine at 10^3 sequences, hopeless at the 10^6
reads of a real readset (the reference assembles multi-Mbp readsets via
its packed sparse index, CKangadna::GenRdsSfx biokanga/Kangadna.cpp:6391,
CdeNovoAssemb::BuildOverlapExtensions deNovoAssemb.cpp:939).

Batched re-design — everything per-pass is array work:
  1. concatenate the CURRENT sequence set into one "genome" whose entries
     are the sequences; suffix-index it on device
     (index/device_build.device_build_index — only int8 codes cross the
     host link)
  2. queries = every sequence in both orientations, k-mers at a few
     prefix anchor offsets; one batched range-lookup + candidate
     diagonal-dedup (the aligner's own _strand_candidates)
  3. a candidate diagonal d implies target entry e, shift = d - start[e],
     overlap ov = len[e] - shift; verify by counting mismatches over the
     first ov query bases with ONE packed-row gather per candidate
     (ops/extend_packed.hamming_extend_packed_win)
  4. winner selection happens ON DEVICE: per-target scatter-max of a
     packed (overlap, query) score, then a RECOMPUTED tie-count sweep, so
     only O(n_seqs) winner arrays ever cross the host link — candidate
     edge lists (10^7-10^8 rows) never do, and no per-batch tensors are
     retained between sweeps.

Both ORIENTATIONS of every sequence are indexed as targets (entries
0..n-1 fwd, n..2n-1 rc), so the overlap graph is properly bidirected: a
dovetail whose left piece is stored reverse-complemented is found as a
right-extension of that piece's rc target.  (Forward-only targets stall
end-game merges whenever stored orientations clash at a junction.)

Greedy-merge semantics match assembly/assemble.one_pass: a target merges
with its single best (longest-overlap) right extension; a tie on overlap
length disqualifies the target; an extension source may attach to only
one target.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..align.params import DerivedParams
from ..align.pipeline import _strand_candidates
from ..index.device_build import device_build_index
from ..ops.extend_packed import (
    BASES_PER_WORD,
    PackedGenome,
    hamming_extend_packed_win,
    pack_reads,
)
from ..seq.encode import revcomp

# queries are verified over at most this prefix window; dovetails longer
# than this (giant contig-contig overlaps) are rejected conservatively
VERIFY_CAP = 4096
_BIG = np.int32(1) << 30


@dataclass
class PassEdges:
    """Per-target winning right-extension (host arrays, length n_seqs).

    win_q >= n encodes the reverse-complement orientation of query
    (win_q - n).  ambiguous targets (a tie at the best overlap, or an
    overlap at the score-packing cap) must not be merged."""
    win_q: np.ndarray
    win_ov: np.ndarray
    win_subs: np.ndarray
    ambiguous: np.ndarray


@partial(jax.jit, static_argnames=("H", "cap", "shift_bits", "offsets",
                                   "core_len", "n_total", "has_n", "phase",
                                   "lut_bases", "max_steps"))
def _sweep_batch(key_hi, key_lo, lut, pos_rows,
                 pk_rows, pk_nrows, starts32, lens32,
                 qseq, qlen, qid0, min_ov, sub_per100,
                 best, tie_cnt, win_subs,
                 *, H: int, cap: int, shift_bits: int, offsets,
                 core_len: int, n_total: int, has_n: bool, phase: str,
                 lut_bases: int, max_steps: int):
    """One query batch through candidates -> verify -> scatter.

    phase='max': scatter-max packed (ov << shift_bits | qid) into best.
    phase='tie': recompute and count candidates whose ov equals the
    winner's, recording the minimum substitution count among them."""
    dp = DerivedParams(read_len=int(qseq.shape[1]), max_tot_mm=0,
                       core_len=core_len, core_delta=core_len,
                       max_slides=len(offsets), offsets=tuple(offsets))
    arrays = (key_hi, key_lo, lut, pos_rows, lut_bases, max_steps)
    diag, valid, _n_over, _trunc = _strand_candidates(arrays, qseq, dp, H,
                                                      cap)
    ent = jnp.searchsorted(starts32, diag, side="right") - 1
    entc = jnp.clip(ent, 0, lens32.shape[0] - 1)
    shift = diag - starts32[entc]
    ov = lens32[entc] - shift
    ovc = jnp.clip(ov, 0, VERIFY_CAP)
    pg = PackedGenome(rows=pk_rows, n_rows=pk_nrows if has_n else None,
                      length=n_total)
    rcodes, rnlane = pack_reads(qseq, qlen)
    mm = hamming_extend_packed_win(pg, starts32, diag, valid, rcodes,
                                   rnlane, ovc)
    budget = (ovc * sub_per100) // 100
    n_half = lens32.shape[0] // 2          # physical sequence count
    base_t = jnp.where(entc >= n_half, entc - n_half, entc)
    qid_col = qid0 + jnp.arange(qseq.shape[0], dtype=jnp.int32)[:, None]
    base_q = jnp.where(qid_col >= n_half, qid_col - n_half, qid_col)
    acc = (
        valid
        & (shift >= 0)
        & (ov >= min_ov)
        & (ov < qlen[:, None])
        & (ov <= VERIFY_CAP)
        & (mm <= budget)
        & (base_t != base_q)               # no self / fold-back joins
    )
    ov_cap = (np.int32(2**31 - 1) >> shift_bits).astype(np.int32)
    ovs = jnp.minimum(ov, ov_cap)
    qid = qid_col
    tid = jnp.where(acc, entc, 0)
    if phase == "max":
        score = (ovs << shift_bits) | qid
        best = best.at[tid.ravel()].max(
            jnp.where(acc, score, -1).ravel()
        )
        return best, tie_cnt, win_subs
    b_ov = best[tid] >> shift_bits
    is_tie = acc & (ovs == b_ov)
    t0 = jnp.where(is_tie, tid, 0)
    tie_cnt = tie_cnt.at[t0.ravel()].add(is_tie.ravel().astype(jnp.int32))
    win_subs = win_subs.at[t0.ravel()].min(
        jnp.where(is_tie, mm, _BIG).ravel()
    )
    return best, tie_cnt, win_subs


def best_right_extensions(
    seqs: list[np.ndarray],
    min_overlap: int,
    max_subs_per_100: float = 1.0,
    k: int = 16,
    anchors: tuple = (0, 8, 16, 32),
    H: int = 32,
    batch: int = 4096,
    lut_bases: int = 12,
) -> PassEdges:
    """One pass of device-batched overlap discovery over the whole
    sequence set.  Targets AND queries are both orientations; returned
    winner arrays have length 2n (oriented targets: t < n fwd, t >= n
    rc), with win_q likewise oriented."""
    n = len(seqs)
    lens1 = np.fromiter((len(s) for s in seqs), np.int64, n)
    lens = np.concatenate([lens1, lens1])
    starts = np.zeros(2 * n + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    rc_full = [revcomp(s) for s in seqs]
    concat = (np.concatenate(seqs + rc_full) if n
              else np.zeros(0, np.int8))
    didx = device_build_index(concat.astype(np.int8), starts,
                              lut_bases=lut_bases)
    starts32 = jnp.asarray(starts.astype(np.int32))
    lens32 = jnp.asarray(lens.astype(np.int32))

    Lq = int(min(max(int(lens1.max()), k + max(anchors)), VERIFY_CAP))
    Lq = ((Lq + BASES_PER_WORD - 1) // BASES_PER_WORD) * BASES_PER_WORD
    nq = 2 * n
    shift_bits = max(1, int(np.ceil(np.log2(nq + 1))))
    offs = tuple(o for o in anchors if o + k <= Lq)
    cap = min(2 * H * len(offs), 192)

    rc_cache = [r[:Lq] for r in rc_full]

    def batches():
        for orient in (0, 1):
            src = seqs if orient == 0 else rc_cache
            for b0 in range(0, n, batch):
                nb = min(batch, n - b0)
                q = np.full((batch, Lq), 4, np.int8)
                ql = np.zeros(batch, np.int32)
                for j in range(nb):
                    s = src[b0 + j]
                    m = min(len(s), Lq)
                    q[j, :m] = s[:m]
                    ql[j] = m
                yield orient * n + b0, jnp.asarray(q), jnp.asarray(ql)

    common = dict(H=H, cap=cap, shift_bits=shift_bits, offsets=offs,
                  core_len=k, n_total=didx.packed.length,
                  has_n=didx.packed.has_n, lut_bases=int(didx.lut_bases),
                  max_steps=int(didx.max_bsearch_steps))
    args = (didx.key_hi, didx.key_lo, didx.lut, didx.pos_rows,
            didx.packed.rows,
            didx.packed.n_rows if didx.packed.has_n else didx.packed.rows,
            starts32, lens32)

    best = jnp.full(2 * n, -1, jnp.int32)
    tie_cnt = jnp.zeros(2 * n, jnp.int32)
    win_subs = jnp.full(2 * n, _BIG, jnp.int32)
    for phase in ("max", "tie"):
        for qid0, q, ql in batches():
            best, tie_cnt, win_subs = _sweep_batch(
                *args, q, ql, jnp.int32(qid0), jnp.int32(min_overlap),
                jnp.int32(round(max_subs_per_100)),
                best, tie_cnt, win_subs, phase=phase, **common,
            )

    best_h = np.asarray(best)
    tie_h = np.asarray(tie_cnt)
    subs_h = np.asarray(win_subs)
    has = best_h >= 0
    mask = (1 << shift_bits) - 1
    win_ov = np.where(has, best_h >> shift_bits, 0).astype(np.int64)
    ov_cap = (2**31 - 1) >> shift_bits
    return PassEdges(
        win_q=np.where(has, best_h & mask, -1).astype(np.int64),
        win_ov=win_ov,
        win_subs=np.where(has, subs_h, 0).astype(np.int64),
        # a capped score cannot prove the true longest overlap -> treat
        # as ambiguous (only reachable for >=2^(31-shift_bits)-base
        # dovetails, i.e. never for read-length sequences)
        ambiguous=(tie_h > 1) | (has & (win_ov >= ov_cap)),
    )
