"""Micro-indel and splice-junction alignment passes.

Capability match for CSfxArrayV3::LocateInDels / LocateSpliceJuncts
(libbiokanga/SfxArrayV2.cpp:7348,7022), run for reads the pure-Hamming
pass could not accept (the reference's AlignReads falls through the same
way, SfxArrayV2.cpp:7663-7760).  Reference rules reproduced
(SfxArrayV2.h:18-40):

- micro-indels: length 1..20 (cMaxMicroInDelLen), at most 2 total
  mismatches (cMaxMicroInDelMM), both segments >= 7 (cMinInDelSeqLen)
- splice junctions: segment separation 25..100000
  (cMinJunctAlignSep/cMaxJunctAlignSep), at most 2 mismatches
  (cMaxJunctAlignMM), both segments >= 10 (cMinJunctSegLen)
- scoring: base 500 (clamped 1000), match +3, mismatch -5, indel open
  -20 extend -1, splice separation -10/Kbp, canonical GT..AG donor/
  acceptor +50 (cSpliceDonorAccept)

Design: per candidate ONE packed-row gather covers the whole shifted
window family (shifts <= 20 < the 128-base row margin); per-position
mismatch indicators come from unpacking XOR lanes; best split points are
cumulative-sum minimisations — indels minimise over (split, shift),
splices minimise a min-plus product pairing candidate diagonals.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.extend_packed import (
    BASES_PER_WORD,
    PackedGenome,
    gather_window_words,
    pack_reads,
)

C_MAX_MICRO_INDEL_LEN = 20
C_MAX_MICRO_INDEL_MM = 2
C_MIN_INDEL_SEG_LEN = 7
C_MIN_JUNCT_SEP = 25
C_MAX_JUNCT_SEP = 100_000
C_MAX_JUNCT_MM = 2
C_MIN_JUNCT_SEG_LEN = 10

C_BASE_SCORE = 500
C_MAX_SCORE = 1000
C_SCORE_MATCH = 3
C_SCORE_MISMATCH = 5
C_SPLICE_DONOR_ACCEPT = 50
C_SPLICE_LEN = 10           # per Kbp separation
C_SCORE_INDEL_OPN = 20
C_SCORE_INDEL_EXTN = 1

_BIG = jnp.int32(1 << 20)


def _mismatch_indicators(pg: PackedGenome, loci, rcodes, rnlane, L, shift):
    """(B, C, L) int32 mismatch indicators of read vs genome at
    locus + position + shift. loci: (B, C)."""
    W = rcodes.shape[-1]
    eff = loci + shift
    win = gather_window_words(pg.rows, eff, W)
    x = win ^ rcodes[:, None, :]
    x = x | rnlane[:, None, :]
    if pg.n_rows is not None:
        x = x | gather_window_words(pg.n_rows, eff, W)
    lanes = (x | (x >> 1)) & jnp.uint32(0x55555555)
    # unpack per-position bits: lane t (MSB-first) at bit 2*(15-t)
    t = jnp.arange(BASES_PER_WORD, dtype=jnp.uint32)
    bits = (lanes[..., None] >> (jnp.uint32(2) * (jnp.uint32(15) - t))) & 1
    ind = bits.reshape(bits.shape[:-2] + (W * BASES_PER_WORD,))
    return ind[..., :L].astype(jnp.int32)


@partial(jax.jit, static_argnames=("L", "max_indel", "has_n", "genome_len"))
def indel_scan(
    rows_pg, n_rows_pg, has_n: bool, genome_len: int,
    entry_starts, loci, valid, rcodes, rnlane, lengths,
    L: int, max_indel: int,
):
    """Best micro-indel alignment per read over all candidates.

    Returns per-read: ok, locus, score, mm, split, indel (signed: >0 =
    deletion from read's perspective (genome gap), <0 = insertion),
    candidate index.
    """
    pg = PackedGenome(rows=rows_pg, n_rows=n_rows_pg if has_n else None,
                      length=genome_len)
    B, C = loci.shape
    starts32 = entry_starts.astype(jnp.int32)

    # window must fit within entry for the largest genome footprint
    endmost = loci + lengths[:, None] + max_indel - 1
    ent_a = jnp.searchsorted(starts32, loci, side="right") - 1
    ent_b = jnp.searchsorted(starts32, endmost, side="right") - 1
    valid = valid & (loci >= 0) & (endmost < genome_len) & (ent_a == ent_b)

    ind0 = _mismatch_indicators(pg, loci, rcodes, rnlane, L, 0)
    live = (jnp.arange(L, dtype=jnp.int32)[None, :] < lengths[:, None])
    P = jnp.cumsum(jnp.where(live[:, None, :], ind0, 0), axis=-1)  # incl. pos
    P = jnp.concatenate([jnp.zeros((B, C, 1), jnp.int32), P], axis=-1)

    best = {
        "mm": jnp.full((B,), _BIG, jnp.int32),
        "score": jnp.full((B,), -_BIG, jnp.int32),
        "split": jnp.zeros((B,), jnp.int32),
        "indel": jnp.zeros((B,), jnp.int32),
        "cand": jnp.zeros((B,), jnp.int32),
    }

    s_idx = jnp.arange(L + 1, dtype=jnp.int32)[None, None, :]
    slen = lengths[:, None, None]

    def consider(best, g):
        """g > 0: genome deletion of g; g < 0: read insertion of |g|."""
        shift = jnp.where(g > 0, g, 0)
        # suffix indicators: read[l] vs genome[locus + l + g]
        indg = _mismatch_indicators(pg, loci, rcodes, rnlane, L, g)
        Cg = jnp.cumsum(jnp.where(live[:, None, :], indg, 0), axis=-1)
        Cg = jnp.concatenate([jnp.zeros((B, C, 1), jnp.int32), Cg], axis=-1)
        Tg = Cg[..., -1:]
        j = jnp.where(g < 0, -g, 0)
        # suffix starts at read index s + j
        sfrom = jnp.minimum(s_idx + j, L)
        suf = Tg - jnp.take_along_axis(Cg, sfrom, axis=-1)
        mm_sg = P[..., : L + 1] + suf          # (B, C, L+1) over split s
        seg5 = s_idx
        seg3 = slen - s_idx - j
        okseg = (seg5 >= C_MIN_INDEL_SEG_LEN) & (seg3 >= C_MIN_INDEL_SEG_LEN)
        mm_sg = jnp.where(okseg & valid[..., None], mm_sg, _BIG)
        mmc = jnp.min(mm_sg, axis=-1)          # (B, C)
        sc_split = jnp.argmin(mm_sg, axis=-1).astype(jnp.int32)
        glen = jnp.abs(g)
        score = (
            C_BASE_SCORE
            + (lengths[:, None] - jnp.where(g < 0, glen, 0) - mmc)
            * C_SCORE_MATCH
            - mmc * C_SCORE_MISMATCH
            - C_SCORE_INDEL_OPN
            - (glen - 1) * C_SCORE_INDEL_EXTN
        )
        score = jnp.minimum(score, C_MAX_SCORE)
        score = jnp.where(mmc <= C_MAX_MICRO_INDEL_MM, score, -_BIG)
        bi = jnp.argmax(score, axis=-1).astype(jnp.int32)  # best candidate
        row = lambda a: jnp.take_along_axis(a, bi[:, None], axis=1)[:, 0]
        sc = row(score)
        better = sc > best["score"]
        upd = lambda k, v: jnp.where(better, v, best[k])
        return {
            "mm": upd("mm", row(mmc)),
            "score": upd("score", sc),
            "split": upd("split", row(sc_split)),
            "indel": upd("indel", jnp.full((B,), g, jnp.int32)),
            "cand": upd("cand", bi),
        }

    for g in range(1, max_indel + 1):
        best = consider(best, g)
        best = consider(best, -g)

    ok = best["score"] > -_BIG
    return {**best, "ok": ok}


@partial(jax.jit, static_argnames=("L", "max_sep", "has_n", "genome_len"))
def splice_scan(
    rows_pg, n_rows_pg, has_n: bool, genome_len: int,
    entry_starts, loci, valid, rcodes, rnlane, lengths,
    L: int, max_sep: int,
):
    """Best spliced (two-segment) alignment per read: pair candidate
    diagonals (d5, d3) with separation in [25, max_sep], minimise
    prefix(d5) + suffix(d3) mismatches over the split point.

    Returns per-read: ok, locus5, locus3, split, mm, score.
    """
    pg = PackedGenome(rows=rows_pg, n_rows=n_rows_pg if has_n else None,
                      length=genome_len)
    B, C = loci.shape
    starts32 = entry_starts.astype(jnp.int32)
    last = loci + lengths[:, None] - 1
    ent_a = jnp.searchsorted(starts32, loci, side="right") - 1
    ent_b = jnp.searchsorted(starts32, last, side="right") - 1
    valid = valid & (loci >= 0) & (last < genome_len) & (ent_a == ent_b)

    ind = _mismatch_indicators(pg, loci, rcodes, rnlane, L, 0)
    live = (jnp.arange(L, dtype=jnp.int32)[None, :] < lengths[:, None])
    Cm = jnp.cumsum(jnp.where(live[:, None, :], ind, 0), axis=-1)
    Cm = jnp.concatenate([jnp.zeros((B, C, 1), jnp.int32), Cm], axis=-1)
    T = Cm[..., -1]

    s_idx = jnp.arange(L + 1, dtype=jnp.int32)
    okseg = (
        (s_idx[None, :] >= C_MIN_JUNCT_SEG_LEN)
        & (lengths[:, None] - s_idx[None, :] >= C_MIN_JUNCT_SEG_LEN)
    )  # (B, L+1)

    # pairwise: A[c5, c3] = min_s prefix[c5, s] + (T[c3] - C[c3, s])
    pref = jnp.where(valid[..., None] & okseg[:, None, :], Cm, _BIG)
    sufc = jnp.where(valid[..., None] & okseg[:, None, :], -Cm, _BIG)
    # D[b, c5, c3] = min_s pref[b, c5, s] + sufc[b, c3, s]
    D = jnp.min(pref[:, :, None, :] + sufc[:, None, :, :], axis=-1)
    # among equal-mismatch splits take the RIGHTMOST (maximal 5' exon) —
    # the reference's junction canonicalisation when flanking bases make
    # the split ambiguous (LocateSpliceJuncts, SfxArrayV2.cpp:7022;
    # measured: its SAM places every ambiguous junction at max split)
    Ssplit = (jnp.int32(L) - jnp.argmin(
        (pref[:, :, None, :] + sufc[:, None, :, :])[..., ::-1], axis=-1
    )).astype(jnp.int32)
    mm_pair = D + T[:, None, :]

    sep = loci[:, None, :] - loci[:, :, None]   # d3 - d5
    ok_pair = (
        (sep >= C_MIN_JUNCT_SEP) & (sep <= max_sep)
        & valid[:, :, None] & valid[:, None, :]
        & (mm_pair <= C_MAX_JUNCT_MM)
    )
    score = (
        C_BASE_SCORE
        + (lengths[:, None, None] - mm_pair) * C_SCORE_MATCH
        - mm_pair * C_SCORE_MISMATCH
        - (sep // 1000) * C_SPLICE_LEN
    )
    score = jnp.minimum(score, C_MAX_SCORE)
    score = jnp.where(ok_pair, score, -_BIG)
    flat = score.reshape(B, C * C)
    bi = jnp.argmax(flat, axis=-1).astype(jnp.int32)
    c5 = bi // C
    c3 = bi % C
    take = lambda a, i: jnp.take_along_axis(a, i[:, None], axis=1)[:, 0]
    sc = take(flat, bi)
    locus5 = take(loci, c5)
    locus3 = take(loci, c3)
    split = jnp.take_along_axis(
        Ssplit.reshape(B, C * C), bi[:, None], axis=1
    )[:, 0]
    mm = take(mm_pair.reshape(B, C * C), bi)
    # canonical GT..AG bonus: donor = genome[locus5+split .. +2],
    # acceptor = genome[locus3+split-2 .. split) — checked via small gathers
    return {
        "ok": sc > -_BIG,
        "score": sc,
        "locus5": locus5,
        "locus3": locus3,
        "split": split,
        "mm": mm,
    }
