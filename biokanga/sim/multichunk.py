"""A genome-range chunked index shaped like a 3 Gbp genome, with reads
planted at the geometry that chunking makes risky.

One entry of n_sp x chunk_bp real bases is cut into n_sp chunks, so
every internal cut lands mid-entry; the chunks' global bases are then
re-based onto 3 Gbp / n_sp strides so loci pass 2^31.  Planted reads:

  - one read spanning every chunk-overlap cut (ownership rule);
  - an identical 100-mer in chunk 0 and in the last chunk (cross-chunk
    multi-hit: inst / multi-hit loci merge);
  - an exact copy in chunk 0 with a 1-mismatch copy in the last chunk
    (cross-chunk best / next-best margin).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TOTAL_SHAPE = 3_000_000_000


@dataclass
class ChunkedProblem:
    ci: object                # index.chunked.ChunkedIndex, re-based
    reads: np.ndarray         # (n, 100) int8
    lengths: np.ndarray       # (n,) int32
    i_bnd: np.ndarray         # rows of the cut-spanning reads
    bnd_glob: list[int]       # their true global loci
    i_mh: int                 # cross-chunk multi-hit read
    mh_glob: tuple[int, int]  # its two global loci
    i_mg: int                 # cross-chunk margin read
    mg_glob: int              # its exact-copy global locus


def chunked_problem(n_sp: int, chunk_bp: int, n_reads: int,
                    pad_to: int = 1, lut_bases: int = 8) -> ChunkedProblem:
    from ..index.chunked import build_chunked_index
    from .simreads import random_genome, simulate_reads

    n_ch = max(n_sp, 2)
    stride = TOTAL_SHAPE // n_ch
    real_bp = chunk_bp * n_ch
    seqs = random_genome([("chr1", real_bp)], seed=7)
    g = seqs[0][1]
    rng = np.random.default_rng(5)
    motif_mh = rng.integers(0, 4, 100, np.int8)
    motif_mg = rng.integers(0, 4, 100, np.int8)
    p0, p1 = 1234, (n_ch - 1) * chunk_bp + 5000
    q0, q1 = 7777, (n_ch - 1) * chunk_bp + 9000
    g[p0: p0 + 100] = motif_mh
    g[p1: p1 + 100] = motif_mh
    g[q0: q0 + 100] = motif_mg
    g[q1: q1 + 100] = motif_mg
    g[q1 + 50] = (g[q1 + 50] + 1) % 4              # 1-mismatch copy

    ci = build_chunked_index(seqs, num_chunks=n_sp, overlap=512,
                             lut_bases=lut_bases)
    cuts = ci.bases.copy()                          # concat-coord cuts
    ci.bases = np.arange(n_sp, dtype=np.int64) * stride
    ci.entry_starts = np.array([0, TOTAL_SHAPE], dtype=np.int64)

    def glob(concat_pos: int) -> int:
        k = int(np.searchsorted(cuts, concat_pos, side="right") - 1)
        return int(ci.bases[k] + (concat_pos - cuts[k]))

    _, reads, _ = simulate_reads(seqs, n_reads, read_len=100,
                                 sub_rate=0.02, seed=3)
    planted = [g[c - 50: c + 50].copy() for c in cuts[1:]]
    planted += [motif_mh.copy(), motif_mg.copy()]
    reads = np.concatenate([reads, np.stack(planted)])
    pad = -len(reads) % pad_to
    if pad:
        reads = np.concatenate([reads, reads[:pad]])
    lengths = np.full(len(reads), 100, dtype=np.int32)
    first = len(reads) - pad - len(planted)
    nb = len(cuts) - 1
    return ChunkedProblem(
        ci=ci, reads=reads, lengths=lengths,
        i_bnd=first + np.arange(nb),
        bnd_glob=[glob(int(c) - 50) for c in cuts[1:]],
        i_mh=first + nb, mh_glob=(glob(p0), glob(p1)),
        i_mg=first + nb + 1, mg_glob=glob(q0),
    )


def check_planted(out: dict, prob: ChunkedProblem) -> None:
    """Check the planted reads' results; raises AssertionError (also
    under python -O)."""
    def need(ok, what):
        if not ok:
            raise AssertionError(what)

    for bi, want in zip(prob.i_bnd, prob.bnd_glob):
        need(out["unique"][bi], f"cut-spanning read {bi} not unique")
        need(int(out["locus"][bi]) == want, (out["locus"][bi], want))
    i = prob.i_mh
    need(not out["unique"][i] and int(out["inst"][i]) >= 2,
         "cross-chunk duplicate must multi-hit")
    ml = set(int(x) for x in out["ml_loci"][i] if x >= 0)
    need(set(prob.mh_glob) <= ml, (ml, prob.mh_glob))
    i = prob.i_mg
    need(out["unique"][i] and int(out["locus"][i]) == prob.mg_glob,
         "cross-chunk margin read: exact copy must win")
    need(int(out["best_mm"][i]) == 0 and int(out["next_mm"][i]) == 1,
         "cross-chunk margin read: next_mm must be 1")
