"""Long-read segment+stitch alignment (align/longread.py) — 100 Kbp
reads with substitutions through the main engine, matching the
reference's 256 Kbp envelope semantics (commdefs.h:158-161) and the
63-substitution total budget (Aligner.h:23).
"""
import numpy as np

from biokanga.align.longread import LongReadAligner
from biokanga.align.params import AlignParams
from biokanga.align.pipeline import AlignEngine
from biokanga.index.build import build_index
from biokanga.index.device import to_device
from biokanga.seq.encode import revcomp
from biokanga.sim.simreads import random_genome


def _engine(n=2_000_000, seed=5):
    seqs = random_genome([("chr1", n)], seed=seed)
    idx = build_index(seqs, lut_bases=10)
    return AlignEngine(to_device(idx), AlignParams()), seqs[0][1]


def test_100kbp_reads_with_subs():
    eng, g = _engine()
    rng = np.random.default_rng(3)
    L = 100_000
    B = 3
    reads = np.zeros((B, L), np.int8)
    starts = []
    for b in range(B):
        s = int(rng.integers(0, len(g) - L))
        starts.append(s)
        r = g[s : s + L].copy()
        mut = rng.choice(L, size=30, replace=False)   # 30 subs < 63 cap
        r[mut] = (r[mut] + rng.integers(1, 4, 30)) % 4
        reads[b] = r
    # read 2 reverse-complemented
    reads[2] = revcomp(reads[2])
    lengths = np.full(B, L, np.int32)
    lr = LongReadAligner(eng)
    out = lr.align(reads, lengths)
    assert out["unique"].all()
    assert out["locus"].tolist() == starts
    assert out["is_rc"].tolist() == [False, False, True]
    assert (out["best_mm"] == 30).all()


def test_budget_cap_rejects():
    # > 63 substitutions must be rejected (reference cMaxTotAllowedSubs)
    eng, g = _engine(n=500_000, seed=9)
    rng = np.random.default_rng(4)
    L = 20_000
    s = 1000
    r = g[s : s + L].copy()
    mut = rng.choice(L, size=120, replace=False)
    r[mut] = (r[mut] + rng.integers(1, 4, 120)) % 4
    out = LongReadAligner(eng).align(r[None, :], np.array([L], np.int32))
    assert not out["unique"][0]


def test_ragged_tail_segment():
    eng, g = _engine(n=500_000, seed=11)
    L = 5000 + 700   # non-multiple of SEG_LEN -> ragged tail
    s = 4321
    r = g[s : s + L].copy()
    out = LongReadAligner(eng).align(r[None, :], np.array([L], np.int32))
    assert out["unique"][0] and out["locus"][0] == s
    assert out["best_mm"][0] == 0
