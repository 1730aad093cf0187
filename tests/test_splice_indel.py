"""Micro-indel and splice-junction pass tests."""
import numpy as np
import pytest

from biokanga.align.params import AlignParams
from biokanga.align.pipeline import AlignEngine, ExtendedAligner, cigar_for
from biokanga.index.build import build_index
from biokanga.index.device import to_device
from biokanga.seq.encode import revcomp
from biokanga.sim.simreads import random_genome


@pytest.fixture(scope="module")
def setup():
    seqs = random_genome([("c1", 60000)], seed=91)
    idx = build_index(seqs, lut_bases=8)
    engine = AlignEngine(to_device(idx), AlignParams())
    return seqs, idx, engine


def _reads_with_deletion(g, rng, n, L=100, del_len=6):
    """Reads sampled so the read SKIPS del_len genome bases mid-read
    (genome deletion relative to read => CIGAR D)."""
    reads, starts, splits = [], [], []
    for _ in range(n):
        p = int(rng.integers(100, len(g) - 200))
        s = int(rng.integers(20, L - 20))
        r = np.concatenate([g[p : p + s], g[p + s + del_len : p + s + del_len + (L - s)]])
        reads.append(r)
        starts.append(p)
        splits.append(s)
    return np.stack(reads).astype(np.int8), starts, splits


def _reads_with_insertion(g, rng, n, L=100, ins_len=5):
    reads, starts = [], []
    for _ in range(n):
        p = int(rng.integers(100, len(g) - 200))
        s = int(rng.integers(20, L - 30))
        ins = rng.integers(0, 4, size=ins_len).astype(np.int8)
        r = np.concatenate([g[p : p + s], ins, g[p + s : p + s + (L - s - ins_len)]])
        reads.append(r)
        starts.append(p)
    return np.stack(reads).astype(np.int8), starts


def test_micro_deletion(setup):
    seqs, idx, engine = setup
    g = seqs[0][1]
    rng = np.random.default_rng(2)
    reads, starts, splits = _reads_with_deletion(g, rng, 24, del_len=6)
    lengths = np.full(len(reads), 100, dtype=np.int32)
    ext = ExtendedAligner(engine, micro_indel_len=10)
    res = ext.align(reads, lengths)
    ok = 0
    for i, p in enumerate(starts):
        if res["unique"][i] and res["cigar_op"][i] == 6:
            assert int(res["locus"][i]) == p
            ok += 1
    assert ok >= 20, f"only {ok}/24 deletions recovered"


def test_micro_insertion(setup):
    seqs, idx, engine = setup
    g = seqs[0][1]
    rng = np.random.default_rng(3)
    reads, starts = _reads_with_insertion(g, rng, 24, ins_len=5)
    lengths = np.full(len(reads), 100, dtype=np.int32)
    ext = ExtendedAligner(engine, micro_indel_len=10)
    res = ext.align(reads, lengths)
    ok = 0
    for i, p in enumerate(starts):
        if res["unique"][i] and res["cigar_op"][i] == -5:
            assert int(res["locus"][i]) == p
            ok += 1
    assert ok >= 20, f"only {ok}/24 insertions recovered"


def test_splice_junction(setup):
    seqs, idx, engine = setup
    g = seqs[0][1]
    rng = np.random.default_rng(7)
    reads, truth = [], []
    for _ in range(16):
        p = int(rng.integers(100, 20000))
        s = int(rng.integers(30, 70))
        intron = int(rng.integers(500, 5000))
        r = np.concatenate([g[p : p + s], g[p + s + intron : p + s + intron + (100 - s)]])
        reads.append(r)
        truth.append((p, s, intron))
    reads = np.stack(reads).astype(np.int8)
    lengths = np.full(16, 100, dtype=np.int32)
    ext = ExtendedAligner(engine, splice_junct_len=50000)
    res = ext.align(reads, lengths)
    ok = 0
    for i, (p, s, intron) in enumerate(truth):
        if res["unique"][i] and res["cigar_op"][i] == (1 << 30):
            lp = int(res["locus"][i])
            gap = int(res["op_len"][i])
            sp = int(res["split"][i])
            # junction split can be ambiguous when the boundary bases match
            # both exon contexts — verify the IMPLIED alignment is exact
            recon = np.concatenate([g[lp : lp + sp],
                                    g[lp + gap + sp : lp + gap + 100]])
            assert np.array_equal(recon, reads[i]), f"read {i}"
            assert abs(sp - s) <= 3 and lp + sp == p + sp or lp == p
            ok += 1
    assert ok >= 13, f"only {ok}/16 splices recovered"


def test_cigar_strings():
    assert cigar_for(100, 0, 0, 0) == "100M"
    assert cigar_for(100, 6, 0, 40) == "40M6D60M"
    assert cigar_for(100, -5, 0, 40) == "40M5I55M"
    assert cigar_for(100, 1 << 30, 1234, 40) == "40M1234N60M"


def test_clean_reads_unaffected(setup):
    """Extended passes must not fire for reads the Hamming pass accepts."""
    seqs, idx, engine = setup
    g = seqs[0][1]
    rng = np.random.default_rng(9)
    reads = np.stack([
        g[int(p) : int(p) + 100]
        for p in rng.integers(0, len(g) - 100, size=32)
    ]).astype(np.int8)
    lengths = np.full(32, 100, dtype=np.int32)
    ext = ExtendedAligner(engine, micro_indel_len=10, splice_junct_len=50000)
    res = ext.align(reads, lengths)
    assert res["unique"].sum() >= 30
    assert np.all(res["cigar_op"][res["unique"]] == 0)
