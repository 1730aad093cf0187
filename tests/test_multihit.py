"""Multi-hit assignment + chimeric trimming + stats report tests."""
import numpy as np
import pytest

from biokanga.align.multihit import (
    adaptive_trim,
    assign_multihits,
    chimeric_pass,
)
from biokanga.align.params import AlignParams
from biokanga.align.pipeline import AlignEngine
from biokanga.cli import main
from biokanga.index.build import build_index
from biokanga.index.device import to_device
from biokanga.seq.fasta import write_fasta
from biokanga.sim.simreads import SimReadTruth, random_genome


def test_assign_multihits_prefers_supported_locus():
    # unique coverage piled around locus 1000; candidates 1000 vs 50000
    uq = np.full(30, 950, np.int64) + np.arange(30) * 5
    ul = np.full(30, 100, np.int64)
    cand = np.array([[1000, 50000, -1]], np.int64)
    assigned, ok = assign_multihits(uq, ul, cand, 100000)
    assert ok[0] and assigned[0] == 1000
    # no support anywhere -> unassigned
    cand2 = np.array([[70000, 90000, -1]], np.int64)
    a2, ok2 = assign_multihits(uq, ul, cand2, 100000)
    assert not ok2[0]


def test_adaptive_trim_rules():
    L = 100
    mism = np.zeros(L, np.int64)
    mism[:20] = 1           # garbage 5' flank
    s, e = adaptive_trim(mism, L)
    # longest window within the 15-per-100bp budget: may keep a few
    # leading mismatches (14 allowed over a 94bp window)
    assert e == 100 and s <= 20
    assert mism[s:e].sum() <= ((e - s) * 15) // 100
    # uniformly bad read: no window survives
    bad = np.ones(L, np.int64)
    bad[::4] = 0
    assert adaptive_trim(bad, L) is None


def test_multihit_ml_lists_and_engine():
    # genome with an exact duplicated segment => simulated reads from it
    # are 2-instance multihits whose ml list holds both loci
    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, size=20000).astype(np.int8)
    g[12000:12500] = g[3000:3500]
    idx = build_index([("c", g)], lut_bases=8)
    engine = AlignEngine(to_device(idx), AlignParams())
    reads = np.stack([g[3100:3200], g[5000:5100]]).astype(np.int8)
    lens = np.full(2, 100, np.int32)
    res = engine.align_with_rescue(reads, lens)
    assert not res["unique"][0] and res["inst"][0] == 2
    got = set(int(x) for x in res["ml_loci"][0][:2])
    assert got == {3100, 12100}
    assert res["unique"][1]


def test_chimeric_cli(tmp_path):
    seqs = random_genome([("chr1", 30000)], seed=77)
    g = seqs[0][1]
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, seqs)
    rng = np.random.default_rng(5)
    # chimeric reads: 70bp true + 30bp random junk at the 3' end
    reads = []
    for i in range(30):
        p = int(rng.integers(0, 29000))
        r = np.concatenate([g[p : p + 70],
                            rng.integers(0, 4, 30).astype(np.int8)])
        reads.append((f"lcl|usimreads|{i:08d}|chr1|{p+1}|{p+70}|70|+|0|0|0", r))
    rf = str(tmp_path / "r.fa")
    write_fasta(rf, reads)
    ip = str(tmp_path / "g.idx.npz")
    assert main(["index", "-i", fa, "-o", ip, "--lut-bases", "8"]) == 0
    sam = str(tmp_path / "o.sam")
    stats = str(tmp_path / "stats.csv")
    assert main(["align", "-i", rf, "-I", ip, "-o", sam, "-C", "50",
                 "--stats", stats]) == 0
    n_chim = 0
    for line in open(sam):
        if line.startswith("@"):
            continue
        f = line.split("\t")
        if int(f[1]) & 4:
            continue
        t = SimReadTruth.parse(f[0])
        assert int(f[3]) == t.start
        n_chim += 1
    assert n_chim >= 25   # most junk-tailed reads recovered chimericly
    body = open(stats).read()
    assert '"chimeric"' in body and '"total",30' in body
