"""pbfilter (SMRTbell removal) + swservice CLI (sharded SW job batch)."""
import numpy as np

from biokanga.cli import main
from biokanga.pacbio.pbfilter import (
    PBFilterParams, SMRTBELL, find_adapter_hits, pb_filter,
)
from biokanga.seq.encode import ascii_to_codes
from biokanga.seq.fasta import read_seqs, write_fasta
from biokanga.sim.simreads import random_genome


def _mk_read_with_adapter(rng, flank=800, mm=0):
    ad = np.array(ascii_to_codes(SMRTBELL.encode()), np.int8).copy()
    for p in rng.choice(len(ad), size=mm, replace=False):
        ad[p] = (ad[p] + 1) % 4
    left = rng.integers(0, 4, flank).astype(np.int8)
    right = rng.integers(0, 4, flank).astype(np.int8)
    return np.concatenate([left, ad, right]), flank


def test_find_adapter_exact_and_noisy():
    rng = np.random.default_rng(3)
    ad = np.asarray(ascii_to_codes(SMRTBELL.encode()), np.int8)
    read, pos = _mk_read_with_adapter(rng, mm=0)
    hits = find_adapter_hits(read, ad, max_mm=9)
    assert list(hits) == [pos]
    read, pos = _mk_read_with_adapter(rng, mm=8)
    hits = find_adapter_hits(read, ad, max_mm=9)
    assert list(hits) == [pos]
    # no adapter -> no hits
    clean = rng.integers(0, 4, 2000).astype(np.int8)
    assert find_adapter_hits(clean, ad, max_mm=9).size == 0


def test_pb_filter_splits_and_drops():
    rng = np.random.default_rng(7)
    read, pos = _mk_read_with_adapter(rng, flank=700)
    short = rng.integers(0, 4, 120).astype(np.int8)  # below min length
    kept, st = pb_filter(
        [("hairpin", read), ("short", short)],
        PBFilterParams(min_subread_len=500),
    )
    assert st.reads_in == 2 and st.reads_with_adapter == 1
    names = [n for n, _ in kept]
    assert names == ["hairpin/sub1", "hairpin/sub2"]
    assert all(len(c) == 700 for _, c in kept)


def test_pbfilter_cli(tmp_path):
    rng = np.random.default_rng(11)
    read, _ = _mk_read_with_adapter(rng, flank=600)
    fa = str(tmp_path / "raw.fa")
    out = str(tmp_path / "filt.fa")
    write_fasta(fa, [("r1", read)])
    assert main(["pbfilter", "-i", fa, "-o", out,
                 "--min-subread-len", "400"]) == 0
    recs = list(read_seqs(out))
    assert len(recs) == 2 and all(len(r.codes) == 600 for r in recs)


def test_swservice_cli_zip_and_cross(tmp_path):
    genome = random_genome([("g", 400)], seed=1)[0][1]
    probes = [("p1", genome[:160]), ("p2", genome[200:360])]
    targs = [("t1", genome[:160].copy()), ("t2", genome[200:360].copy())]
    targs[0][1][10] = (targs[0][1][10] + 1) % 4  # one mismatch
    pfa, tfa = str(tmp_path / "p.fa"), str(tmp_path / "t.fa")
    out = str(tmp_path / "sw.csv")
    write_fasta(pfa, probes)
    write_fasta(tfa, targs)
    assert main(["swservice", "-a", pfa, "-b", tfa, "-o", out]) == 0
    rows = open(out).read().strip().splitlines()
    assert len(rows) == 3  # header + 2 zip pairs
    s1 = int(rows[1].split(",")[2])
    s2 = int(rows[2].split(",")[2])
    assert s2 > s1 > 0  # p2/t2 identical beats p1/t1 (1 mismatch)

    out2 = str(tmp_path / "swx.csv")
    assert main(["swservice", "-a", pfa, "-b", tfa, "-o", out2,
                 "--pairs", "cross"]) == 0
    assert len(open(out2).read().strip().splitlines()) == 5  # header + 4
