"""Blitz local-alignment tests: exact hits, spliced (gapped) queries,
reverse strand, PSL output shape."""
import numpy as np
import pytest

from biokanga.cli import main
from biokanga.index.build import build_index
from biokanga.index.device import to_device
from biokanga.seq.encode import revcomp
from biokanga.seq.fasta import write_fasta
from biokanga.sim.simreads import random_genome
from biokanga.tools.blitz import BlitzParams, blitz_query, psl_row


@pytest.fixture(scope="module")
def blz():
    seqs = random_genome([("tA", 50000), ("tB", 30000)], seed=71)
    idx = build_index(seqs, lut_bases=8)
    return seqs, idx, to_device(idx)


def test_exact_query(blz):
    seqs, idx, didx = blz
    q = seqs[0][1][1000:1600].copy()
    paths = blitz_query(didx, "q1", q, BlitzParams())
    assert paths, "no path found for exact 600bp query"
    p = paths[0]
    assert p.tname == "tA" and p.strand == "+"
    assert p.tstart <= 1000 and p.tend >= 1590
    assert p.qstart <= 10 and p.qend >= 590
    assert p.matches >= 550


def test_reverse_strand(blz):
    seqs, idx, didx = blz
    q = revcomp(seqs[1][1][5000:5500].copy())
    paths = blitz_query(didx, "qr", q, BlitzParams())
    assert paths
    p = paths[0]
    assert p.tname == "tB" and p.strand == "-"
    assert p.tstart <= 5005 and p.tend >= 5490


def test_spliced_query_chains_across_gap(blz):
    """Two exons 10kb apart in the target chain into ONE path with a
    target insert (the RNA splice use-case)."""
    seqs, idx, didx = blz
    g = seqs[0][1]
    q = np.concatenate([g[2000:2300], g[12300:12600]]).copy()
    paths = blitz_query(didx, "qs", q, BlitzParams())
    assert paths
    p = paths[0]
    assert p.tstart <= 2005 and p.tend >= 12590
    row = psl_row(p)
    f = row.split("\t")
    assert int(f[6]) >= 1          # tNumInsert
    assert int(f[7]) >= 9000       # tBaseInsert spans the intron


def test_low_identity_rejected(blz):
    seqs, idx, didx = blz
    rng = np.random.default_rng(4)
    q = rng.integers(0, 4, size=500).astype(np.int8)  # unrelated sequence
    paths = blitz_query(didx, "junk", q, BlitzParams())
    # random 500bp: no 20-mer exact seeds expected
    assert paths == []


def test_blitz_cli_psl(blz, tmp_path):
    seqs, idx, didx = blz
    fa = str(tmp_path / "t.fa")
    write_fasta(fa, seqs)
    ip = str(tmp_path / "t.idx.npz")
    assert main(["index", "-i", fa, "-o", ip, "--lut-bases", "8"]) == 0
    qf = str(tmp_path / "q.fa")
    write_fasta(qf, [("q1", seqs[0][1][700:1500]),
                     ("q2", revcomp(seqs[1][1][100:900]))])
    out = str(tmp_path / "o.psl")
    assert main(["blitz", "-i", qf, "-I", ip, "-o", out]) == 0
    lines = open(out).read().splitlines()
    assert lines[0].startswith("psLayout")
    rows = [l.split("\t") for l in lines[5:] if l]
    assert len(rows) >= 2
    for r in rows:
        assert len(r) == 21
        assert r[8] in ("+", "-")
