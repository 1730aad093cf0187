"""Marker family tests: kmarkers brute-force parity, snpmarkers pipeline,
markerseqs flank extraction, uhamming CLI."""
import numpy as np
import pytest

from biokanga.cli import main
from biokanga.index.build import build_index
from biokanga.seq.encode import codes_to_ascii
from biokanga.seq.fasta import read_seqs, write_fasta
from biokanga.sim.simreads import random_genome
from biokanga.tools.markers import kmer_markers


def test_kmarkers_bruteforce():
    rng = np.random.default_rng(42)
    a = rng.integers(0, 4, size=3000).astype(np.int8)
    b = rng.integers(0, 4, size=3000).astype(np.int8)
    b[1000:1500] = a[1000:1500]  # shared region: K-mers there are NOT markers
    idx = build_index([("cultA", a), ("cultB", b)], lut_bases=8)
    K = 20
    ms = kmer_markers(idx, ["A", "B"], K=K, min_count=1, max_other_count=0)

    # brute force: count K-mers in each cultivar
    from collections import Counter

    ca = Counter(bytes(a[i : i + K]) for i in range(len(a) - K + 1))
    cb = Counter(bytes(b[i : i + K]) for i in range(len(b) - K + 1))
    expect_a = {k for k in ca if k not in cb}
    expect_b = {k for k in cb if k not in ca}

    got_a = {m.kmer for m in ms if m.cultivar == "A"}
    got_b = {m.kmer for m in ms if m.cultivar == "B"}
    exp_a_str = {codes_to_ascii(np.frombuffer(k, np.int8)).decode()
                 for k in expect_a}
    exp_b_str = {codes_to_ascii(np.frombuffer(k, np.int8)).decode()
                 for k in expect_b}
    assert got_a == exp_a_str
    assert got_b == exp_b_str
    # shared-region K-mers excluded
    shared = codes_to_ascii(a[1100 : 1100 + K]).decode()
    assert shared not in got_a and shared not in got_b


def test_snpmarkers_and_markerseqs(tmp_path):
    # synthesise two cultivar SNP CSVs via the real writer
    from biokanga.align.snp import SNPCall, write_snps_csv

    def mkcall(chrom, loci, ref, alt, cov):
        cnts = np.zeros(4, np.int64)
        cnts[ref] = cov // 2
        cnts[alt] = cov - cov // 2
        return SNPCall(chrom=chrom, loci=loci, ref_base=ref, tot_bases=cov,
                       nonref=cov - cov // 2, base_cnts=cnts, pvalue=1e-9,
                       bkgnd_rate=0.01, win_bases=100, win_mm=1)

    c1 = str(tmp_path / "c1.csv")
    c2 = str(tmp_path / "c2.csv")
    write_snps_csv(c1, [mkcall("chr1", 500, 0, 2, 20),
                        mkcall("chr1", 900, 1, 3, 8)])
    write_snps_csv(c2, [mkcall("chr1", 500, 0, 3, 30)])

    out = str(tmp_path / "markers.csv")
    assert main(["snpmarkers", "-i", f"cv1={c1}", "-i", f"cv2={c2}",
                 "-o", out, "--min-cov", "5"]) == 0
    lines = open(out).read().splitlines()
    assert len(lines) == 3  # header + loci 500, 900
    assert "cv1" in lines[0] and "cv2" in lines[0]

    # markerseqs over a real index
    seqs = random_genome([("chr1", 2000)], seed=1)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, seqs)
    ip = str(tmp_path / "g.idx.npz")
    assert main(["index", "-i", fa, "-o", ip, "--lut-bases", "8"]) == 0
    mfa = str(tmp_path / "m.fa")
    assert main(["markerseqs", "-I", ip, "-i", f"cv1={c1}", "-o", mfa,
                 "--flank5", "50", "--flank3", "50"]) == 0
    recs = list(read_seqs(mfa))
    assert len(recs) == 2
    assert len(recs[0].codes) == 101
    # the flank content matches the genome around locus 500
    assert np.array_equal(recs[0].codes, seqs[0][1][450:551])


def test_uhamming_cli(tmp_path):
    seqs = random_genome([("c", 600)], seed=3)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, seqs)
    # two nodes + merge == full
    o_full = str(tmp_path / "full.npz")
    assert main(["uhamming", "-i", fa, "-o", o_full, "-K", "40",
                 "--no-rc"]) == 0
    o1 = str(tmp_path / "p1.npz")
    o2 = str(tmp_path / "p2.npz")
    assert main(["uhamming", "-m", "2", "-i", fa, "-o", o1, "-K", "40",
                 "-n", "2", "-N", "1"]) == 0
    assert main(["uhamming", "-m", "2", "-i", fa, "-o", o2, "-K", "40",
                 "-n", "2", "-N", "2"]) == 0
    om = str(tmp_path / "merged.npz")
    ocsv = str(tmp_path / "h.csv")
    assert main(["uhamming", "-m", "3", "-I", o1, "-I", o2, "-o", om,
                 "-O", ocsv]) == 0
    from biokanga.tools.uhamming import load_hmg

    hf, _, _, _ = load_hmg(o_full)
    hm, _, _, _ = load_hmg(om)
    np.testing.assert_array_equal(hf, hm)
    assert open(ocsv).readline().startswith('"Chrom"')
