"""Tests for the host-side tool subcommands (fasta2nxx, xfasta,
pseudogenome, filter, ngsqc, mergeoverlaps, ssr, filtchrom, remaploci)."""
import numpy as np
import pytest

from biokanga.cli import main
from biokanga.seq.encode import ascii_to_codes, codes_to_ascii, revcomp
from biokanga.seq.fasta import read_seqs, write_fasta, write_fastq
from biokanga.sim.simreads import random_genome


def test_fasta2nxx(tmp_path):
    seqs = [("a", np.zeros(100, np.int8)), ("b", np.ones(300, np.int8)),
            ("c", np.full(600, 2, np.int8))]
    fa = str(tmp_path / "x.fa")
    write_fasta(fa, seqs)
    from biokanga.tools.fasta_tools import fasta_nxx

    st = fasta_nxx(fa)
    assert st.num_seqs == 3 and st.total_bp == 1000
    assert st.max_len == 600 and st.min_len == 100
    # N50: cumulative 600 >= 500 at the first (longest) seq
    assert st.nxx[50] == 600
    assert st.nxx[90] == 300
    # GC: b(C)=300, c(G)=600 -> 900/1000
    assert abs(st.gc_pcnt - 90.0) < 1e-9


def test_xfasta_and_pseudogenome_and_remap(tmp_path):
    seqs = random_genome([("s1", 500), ("s2", 800), ("other", 300)], seed=3)
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, seqs)
    out = str(tmp_path / "sub.fa")
    assert main(["xfasta", "-i", fa, "-o", out, "-r", "^s", "--min-len",
                 "600"]) == 0
    got = list(read_seqs(out))
    assert [g.name for g in got] == ["s2"]

    pg = str(tmp_path / "pg.fa")
    bed = str(tmp_path / "pg.bed")
    assert main(["pseudogenome", "-i", fa, "-o", pg, "-O", bed]) == 0
    cat = list(read_seqs(pg))
    assert len(cat) == 1
    assert len(cat[0].codes) == 500 + 800 + 300 + 2 * 100
    rows = [l.split("\t") for l in open(bed)]
    assert [r[3].strip() for r in rows] == ["s1", "s2", "other"]
    assert int(rows[1][1]) == 600  # 500 + 100 Ns

    # remaploci: a fake SAM against the pseudo-chrom lifts back to s2
    sam = str(tmp_path / "a.sam")
    with open(sam, "w") as f:
        f.write("@HD\tVN:1.6\n@SQ\tSN:PseudoG\tLN:1900\n")
        f.write("r1\t0\tPseudoG\t701\t60\t50M\t*\t0\t0\t*\t*\n")  # in s2
        f.write("r2\t0\tPseudoG\t580\t60\t50M\t*\t0\t0\t*\t*\n")  # in Ns gap
    out_sam = str(tmp_path / "remap.sam")
    assert main(["remaploci", "-i", sam, "-o", out_sam, "-b", bed]) == 0
    recs = [l.split("\t") for l in open(out_sam) if not l.startswith("@")]
    assert len(recs) == 1
    assert recs[0][2] == "s2" and recs[0][3] == str(701 - 600)


def test_filter(tmp_path):
    rng = np.random.default_rng(5)
    reads = rng.integers(0, 4, size=(50, 80)).astype(np.int8)
    reads[3] = reads[2]                # duplicate
    reads[5, 10:30] = 4                # many Ns
    adapter = ascii_to_codes(b"AGATCGGAAGAGC")
    reads[7, -10:] = adapter[:10]      # adapter at the 3' end
    fq = str(tmp_path / "in.fastq")
    write_fastq(fq, ((f"r{i}", reads[i], b"I" * 80) for i in range(50)))
    ad = str(tmp_path / "ad.fa")
    write_fasta(ad, [("adapter", adapter)])

    out = str(tmp_path / "out.fastq")
    assert main(["filter", "-i", fq, "-o", out, "-c", ad,
                 "--min-len", "50"]) == 0
    got = {r.name: r for r in read_seqs(out)}
    assert "r3" not in got            # dup removed
    assert "r5" not in got            # too many Ns
    assert len(got["r7"].codes) == 70  # adapter trimmed
    assert len(got) == 48


def test_ngsqc(tmp_path):
    rng = np.random.default_rng(8)
    reads = rng.integers(0, 4, size=(200, 60)).astype(np.int8)
    fq = str(tmp_path / "r.fastq")
    write_fastq(fq, ((f"q{i}", reads[i], bytes([33 + 30] * 60))
                     for i in range(200)))
    html = str(tmp_path / "qc.html")
    assert main(["ngsqc", "-i", fq, "-o", html, "-k", "4"]) == 0
    doc = open(html).read()
    assert "<svg" in doc and "200" in doc
    assert "Mean Phred" in doc


def test_mergeoverlaps(tmp_path):
    rng = np.random.default_rng(11)
    frag = rng.integers(0, 4, size=160).astype(np.int8)
    L = 100  # overlap = 40
    r1 = frag[:L].copy()
    r2 = revcomp(frag[-L:])
    f1 = str(tmp_path / "r1.fastq")
    f2 = str(tmp_path / "r2.fastq")
    write_fastq(f1, [("p1", r1, None)])
    write_fastq(f2, [("p1", r2, None)])
    out = str(tmp_path / "m.fasta")
    assert main(["mergeoverlaps", "-i", f1, "-u", f2, "-o", out]) == 0
    merged = list(read_seqs(out))
    assert len(merged) == 1
    assert np.array_equal(merged[0].codes, frag)


def test_ssr(tmp_path):
    pre = ascii_to_codes(b"GATTACAGGCAT" * 10)
    ssr = ascii_to_codes(b"AT" * 12)           # AT x12
    post = ascii_to_codes(b"CCGATGGC" * 10)
    seq = np.concatenate([pre, ssr, post])
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, [("chrZ", seq)])
    out = str(tmp_path / "ssr.csv")
    assert main(["ssr", "-i", fa, "-o", out, "-r", "5"]) == 0
    rows = [l for l in open(out)][1:]
    at_rows = [r for r in rows if '"AT"' in r or '"TA"' in r]
    assert len(at_rows) >= 1
    f = at_rows[0].split(",")
    # the prefix ends "...CAT", so the true tandem run starts 2 bases
    # before the planted block (AT x13)
    assert abs(int(f[2]) - len(pre)) <= 2


def test_filtchrom(tmp_path):
    sam = str(tmp_path / "a.sam")
    with open(sam, "w") as f:
        f.write("@SQ\tSN:chr1\tLN:100\n@SQ\tSN:chrM\tLN:50\n")
        f.write("a\t0\tchr1\t1\t60\t10M\t*\t0\t0\t*\t*\n")
        f.write("b\t0\tchrM\t1\t60\t10M\t*\t0\t0\t*\t*\n")
    out = str(tmp_path / "f.sam")
    assert main(["filtchrom", "-i", sam, "-o", out, "-z", "^chr1$"]) == 0
    body = [l for l in open(out) if not l.startswith("@")]
    hdr = [l for l in open(out) if l.startswith("@SQ")]
    assert len(body) == 1 and body[0].startswith("a")
    assert len(hdr) == 1 and "chr1" in hdr[0]
