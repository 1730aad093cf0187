"""Tests for converters3: genbioseq, genbiobed, genbiomultialign,
fasta2struct, plus the BED12 fasta2bed upgrade."""
import numpy as np

from biokanga.cli import main
from biokanga.seq.fasta import write_fasta
from biokanga.tools.converters3 import (
    load_biobed,
    load_biomultialign,
    seq_struct_profile,
)


def _mkfa(path, seqs):
    lut = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
    write_fasta(
        str(path),
        [(n, np.array([lut[c] for c in s], dtype=np.int8))
         for n, s in seqs],
    )


def test_fasta2bed_bed12(tmp_path):
    fa = tmp_path / "a.fa"
    _mkfa(fa, [("s1", "ACGTACGT"), ("s2 desc", "GGGCCC")])
    out = str(tmp_path / "a.bed")
    assert main(["fasta2bed", "-i", str(fa), "-o", out]) == 0
    rows = [l.split("\t") for l in open(out)]
    assert rows[0][:4] == ["s1", "0", "8", "s1"]
    assert len(rows[0]) == 12 and rows[0][10] == "8,"
    assert rows[1][0] == "s2" and rows[1][2] == "6"


def test_genbioseq_roundtrip_via_dmpbioseq(tmp_path):
    fa = tmp_path / "b.fa"
    _mkfa(fa, [("x", "ACGT"), ("y", "TTTTA")])
    cont = str(tmp_path / "b.rds.npz")
    assert main(["genbioseq", "-i", str(fa), "-o", cont]) == 0
    dump = str(tmp_path / "b.txt")
    assert main(["dmpbioseq", "-i", cont, "-o", dump]) == 0
    text = open(dump).read()
    assert ">x" in text and "ACGT" in text and "TTTTA" in text


def test_genbiobed_container(tmp_path):
    bed = tmp_path / "c.bed"
    bed.write_text(
        "chr2\t50\t90\tfB\t7\t-\n"
        "chr1\t10\t20\tfA\t5\t+\n"
    )
    cont = str(tmp_path / "c.biobed.npz")
    assert main(["genbiobed", "-i", str(bed), "-o", cont]) == 0
    feats = load_biobed(cont)
    # sorted by (chrom, start)
    assert feats[0][:4] == ("chr1", 10, 20, "fA")
    assert feats[1][0] == "chr2" and feats[1][5] == "-"


def test_genbiomultialign_roundtrip(tmp_path):
    maf = tmp_path / "d.maf"
    maf.write_text(
        "##maf version=1\n"
        "a score=123.0\n"
        "s hg.chr1 100 8 + 1000 ACGT--ACGT\n"
        "s mm.chr2 200 10 - 2000 ACGTTTACGT\n"
        "\n"
        "a score=9.5\n"
        "s hg.chr1 500 4 + 1000 AC-GT\n"
        "s mm.chr2 700 5 + 2000 ACCGT\n"
    )
    cont = str(tmp_path / "d.algn.npz")
    assert main(["genbiomultialign", "-i", str(maf), "-o", cont]) == 0
    scores, blocks = load_biomultialign(cont)
    assert scores == [123.0, 9.5]
    assert blocks[0][0] == ("hg.chr1", 100, 8, "+", 1000, "ACGT--ACGT")
    assert blocks[1][1][5] == "ACCGT"


def test_fasta2struct_profile_and_cli(tmp_path):
    # AT-rich vs GC-rich minor groove widths differ (published B-DNA step
    # parameters: AA/AT steps are narrower than CG/GC steps)
    at = seq_struct_profile(np.array([0, 0, 3, 0, 0, 3] * 5), "minorgroove")
    gc = seq_struct_profile(np.array([1, 2, 1, 2, 1, 2] * 5), "minorgroove")
    assert np.nanmean(at) < np.nanmean(gc)
    # N bases produce NaN steps
    prof = seq_struct_profile(np.array([0, 4, 0]), "twist")
    assert np.isnan(prof).all()

    fa = tmp_path / "e.fa"
    _mkfa(fa, [("q1", "ACGTACGTACGTACGT"), ("q2", "AAAAAAAATTTTTTTT")])
    out = str(tmp_path / "e.csv")
    assert main(["fasta2struct", "-i", str(fa), "-o", out,
                 "-c", "twist", "-C", "4"]) == 0
    lines = open(out).read().strip().split("\n")
    assert len(lines) == 3 and lines[0].startswith('"Seq"')
    assert '"q1","twist",16,' in lines[1]


def test_fasta2struct_user_params(tmp_path):
    params = tmp_path / "p.csv"
    # override all 16 steps' twist with a constant 99
    steps = [a + b for a in "ACGT" for b in "ACGT"]
    params.write_text("".join(
        f"{s},0,0,0,99,0,0,0,0,0\n" for s in steps))
    from biokanga.tools.converters3 import load_struct_params

    table = load_struct_params(str(params))
    prof = seq_struct_profile(np.array([0, 1, 2, 3]), "twist", table)
    assert np.allclose(prof, 99.0)
