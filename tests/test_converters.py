"""Converter tool tests."""
import os

import numpy as np

from biokanga.cli import main
from biokanga.seq.fasta import read_seqs, write_fasta
from biokanga.sim.simreads import random_genome


def test_bed_csv_roundtrip(tmp_path):
    bed = tmp_path / "a.bed"
    bed.write_text("chr1\t10\t50\tf1\t0\t+\nchr2\t5\t99\tf2\t0\t-\n")
    csvp = str(tmp_path / "a.csv")
    assert main(["bed2csv", "-i", str(bed), "-o", csvp]) == 0
    bed2 = str(tmp_path / "b.bed")
    assert main(["csv2bed", "-i", csvp, "-o", bed2]) == 0
    assert open(bed2).read().splitlines() == [
        "chr1\t10\t50\tf1\t0\t+", "chr2\t5\t99\tf2\t0\t-",
    ]


def test_csv2fasta_and_fasta2bed(tmp_path):
    csvp = tmp_path / "s.csv"
    csvp.write_text('"name","seq"\n"s1","ACGT"\n"s2","GGGG"\n')
    fa = str(tmp_path / "s.fa")
    assert main(["csv2fasta", "-i", str(csvp), "-o", fa]) == 0
    recs = list(read_seqs(fa))
    assert [r.name for r in recs] == ["s1", "s2"]
    bed = str(tmp_path / "s.bed")
    assert main(["fasta2bed", "-i", fa, "-o", bed]) == 0
    assert open(bed).read().splitlines()[0] == "s1\t0\t4\ts1\t0\t+\t0\t4\t0\t1\t4,\t0"


def test_bedmerge_and_filter(tmp_path):
    bed = tmp_path / "m.bed"
    bed.write_text(
        "chr1\t0\t100\ta\t0\t+\nchr1\t90\t200\tb\t0\t+\n"
        "chr1\t500\t600\tc\t0\t+\nchr2\t0\t10\td\t0\t+\n"
    )
    out = str(tmp_path / "merged.bed")
    assert main(["bedmerge", "-i", str(bed), "-o", out]) == 0
    rows = [l.split("\t") for l in open(out)]
    assert len(rows) == 3
    assert rows[0][1] == "0" and rows[0][2] == "200"

    outf = str(tmp_path / "filt.bed")
    assert main(["bedfilter", "-i", str(bed), "-o", outf, "-z", "chr1",
                 "--min-len", "105"]) == 0
    assert len(open(outf).read().splitlines()) == 1


def test_gfffilter(tmp_path):
    gff = tmp_path / "a.gff3"
    gff.write_text(
        "##gff-version 3\n"
        "c\tx\tgene\t1\t100\t.\t+\t.\tID=g1\n"
        "c\tx\texon\t1\t50\t.\t+\t.\tID=e1\n"
    )
    out = str(tmp_path / "f.gff3")
    assert main(["gfffilter", "-i", str(gff), "-o", out, "-t", "gene"]) == 0
    body = [l for l in open(out) if not l.startswith("#")]
    assert len(body) == 1 and "\tgene\t" in body[0]


def test_genwiggle(tmp_path):
    sam = tmp_path / "a.sam"
    sam.write_text(
        "@SQ\tSN:c\tLN:100\n"
        "r1\t0\tc\t1\t60\t50M\t*\t0\t0\t" + "A" * 50 + "\t*\n"
        "r2\t0\tc\t26\t60\t50M\t*\t0\t0\t" + "A" * 50 + "\t*\n"
    )
    out = str(tmp_path / "c.wig")
    assert main(["genwiggle", "-i", str(sam), "-o", out]) == 0
    lines = open(out).read().splitlines()
    assert lines[0].startswith("track")
    vals = [float(x) for x in lines[2:]]
    assert vals[0] == 1.0 and vals[30] == 2.0 and vals[80] == 0.0


def test_split_filter_pe(tmp_path):
    seqs = random_genome([("s1", 100), ("s1", 120), ("short", 30)], seed=2)
    fa = str(tmp_path / "multi.fa")
    write_fasta(fa, seqs)
    outdir = str(tmp_path / "split")
    os.makedirs(outdir)
    assert main(["splitmultifasta", "-i", fa, "-o", outdir]) == 0
    assert len(os.listdir(outdir)) >= 2

    filt = str(tmp_path / "filt.fa")
    assert main(["fastafilter", "-i", fa, "-o", filt, "--min-len", "50"]) == 0
    recs = list(read_seqs(filt))
    assert len(recs) == 2
    assert recs[1].name == "s1.1"  # duplicate identifier fixed

    inter = str(tmp_path / "inter.fa")
    write_fasta(inter, [("p1/1", seqs[0][1]), ("p1/2", seqs[1][1])])
    o1, o2 = str(tmp_path / "r1.fa"), str(tmp_path / "r2.fa")
    assert main(["fasta2pe", "-i", inter, "-o", o1, "-O", o2]) == 0
    assert len(list(read_seqs(o1))) == 1 and len(list(read_seqs(o2))) == 1
