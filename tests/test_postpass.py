"""PCR dedupe / priority regions / PE insert distribution tests."""
import numpy as np

from biokanga.align.postpass import reduce_pcr_duplicates
from biokanga.cli import main
from biokanga.seq.fasta import write_fasta, write_fastq
from biokanga.sim.simreads import random_genome, simulate_reads


def test_reduce_pcr_duplicates():
    res = {
        "unique": np.array([True, True, True, True, False]),
        "locus": np.array([100, 100, 100, 200, 100]),
        "is_rc": np.array([False, False, True, False, False]),
    }
    n = reduce_pcr_duplicates(res, np.full(5, 50), keep=1)
    assert n == 1
    # second fwd hit at 100 demoted; rc at 100 and the 200 hit kept
    assert list(res["unique"]) == [True, False, True, True, False]


def test_priority_region_cli(tmp_path):
    seqs = random_genome([("chr1", 20000)], seed=3)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, seqs)
    names, reads, truths = simulate_reads(seqs, 300, read_len=100, seed=8)
    rf = str(tmp_path / "r.fastq")
    write_fastq(rf, ((n, c, None) for n, c in zip(names, reads)))
    bed = tmp_path / "prio.bed"
    bed.write_text("chr1\t0\t5000\troi\t0\t+\n")
    ip = str(tmp_path / "g.idx.npz")
    assert main(["index", "-i", fa, "-o", ip, "--lut-bases", "8"]) == 0
    sam = str(tmp_path / "o.sam")
    assert main(["align", "-i", rf, "-I", ip, "-o", sam,
                 "-Y", str(bed), "--no-mlassign"]) == 0
    for line in open(sam):
        if line.startswith("@"):
            continue
        f = line.split("\t")
        if int(f[1]) & 4:
            continue
        # every accepted hit overlaps [0, 5000)
        assert int(f[3]) <= 5000


def test_pe_insert_dist(tmp_path):
    seqs = random_genome([("chr1", 40000)], seed=21)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, seqs)
    r1 = str(tmp_path / "r1.fastq")
    r2 = str(tmp_path / "r2.fastq")
    assert main(["simreads", "-i", fa, "-o", r1, "-O", r2, "--pe",
                 "-n", "100", "-l", "100", "--insert-min", "250",
                 "--insert-max", "350"]) == 0
    ip = str(tmp_path / "g.idx.npz")
    assert main(["index", "-i", fa, "-o", ip, "--lut-bases", "8"]) == 0
    sam = str(tmp_path / "o.sam")
    dist = str(tmp_path / "inserts.csv")
    assert main(["align", "-i", r1, "-u", r2, "-I", ip, "-o", sam,
                 "-d", "100", "-D", "600", "--peinsertdist", dist]) == 0
    body = open(dist).read()
    assert '"InsertBin","Count"' in body
    bins = [int(l.split(",")[0]) for l in body.splitlines()
            if l and l[0].isdigit()]
    assert bins and min(bins) >= 240 and max(bins) <= 350
