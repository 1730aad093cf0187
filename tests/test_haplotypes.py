"""DiSNP/TriSNP haplotype counting tests."""
import numpy as np

from biokanga.cli import main
from biokanga.seq.fasta import write_fasta, write_fastq
from biokanga.sim.simreads import random_genome, simulate_reads


def test_disnp_cli(tmp_path):
    seqs = random_genome([("chr1", 20000)], seed=13)
    g = seqs[0][1]
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, seqs)
    # sample genome with TWO linked SNPs 40bp apart: haplotype AB always
    # co-occurs (same chromosome copy)
    sample = [(n, s.copy()) for n, s in seqs]
    l1, l2 = 5000, 5040
    old1, old2 = int(g[l1]), int(g[l2])
    new1, new2 = (old1 + 1) % 4, (old2 + 2) % 4
    sample[0][1][l1] = new1
    sample[0][1][l2] = new2
    names, reads, truths = simulate_reads(sample, 4000, read_len=100, seed=3)
    rf = str(tmp_path / "r.fastq")
    write_fastq(rf, ((n, c, None) for n, c in zip(names, reads)))

    ip = str(tmp_path / "g.idx.npz")
    assert main(["index", "-i", fa, "-o", ip, "--lut-bases", "8"]) == 0
    sam = str(tmp_path / "o.sam")
    snps = str(tmp_path / "snps.csv")
    disnp = str(tmp_path / "disnp.csv")
    assert main(["align", "-i", rf, "-I", ip, "-o", sam, "-O", snps,
                 "--disnp", disnp]) == 0
    lines = open(disnp).read().splitlines()
    assert lines[0].startswith('"DiSNP_ID"')
    rows = [l.split(",") for l in lines[1:]]
    assert rows, "no DiSNP rows"
    # the dominant haplotype must be the linked new1+new2 combo
    top = rows[0]
    assert top[3].strip('"') == "ACGT"[new1] + "ACGT"[new2]
    assert int(top[4]) > 10
