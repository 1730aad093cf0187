"""PE end-to-end through the CLI: simreads --pe -> align -u -> SAM flags."""
import numpy as np

from biokanga.cli import main
from biokanga.seq.fasta import write_fasta
from biokanga.sim.simreads import SimReadTruth, random_genome


def test_cli_pe(tmp_path):
    seqs = random_genome([("chr1", 50000)], seed=9)
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, seqs)
    r1 = str(tmp_path / "r1.fastq")
    r2 = str(tmp_path / "r2.fastq")
    assert main(["simreads", "-i", ref, "-o", r1, "-O", r2, "--pe",
                 "-n", "200", "-l", "100", "--seed", "6"]) == 0
    idx = str(tmp_path / "ref.idx.npz")
    assert main(["index", "-i", ref, "-o", idx, "--lut-bases", "8"]) == 0
    sam = str(tmp_path / "out.sam")
    assert main(["align", "-i", r1, "-u", r2, "-I", idx, "-o", sam,
                 "-d", "100", "-D", "600"]) == 0

    n_rec = n_proper = n_correct = 0
    with open(sam) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            flag = int(fields[1])
            assert flag & 0x1  # all records paired
            assert (flag & 0x40) or (flag & 0x80)
            n_rec += 1
            if flag & 0x4:
                continue
            if flag & 0x2:
                n_proper += 1
                t = SimReadTruth.parse(fields[0])
                strand = "-" if flag & 0x10 else "+"
                if (fields[2] == t.chrom and int(fields[3]) == t.start
                        and strand == t.strand):
                    n_correct += 1
                # proper pairs must have RNEXT '=' and a signed TLEN
                assert fields[6] == "="
                assert int(fields[8]) != 0
    assert n_rec == 400
    assert n_proper > 390
    assert n_correct == n_proper
