"""End-to-end CLI slice: simreads -> index -> align -> SAM truth check.

This is the SURVEY.md §7.2 minimum slice exercised through the same CLI
surface the reference exposes (index/align/simreads subcommands).
"""
import numpy as np

from biokanga.cli import main
from biokanga.seq.fasta import write_fasta
from biokanga.sim.simreads import SimReadTruth, random_genome


def test_cli_simreads_index_align(tmp_path):
    seqs = random_genome([("chr1", 30000), ("chr2", 15000)], seed=21)
    ref_fa = str(tmp_path / "ref.fa")
    write_fasta(ref_fa, seqs)

    reads_fa = str(tmp_path / "reads.fasta")
    assert main(["simreads", "-i", ref_fa, "-o", reads_fa,
                 "-n", "500", "-l", "100", "--seed", "3"]) == 0

    idx_path = str(tmp_path / "ref.idx.npz")
    assert main(["index", "-i", ref_fa, "-o", idx_path, "--lut-bases", "8"]) == 0

    sam_path = str(tmp_path / "out.sam")
    assert main(["align", "-i", reads_fa, "-I", idx_path, "-o", sam_path]) == 0

    # parse SAM, check against simreads descriptors
    n_aligned = 0
    n_correct = 0
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            qname, flag, rname, pos = fields[0], int(fields[1]), fields[2], int(fields[3])
            if flag & 4:
                continue
            n_aligned += 1
            t = SimReadTruth.parse(qname)
            strand = "-" if flag & 16 else "+"
            if rname == t.chrom and pos == t.start and strand == t.strand:
                n_correct += 1
            assert fields[5] == "100M"
    assert n_aligned > 480
    assert n_correct == n_aligned  # exact-read truth must be perfectly recovered


def test_response_file(tmp_path):
    seqs = random_genome([("c", 5000)], seed=2)
    ref_fa = str(tmp_path / "r.fa")
    write_fasta(ref_fa, seqs)
    rsp = tmp_path / "params.txt"
    rsp.write_text(f"-i\n{ref_fa}\n-o\n{tmp_path}/o.fa\n-n\n10\n-l\n50\n")
    assert main(["simreads", f"@{rsp}"]) == 0
    assert (tmp_path / "o.fa").exists()
