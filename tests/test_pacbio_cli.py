"""pacbiokanga-family CLI: ecreads -> contigs pipeline + kmerdist."""
import numpy as np

from biokanga.cli import main
from biokanga.seq.fasta import read_seqs, write_fasta
from biokanga.sim.simreads import random_genome


def test_ecreads_then_contigs(tmp_path):
    rng = np.random.default_rng(19)
    true = random_genome([("t", 1200)], seed=5)[0][1]

    def noisy(seq):
        out = []
        for c in seq:
            r = rng.random()
            if r < 0.01:
                continue
            if r < 0.02:
                out.append(rng.integers(0, 4))
            out.append((c + 1) % 4 if rng.random() < 0.02 else c)
        return np.array(out, np.int8)

    # overlapping noisy long reads tiling the sequence
    reads = []
    for s in range(0, 700, 100):
        reads.append(noisy(true[s : s + 500]))
    fa = str(tmp_path / "raw.fa")
    write_fasta(fa, ((f"pb{i}", r) for i, r in enumerate(reads)))

    ec = str(tmp_path / "ec.fa")
    assert main(["ecreads", "-i", fa, "-o", ec, "--min-score", "100"]) == 0
    corrected = list(read_seqs(ec))
    assert len(corrected) == len(reads)

    ctg = str(tmp_path / "ctg.fa")
    assert main(["contigs", "-i", ec, "-o", ctg, "--min-overlap", "300",
                 "--final-overlap", "150", "--max-subs-100", "5"]) == 0
    contigs = list(read_seqs(ctg))
    assert len(contigs) >= 1
    assert max(len(c.codes) for c in contigs) > 600


def test_kmerdist(tmp_path):
    g1 = random_genome([("a", 2000)], seed=1)
    g2 = random_genome([("b", 2000)], seed=2)
    f1, f2 = str(tmp_path / "1.fa"), str(tmp_path / "2.fa")
    write_fasta(f1, g1)
    write_fasta(f2, g2)
    out = str(tmp_path / "kd.csv")
    assert main(["kmerdist", "-i", f1, "-i", f2, "-o", out, "-k", "3"]) == 0
    lines = open(out).read().splitlines()
    assert len(lines) == 64 + 1
    tot1 = sum(int(l.split(",")[1]) for l in lines[1:])
    assert tot1 == 2000 - 3 + 1
