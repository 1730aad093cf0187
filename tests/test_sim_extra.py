"""rnafragsim / usimdiffexpr / kangarg / findapproxmatches."""
import numpy as np

from biokanga.cli import main
from biokanga.ops.shortmatch import find_short_matches
from biokanga.seq.encode import revcomp
from biokanga.seq.fasta import read_seqs, write_fasta
from biokanga.sim.extra import klet_shuffle, rna_frag_sim, sim_diff_expr
from biokanga.sim.simreads import random_genome


def _kmer_counts(c, k):
    from collections import Counter

    return Counter(tuple(c[i: i + k]) for i in range(len(c) - k + 1))


def test_klet_shuffle_preserves_kmers():
    rng = np.random.default_rng(0)
    for k in (1, 2, 3):
        c = rng.integers(0, 4, 400).astype(np.int8)
        s = klet_shuffle(c, k=k, seed=7)
        assert len(s) == len(c)
        assert _kmer_counts(s, k) == _kmer_counts(c, k)
        if k >= 2:
            assert s[0] == c[0] and s[-1] == c[-1]  # Euler path endpoints
        # actually shuffled (overwhelmingly likely)
        assert not np.array_equal(s, c)


def test_find_short_matches_exact_and_mm():
    g = random_genome([("g", 5000)], seed=3)[0][1]
    q_exact = g[1000:1030].copy()
    q_mm = g[2000:2030].copy()
    q_mm[5] = (q_mm[5] + 1) % 4
    q_rc = revcomp(g[3000:3030])
    hits = find_short_matches(g, [q_exact, q_mm, q_rc], max_mm=1)
    got = {(q, l, s, m) for q, l, s, m in hits}
    assert (0, 1000, "+", 0) in got
    assert (1, 2000, "+", 1) in got
    assert (2, 3000, "-", 0) in got


def test_findapproxmatches_cli(tmp_path):
    seqs = random_genome([("c1", 3000), ("c2", 2000)], seed=5)
    gfa = str(tmp_path / "g.fa")
    write_fasta(gfa, seqs)
    q = seqs[1][1][500:530]
    qfa = str(tmp_path / "q.fa")
    write_fasta(qfa, [("probe", q)])
    out = str(tmp_path / "hits.csv")
    assert main(["findapproxmatches", "-i", qfa, "-I", gfa, "-o", out,
                 "-s", "0"]) == 0
    rows = open(out).read().strip().splitlines()
    assert any('"c2",500,"+"' in r for r in rows[1:])


def test_rna_frag_sim(tmp_path):
    seqs = random_genome([("chr1", 10000)], seed=6)
    bed = tmp_path / "tx.bed"
    bed.write_text("chr1\t1000\t3000\ttxA\t0\t+\nchr1\t5000\t8000\ttxB\t0\t-\n")
    names, reads, counts = rna_frag_sim(seqs, str(bed), 200, seed=2)
    assert len(reads) == 200
    assert sum(c for _, c in counts) == 200
    g = seqs[0][1]
    # verify a sense-strand read matches the genome at its descriptor locus
    for nm, rd in zip(names, reads):
        f = nm.split("|")
        if f[6] == "+":
            s = int(f[5])
            assert np.array_equal(rd, g[s: s + len(rd)])
            break


def test_sim_diff_expr_and_cli(tmp_path):
    names, ctrl, expt, truth = sim_diff_expr(500, de_frac=0.2, seed=3)
    de = truth != 1.0
    assert 80 <= de.sum() <= 120
    # up-regulated features should show clearly higher experiment means
    up = truth > 1.0
    ratio = (expt.mean(1) + 1) / (ctrl.mean(1) + 1)
    assert np.median(ratio[up]) > 2.0
    assert 0.5 < np.median(ratio[~de]) < 2.0

    out = str(tmp_path / "counts.csv")
    tr = str(tmp_path / "truth.csv")
    assert main(["usimdiffexpr", "-o", out, "-O", tr, "-n", "100"]) == 0
    assert len(open(out).read().strip().splitlines()) == 101


def test_rnafragsim_kangarg_cli(tmp_path):
    seqs = random_genome([("chr1", 8000)], seed=7)
    gfa = str(tmp_path / "g.fa")
    write_fasta(gfa, seqs)
    bed = tmp_path / "tx.bed"
    bed.write_text("chr1\t500\t2500\ttx1\t0\t+\n")
    fq = str(tmp_path / "frags.fastq")
    assert main(["rnafragsim", "-i", gfa, "-b", str(bed), "-o", fq,
                 "-n", "50"]) == 0
    assert sum(1 for l in open(fq) if l.startswith("@lcl|rnafragsim")) == 50

    sh = str(tmp_path / "shuf.fa")
    assert main(["kangarg", "-i", gfa, "-o", sh, "-k", "2"]) == 0
    orig = seqs[0][1]
    got = next(iter(read_seqs(sh))).codes
    assert _kmer_counts(got, 2) == _kmer_counts(orig, 2)
    assert not np.array_equal(got, orig)
