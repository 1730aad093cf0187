"""quickcount / gensampler / ufilter / loci2dist / kangahrdx / kangaradseq."""
import numpy as np

from biokanga.cli import main
from biokanga.seq.encode import ascii_to_codes
from biokanga.seq.fasta import read_seqs, write_fasta
from biokanga.sim.simreads import random_genome
from biokanga.tools.misc_tools import (
    RADSEQ_SITES, homozy_reduce, radseq_demux,
)


def test_quickcount_modes(tmp_path):
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, [("s1", np.array([0, 1, 2, 3] * 25, np.int8)),
                     ("s2", np.zeros(100, np.int8))])
    out = str(tmp_path / "q.csv")
    assert main(["quickcount", "-i", fa, "-o", out, "-k", "2"]) == 0
    rows = {r.split(",")[0].strip('"'): int(r.split(",")[1])
            for r in open(out).read().strip().splitlines()[1:]}
    assert rows["AA"] == 99          # s2 is all-A
    assert rows["AC"] == 25          # from the ACGT repeat
    out2 = str(tmp_path / "q2.csv")
    assert main(["quickcount", "-i", fa, "-o", out2, "-k", "2",
                 "-m", "perseq"]) == 0
    assert any(l.startswith('"s2","AA",99')
               for l in open(out2).read().splitlines())


def test_gensampler(tmp_path):
    seqs = random_genome([("chr1", 5000)], seed=1)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, seqs)
    bed = tmp_path / "r.bed"
    bed.write_text("chr1\t1000\t2000\tr1\t0\t+\n")
    out = str(tmp_path / "s.fa")
    assert main(["gensampler", "-i", fa, "-o", out, "-n", "20",
                 "-l", "50", "-b", str(bed)]) == 0
    recs = list(read_seqs(out))
    assert len(recs) == 20
    for r in recs:
        s = int(r.name.split("_")[-2])
        assert 1000 <= s and s + 50 <= 2000


def test_ufilter_and_loci2dist(tmp_path):
    bedp = tmp_path / "in.bed"
    bedp.write_text("chr1\t0\t100\ta\t0\t+\nchr2\t0\t250\tb\t0\t+\n"
                    "chrM\t5\t25\tc\t0\t+\n")
    out = tmp_path / "f.bed"
    assert main(["ufilter", "-i", str(bedp), "-o", str(out),
                 "-z", "chr[12]"]) == 0
    assert len(out.read_text().strip().splitlines()) == 2
    out2 = tmp_path / "f2.bed"
    assert main(["ufilter", "-i", str(bedp), "-o", str(out2),
                 "-Z", "chrM"]) == 0
    assert len(out2.read_text().strip().splitlines()) == 2

    dist = tmp_path / "d.csv"
    assert main(["loci2dist", "-i", str(bedp), "-o", str(dist),
                 "-b", "100"]) == 0
    rows = dist.read_text().strip().splitlines()
    assert "0,99,1" in rows            # the 20 bp locus
    assert "100,199,1" in rows         # the 100 bp locus
    assert "200,299,1" in rows         # the 250 bp locus


def test_homozy_reduce():
    rng = np.random.default_rng(4)
    region = rng.integers(0, 4, 200).astype(np.int8)
    reads = [(f"r{i}", region[:100].copy()) for i in range(10)]  # 10 copies
    reads += [(f"u{i}", rng.integers(0, 4, 100).astype(np.int8))
              for i in range(5)]
    kept, st = homozy_reduce(reads, max_copies=2)
    assert st["reads_in"] == 15 and st["reads_out"] == 7  # 2 + 5


def test_radseq_demux_and_cli(tmp_path):
    rng = np.random.default_rng(5)
    site = RADSEQ_SITES["sbfI"]
    bcs = {"sampleA": "ACGTA", "sampleB": "TTGCC"}
    reads = []
    for i, (s, bc) in enumerate(list(bcs.items()) * 3):
        body = rng.integers(0, 4, 80).astype(np.int8)
        codes = np.concatenate([
            np.asarray(ascii_to_codes(bc.encode()), np.int8),
            np.asarray(ascii_to_codes(site.encode()), np.int8),
            body,
        ])
        reads.append((f"rd{i}_{s}", codes))
    # one read with broken site
    bad = reads[0][1].copy()
    bad[6] = (bad[6] + 1) % 4
    reads.append(("bad", bad))
    groups, st = radseq_demux(reads, bcs)
    assert st["assigned"] == 6 and st["bad_site"] == 1
    assert len(groups["sampleA"]) == 3 and len(groups["sampleB"]) == 3
    # barcode trimmed: reads now start with the site remnant
    got = groups["sampleA"][0][1]
    assert np.array_equal(got[: len(site)],
                          np.asarray(ascii_to_codes(site.encode()), np.int8))

    fa = str(tmp_path / "rad.fa")
    write_fasta(fa, reads)
    bcsv = tmp_path / "bc.csv"
    bcsv.write_text("sample,barcode\nsampleA,ACGTA\nsampleB,TTGCC\n")
    outdir = str(tmp_path / "demux")
    assert main(["kangaradseq", "-i", fa, "-b", str(bcsv),
                 "-O", outdir]) == 0
    import os

    assert sorted(os.listdir(outdir)) == ["_unassigned.fa", "sampleA.fa",
                                          "sampleB.fa"]


def test_kangahrdx_cli(tmp_path):
    rng = np.random.default_rng(6)
    region = rng.integers(0, 4, 100).astype(np.int8)
    reads = [(f"r{i}", region.copy()) for i in range(6)]
    fa = str(tmp_path / "in.fa")
    out = str(tmp_path / "out.fa")
    write_fasta(fa, reads)
    assert main(["kangahrdx", "-i", fa, "-o", out,
                 "--max-copies", "2"]) == 0
    assert len(list(read_seqs(out))) == 2


def test_kangapr_sampling(tmp_path):
    from biokanga.cli import main

    p1 = tmp_path / "p1.fq"
    p2 = tmp_path / "p2.fq"
    p1.write_text("".join(f"@a{i}\nACGT\n+\nIIII\n" for i in range(10)))
    p2.write_text("".join(f"@b{i}\nTTTT\n+\nIIII\n" for i in range(10)))
    o1, o2 = str(tmp_path / "o1.fq"), str(tmp_path / "o2.fq")
    # PE: every 3rd pair starting at pair 2, max 2 samples
    assert main(["kangapr", "-m", "1", "-i", str(p1), "-I", str(p2),
                 "-o", o1, "-O", o2, "-s", "2", "-S", "3", "-M", "2"]) == 0
    names1 = [l[1:].strip() for l in open(o1) if l.startswith("@")]
    names2 = [l[1:].strip() for l in open(o2) if l.startswith("@")]
    assert names1 == ["a1", "a4"]
    assert names2 == ["b1", "b4"]
