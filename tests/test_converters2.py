"""Second converter batch: psl2csv, blast2csv, csv tools, fasta2dist,
agp2genome, dmpbioseq, hammingdist."""
import numpy as np

from biokanga.cli import main
from biokanga.seq.encode import codes_to_ascii, revcomp
from biokanga.seq.fasta import read_seqs, write_fasta
from biokanga.sim.simreads import random_genome


def test_psl2csv(tmp_path):
    psl = tmp_path / "in.psl"
    psl.write_text(
        "psLayout version 3\n\nmatch\tmis-\n----\n"
        "90\t5\t0\t0\t1\t2\t1\t3\t+\tq1\t100\t0\t97\tt1\t5000\t100\t200\t"
        "2\t50,45\t0,52\t100,155\n"
    )
    out = tmp_path / "out.csv"
    assert main(["psl2csv", "-i", str(psl), "-o", str(out)]) == 0
    rows = out.read_text().strip().splitlines()
    assert len(rows) == 2
    assert rows[1].startswith('90,5,0,0,1,2,1,3,"+","q1"')


def test_blast2csv(tmp_path):
    b = tmp_path / "in.b6"
    b.write_text("# comment\nq1\tt1\t98.5\t100\t1\t0\t1\t100\t500\t599\t"
                 "1e-50\t190\n")
    out = tmp_path / "out.csv"
    assert main(["blast2csv", "-i", str(b), "-o", str(out)]) == 0
    rows = out.read_text().strip().splitlines()
    assert len(rows) == 2 and rows[1].startswith('"q1","t1",98.5')


def test_csv_tools(tmp_path):
    src = tmp_path / "a.csv"
    src.write_text('"Name","Score","Chrom"\n"x",5,"chr1"\n"y",15,"chr2"\n'
                   '"z",25,"chr1"\n')
    stats = tmp_path / "stats.csv"
    assert main(["csv2stats", "-i", str(src), "-o", str(stats)]) == 0
    srows = stats.read_text().strip().splitlines()
    assert any(r.startswith('"Score",3,5,25,15') for r in srows)

    filt = tmp_path / "f.csv"
    assert main(["csvfilter", "-i", str(src), "-o", str(filt),
                 "-c", "Score", "-p", "gt", "-V", "10"]) == 0
    assert len(filt.read_text().strip().splitlines()) == 3  # hdr + y + z

    filt2 = tmp_path / "f2.csv"
    assert main(["csvfilter", "-i", str(src), "-o", str(filt2),
                 "-c", "Chrom", "-p", "match", "-V", "chr1"]) == 0
    assert len(filt2.read_text().strip().splitlines()) == 3  # hdr + x + z

    other = tmp_path / "b.csv"
    other.write_text('"Name","Extra"\n"y",7\n"w",9\n')
    merged = tmp_path / "m.csv"
    assert main(["csvmerge", "-i", str(src), "-i", str(other),
                 "-o", str(merged), "-k", "Name"]) == 0
    mrows = merged.read_text().strip().splitlines()
    assert len(mrows) == 5  # header + x,y,z,w

    feat = tmp_path / "feat.bed"
    src2 = tmp_path / "loci.csv"
    src2.write_text('"Chrom","Start","End","Name","Strand"\n'
                    '"chr1",100,200,"snp1","-"\n')
    assert main(["csv2feat", "-i", str(src2), "-o", str(feat)]) == 0
    assert feat.read_text() == "chr1\t100\t200\tsnp1\t0\t-\n"


def test_fasta2dist(tmp_path):
    g = random_genome([("a", 2000)], seed=8)[0][1]
    recs = [("a", g), ("a2", g.copy()), ("b", random_genome(
        [("b", 2000)], seed=99)[0][1])]
    fa = tmp_path / "in.fa"
    write_fasta(str(fa), recs)
    out = tmp_path / "d.csv"
    assert main(["fasta2dist", "-i", str(fa), "-o", str(out)]) == 0
    rows = [r.split(",") for r in out.read_text().strip().splitlines()[1:]]
    d_aa2 = float(rows[0][2])
    d_ab = float(rows[0][3])
    assert d_aa2 < 1e-9 < d_ab


def test_agp2genome(tmp_path):
    c1 = random_genome([("c1", 300)], seed=1)[0][1]
    c2 = random_genome([("c2", 200)], seed=2)[0][1]
    ctg = tmp_path / "ctg.fa"
    write_fasta(str(ctg), [("c1", c1), ("c2", c2)])
    agp = tmp_path / "s.agp"
    agp.write_text(
        "scaf1\t1\t300\t1\tW\tc1\t1\t300\t+\n"
        "scaf1\t301\t400\t2\tN\t100\tscaffold\tyes\tpaired-ends\n"
        "scaf1\t401\t600\t3\tW\tc2\t1\t200\t-\n"
    )
    out = tmp_path / "genome.fa"
    assert main(["agp2genome", "-a", str(agp), "-c", str(ctg),
                 "-o", str(out)]) == 0
    recs = list(read_seqs(str(out)))
    assert len(recs) == 1 and recs[0].name == "scaf1"
    got = recs[0].codes
    assert len(got) == 600
    assert np.array_equal(got[:300], c1)
    assert (got[300:400] == 4).all()
    assert np.array_equal(got[400:], revcomp(c2))


def test_dmpbioseq_rds(tmp_path):
    from biokanga.seq.rds import write_rds

    rng = np.random.default_rng(3)
    recs = [(f"r{i}", rng.integers(0, 4, 60).astype(np.int8))
            for i in range(5)]
    rds = tmp_path / "x.rds.npz"
    write_rds(str(rds), recs)
    out = tmp_path / "dump.txt"
    assert main(["dmpbioseq", "-i", str(rds), "-o", str(out)]) == 0
    text = out.read_text()
    assert text.count(">") == 5
    assert codes_to_ascii(recs[0][1]).decode() in text


def test_hammingdist(tmp_path):
    src = tmp_path / "h.csv"
    lines = ['"Chrom","Loci","Hamming"']
    lines += [f'"chr1",{i},{h}' for i, h in enumerate([0, 1, 1, 2, 3, 3, 3])]
    src.write_text("\n".join(lines) + "\n")
    out = tmp_path / "hist.csv"
    assert main(["hammingdist", "-i", str(src), "-o", str(out),
                 "-w", "4"]) == 0
    text = out.read_text().splitlines()
    assert text[1] == "0,1,0.142857"
    assert text[4] == "3,3,0.428571"
    assert any(l.startswith('"chr1",0,1.0000') for l in text)
