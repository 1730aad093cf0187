"""Generic csv2sqlite loader + alignvalidate harness."""
import sqlite3

from biokanga.cli import main


def test_csv2sqlite(tmp_path):
    csvp = tmp_path / "markers.csv"
    csvp.write_text('"Name","Loci","Score"\n"m1",100,0.5\n"m2",250,1.5\n'
                    '"m3",,2\n')
    db = str(tmp_path / "x.db")
    assert main(["csv2sqlite", "-i", str(csvp), "-o", db]) == 0
    con = sqlite3.connect(db)
    rows = con.execute("SELECT Name, Loci, Score FROM markers "
                       "ORDER BY Name").fetchall()
    assert rows == [("m1", 100, 0.5), ("m2", 250, 1.5), ("m3", None, 2.0)]
    # type inference: Loci INTEGER, Score REAL
    info = {r[1]: r[2] for r in con.execute("PRAGMA table_info(markers)")}
    assert info["Loci"] == "INTEGER" and info["Score"] == "REAL"
    con.close()


SAM_HDR = "@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:10000\n"


def _samline(name, chrom, pos, flag=0):
    if chrom is None:
        return f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n"
    return (f"{name}\t{flag}\t{chrom}\t{pos + 1}\t60\t4M\t*\t0\t0\t"
            "ACGT\tIIII\n")


def test_alignvalidate_truth_mode(tmp_path, capsys):
    sam = tmp_path / "a.sam"
    lines = [SAM_HDR]
    # simreads descriptor: lcl|usimreads|N|chrom|start|end|len|strand|...
    lines.append(_samline("lcl|usimreads|00000001|chr1|100|199|100|+|0|0|0",
                          "chr1", 100))
    lines.append(_samline("lcl|usimreads|00000002|chr1|500|599|100|-|0|0|0",
                          "chr1", 500, flag=16))
    lines.append(_samline("lcl|usimreads|00000003|chr1|900|999|100|+|0|0|0",
                          "chr1", 333))  # wrong locus
    lines.append(_samline("lcl|usimreads|00000004|chr1|700|799|100|+|0|0|0",
                          None, 0))
    sam.write_text("".join(lines))
    out = tmp_path / "v.csv"
    assert main(["alignvalidate", "-i", str(sam), "-o", str(out)]) == 0
    text = out.read_text()
    assert '"Correct",2' in text and '"Wrong",1' in text
    assert '"Unaligned",1' in text


def test_alignvalidate_sam_vs_sam(tmp_path):
    a = tmp_path / "a.sam"
    b = tmp_path / "b.sam"
    a.write_text(SAM_HDR + _samline("r1", "chr1", 100)
                 + _samline("r2", "chr1", 200) + _samline("r3", None, 0))
    b.write_text(SAM_HDR + _samline("r1", "chr1", 101)
                 + _samline("r2", "chr1", 900) + _samline("r3", "chr1", 5))
    out = tmp_path / "v.csv"
    assert main(["alignvalidate", "-i", str(a), "-r", str(b),
                 "-o", str(out)]) == 0
    text = out.read_text()
    assert '"AlignedBoth",2' in text
    assert '"Agree",1' in text          # r1 within tolerance, r2 not
    assert '"OnlyInRef",1' in text      # r3 aligned only in ref
