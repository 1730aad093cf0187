"""SQLite summaries + loader tests."""
import sqlite3

import numpy as np

from biokanga.cli import main
from biokanga.utils.sqlite_summaries import SQLiteSummaries


def test_summaries_roundtrip(tmp_path):
    db = str(tmp_path / "s.db")
    s = SQLiteSummaries(db)
    eid = s.start_experiment("exp1", "test run")
    pid = s.add_process(eid, "align")
    s.add_parameter(eid, pid, "subs", 10)
    s.add_result(eid, pid, "unique", 1234)
    s.end_process(pid, 0)
    s.close()
    con = sqlite3.connect(db)
    assert con.execute("SELECT COUNT(*) FROM TblExperiments").fetchone()[0] == 1
    r = con.execute(
        "SELECT ParamName, ParamValue FROM TblParameters"
    ).fetchone()
    assert r == ("subs", "10")
    assert con.execute(
        "SELECT ResultValue FROM TblResults WHERE ResultName='unique'"
    ).fetchone()[0] == "1234"
    assert con.execute(
        "SELECT Finished IS NOT NULL FROM TblProcesses"
    ).fetchone()[0] == 1


def test_snps2sqlite_and_index_q(tmp_path):
    # produce a SNP CSV through the writer, load it
    from biokanga.align.snp import SNPCall, write_snps_csv

    cnts = np.array([3, 0, 9, 0], np.int64)
    calls = [
        SNPCall(chrom="chr1", loci=42, ref_base=0, tot_bases=12, nonref=9,
                base_cnts=cnts, pvalue=1e-8, bkgnd_rate=0.01,
                win_bases=200, win_mm=2, rank=1)
    ]
    csvp = str(tmp_path / "snps.csv")
    write_snps_csv(csvp, calls)
    db = str(tmp_path / "snps.db")
    assert main(["snps2sqlite", "-i", csvp, "-o", db, "-n", "e1",
                 "-c", "cv1"]) == 0
    con = sqlite3.connect(db)
    assert con.execute("SELECT COUNT(*) FROM TblSnps").fetchone()[0] == 1
    row = con.execute(
        "SELECT Gcnt, TotCovCnt FROM TblSnps"
    ).fetchone()
    assert row == (9, 12)
    assert con.execute("SELECT SeqName FROM TblSeqs").fetchone()[0] == "chr1"

    # -q experiment logging through the index subcommand
    from biokanga.seq.fasta import write_fasta
    from biokanga.sim.simreads import random_genome

    fa = str(tmp_path / "g.fa")
    write_fasta(fa, random_genome([("c", 2000)], seed=2))
    qdb = str(tmp_path / "sum.db")
    assert main(["index", "-i", fa, "-o", str(tmp_path / "g.idx.npz"),
                 "--lut-bases", "8", "-q", qdb]) == 0
    con = sqlite3.connect(qdb)
    assert con.execute(
        "SELECT ProcName FROM TblProcesses"
    ).fetchone()[0] == "index"
    assert con.execute(
        "SELECT ResultValue FROM TblResults WHERE ResultName='total_bp'"
    ).fetchone()[0] == "2000"


def test_universal_sumrslts_dispatch(tmp_path):
    """-q/--sumrslts on subcommands WITHOUT their own flag logs a row
    via the dispatch wrapper (reference: every subprocess logs its
    experiment, biokanga.cpp:134-137) — three diverse subcommands."""
    db = str(tmp_path / "u.db")

    # 1. csv2bed (converter)
    csv = tmp_path / "in.csv"
    csv.write_text(
        "chrom,start,end,name,strand\n"
        "chr1,100,199,el1,+\n"
        "chr1,500,599,el2,-\n")
    bed = str(tmp_path / "out.bed")
    assert main(["csv2bed", "-i", str(csv), "-o", bed, "-q", db]) == 0

    # 2. fastafilter (sequence tool), --sumrslts= form
    fa = tmp_path / "in.fa"
    fa.write_text(">a\nACGTACGTACGT\n>b\nAC\n")
    out_fa = str(tmp_path / "out.fa")
    assert main(["fastafilter", "-i", str(fa), "-o", out_fa,
                 "--min-len", "5", f"--sumrslts={db}"]) == 0

    # 3. ssr (discovery tool)
    fa2 = tmp_path / "ssr.fa"
    fa2.write_text(">s\n" + "ACGG" * 30 + "TTGACCA\n")
    out_csv = str(tmp_path / "ssr.csv")
    assert main(["ssr", "-i", str(fa2), "-o", out_csv, "-q", db]) == 0

    con = sqlite3.connect(db)
    procs = [r[0] for r in con.execute(
        "SELECT ProcName FROM TblProcesses").fetchall()]
    assert sorted(procs) == ["csv2bed", "fastafilter", "ssr"]
    rc = con.execute(
        "SELECT ResultValue FROM TblResults WHERE ResultName='result_code'"
    ).fetchall()
    assert len(rc) == 3 and all(v == ('0',) for v in rc)
