"""CContaminants parity: flank overlay types 5'/3' x PE1/PE2 (+RC codes)
and whole-vector containment (libbiokanga/Contaminants.h:31,95-110;
naming convention Contaminants.cpp:195-203), wired into filter and ngsqc."""
import numpy as np

from biokanga.seq.contaminants import (
    T_3PE1,
    T_3PE2,
    T_5PE1,
    T_5PE2,
    Contaminants,
)
from biokanga.seq.encode import ascii_to_codes, revcomp
from biokanga.seq.fasta import write_fasta, write_fastq
from biokanga.sim.simreads import random_genome


def _db(tmp_path, entries):
    p = str(tmp_path / "contam.fa")
    write_fasta(p, entries)
    return Contaminants.load(p)


def test_naming_convention_and_flank_match(tmp_path):
    ad = ascii_to_codes(b"AGATCGGAAGAGCACACGT")
    vec = random_genome([("v", 400)], seed=1)[0][1]
    db = _db(tmp_path, [
        ("illumina3@34", ad),        # 3' PE1 + PE2
        ("prefix5@1", ad[::-1]),     # 5' PE1 only
        ("rcboth@78", ad),           # 3' PE1+PE2 after revcomp
        ("clonevec&12", vec),        # vector, PE1+PE2
    ])
    assert db.num_flank == 3  # @34 plain, @1 plain, @78 rc-only
    types = {(f.name, f.rc): f.types for f in db.flank}
    assert types[("illumina3", False)] == (T_3PE1, T_3PE2)
    assert types[("prefix5", False)] == (T_5PE1,)
    assert types[("rcboth", True)] == (T_3PE1, T_3PE2)
    assert db.num_vectors == 1 and db.vectors[0].pe1 and db.vectors[0].pe2

    rng = np.random.default_rng(3)
    L = 80
    reads = rng.integers(0, 4, size=(6, L)).astype(np.int8)
    lengths = np.full(6, L, np.int32)
    # read 0: adapter read-through at the 3' end (12 bases of the prefix)
    reads[0, L - 12 :] = ad[:12]
    # read 1: 5' overlay = contaminant SUFFIX over read prefix
    pre = ad[::-1]
    reads[1, :10] = pre[-10:]
    # read 2: revcomp'd contaminant prefix at 3' end
    reads[2, L - 14 :] = revcomp(ad)[:14]
    ov3 = db.match_flank(reads, lengths, T_3PE1, min_overlap=8,
                         subs_rate=0)
    assert ov3[0] == 12 and ov3[2] == 14 and ov3[1] == 0
    ov5 = db.match_flank(reads, lengths, T_5PE1, min_overlap=8,
                         subs_rate=0)
    assert ov5[1] == 10 and ov5[0] == 0
    # PE2 5' should NOT match (prefix5 is PE1-only)
    ov5b = db.match_flank(reads, lengths, T_5PE2, min_overlap=8,
                          subs_rate=0)
    assert ov5b[1] == 0
    # subs tolerance: 1 sub per 25bp of overlap
    reads[3, L - 18 :] = ad[:18]
    reads[3, L - 5] = (reads[3, L - 5] + 1) % 4
    ov3s = db.match_flank(reads[3:4], lengths[3:4], T_3PE1,
                          min_overlap=8, subs_rate=1)
    assert ov3s[0] == 18


def test_vector_containment(tmp_path):
    vec = random_genome([("v", 500)], seed=5)[0][1]
    db = _db(tmp_path, [("clonevec&15", vec)])  # PE1 sense + PE1 rc
    rng = np.random.default_rng(7)
    reads = rng.integers(0, 4, size=(4, 60)).astype(np.int8)
    reads[0] = vec[100:160]            # contained, sense
    reads[1] = revcomp(vec[300:360])   # contained after rc
    lengths = np.full(4, 60, np.int32)
    hit = db.match_vectors(reads, lengths, is_pe2=False)
    assert hit[0] and hit[1] and not hit[2] and not hit[3]
    # PE2 not enabled for this vector
    hit2 = db.match_vectors(reads, lengths, is_pe2=True)
    assert not hit2.any()


def test_filter_cli_with_contaminant_db(tmp_path):
    from biokanga.cli import main

    ad = ascii_to_codes(b"AGATCGGAAGAGCACACGTCTGAA")
    vec = random_genome([("v", 400)], seed=2)[0][1]
    cfa = str(tmp_path / "c.fa")
    write_fasta(cfa, [("adp@3", ad), ("vec&1", vec)])
    rng = np.random.default_rng(9)
    reads = rng.integers(0, 4, size=(30, 80)).astype(np.int8)
    reads[0, 60:] = ad[:20]        # 3' adapter -> trimmed to 60
    reads[1] = vec[50:130]         # vector-contained -> rejected
    fq = str(tmp_path / "r.fastq")
    write_fastq(fq, [(f"r{i}", reads[i], None) for i in range(30)])
    out = str(tmp_path / "f.fastq")
    assert main(["filter", "-i", fq, "-o", out, "-c", cfa,
                 "--min-len", "50", "-n", "0"]) == 0
    got = {}
    from biokanga.seq.fasta import read_seqs

    for r in read_seqs(out):
        got[r.name] = r.codes
    assert len(got["r0"]) == 60
    assert "r1" not in got
    assert len(got) == 29


def test_ngsqc_contaminant_report(tmp_path):
    from biokanga.cli import main

    ad = ascii_to_codes(b"AGATCGGAAGAGCACACGTCT")
    cfa = str(tmp_path / "c.fa")
    write_fasta(cfa, [("adp@3", ad)])
    rng = np.random.default_rng(4)
    reads = rng.integers(0, 4, size=(40, 70)).astype(np.int8)
    reads[:10, 55:] = ad[:15]
    fq = str(tmp_path / "r.fastq")
    write_fastq(fq, [(f"r{i}", reads[i], None) for i in range(40)])
    html = str(tmp_path / "qc.html")
    assert main(["ngsqc", "-i", fq, "-o", html, "-c", cfa]) == 0
    txt = open(html).read()
    assert "Contaminants" in txt and "adp" in txt
    assert "reads with 3' contaminant overlay" in txt


def test_near_duplicate_mask_and_filter(tmp_path):
    from biokanga.cli import main
    from biokanga.seq.fasta import read_seqs as _rs
    from biokanga.tools.filter_reads import near_duplicate_mask

    rng = np.random.default_rng(11)
    base = rng.integers(0, 4, size=80).astype(np.int8)
    v1 = base.copy(); v1[40] = (v1[40] + 1) % 4          # 1 sub
    v2 = base.copy(); v2[3] = (v2[3] + 2) % 4            # sub in anchor 0
    far = base.copy()
    far[::7] = (far[::7] + 1) % 4                        # 12 subs: distinct
    other = rng.integers(0, 4, size=80).astype(np.int8)
    seqs = [base, v1, v2, far, other, v1.copy()]
    dup = near_duplicate_mask(seqs, max_subs=2)
    assert dup.tolist() == [False, True, True, False, False, True]

    write_fastq(str(tmp_path / "n.fastq"),
                [(f"n{i}", s, None) for i, s in enumerate(seqs)])
    out = str(tmp_path / "nf.fastq")
    assert main(["filter", "-i", str(tmp_path / "n.fastq"), "-o", out,
                 "--near-dedupe", "--min-len", "50", "-n", "0"]) == 0
    kept = [r.name for r in _rs(out)]
    assert kept == ["n0", "n3", "n4"]
