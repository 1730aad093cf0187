"""CAligner post-pass family (Aligner.cpp:594-672 parity): AutoTrimFlanks,
PCR5PrimerCorrect, orphan splice/microInDel removal, loci constraints —
as vectorised array passes."""
import numpy as np

from biokanga.align.postpass import (
    SPLICE_MARKER,
    ConstraintLoci,
    auto_trim_flanks,
    identify_constraint_violations,
    pcr5_primer_correct,
    reduce_pcr_duplicates,
    remove_orphan_microindels,
    remove_orphan_splice_juncts,
)
from biokanga.seq.encode import revcomp


def _mkres(n, loci, rc=None, mm=None):
    return {
        "unique": np.ones(n, bool),
        "locus": np.asarray(loci, np.int64),
        "is_rc": np.zeros(n, bool) if rc is None else np.asarray(rc),
        "best_mm": np.zeros(n, np.uint8) if mm is None else np.asarray(
            mm, np.uint8),
    }


def test_auto_trim_flanks_plus_and_minus():
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, size=5000).astype(np.int8)
    L = 60
    reads = np.zeros((4, L), np.int8)
    lengths = np.full(4, L, np.int32)
    # read 0: dirty 5' flank (mm at 0,2,4), clean elsewhere
    reads[0] = genome[100:160]
    for p in (0, 2, 4):
        reads[0, p] = (reads[0, p] + 1) % 4
    # read 1: clean everywhere
    reads[1] = genome[300:360]
    # read 2: minus strand, dirty 3'-of-genome end
    w = genome[700:760].copy()
    for p in (57, 59):
        w[p] = (w[p] + 1) % 4
    reads[2] = revcomp(w)
    # read 3: hopeless (mismatch every 3rd base -> no 10-exact flank)
    reads[3] = genome[900:960]
    reads[3, ::3] = (reads[3, ::3] + 1) % 4

    res = _mkres(4, [100, 300, 700, 900],
                 rc=[False, False, True, False],
                 mm=[3, 0, 2, 20])
    st = auto_trim_flanks(reads, lengths, res, genome,
                          min_flank_exacts=10)
    assert res["unique"][0] and res["clip5"][0] == 5 and res["clip3"][0] == 0
    assert res["locus"][0] == 105 and res["best_mm"][0] == 0
    assert res["unique"][1] and res["clip5"][1] == 0 and res["clip3"][1] == 0
    # minus read: mm at oriented (genome-forward) positions 57,59 ->
    # trim3(oriented)=... window [700..757) trimmed at the right end
    assert res["unique"][2] and res["locus"][2] == 700
    assert res["clip3"][2] == 3 and res["best_mm"][2] == 0
    assert not res["unique"][3]
    assert st.demoted_plus == 1


def test_pcr5_primer_correct():
    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, size=2000).astype(np.int8)
    L = 50
    reads = np.zeros((2, L), np.int8)
    lengths = np.full(2, L, np.int32)
    # plus read: 3 subs inside first 12 bases
    reads[0] = genome[100:150]
    for p in (1, 5, 9):
        reads[0, p] = (reads[0, p] + 2) % 4
    # minus read: 2 subs in ORIENTED first 12 (genome-forward start)
    w = genome[400:450].copy()
    for p in (2, 7):
        w[p] = (w[p] + 1) % 4
    reads[1] = revcomp(w)
    res = _mkres(2, [100, 400], rc=[False, True], mm=[3, 2])
    # max rate 2 subs/100 over 50bp -> MaxMMs = 1
    nr, nb = pcr5_primer_correct(reads, lengths, res, genome,
                                 max_sub_rate=2, klen=12)
    assert nr == 2 and nb == 3
    assert res["best_mm"][0] == 1 and res["best_mm"][1] == 1
    # reads were corrected toward the genome IN READ SPACE
    assert (reads[0, [1, 5]] == genome[[101, 105]]).all()
    assert reads[1, L - 1 - 2] == (3 - genome[402])


def test_orphan_splice_and_indel_removal():
    n = 6
    res = _mkres(n, [100, 102, 5000, 100, 101, 9000])
    res["cigar_op"] = np.array([SPLICE_MARKER, SPLICE_MARKER, SPLICE_MARKER,
                                3, 3, -2], np.int64)
    res["op_len"] = np.array([500, 500, 700, 0, 0, 0], np.int64)
    res["split"] = np.array([40, 38, 50, 30, 29, 55], np.int64)
    lengths = np.full(n, 100, np.int32)
    # splice: rows 0,1 support each other (donor 140 vs 140, acceptor +-3);
    # row 2 is an orphan
    d = remove_orphan_splice_juncts(res, lengths)
    assert d == 1
    assert res["unique"][0] and res["unique"][1] and not res["unique"][2]
    # indels: rows 3,4 same size-3 indel at ~130; row 5 orphan
    d2 = remove_orphan_microindels(res, lengths)
    assert d2 == 1
    assert res["unique"][3] and res["unique"][4] and not res["unique"][5]


def test_constraint_violations():
    genome = np.zeros(1000, np.int8)  # all A
    genome[500] = 2                   # ref G at the constrained locus
    L = 40
    reads = np.zeros((3, L), np.int8)
    lengths = np.full(3, L, np.int32)
    reads[0] = genome[480:520]        # matches ref (G at offset 20)
    reads[1] = genome[480:520]
    reads[1, 20] = 3                  # T at the constrained locus
    reads[2] = genome[100:140]        # doesn't cover the locus
    res = _mkres(3, [480, 480, 100])
    cons = [ConstraintLoci("chr1", 500, 500, "AR")]
    n = identify_constraint_violations(
        reads, lengths, res, genome, ["chr1"], np.array([0, 1000]), cons
    )
    assert n == 1
    assert res["unique"][0] and not res["unique"][1] and res["unique"][2]


def test_reduce_pcr_duplicates_vectorised():
    n = 10
    res = _mkres(n, [5, 5, 5, 9, 9, 7, 5, 9, 7, 7],
                 rc=[0, 0, 0, 0, 0, 0, 1, 0, 0, 0])
    lengths = np.full(n, 30, np.int32)
    d = reduce_pcr_duplicates(res, lengths, keep=2)
    # locus 5 fwd x3 / locus 9 x3 / locus 7 x3 -> demote 1 each;
    # locus 5 rc x1 -> keep
    assert d == 3
    assert res["unique"].sum() == 7
