"""simreads completeness: InDel simulation, simulated-SNP truth BED,
error-profile modes, random reads — and E2E truth for the -a/-A aligner
paths (VERDICT round-1 item 5; reference SimReads.cpp SimInDels /
SimSeqErrors / simulated-SNP loop :2437)."""
import numpy as np

from biokanga.align.params import AlignParams
from biokanga.align.pipeline import (
    AlignEngine,
    ExtendedAligner,
    cigar_for,
    pad_rows,
)
from biokanga.index.build import build_index
from biokanga.index.device import to_device
from biokanga.sim.simreads import (
    induce_seq_errors,
    plant_snps,
    random_genome,
    simulate_reads,
)


def test_indel_truth_consistent():
    seqs = random_genome([("c1", 30000)], seed=5)
    names, reads, truths = simulate_reads(
        seqs, 400, read_len=100, sub_rate=0.0, seed=3,
        indel_rate=1.0, indel_size=5,
    )
    s = dict(seqs)["c1"]
    n_indel = 0
    for t, r in zip(truths, reads):
        if t.indels == 0:
            continue
        n_indel += 1
        w = s[t.start - 1 : t.end]
        if t.strand == "-":
            w = np.where(w >= 4, w, 3 - w)[::-1]
        if t.indels < 0:
            # deletion: genomic span L+g; read = window minus g bases
            g = -t.indels
            assert len(w) == 100 + g
            # read must be reconstructable by deleting g at SOME position
            ok = any(
                np.array_equal(np.concatenate([w[:p], w[p + g:]]), r)
                for p in range(0, 101)
            )
            assert ok
        else:
            # insertion: genomic span L-g; read contains the window bases
            g = t.indels
            assert len(w) == 100 - g
            ok = any(
                np.array_equal(np.concatenate([r[:p], r[p + g:]]), w)
                for p in range(0, 101 - g)
            )
            assert ok
    assert n_indel > 300  # indel_rate=1.0 (deletions at seq start may skip)


def test_indel_reads_align_with_microindel_pass():
    """E2E: indel-simulated reads are recovered by the -a micro-indel
    fall-through at the truth locus with the right CIGAR family."""
    seqs = random_genome([("c1", 40000)], seed=7)
    names, reads, truths = simulate_reads(
        seqs, 256, read_len=100, sub_rate=0.0, seed=9,
        indel_rate=1.0, indel_size=4,
    )
    lengths = np.full(len(reads), 100, np.int32)
    reads_p, lengths_p = pad_rows(reads, lengths)
    eng = AlignEngine(to_device(build_index(seqs, lut_bases=10)),
                      AlignParams(batch_size=len(reads_p)))
    ext = ExtendedAligner(eng, micro_indel_len=9)
    res = ext.align(reads_p, lengths_p)
    ok = loci_ok = 0
    for i, t in enumerate(truths):
        if t.indels == 0:
            continue
        if not res["unique"][i]:
            continue
        ok += 1
        loci_ok += abs(int(res["locus"][i]) - (t.start - 1)) <= 4
        cig = cigar_for(100, int(res["cigar_op"][i]),
                        int(res["op_len"][i]), int(res["split"][i]))
        assert ("I" in cig) or ("D" in cig) or cig == "100M"
    n_indel = sum(1 for t in truths if t.indels != 0)
    assert ok / n_indel > 0.9
    assert loci_ok / max(ok, 1) > 0.95


def test_splice_reads_align_with_junction_pass():
    """E2E: junction-spanning transcript reads recovered by -A."""
    seqs = random_genome([("c1", 60000)], seed=11)
    s = seqs[0][1]
    exon1, exon2 = s[10000:10400], s[30000:30400]
    transcript = np.concatenate([exon1, exon2])
    rng = np.random.default_rng(2)
    L = 100
    rows, starts = [], []
    for _ in range(128):
        # spanning reads: start so the junction (at 400) is inside
        st = int(rng.integers(320, 381))
        rows.append(transcript[st : st + L])
        starts.append(st)
    reads = np.stack(rows).astype(np.int8)
    lengths = np.full(len(reads), L, np.int32)
    reads_p, lengths_p = pad_rows(reads, lengths)
    eng = AlignEngine(to_device(build_index(seqs, lut_bases=10)),
                      AlignParams(batch_size=len(reads_p)))
    ext = ExtendedAligner(eng, splice_junct_len=50_000)
    res = ext.align(reads_p, lengths_p)
    good = 0
    for i, st in enumerate(starts):
        if not res["unique"][i]:
            continue
        if res["cigar_op"][i] == (1 << 30):  # splice marker
            good += (abs(int(res["locus"][i]) - (10000 + st)) <= 2
                     and abs(int(res["op_len"][i]) - 19600) <= 4)
    assert good > 100


def test_plant_snps_and_bed(tmp_path):
    seqs = random_genome([("c1", 100000), ("c2", 50000)], seed=3)
    bed = str(tmp_path / "truth.bed")
    mut, snps = plant_snps(seqs, snp_rate_per_mbp=500, seed=4, bed_path=bed)
    assert len(snps) == (1 + 50) + (1 + 25)
    # originals untouched; mutated differ exactly at the SNP loci
    d = dict(seqs)
    m = dict(mut)
    for chrom in ("c1", "c2"):
        diff = np.nonzero(d[chrom] != m[chrom])[0]
        want = sorted(ofs for c, ofs, _, _ in snps if c == chrom)
        assert sorted(diff.tolist()) == want
    lines = [l for l in open(bed) if not l.startswith("track")]
    assert len(lines) == len(snps)
    f0 = lines[0].split("\t")
    assert int(f0[2]) == int(f0[1]) + 1


def test_snp_truth_e2e():
    """Plant SNPs -> simulate reads from the mutated genome -> align vs
    the ORIGINAL genome -> pileup -> call_snps recovers the planted loci
    (the BASELINE SNP-calling config with simulated truth)."""
    from biokanga.align.snp import PileupAccumulator, SNPParams, call_snps

    seqs = random_genome([("c1", 20000)], seed=21)
    mut, snps = plant_snps(seqs, snp_rate_per_mbp=1000, seed=6)
    names, reads, truths = simulate_reads(mut, 4000, read_len=100,
                                          sub_rate=0.002, seed=7)
    lengths = np.full(len(reads), 100, np.int32)
    didx = to_device(build_index(seqs, lut_bases=10))
    eng = AlignEngine(didx, AlignParams(batch_size=4096))
    reads_p, lengths_p = pad_rows(reads, lengths)
    res = eng.align_with_rescue(reads_p, lengths_p)
    acc = PileupAccumulator(didx)
    acc.add_alignments(reads_p, lengths_p, res)
    counts, match, mismatch = acc.finalize()
    idx = build_index(seqs, lut_bases=10)
    calls = call_snps(counts, match, mismatch, idx.codes,
                      idx.entry_names, idx.entry_starts,
                      SNPParams(min_snp_reads=5))
    called = {(c.chrom, c.loci) for c in calls if c.pvalue < 0.05}
    truth = {(c, o) for c, o, _, _ in snps}
    # 20x coverage: the vast majority of planted SNPs must be recovered
    found = len(called & truth)
    assert found / len(truth) > 0.85
    # and few spurious calls
    assert len(called - truth) < 0.2 * len(truth)


def test_error_modes_distributions():
    rng = np.random.default_rng(8)
    reads = rng.integers(0, 4, size=(4000, 100)).astype(np.int8)
    orig = reads.copy()
    n1 = induce_seq_errors(reads, 100, "fixed", 5, True, rng)
    assert (n1 == 5).mean() > 0.95  # collisions may rarely drop one
    # static profile: mean ~1 sub/read
    reads2 = orig.copy()
    n2 = induce_seq_errors(reads2, 100, "static", 0, True, rng)
    assert 0.7 < n2.mean() < 1.3
    # Illumina spatial: 3' quartile gets far more subs than 5' quartile
    reads3 = orig.copy()
    induce_seq_errors(reads3, 100, "fixed", 8, False, rng)
    changed = reads3 != orig
    assert changed[:, 75:].sum() > 2 * changed[:, :25].sum()


def test_random_reads_mostly_unaligned():
    seqs = random_genome([("c1", 30000)], seed=13)
    names, reads, truths = simulate_reads(
        seqs, 256, read_len=100, sub_rate=0.01, seed=5, prop_random=0.5,
    )
    n_rand = sum(1 for t in truths if t.chrom == "random")
    assert 80 < n_rand < 180
    lengths = np.full(len(reads), 100, np.int32)
    eng = AlignEngine(to_device(build_index(seqs, lut_bases=10)),
                      AlignParams(batch_size=256))
    res = eng.align_with_rescue(reads, lengths)
    for i, t in enumerate(truths):
        if t.chrom == "random":
            assert not res["any_hit"][i]
        else:
            assert res["unique"][i] or res["inst"][i] > 1 or res["overflow"][i] or not res["any_hit"][i]
