"""SNP calling tests: planted SNPs recovered, clean loci rejected."""
import numpy as np
import pytest

from biokanga.align.params import AlignParams
from biokanga.align.pipeline import AlignEngine
from biokanga.align.snp import (
    PileupAccumulator,
    SNPParams,
    call_snps,
    write_snps_csv,
    write_snps_vcf,
)
from biokanga.index.build import build_index
from biokanga.index.device import to_device
from biokanga.sim.simreads import random_genome, simulate_reads


@pytest.fixture(scope="module")
def snp_setup():
    seqs = random_genome([("chr1", 30000)], seed=101)
    idx = build_index(seqs, lut_bases=8)
    engine = AlignEngine(to_device(idx), AlignParams())
    return seqs, idx, engine


def test_planted_snps_called(snp_setup, tmp_path):
    seqs, idx, engine = snp_setup
    # mutate the "sample" genome at known loci, simulate reads from it,
    # align against the REFERENCE genome, call SNPs
    rng = np.random.default_rng(31)
    sample = [(n, s.copy()) for n, s in seqs]
    snp_loci = sorted(rng.choice(29000, size=20, replace=False) + 500)
    truth = {}
    for l in snp_loci:
        old = sample[0][1][l]
        new = (old + 1 + rng.integers(0, 3)) % 4
        sample[0][1][l] = new
        truth[int(l)] = (int(old), int(new))

    names, reads, _ = simulate_reads(sample, 6000, read_len=100,
                                     sub_rate=0.002, seed=77)
    lengths = np.full(len(reads), 100, dtype=np.int32)
    acc = PileupAccumulator(engine.didx)
    for i in range(0, len(reads), 2048):
        res = engine.align_with_rescue(reads[i:i+2048], lengths[i:i+2048])
        acc.add_alignments(reads[i:i+2048], lengths[i:i+2048], res)
    counts, match, mismatch = acc.finalize()

    calls = call_snps(counts, match, mismatch, idx.codes,
                      idx.entry_names, idx.entry_starts, SNPParams())
    called = {c.loci: c for c in calls}
    found = sum(1 for l in truth if l in called)
    assert found >= 18, f"only {found}/20 planted SNPs called"
    # called alt base must be the planted one
    for l, (old, new) in truth.items():
        if l in called:
            c = called[l]
            assert c.ref_base == old
            assert int(np.argmax(
                [c.base_cnts[b] if b != old else -1 for b in range(4)]
            )) == new
    # false positives: every called SNP should be a planted locus
    # (sub_rate noise is uniform; BH at q=0.05 keeps FP count low)
    fp = [l for l in called if l not in truth]
    assert len(fp) <= 2, f"too many false positives: {fp}"

    # writers
    csvp = str(tmp_path / "snps.csv")
    write_snps_csv(csvp, calls)
    lines = open(csvp).read().splitlines()
    assert lines[0].startswith('"SNP_ID","ElType"')
    assert len(lines) == len(calls) + 1
    vcfp = str(tmp_path / "snps.vcf")
    write_snps_vcf(vcfp, calls, idx.entry_names, np.diff(idx.entry_starts))
    vcf = [l for l in open(vcfp) if not l.startswith("#")]
    assert len(vcf) == len(calls)


def test_no_snps_on_clean_reads(snp_setup):
    seqs, idx, engine = snp_setup
    names, reads, _ = simulate_reads(seqs, 3000, read_len=100, seed=5)
    lengths = np.full(len(reads), 100, dtype=np.int32)
    acc = PileupAccumulator(engine.didx)
    res = engine.align_with_rescue(reads, lengths)
    acc.add_alignments(reads, lengths, res)
    counts, match, mismatch = acc.finalize()
    calls = call_snps(counts, match, mismatch, idx.codes,
                      idx.entry_names, idx.entry_starts, SNPParams())
    assert calls == []


def test_snp_centroids_accumulation():
    import numpy as np

    from biokanga.align.snp import (
        SNPCall,
        snp_centroids,
        write_snp_centroids_csv,
    )

    # genome: ACGTACGTACGT...  the 7-mer centered at locus 5 is g[2..8]
    # = GTACGTA, ref base g[5] = C
    g = np.tile(np.array([0, 1, 2, 3], dtype=np.int8), 5)
    counts = np.zeros((len(g), 4), dtype=np.int32)
    counts[5] = [0, 9, 1, 0]  # covered locus 5 (ref C), alt G
    counts[9] = [0, 10, 0, 0]  # covered locus 9, no SNP
    call = SNPCall(chrom="c", loci=5, ref_base=1, tot_bases=10, nonref=1,
                   base_cnts=counts[5], pvalue=1e-9, bkgnd_rate=0.01,
                   win_bases=100, win_mm=1, rank=1)
    ni, ns, rc, nr = snp_centroids(
        counts, g, [call], ["c"], np.array([0, len(g)]), min_reads=5)
    # expected centroid index for GTACGTA (first base most significant)
    ci = 0
    for b in [2, 3, 0, 1, 2, 3, 0]:
        ci = (ci << 2) | b
    assert ni[ci] >= 1 and ns[ci] == 1
    assert rc[ci] == 9 and nr[ci, 2] == 1 and nr[ci, 0] == 0
    assert ns.sum() == 1
    # two covered loci total
    assert ni.sum() == 2

    import io

    buf = io.StringIO()
    write_snp_centroids_csv(buf, ni, ns, rc, nr)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 4**7 + 1
    row = lines[ci + 1].split(",")
    assert row[0] == str(ci + 1) and row[1] == '"GTACGTA"'
    assert row[4] == '"C"'  # center base
