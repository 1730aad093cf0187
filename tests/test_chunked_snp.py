"""Chunked (tiled) SNP pileup == single-index SNP calling, and the
chunked CLI -O path end-to-end against planted SNP truth."""
import numpy as np

from biokanga.align.params import AlignParams
from biokanga.align.pipeline import AlignEngine, pad_rows
from biokanga.align.snp import (
    ChunkedPileup,
    PileupAccumulator,
    SNPParams,
    call_snps,
)
from biokanga.index.build import build_index
from biokanga.index.chunked import build_chunked_index
from biokanga.index.device import to_device
from biokanga.parallel.chunked import ChunkedAligner
from biokanga.seq.encode import revcomp
from biokanga.sim.simreads import plant_snps, random_genome, simulate_reads


def test_chunked_pileup_matches_single():
    seqs = random_genome([("c1", 30000), ("c2", 20000)], seed=31)
    mut, snps = plant_snps(seqs, snp_rate_per_mbp=600, seed=2)
    _, reads, _ = simulate_reads(mut, 8000, read_len=100, sub_rate=0.002,
                                 seed=4)
    lengths = np.full(len(reads), 100, np.int32)
    reads, lengths = pad_rows(reads, lengths)
    sp = SNPParams(min_snp_reads=5)

    # single-index truth path
    idx = build_index(seqs, lut_bases=10)
    didx = to_device(idx)
    eng = AlignEngine(didx, AlignParams(batch_size=len(reads)))
    res = eng.align_with_rescue(reads, lengths)
    acc = PileupAccumulator(didx)
    acc.add_alignments(reads, lengths, res)
    c1, m1, mm1 = acc.finalize()
    single_calls = call_snps(c1, m1, mm1, idx.codes, idx.entry_names,
                             idx.entry_starts, sp)

    # chunked path (3 chunks, cuts mid-entry)
    ci = build_chunked_index(seqs, num_chunks=3, overlap=256, lut_bases=10)
    ca = ChunkedAligner(ci, AlignParams(batch_size=len(reads)))
    out = ca.align(reads, lengths)
    np.testing.assert_array_equal(out["unique"], res["unique"])

    cp = ChunkedPileup(ci.bases, [c.total_len for c in ci.chunks],
                       ci.owned, ci.overlap)
    for k in range(ci.num_chunks):
        engk = ca.engine_for(k)
        cp.start_chunk(k, int(engk.didx.genome.shape[0]))
        esl = np.clip(ci.entry_starts - ci.bases[k], 0,
                      ci.chunks[k].total_len)
        chunk = np.clip(np.searchsorted(ci.bases, out["locus"],
                                        side="right") - 1, 0, 2)
        a = out["unique"] & (chunk == k)
        aligned = reads.copy()
        for i in np.nonzero(out["is_rc"] & a)[0]:
            L0 = int(lengths[i])
            aligned[i, :L0] = revcomp(reads[i, :L0])
        cp.add_batch(engk.didx.genome,
                     (out["locus"] - ci.bases[k]).astype(np.int64),
                     aligned, lengths, a)
        cp.finish_chunk(engk.didx.genome, esl, sp)

    def ref_base(e, loci):
        g = int(ci.entry_starts[e]) + int(loci)
        kk = int(np.clip(np.searchsorted(ci.bases, g, "right") - 1, 0, 2))
        return int(ci.chunks[kk].codes[g - int(ci.bases[kk])])

    chunk_calls = cp.finalize_calls(ref_base, ci.entry_names,
                                    ci.entry_starts, sp)

    s_set = {(c.chrom, c.loci): c for c in single_calls}
    c_set = {(c.chrom, c.loci): c for c in chunk_calls}
    assert set(s_set) == set(c_set)
    for key in s_set:
        a, b = s_set[key], c_set[key]
        np.testing.assert_array_equal(a.base_cnts, b.base_cnts)
        assert a.tot_bases == b.tot_bases and a.nonref == b.nonref
        assert abs(a.pvalue - b.pvalue) < 1e-9
    # and the calls actually recover the planted truth
    truth = {(c, o) for c, o, _, _ in snps}
    found = {(c.chrom, c.loci) for c in chunk_calls}
    assert len(found & truth) / len(truth) > 0.85


def test_chunked_cli_snp(tmp_path):
    from biokanga.cli import main
    from biokanga.seq.fasta import write_fasta, write_fastq

    seqs = random_genome([("chr1", 30000)], seed=8)
    mut, snps = plant_snps(seqs, snp_rate_per_mbp=500, seed=3)
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, seqs)
    names, reads, _ = simulate_reads(mut, 5000, read_len=100,
                                     sub_rate=0.002, seed=5)
    fq = str(tmp_path / "r.fastq")
    write_fastq(fq, [(n, r, None) for n, r in zip(names, reads)])
    idxp = str(tmp_path / "i.npz")
    assert main(["index", "-i", ref, "-o", idxp, "--chunks", "2",
                 "--lut-bases", "10"]) == 0
    sam = str(tmp_path / "o.sam")
    snpf = str(tmp_path / "snps.csv")
    assert main(["align", "-i", fq, "-I", idxp, "-o", sam, "-O", snpf,
                 "--batch-size", "2048"]) == 0
    rows = [l for l in open(snpf) if not l.startswith('"SNP_ID"')
            and l.strip()]
    called = set()
    for l in rows:
        f = l.split(",")
        called.add((f[3].strip('"'), int(f[4])))
    truth = {(c, o) for c, o, _, _ in snps}
    assert len(called & truth) / len(truth) > 0.8
