"""Bisulfite-mode alignment: C->T converted reads from both strands map to
their true loci through the CT/GA collapsed-index pair."""
import numpy as np

from biokanga.align.bisulfite import BisulfiteAligner
from biokanga.align.params import AlignParams
from biokanga.align.pipeline import AlignEngine, pad_rows
from biokanga.cli import main
from biokanga.index.build import (
    build_bisulfite_indexes, is_bisulfite_index, load_bisulfite_index,
    save_bisulfite_index,
)
from biokanga.index.device import to_device
from biokanga.seq.encode import ct_collapse, ga_collapse, revcomp
from biokanga.seq.fasta import write_fasta, write_fastq
from biokanga.sim.simreads import random_genome


def _bs_reads(genome, n, read_len, rng, conv_rate=0.98):
    """Simulate bisulfite reads: half top strand (C->T at conv_rate),
    half bottom strand.  Returns (names, reads, truth list)."""
    names, reads, truth = [], [], []
    for i in range(n):
        s = int(rng.integers(0, len(genome) - read_len))
        frag = genome[s: s + read_len].copy()
        bottom = i % 2 == 1
        if bottom:
            frag = revcomp(frag)
        conv = frag.copy()
        cs = np.flatnonzero(conv == 1)  # C positions
        flip = cs[rng.random(len(cs)) < conv_rate]
        conv[flip] = 3  # C -> T
        names.append(f"bs{i}")
        reads.append(conv)
        truth.append((s, bottom))
    return names, reads, truth


def test_collapse_tables():
    c = np.array([0, 1, 2, 3, 4], np.int8)
    assert list(ct_collapse(c)) == [0, 3, 2, 3, 4]
    assert list(ga_collapse(c)) == [0, 1, 0, 3, 4]


def test_bisulfite_align_both_strands():
    rng = np.random.default_rng(11)
    seqs = random_genome([("chr1", 60000)], seed=13)
    g = seqs[0][1]
    ct, ga = build_bisulfite_indexes(seqs, lut_bases=8)
    pc = AlignParams(strand="sense", batch_size=64)
    pg = AlignParams(strand="antisense", batch_size=64)
    bs = BisulfiteAligner(AlignEngine(to_device(ct), pc),
                          AlignEngine(to_device(ga), pg))
    names, reads, truth = _bs_reads(g, 64, 100, rng)
    codes, lens = pad_rows(np.stack(reads), np.full(64, 100, np.int32))
    res = bs.align_batch(codes, lens)
    ok = 0
    for i, (s, bottom) in enumerate(truth):
        if res["unique"][i] and res["locus"][i] == s \
                and bool(res["is_rc"][i]) == bottom:
            ok += 1
    assert ok >= 60  # rare repeats / high-conversion edge cases only


def test_bisulfite_index_roundtrip_and_cli(tmp_path):
    rng = np.random.default_rng(21)
    seqs = random_genome([("chrB", 30000)], seed=5)
    ct, ga = build_bisulfite_indexes(seqs, lut_bases=8)
    p = str(tmp_path / "bs.idx.npz")
    save_bisulfite_index(ct, ga, p)
    assert is_bisulfite_index(p)
    ct2, ga2 = load_bisulfite_index(p)
    assert np.array_equal(ct2.codes, ct.codes)
    assert np.array_equal(ga2.key_hi, ga.key_hi)

    fa = str(tmp_path / "g.fa")
    write_fasta(fa, seqs)
    idxp = str(tmp_path / "bsi.npz")
    assert main(["index", "-i", fa, "-o", idxp, "-m", "1",
                 "--lut-bases", "8"]) == 0
    assert is_bisulfite_index(idxp)

    names, reads, truth = _bs_reads(seqs[0][1], 32, 100, rng)
    fq = str(tmp_path / "bs.fastq")
    write_fastq(fq, ((n, r, None) for n, r in zip(names, reads)))
    sam = str(tmp_path / "bs.sam")
    assert main(["align", "-i", fq, "-I", idxp, "-o", sam,
                 "--batch-size", "32"]) == 0
    rows = [l.split("\t") for l in open(sam) if not l.startswith("@")]
    mapped = [r for r in rows if r[2] != "*"]
    assert len(mapped) >= 28
    by_name = {r[0]: r for r in mapped}
    ok = 0
    for n, (s, bottom) in zip(names, truth):
        r = by_name.get(n)
        if r and int(r[3]) - 1 == s and (int(r[1]) & 16 == (16 if bottom
                                                            else 0)):
            ok += 1
    assert ok >= 26
