"""Packed .rds read container: pack/unpack roundtrip, kangar/filterreads
CLI, and aligner .rds input (SE + PE-interleaved)."""
import numpy as np

from biokanga.cli import main
from biokanga.seq.fasta import write_fasta, write_fastq
from biokanga.seq.rds import (
    FLAG_PE2, RDSFile, is_rds, pack_2bit, read_rds_blocks, rds_info,
    unpack_2bit, write_rds,
)
from biokanga.sim.simreads import random_genome, simulate_reads


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    for n in (0, 1, 3, 4, 5, 17, 1000):
        codes = rng.integers(0, 5, n).astype(np.int8)  # includes N=4
        packed, nmask = pack_2bit(codes)
        back = unpack_2bit(packed, nmask, n)
        assert np.array_equal(back, codes)


def test_write_read_rds(tmp_path):
    rng = np.random.default_rng(1)
    recs = [(f"r{i}", rng.integers(0, 4, rng.integers(50, 150)).astype(np.int8))
            for i in range(37)]
    path = str(tmp_path / "reads.rds.npz")
    assert write_rds(path, recs) == 37
    assert is_rds(path)
    info = rds_info(path)
    assert info.n_reads == 37 and not info.is_pe
    f = RDSFile(path)
    for i, (name, codes) in enumerate(recs):
        assert f.names[i] == name
        assert np.array_equal(f.read(i), codes)
    blocks = list(read_rds_blocks(path, block_size=16))
    assert sum(len(b.names) for b in blocks) == 37
    assert np.array_equal(blocks[0].codes[0, : len(recs[0][1])], recs[0][1])


def test_kangar_filterreads_cli(tmp_path):
    rng = np.random.default_rng(2)
    recs = []
    for i in range(20):
        c = rng.integers(0, 4, 100).astype(np.int8)
        if i < 3:
            c[:60] = 4  # N-heavy: should be dropped by --max-ns
        recs.append((f"r{i}", c, None))
    recs.append(("dup", recs[5][1].copy(), None))  # exact duplicate
    fq = str(tmp_path / "in.fastq")
    write_fastq(fq, recs)
    rds = str(tmp_path / "reads.rds.npz")
    assert main(["kangar", "-i", fq, "-o", rds, "--max-ns", "10"]) == 0
    assert rds_info(rds).n_reads == 18  # 3 N-heavy dropped

    out = str(tmp_path / "filt.rds.npz")
    assert main(["filterreads", "-i", rds, "-o", out, "--dedupe"]) == 0
    assert rds_info(out).n_reads == 17  # duplicate dropped


def test_align_accepts_rds_se_and_pe(tmp_path):
    seqs = random_genome([("chr1", 30000)], seed=4)
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, seqs)
    idx = str(tmp_path / "ref.idx.npz")
    assert main(["index", "-i", ref, "-o", idx, "--lut-bases", "8"]) == 0

    names, reads, truths = simulate_reads(seqs, 64, read_len=80, seed=5)
    rds = str(tmp_path / "se.rds.npz")
    write_rds(rds, list(zip(names, reads)))
    sam = str(tmp_path / "se.sam")
    assert main(["align", "-i", rds, "-I", idx, "-o", sam,
                 "--batch-size", "64"]) == 0
    aligned = [l for l in open(sam) if not l.startswith("@")]
    assert len(aligned) >= 60

    # PE-interleaved container -> auto mate split
    g = seqs[0][1]
    pe_recs = []
    for i in range(16):
        s = 200 + i * 600
        from biokanga.seq.encode import revcomp
        pe_recs.append((f"p{i}/1", g[s: s + 80]))
        pe_recs.append((f"p{i}/2", revcomp(g[s + 220: s + 300])))
    perds = str(tmp_path / "pe.rds.npz")
    write_rds(perds, pe_recs, pe_interleaved=True)
    assert rds_info(perds).is_pe
    pesam = str(tmp_path / "pe.sam")
    assert main(["align", "-i", perds, "-I", idx, "-o", pesam,
                 "--batch-size", "16", "-d", "100", "-D", "600"]) == 0
    rows = [l.split("\t") for l in open(pesam) if not l.startswith("@")]
    proper = [r for r in rows if int(r[1]) & 0x2]
    assert len(proper) >= 24  # most of the 16 pairs x 2 mates
