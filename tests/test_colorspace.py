"""SOLiD colorspace: transform properties, csfasta IO, end-to-end align."""
import numpy as np

from biokanga.cli import main
from biokanga.seq.encode import revcomp, to_colorspace
from biokanga.seq.fasta import (
    read_csfasta,
    write_csfasta,
    write_fasta,
)
from biokanga.sim.simreads import SimReadTruth, random_genome


def test_colorspace_transform_properties():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=50).astype(np.int8)
    colors = to_colorspace(codes)
    assert colors.shape == (49,)
    assert colors.max() < 4
    # strand symmetry: colors of the revcomp are the reversed colors
    assert np.array_equal(to_colorspace(revcomp(codes)), colors[::-1])
    # N propagates as no-call 4
    codes[10] = 4
    colors = to_colorspace(codes)
    assert colors[9] == 4 and colors[10] == 4


def test_csfasta_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, size=30).astype(np.int8)
    path = str(tmp_path / "r.csfasta")
    write_csfasta(path, [("read1", codes)])
    recs = list(read_csfasta(path))
    assert recs[0].name == "read1"
    # reader strips primer+first color -> internal colors of the read
    assert np.array_equal(recs[0].codes, to_colorspace(codes))


def test_colorspace_align_e2e(tmp_path):
    seqs = random_genome([("chrA", 30000), ("chrB", 20000)], seed=5)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, seqs)
    reads = str(tmp_path / "r.csfasta")
    assert main(["simreads", "-i", fa, "-o", reads, "-n", "300",
                 "-l", "100", "-C", "--seed", "6"]) == 0
    ip = str(tmp_path / "g.cs.idx.npz")
    assert main(["index", "-i", fa, "-o", ip, "-C", "--lut-bases", "8"]) == 0
    sam = str(tmp_path / "o.sam")
    assert main(["align", "-i", reads, "-I", ip, "-o", sam,
                 "--batch-size", "512"]) == 0
    ok = bad = unm = 0
    for line in open(sam):
        if line.startswith("@"):
            continue
        fl = line.split("\t")
        if int(fl[1]) & 4:
            unm += 1
            continue
        t = SimReadTruth.parse(fl[0])
        rc = bool(int(fl[1]) & 16)
        if fl[2] == t.chrom and int(fl[3]) == t.start and \
                rc == (t.strand == "-"):
            ok += 1
        else:
            bad += 1
    assert ok + bad + unm == 300
    assert ok > 290, (ok, bad, unm)
