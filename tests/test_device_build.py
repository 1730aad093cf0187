"""Device-side index build == host build (keys, LUT) and align parity."""
import numpy as np

from biokanga.align.params import AlignParams
from biokanga.align.pipeline import AlignEngine, pad_rows
from biokanga.index.build import build_index
from biokanga.index.device import to_device
from biokanga.index.device_build import (
    DeviceBuildChunkedAligner,
    device_build_index,
)
from biokanga.sim.simreads import random_genome, simulate_reads


def test_device_build_matches_host():
    seqs = random_genome([("c1", 20000), ("c2", 15000)], seed=9)
    rng = np.random.default_rng(2)
    for _, s in seqs:
        s[rng.choice(len(s), size=20, replace=False)] = 4
    host = build_index(seqs, lut_bases=8)
    codes = np.concatenate([s for _, s in seqs])
    dev = device_build_index(codes, host.entry_starts, lut_bases=8)

    np.testing.assert_array_equal(np.asarray(dev.key_hi), host.key_hi)
    np.testing.assert_array_equal(np.asarray(dev.key_lo), host.key_lo)
    np.testing.assert_array_equal(np.asarray(dev.lut),
                                  host.lut.astype(np.int32))
    n = host.total_len
    np.testing.assert_array_equal(
        np.asarray(dev.pos_rows).reshape(-1)[:n], host.pos_sorted
    )

    # align parity vs the host-built device index
    _, reads, _ = simulate_reads(seqs, 512, read_len=100, sub_rate=0.02,
                                 seed=4)
    lengths = np.full(512, 100, np.int32)
    params = AlignParams(batch_size=512)
    r1 = AlignEngine(to_device(host), params).align_with_rescue(
        reads, lengths)
    eng = AlignEngine(dev, params)
    r2 = eng.align_with_rescue(reads, lengths)
    for k in ("unique", "best_mm", "locus", "is_rc", "inst", "next_mm"):
        np.testing.assert_array_equal(r2[k], r1[k], err_msg=k)


def test_device_build_chunked_aligner():
    seqs = random_genome([("c1", 40000), ("c2", 25000)], seed=12)
    _, reads, truths = simulate_reads(seqs, 500, read_len=100,
                                      sub_rate=0.01, seed=3)
    lengths = np.full(500, 100, np.int32)
    reads_p, lengths_p = pad_rows(reads, lengths)

    ca = DeviceBuildChunkedAligner(seqs, AlignParams(batch_size=512),
                                   max_chunk=24_000, overlap=256,
                                   lut_bases=8)
    assert ca.num_chunks == 3
    res = ca.align(reads_p, lengths_p)
    assert res["locus"].dtype == np.int64
    # check against simreads truth (global coordinates)
    starts = ca.entry_starts
    names = ca.entry_names
    ok = 0
    for i, t in enumerate(truths):
        if not res["unique"][i]:
            continue
        g = res["locus"][i]
        e = np.searchsorted(starts, g, side="right") - 1
        ok += (names[e] == t.chrom and g - starts[e] == t.start - 1)
    assert ok / len(truths) > 0.99
