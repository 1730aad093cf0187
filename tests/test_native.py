"""Native C++ runtime vs numpy reference implementations."""
import numpy as np
import pytest

from biokanga.index.build import pack_keys
from biokanga.utils.native import (
    build_sorted_keys,
    get_lib,
    parse_fastq_native,
)

needs_native = pytest.mark.skipif(get_lib() is None,
                                  reason="native toolchain unavailable")


@needs_native
def test_sorted_keys_match_numpy():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, size=20000).astype(np.int8)  # incl. Ns
    pos, hi_s, lo_s = build_sorted_keys(codes)
    hi, lo = pack_keys(codes)
    order = np.lexsort((lo, hi)).astype(np.int32)
    # keys must be identical; order may differ only within equal keys —
    # native sort uses a position tie-break, lexsort is stable: both give
    # position-ascending ties, so full equality holds
    np.testing.assert_array_equal(hi_s, hi[order])
    np.testing.assert_array_equal(lo_s, lo[order])
    np.testing.assert_array_equal(pos, order)


@needs_native
def test_parse_fastq_native():
    buf = (
        b"@read1 desc\nACGTN\n+\nIIIII\n"
        b"@read2\nGGGGCCCC\n+\nFFFFFFFF\n"
        b"@read3\nTT\n+\nII\n"
    )
    names, codes, lengths, quals, consumed = parse_fastq_native(buf, 10, 12)
    assert names == ["read1", "read2", "read3"]
    assert list(lengths) == [5, 8, 2]
    assert list(codes[0, :5]) == [0, 1, 2, 3, 4]
    assert list(codes[1, :8]) == [2, 2, 2, 2, 1, 1, 1, 1]
    assert quals[0, 0] == ord("I")
    assert consumed == len(buf)
    # padding beyond length is N
    assert (codes[2, 2:] == 4).all()


@needs_native
def test_index_uses_native_and_stays_correct():
    """The full index built through the native sort still answers range
    queries exactly (reuses the brute-force oracle)."""
    from biokanga.index.build import build_index
    from biokanga.sim.simreads import random_genome

    seqs = random_genome([("c", 30000)], seed=17)
    idx = build_index(seqs, lut_bases=8)
    keys = idx.key_hi.astype(np.uint64) << np.uint64(32) | idx.key_lo.astype(
        np.uint64
    )
    assert (keys[:-1] <= keys[1:]).all()
    # spot-check: every sampled position's 16-mer is findable via its key
    g = idx.codes
    rng = np.random.default_rng(1)
    from biokanga.seq.encode import pack_kmers_u32

    for p in rng.integers(0, 29000, size=50):
        k = pack_kmers_u32(g, 16, np.array([p]))[0]
        i = np.searchsorted(idx.key_hi, k)
        hit_positions = set()
        while i < len(keys) and idx.key_hi[i] == k:
            hit_positions.add(int(idx.pos_sorted[i]))
            i += 1
        assert int(p) in hit_positions
