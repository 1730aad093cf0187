import numpy as np

from biokanga.seq.encode import (
    ascii_to_codes,
    codes_to_ascii,
    pack_kmers_u32,
    pack_query_u32,
    revcomp,
    revcomp_jnp,
)


def test_ascii_roundtrip():
    s = b"ACGTNacgtnXU"
    codes = ascii_to_codes(s)
    assert list(codes) == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 4, 3]
    assert codes_to_ascii(codes[:5]) == b"ACGTN"


def test_revcomp():
    codes = ascii_to_codes(b"ACGTN")
    rc = revcomp(codes)
    assert codes_to_ascii(rc) == b"NACGT"
    # involution on ACGT-only
    c2 = ascii_to_codes(b"GATTACA")
    assert np.array_equal(revcomp(revcomp(c2)), c2)


def test_revcomp_jnp_matches_numpy():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, size=57).astype(np.int8)
    got = np.asarray(revcomp_jnp(jnp.asarray(codes)))
    assert np.array_equal(got, revcomp(codes))


def test_pack_kmers_lexicographic_order():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=200).astype(np.int8)
    starts = np.arange(0, 150, dtype=np.int64)
    keys = pack_kmers_u32(codes, 16, starts)
    # integer order of keys == lexicographic order of the 16-mers
    for a in range(0, 140, 17):
        for b in range(0, 140, 13):
            ka, kb = keys[a], keys[b]
            sa = bytes(codes[a : a + 16])
            sb = bytes(codes[b : b + 16])
            assert (ka < kb) == (sa < sb) or sa == sb


def test_pack_query_bounds():
    codes = ascii_to_codes(b"ACGTACGTA")  # k=9
    qlo, qhi = pack_query_u32(codes, 9)
    full = pack_kmers_u32(np.concatenate([codes, np.zeros(16, np.int8)]), 16,
                          np.array([0]))[0]
    assert qlo <= full <= qhi
    # bounds tight: prefix bits equal
    assert (qlo >> (2 * 7)) == (qhi >> (2 * 7))
