"""Property test: packed 2-bit extension == dense extension, incl. Ns,
entry boundaries, short reads, and edge loci."""
import jax.numpy as jnp
import numpy as np
import pytest

from biokanga.ops.extend import hamming_extend
from biokanga.ops.extend_packed import (
    hamming_extend_packed,
    pack_genome,
    pack_reads,
)


@pytest.mark.parametrize("with_n", [False, True])
@pytest.mark.parametrize("L", [100, 75, 128, 17, 150, 300, 1500])
def test_packed_matches_dense(with_n, L):
    rng = np.random.default_rng(L * 2 + with_n)
    n = 5000 if L <= 300 else 20000
    codes = rng.integers(0, 4, size=n).astype(np.int8)
    if with_n:
        npos = rng.choice(n, size=60, replace=False)
        codes[npos] = 4
    entry_starts = np.array([0, 3100, n], dtype=np.int32)

    B, C = 16, 32
    reads = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    if with_n:
        reads[rng.random((B, L)) < 0.01] = 4
    lengths = rng.integers(max(1, L - 20), L + 1, size=B).astype(np.int32)
    # pad beyond true length with N, as the input pipeline does
    for i in range(B):
        reads[i, lengths[i]:] = 4

    # candidate loci: mix of valid, boundary-straddling, negative, past-end
    loci = rng.integers(-5, n + 5, size=(B, C)).astype(np.int32)
    # plant some exact hits
    for i in range(B):
        p = int(rng.integers(0, n - L))
        loci[i, 0] = p
        reads[i, : lengths[i]] = codes[p : p + lengths[i]]
        reads[i, lengths[i]:] = 4
    valid = rng.random((B, C)) < 0.9

    g = jnp.asarray(codes)
    es = jnp.asarray(entry_starts)
    lj = jnp.asarray(loci)
    vj = jnp.asarray(valid)
    rj = jnp.asarray(reads)
    lnj = jnp.asarray(lengths)

    dense = np.asarray(hamming_extend(g, es, lj, vj, rj, lnj))

    pg = pack_genome(codes)
    assert pg.has_n == with_n
    rcodes, rnlane = pack_reads(rj, lnj)
    packed = np.asarray(
        hamming_extend_packed(pg, es, lj, vj, rcodes, rnlane, lnj)
    )
    np.testing.assert_array_equal(packed, dense)


def test_planted_hit_is_zero_mm():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=2000).astype(np.int8)
    entry_starts = np.array([0, 2000], dtype=np.int32)
    L = 100
    read = codes[500:600][None, :].copy()
    pg = pack_genome(codes)
    rcodes, rnlane = pack_reads(jnp.asarray(read), jnp.asarray([L], np.int32))
    loci = jnp.asarray([[500, 501, 499]], dtype=jnp.int32)
    mm = np.asarray(
        hamming_extend_packed(
            pg, jnp.asarray(entry_starts), loci,
            jnp.ones((1, 3), bool), rcodes, rnlane,
            jnp.asarray([L], np.int32),
        )
    )
    assert mm[0, 0] == 0
    assert mm[0, 1] > 0 and mm[0, 2] > 0
