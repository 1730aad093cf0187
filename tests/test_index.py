import numpy as np
import pytest

from biokanga.index.build import build_index, load_index, save_index
from biokanga.index.device import to_device
from biokanga.ops.lookup import pack_read_kmers, seed_range_lookup
from biokanga.sim.simreads import random_genome


def brute_occurrences(codes: np.ndarray, core: np.ndarray) -> set[int]:
    """All positions where `core` occurs exactly (N never matches)."""
    k = len(core)
    n = len(codes)
    out = set()
    if np.any(core >= 4):
        return out
    for i in range(n - k + 1):
        w = codes[i : i + k]
        if np.all(w == core):
            out.add(i)
    return out


@pytest.fixture(scope="module")
def small_index():
    seqs = random_genome([("chr1", 5000), ("chr2", 3000)], seed=11)
    return seqs, build_index(seqs, lut_bases=8)


def test_index_sorted(small_index):
    _, idx = small_index
    keys = idx.key_hi.astype(np.uint64) << np.uint64(32) | idx.key_lo.astype(
        np.uint64
    )
    assert np.all(keys[:-1] <= keys[1:])
    assert idx.lut[0] == 0 and idx.lut[-1] == idx.total_len


@pytest.mark.parametrize("k", [5, 9, 12, 16, 20, 32])
def test_range_lookup_matches_bruteforce(small_index, k):
    import jax.numpy as jnp

    seqs, idx = small_index
    didx = to_device(idx)
    concat = idx.codes
    rng = np.random.default_rng(k)
    # query cores sampled from the genome plus some random ones
    queries = []
    for _ in range(20):
        p = int(rng.integers(0, idx.total_len - k))
        queries.append(concat[p : p + k].copy())
    for _ in range(5):
        queries.append(rng.integers(0, 4, size=k).astype(np.int8))

    reads = np.stack(queries)  # (B, k)
    qlh, qll, qhh, qhl, has_n = pack_read_kmers(jnp.asarray(reads), (0,), k)
    start, end = seed_range_lookup(
        didx.key_hi, didx.key_lo, didx.lut, didx.lut_bases, qlh, qll, qhh, qhl
    )
    start = np.asarray(start)[:, 0]
    end = np.asarray(end)[:, 0]
    for qi, core in enumerate(queries):
        expect = brute_occurrences(concat, core)
        got = set(
            int(p)
            for p in idx.pos_sorted[start[qi] : end[qi]]
            # positions whose 32-base window runs off the end pack 0s; the
            # occurrence itself must fit
            if p + k <= idx.total_len
        )
        # spurious hits can only come from N-packing/boundary (none in this
        # random ACGT genome) — require exact equality
        assert got == expect, f"query {qi} k={k}"


def test_save_load_roundtrip(tmp_path, small_index):
    _, idx = small_index
    p = str(tmp_path / "test.idx.npz")
    save_index(idx, p)
    idx2 = load_index(p)
    assert idx2.entry_names == idx.entry_names
    for f in ("codes", "entry_starts", "pos_sorted", "key_hi", "key_lo", "lut"):
        assert np.array_equal(getattr(idx, f), getattr(idx2, f)), f
    assert idx2.lut_bases == idx.lut_bases
