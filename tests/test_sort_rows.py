"""The aligner's two candidate sorts (align/pipeline.py sort_rows): the
diagonal-dedup sort and the final two-key (mm*2|rc, locus) sort, at
candidate counts that are not powers of two, against numpy oracles."""
import jax.numpy as jnp
import numpy as np
import pytest

from biokanga.align.params import AlignParams
from biokanga.align.pipeline import _I32_MAX, _strand_candidates, sort_rows
from biokanga.index.build import build_index
from biokanga.index.device import to_device
from biokanga.sim.simreads import random_genome, simulate_reads


@pytest.mark.parametrize("C", [3, 96, 130, 384])
def test_dedup_sort_matches_numpy(C):
    rng = np.random.default_rng(C)
    x = rng.integers(-(2**30), 2**30, size=(64, C), dtype=np.int32)
    x[rng.random(x.shape) < 0.3] = _I32_MAX      # invalid candidates
    x[:, 1::3] = x[:, ::3][:, : x[:, 1::3].shape[1]]   # duplicate loci
    got = np.asarray(sort_rows(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x, axis=1))


@pytest.mark.parametrize("C", [3, 64, 100, 384])
def test_final_two_key_sort_matches_lexsort(C):
    rng = np.random.default_rng(C + 7)
    # small key range: most order is decided by the locus
    key = rng.integers(0, 21, size=(32, C), dtype=np.int32)
    loc = rng.integers(0, 2**28, size=(32, C), dtype=np.int32)
    key[rng.random(key.shape) < 0.2] = _I32_MAX
    gk, gl = sort_rows(jnp.asarray(key), jnp.asarray(loc))
    order = np.lexsort((loc, key), axis=1)
    np.testing.assert_array_equal(np.asarray(gk),
                                  np.take_along_axis(key, order, 1))
    np.testing.assert_array_equal(np.asarray(gl),
                                  np.take_along_axis(loc, order, 1))


@pytest.mark.parametrize("two_keys", [False, True])
def test_sentinels_sort_last(two_keys):
    """INT32_MAX marks an invalid candidate: it sorts after every real
    value, including the largest real locus, and all sentinels form one
    suffix of the row."""
    x = np.array([[_I32_MAX, 5, _I32_MAX - 1, 0, _I32_MAX, -3]], np.int32)
    if two_keys:
        k, v = sort_rows(jnp.asarray(x), jnp.asarray(x[:, ::-1].copy()))
        got = np.asarray(k)[0]
    else:
        got = np.asarray(sort_rows(jnp.asarray(x)))[0]
    np.testing.assert_array_equal(
        got, [-3, 0, 5, _I32_MAX - 1, _I32_MAX, _I32_MAX])


def test_strand_candidates_dedup_matches_numpy():
    """The dedup step end to end at S*H = 8*12 = 96 candidates per read
    (not a power of two): the kept loci are exactly the sorted unique
    diagonals of every exact core hit, found here by brute force."""
    seqs = random_genome([("c1", 40_000)], seed=3)
    g = seqs[0][1]
    g[20_000:20_400] = g[1_000:1_400]    # a repeat: two hits per core
    idx = build_index(seqs, lut_bases=8)
    didx = to_device(idx)
    _, reads, _ = simulate_reads(seqs, 64, read_len=100, sub_rate=0.02,
                                 seed=5)
    reads[:8] = np.stack([g[1_100 + 37 * i: 1_200 + 37 * i]
                          for i in range(8)])          # repeat hits
    dp = AlignParams().derive(100, idx.total_len)
    H, cap, k = 12, 40, dp.core_len
    assert len(dp.offsets) * H == 96
    arrays = (didx.key_hi, didx.key_lo, didx.lut, didx.pos_rows,
              didx.lut_bases, didx.max_bsearch_steps)
    loci, v, _, trunc = _strand_candidates(
        arrays, jnp.asarray(reads), dp, H, cap, occ_skip=False)
    loci, v = np.asarray(loci), np.asarray(v)
    assert loci.shape == (64, cap) and not np.asarray(trunc).any()
    hits: dict[bytes, list[int]] = {}
    for p in range(len(g) - k + 1):
        hits.setdefault(g[p: p + k].tobytes(), []).append(p)
    for r in range(64):
        want = sorted({p - o for o in dp.offsets
                       for p in hits.get(reads[r, o: o + k].tobytes(), [])
                       if p - o >= 0})
        np.testing.assert_array_equal(loci[r][v[r]], want)
        # the row is sorted; what is masked out repeats a kept locus or
        # is the invalid sentinel
        assert np.all(np.diff(loci[r].astype(np.int64)) >= 0)
        assert set(loci[r][~v[r]].tolist()) <= set(want) | {int(_I32_MAX)}
