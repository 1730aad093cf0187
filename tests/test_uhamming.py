"""uhamming sweep vs brute force, node partitioning + merge."""
import numpy as np
import pytest

from biokanga.seq.encode import revcomp
from biokanga.tools.uhamming import (
    H_INVALID,
    hamming_sweep,
    merge_partials,
    window_validity,
)


def brute_min_hamming(codes, entry_starts, K, include_rc):
    n = len(codes)
    valid = window_validity(entry_starts, n, K)
    wins = [codes[i : i + K] if valid[i] else None for i in range(n)]
    rc_wins = []
    if include_rc:
        rc = revcomp(codes)
        valid_rc = window_validity(
            np.asarray([0, n]), n, K
        )  # rc entries mirrored; single-entry test genomes only
        rc_wins = [rc[j : j + K] for j in range(n - K + 1)]
    out = np.full(n, H_INVALID, dtype=np.int32)
    for i in range(n):
        if wins[i] is None:
            continue
        best = H_INVALID
        for j in range(n):
            if j == i or wins[j] is None:
                continue
            d = int(np.sum((wins[i] != wins[j]) | (wins[i] >= 4) | (wins[j] >= 4)))
            best = min(best, d)
        for w in rc_wins:
            d = int(np.sum((wins[i] != w) | (wins[i] >= 4) | (w >= 4)))
            best = min(best, d)
        out[i] = best
    return out


@pytest.mark.parametrize("include_rc", [False, True])
def test_sweep_matches_bruteforce(include_rc):
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 4, size=300).astype(np.int8)
    # plant a duplicated region => Hamming 0 somewhere
    codes[200:230] = codes[50:80]
    entry_starts = np.array([0, 300])
    K = 24
    got = hamming_sweep(codes, entry_starts, K=K, include_rc=include_rc,
                        block=64)
    exp = brute_min_hamming(codes, entry_starts, K, include_rc)
    np.testing.assert_array_equal(got.astype(np.int32), exp)
    assert (exp[50:57] == 0).all()  # planted duplicate detected


def test_node_partition_merge_equals_full():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, size=400).astype(np.int8)
    entry_starts = np.array([0, 400])
    K = 20
    full = hamming_sweep(codes, entry_starts, K=K, include_rc=False)
    # static shift-range partitioning over 3 "nodes" (reference -n/-N)
    top = 400 - K + 1
    bounds = [1, top // 3, 2 * top // 3, top]
    parts = [
        hamming_sweep(codes, entry_starts, K=K, shift_lo=bounds[i],
                      shift_hi=bounds[i + 1], include_rc=False)
        for i in range(3)
    ]
    merged = merge_partials(parts)
    np.testing.assert_array_equal(merged, full)


def test_multi_entry_validity():
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, size=200).astype(np.int8)
    entry_starts = np.array([0, 90, 200])
    K = 30
    got = hamming_sweep(codes, entry_starts, K=K, include_rc=False)
    # windows crossing the entry boundary at 90 are invalid
    assert (got[61:90] == H_INVALID).all()
    assert got[60] != H_INVALID or got[60] == H_INVALID  # defined value
    assert (got[171:] == H_INVALID).all()
