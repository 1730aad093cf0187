"""PacBio error-correction tests: noisy long reads corrected towards
the true sequence."""
import numpy as np
import pytest

from biokanga.pacbio.ecreads import ECParams, ec_reads
from biokanga.seq.encode import revcomp
from biokanga.sim.simreads import random_genome


def noisy_copy(rng, seq, sub=0.03, ins=0.01, dele=0.01):
    out = []
    for c in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(rng.integers(0, 4))
        if rng.random() < sub:
            out.append((c + 1 + rng.integers(0, 3)) % 4)
        else:
            out.append(c)
    return np.array(out, np.int8)


def edit_distance(a, b):
    la, lb = len(a), len(b)
    prev = np.arange(lb + 1)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1, np.int64)
        cur[0] = i
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return int(prev[lb])


def test_ec_reduces_errors():
    rng = np.random.default_rng(7)
    true = random_genome([("t", 800)], seed=44)[0][1]
    reads = [noisy_copy(rng, true) for _ in range(12)]
    corrected, stats = ec_reads(reads, ECParams(min_overlap_score=100))
    assert stats["overlaps_used"] > 0
    improved = 0
    for raw, fix in zip(reads, corrected):
        d_raw = edit_distance(raw[:300], true[:300])
        d_fix = edit_distance(fix[:300], true[:300])
        if d_fix < d_raw:
            improved += 1
    assert improved >= 8, f"only {improved}/12 reads improved"


def test_ec_uses_rc_overlaps():
    rng = np.random.default_rng(11)
    true = random_genome([("t", 600)], seed=9)[0][1]
    fwd = [noisy_copy(rng, true) for _ in range(5)]
    rc = [revcomp(noisy_copy(rng, true)) for _ in range(5)]
    reads = fwd + rc
    corrected, stats = ec_reads(reads, ECParams(min_overlap_score=80))
    # rc reads must still find overlaps (via the rc entries in the index)
    assert stats["overlaps_used"] >= 10


def test_ec_target_chunked_matches_full():
    """Target-chunked EC (bounded index residency, VERDICT r3 item 6)
    corrects as well as the all-in-one index."""
    rng = np.random.default_rng(21)
    true = random_genome([("t", 800)], seed=51)[0][1]
    reads = [noisy_copy(rng, true) for _ in range(12)]
    p = ECParams(min_overlap_score=100)
    full, st_full = ec_reads(reads, p)
    chunked, st_ch = ec_reads(reads, p, target_chunk=5)
    assert st_ch["target_chunks"] == 3
    assert st_ch["overlaps_used"] >= st_full["overlaps_used"]
    better = 0
    for raw, fix in zip(reads, chunked):
        if edit_distance(fix[:300], true[:300]) < edit_distance(
                raw[:300], true[:300]):
            better += 1
    assert better >= 8, f"only {better}/12 chunked reads improved"


def test_ec_mesh_sw_dispatch():
    """SW pair batches shard over a dp mesh (swservice dataflow wired
    into ec_reads) and produce the SAME corrections as single-device."""
    import jax
    from jax.sharding import Mesh

    rng = np.random.default_rng(33)
    true = random_genome([("t", 700)], seed=52)[0][1]
    reads = [noisy_copy(rng, true) for _ in range(10)]
    p = ECParams(min_overlap_score=100)
    want, _ = ec_reads(reads, p)
    devs = np.asarray(jax.devices())
    mesh = Mesh(devs.reshape(len(devs)), ("dp",))
    got, _ = ec_reads(reads, p, mesh=mesh)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)


@pytest.mark.parametrize("B,La,N,seed", [(40, 64, 7, 0), (9, 33, 3, 1),
                                         (128, 16, 50, 2)])
def test_vote_deltas_match_integer_reference(B, La, N, seed):
    """The one-hot vote products are exact: bit-equal to an integer
    scatter-add, including rejected pairs and padding rows (pid -1)."""
    import jax.numpy as jnp

    from biokanga.pacbio.ecreads import _vote_deltas, vote_deltas_reference

    rng = np.random.default_rng(seed)
    out = jnp.asarray(rng.integers(0, 7, (B, La)).astype(np.int8))
    insc = jnp.asarray(rng.integers(0, 300, (B, La + 1)).astype(np.int32))
    insb = jnp.asarray(rng.integers(0, 90, (B, La + 1, 4)).astype(np.int32))
    pids = jnp.asarray(rng.integers(-1, N, B).astype(np.int32))
    ok = jnp.asarray(rng.random(B) < 0.7) & (pids >= 0)
    got = _vote_deltas(out, insc, insb, pids, ok, N)
    want = vote_deltas_reference(out, insc, insb, pids, ok, N)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
