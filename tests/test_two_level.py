"""Two-level seeding (AlignParams.fast_pass) must be output-equivalent to
the single-level reference-core engine.

The fast pass uses long disjoint cores and a small candidate budget; its
resolution predicate (params.derive_fast docstring) guarantees any read it
keeps has provably identical best/locus/inst/uniqueness to the full pass,
and every other read is rerun through the classic pass.  This regression
test drives both engines over a stress mix — clean reads, heavy
substitutions, N bases, and planted multi-hit repeats — and requires
field-for-field equality (the batched analogue of the reference's progressive
sensitivity ladder, libbiokanga/SfxArrayV2.cpp:7663-7760).
"""
import numpy as np
import pytest

from biokanga.align.params import AlignParams
from biokanga.align.pipeline import AlignEngine
from biokanga.index.build import build_index
from biokanga.index.device import to_device
from biokanga.sim.simreads import random_genome, simulate_reads


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    seqs = random_genome([("chrA", 60000), ("chrB", 30000)], seed=3)
    # plant a dispersed repeat family: copy a 400bp block to 5 loci so
    # reads from it are genuine multi-hits
    block = seqs[0][1][1000:1400].copy()
    for dst in (7000, 21000, 44000):
        seqs[0][1][dst:dst + 400] = block
    seqs[1][1][5000:5400] = block
    idx = build_index(seqs, lut_bases=8)
    didx = to_device(idx)
    fast = AlignEngine(didx, AlignParams(fast_pass=True))
    slow = AlignEngine(didx, AlignParams(fast_pass=False))
    assert fast.params.derive_fast(100, didx.total_len, didx.lut_bases)
    return seqs, fast, slow, rng


# next_mm is canonical (saturated at best + MMDelta in the accept stage),
# so it is compared bit-for-bit like everything else
FIELDS = ("unique", "any_hit", "best_mm", "next_mm", "inst", "locus",
          "is_rc")


def _compare(fast, slow, reads, lengths):
    rf = fast.align_with_rescue(reads, lengths)
    rs = slow.align_with_rescue(reads, lengths)
    for k in FIELDS:
        np.testing.assert_array_equal(rf[k], rs[k], err_msg=k)
    # the tied-best ml prefix (what multi-hit assignment consumes) is
    # part of the exactness contract; the (best, MaxTotMM] tail is not
    tied = np.asarray(rs["ml_mm"]) == np.asarray(rs["best_mm"])[:, None]
    np.testing.assert_array_equal(np.asarray(rf["ml_mm"])[tied],
                                  np.asarray(rs["ml_mm"])[tied])
    np.testing.assert_array_equal(np.asarray(rf["ml_loci"])[tied],
                                  np.asarray(rs["ml_loci"])[tied])
    np.testing.assert_array_equal(np.asarray(rf["ml_rc"])[tied],
                                  np.asarray(rs["ml_rc"])[tied])


def test_clean_reads_equal(setup):
    seqs, fast, slow, _ = setup
    _, reads, _ = simulate_reads(seqs, 256, read_len=100, seed=21)
    _compare(fast, slow, reads, np.full(len(reads), 100, np.int32))


def test_heavy_substitution_equal(setup):
    """Reads near/over the mm acceptance edge: the fast pass must hand
    every borderline read back to the classic pass, not mis-resolve it."""
    seqs, fast, slow, _ = setup
    _, reads, _ = simulate_reads(
        seqs, 256, read_len=100, sub_rate=0.06, max_subs_per_read=12,
        seed=22)
    _compare(fast, slow, reads, np.full(len(reads), 100, np.int32))


def test_n_bases_and_repeats_equal(setup):
    seqs, fast, slow, rng = setup
    _, reads, _ = simulate_reads(seqs, 256, read_len=100, sub_rate=0.02,
                                 seed=23)
    # sprinkle N runs into a third of the reads
    for i in range(0, len(reads), 3):
        p = rng.integers(0, 95)
        reads[i, p:p + rng.integers(1, 6)] = 4
    _compare(fast, slow, reads, np.full(len(reads), 100, np.int32))


def test_ragged_lengths_equal(setup):
    """resolved_bound must shrink for short reads (fewer disjoint cores)."""
    seqs, fast, slow, _ = setup
    _, reads, _ = simulate_reads(seqs, 200, read_len=100, sub_rate=0.03,
                                 seed=24)
    lengths = np.full(len(reads), 100, np.int32)
    lengths[::2] = 64
    reads[np.arange(len(reads)) % 2 == 0, 64:] = 4
    _compare(fast, slow, reads, lengths)


def test_fast_pass_actually_resolves(setup):
    """Sanity: the fast pass must resolve the bulk of typical reads itself
    (otherwise it is pure overhead)."""
    seqs, fast, _, _ = setup
    _, reads, _ = simulate_reads(seqs, 512, read_len=100, sub_rate=0.01,
                                 seed=25)
    lengths = np.full(len(reads), 100, np.int32)
    fp = fast.params.derive_fast(100, fast.didx.total_len,
                                 fast.didx.lut_bases)
    res = fast.align_batch(reads, lengths, H=fp.H, cand_cap=fp.cand_cap,
                           dp=fp.dp)
    bound = fp.resolved_bound(lengths, fast.params.min_edit_dist)
    resolved = (res["best_mm"].astype(np.int32) <= bound) & (
        ~res["overflow"])
    assert resolved.mean() > 0.85
