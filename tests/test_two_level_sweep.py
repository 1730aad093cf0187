"""Global two-level chunk sweep (parallel/chunked.two_level_chunk_sweep)
vs the per-chunk classic path — field equality after the exact merge.
"""
import numpy as np

from biokanga.align.params import AlignParams
from biokanga.align.pipeline import pad_rows
from biokanga.index.device_build import DeviceBuildChunkedAligner
from biokanga.parallel.chunked import two_level_chunk_sweep
from biokanga.sim.simreads import random_genome, simulate_reads

FIELDS = ("unique", "any_hit", "best_mm", "next_mm", "inst", "locus",
          "is_rc")


def _setup(sub_rate, seed, heavy_frac=0.0):
    seqs = random_genome([("c1", 150_000), ("c2", 130_000)], seed=seed)
    names, reads, truths = simulate_reads(
        seqs, 1024, read_len=100, sub_rate=sub_rate, seed=seed + 1
    )
    reads = np.stack([np.asarray(r, np.int8) for r in reads])
    if heavy_frac:
        rng = np.random.default_rng(seed + 2)
        rows = rng.random(len(reads)) < heavy_frac
        for i in np.nonzero(rows)[0]:
            mut = rng.random(100) < 0.12   # ~12 subs: beyond fast bound
            reads[i, mut] = (reads[i, mut] + rng.integers(
                1, 4, mut.sum())) % 4
    lengths = np.full(len(reads), 100, np.int32)
    params = AlignParams(batch_size=512)
    ca = DeviceBuildChunkedAligner(seqs, params, max_chunk=100_000,
                                   overlap=512, lut_bases=8)
    blocks = [pad_rows(reads[i : i + 512], lengths[i : i + 512])
              for i in range(0, len(reads), 512)]
    return ca, blocks, truths


def _classic_merged(ca, blocks):
    """Reference result: classic engine per chunk + exact merge."""
    from biokanga.parallel.chunked import merge_chunk_results

    out = []
    for reads, lengths in blocks:
        partials = []
        for k in range(ca.num_chunks):
            eng = ca.engine_for(k)
            partials.append(eng.align_with_rescue(reads, lengths))
        out.append(merge_chunk_results(partials, ca.bases, lengths,
                                       ca.params))
    return out


def _check(ca, blocks):
    got = two_level_chunk_sweep(ca, blocks)
    want = _classic_merged(ca, blocks)
    for g, w in zip(got, want):
        for f in FIELDS:
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)


def test_sweep_clean_reads():
    ca, blocks, _ = _setup(0.01, seed=31)
    _check(ca, blocks)


def test_sweep_heavy_sub_fallthrough():
    # ~12-sub reads exceed the fast bound -> classic cycle must engage
    ca, blocks, _ = _setup(0.01, seed=47, heavy_frac=0.15)
    got = two_level_chunk_sweep(ca, blocks)
    want = _classic_merged(ca, blocks)
    for g, w in zip(got, want):
        for f in FIELDS:
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)


def test_sweep_truth():
    ca, blocks, truths = _setup(0.005, seed=53)
    got = two_level_chunk_sweep(ca, blocks)
    ok = tot = 0
    i = 0
    for res in got:
        B = res["unique"].shape[0]
        for j in range(B):
            if i >= len(truths):
                break
            t = truths[i]
            tot += 1
            if res["unique"][j]:
                want = (0 if t.chrom == "c1" else 150_000) + t.start - 1
                ok += int(res["locus"][j] == want)
            i += 1
    assert ok / tot > 0.99
