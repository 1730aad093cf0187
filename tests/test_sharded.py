"""Sharded (multi-device) align must EXACTLY equal the single-device path.

Chunk-per-'sp'-shard design (parallel/sharded.py): full result-dict
equality on >= 10k reads including multi-hit, overflow-rescued, and
N-containing cases, with chunk cuts mid-entry.  Runs on the
8-virtual-CPU-device mesh from conftest.py.
"""
import jax
import numpy as np
import pytest

from biokanga.align.params import AlignParams
from biokanga.align.pipeline import AlignEngine, pad_rows
from biokanga.index.build import build_index
from biokanga.index.chunked import build_chunked_index
from biokanga.index.device import to_device
from biokanga.parallel.sharded import ShardedAligner, make_mesh
from biokanga.sim.simreads import random_genome, simulate_reads


def _genome(seed=31):
    seqs = random_genome([("c1", 30000), ("c2", 25000), ("c3", 20000)],
                         seed=seed)
    seg = seqs[0][1][2000:2600].copy()
    seqs[1][1][7000:7600] = seg       # multi-hit repeat, 3 copies
    seqs[2][1][11000:11600] = seg
    rng = np.random.default_rng(4)
    for _, s in seqs:
        s[rng.choice(len(s), size=30, replace=False)] = 4
    return seqs


@pytest.mark.parametrize("n_dp,n_sp", [(2, 4), (4, 2), (1, 8)])
def test_sharded_matches_single_exact(n_dp, n_sp):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    seqs = _genome()
    _, reads, _ = simulate_reads(seqs, 10_000, read_len=100, sub_rate=0.02,
                                 seed=13)
    seg = np.ascontiguousarray(seqs[0][1][2100:2200])
    reads[:16] = seg              # multi-hit
    reads[16:24, 3] = 4           # N cases
    lengths = np.full(len(reads), 100, dtype=np.int32)
    reads, lengths = pad_rows(reads, lengths)

    params = AlignParams(cand_per_core=48, batch_size=len(reads))
    single = AlignEngine(to_device(build_index(seqs, lut_bases=8)), params
                         ).align_with_rescue(reads, lengths)

    ci = build_chunked_index(seqs, num_chunks=n_sp, overlap=256, lut_bases=8)
    mesh = make_mesh(n_dp, n_sp)
    out = ShardedAligner(mesh, ci, params).align(reads, lengths)

    for k in ("unique", "any_hit", "best_mm", "next_mm", "inst", "is_rc"):
        np.testing.assert_array_equal(out[k], single[k], err_msg=k)
    np.testing.assert_array_equal(out["locus"],
                                  single["locus"].astype(np.int64))
    valid = out["ml_mm"] != 255
    np.testing.assert_array_equal(valid, single["ml_mm"] != 255)
    np.testing.assert_array_equal(out["ml_mm"][valid],
                                  single["ml_mm"][valid])
    np.testing.assert_array_equal(
        out["ml_loci"][valid], single["ml_loci"].astype(np.int64)[valid]
    )
    np.testing.assert_array_equal(out["ml_rc"][valid],
                                  single["ml_rc"][valid])
    assert (out["inst"][:16] >= 3).all()
    assert single["unique"].sum() > 9000


def test_sharded_extended_indel_splice():
    """-a/-A fall-through on the mesh == single-index ExtendedAligner."""
    from biokanga.align.pipeline import ExtendedAligner

    seqs = random_genome([("c1", 60000)], seed=17)
    s = seqs[0][1]
    rng = np.random.default_rng(5)
    L = 100
    rows = []
    for i in range(32):   # deletion reads
        st = 200 + i * 400
        w = s[st : st + L + 3]
        rows.append(np.concatenate([w[:50], w[53:]]))
    for i in range(32):   # junction reads across a 5 kb gap
        st = 30000 + i * 50
        rows.append(np.concatenate([s[st : st + 50],
                                    s[st + 5000 + 50 : st + 5000 + L]]))
    reads = np.stack(rows).astype(np.int8)
    lengths = np.full(len(reads), L, np.int32)
    reads, lengths = pad_rows(reads, lengths)

    params = AlignParams(batch_size=len(reads))
    single = ExtendedAligner(
        AlignEngine(to_device(build_index(seqs, lut_bases=10)), params),
        micro_indel_len=9, splice_junct_len=50_000,
    ).align(reads, lengths)

    ci = build_chunked_index(seqs, num_chunks=4, overlap=8192,
                             lut_bases=10)
    mesh = make_mesh(2, 4)
    sa = ShardedAligner(mesh, ci, params)
    out = sa.align_extended(reads, lengths, micro_indel_len=9,
                            splice_junct_len=50_000)
    np.testing.assert_array_equal(out["unique"], single["unique"])
    u = single["unique"]
    np.testing.assert_array_equal(out["locus"][u],
                                  single["locus"].astype(np.int64)[u])
    np.testing.assert_array_equal(out["cigar_op"][u],
                                  single["cigar_op"][u])
    np.testing.assert_array_equal(out["op_len"][u], single["op_len"][u])
    assert single["unique"][:64].sum() > 60


@pytest.mark.parametrize("n_mm", [2, 9])
def test_sharded_matches_chunked_beyond_exactness_bound(n_mm):
    """ShardedAligner and ChunkedAligner give identical results even for
    reads past the pigeonhole bound (9 mismatches), where the result
    depends on the core length: both derive the core ladder from the
    whole genome's length (here a 3 Gbp-shaped index), not a chunk's."""
    from biokanga.parallel.chunked import ChunkedAligner
    from biokanga.sim.multichunk import chunked_problem

    prob = chunked_problem(4, 200_000, 512)
    reads = prob.reads.copy()
    rng = np.random.default_rng(n_mm)
    for i in range(len(reads)):
        pos = rng.choice(100, n_mm, replace=False)
        reads[i, pos] = (reads[i, pos] + rng.integers(1, 4, n_mm)) % 4
    params = AlignParams()
    out_s = ShardedAligner(make_mesh(1, 4, jax.devices()[:4]), prob.ci,
                           params).align(reads, prob.lengths)
    out_c = ChunkedAligner(prob.ci, params).align(reads, prob.lengths)
    for k in ("unique", "locus", "best_mm", "next_mm", "inst"):
        np.testing.assert_array_equal(np.asarray(out_s[k]),
                                      np.asarray(out_c[k]), err_msg=k)
