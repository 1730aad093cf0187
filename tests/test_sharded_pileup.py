"""Chunk-sharded psum pileup == single-device pileup (after folding
per-chunk local planes to global coordinates)."""
import jax
import numpy as np

from biokanga.align.params import AlignParams
from biokanga.align.pipeline import AlignEngine
from biokanga.align.snp import PileupAccumulator
from biokanga.index.build import build_index
from biokanga.index.chunked import build_chunked_index
from biokanga.index.device import to_device
from biokanga.parallel.sharded import (
    ShardedAligner,
    build_sharded_pileup_fn,
    combine_pileup_planes,
    make_mesh,
)
from biokanga.seq.encode import revcomp
from biokanga.sim.simreads import random_genome, simulate_reads


def test_sharded_pileup_matches_single():
    assert len(jax.devices()) >= 8
    seqs = random_genome([("c", 8000)], seed=3)
    idx = build_index(seqs, lut_bases=8)
    didx = to_device(idx)
    engine = AlignEngine(didx, AlignParams())
    names, reads, _ = simulate_reads(seqs, 64, read_len=100,
                                     sub_rate=0.02, seed=8)
    lens = np.full(64, 100, np.int32)
    res = engine.align_with_rescue(reads, lens)

    # single-device pileup
    acc = PileupAccumulator(didx)
    acc.add_alignments(reads, lens, res)
    c1, m1, mm1 = acc.finalize()

    # chunk-sharded pileup: align on the mesh (exact parity is asserted in
    # test_sharded.py), then psum-pileup with per-chunk planes
    aligned = reads.copy()
    for i in np.nonzero(res["is_rc"] & res["unique"])[0]:
        aligned[i] = revcomp(reads[i])
    mesh = make_mesh(4, 2)
    ci = build_chunked_index(seqs, num_chunks=2, overlap=256, lut_bases=8)
    sa = ShardedAligner(mesh, ci, AlignParams())
    out = sa.align(reads, lens)
    np.testing.assert_array_equal(out["unique"], res["unique"])

    pile = build_sharded_pileup_fn(mesh, sa.sidx)
    loc_local = (out["locus"] - sa.sidx.bases[out["chunk"]]).astype(np.int32)
    c2p, m2p, mm2p = jax.device_get(
        pile(out["chunk"].astype(np.int32), loc_local, aligned, lens,
             out["unique"])
    )
    c2 = combine_pileup_planes(np.asarray(c2p), sa.sidx)
    m2 = combine_pileup_planes(np.asarray(m2p), sa.sidx)
    mm2 = combine_pileup_planes(np.asarray(mm2p), sa.sidx)
    np.testing.assert_array_equal(c2, c1)
    np.testing.assert_array_equal(m2, m1)
    np.testing.assert_array_equal(mm2, mm1)
    assert c1.sum() > 0
