"""Sharded SW job execution equals single-device results (8-dev CPU mesh)."""
import jax
import numpy as np

from biokanga.ops.sw import sw_score_numpy
from biokanga.parallel.swservice import SWJobBatch, make_sw_mesh, run_sw_jobs


def test_sharded_sw_matches_oracle():
    assert len(jax.devices()) >= 8
    rng = np.random.default_rng(2)
    B, La = 13, 70          # deliberately not a multiple of 8
    a = rng.integers(0, 4, size=(B, La)).astype(np.int8)
    bs = []
    for i in range(B):
        seg = list(a[i, 5:60])
        for _ in range(3):
            p = rng.integers(0, len(seg))
            seg[p] = (seg[p] + 1) % 4
        bs.append(np.array(seg, np.int8))
    Lb = max(len(x) for x in bs)
    b = np.full((B, Lb), 4, np.int8)
    blen = np.zeros(B, np.int32)
    for i, x in enumerate(bs):
        b[i, : len(x)] = x
        blen[i] = len(x)

    jobs = SWJobBatch(a, b, np.full(B, La, np.int32), blen,
                      np.zeros(B, np.int32))
    mesh = make_sw_mesh(8)
    out = run_sw_jobs(mesh, jobs, W=80)
    for i in range(B):
        assert out["score"][i] == sw_score_numpy(a[i], bs[i]), f"job {i}"
