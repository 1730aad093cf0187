"""Resumable chunk-major sweeps: per-(chunk, block) checkpoints, stale
signature rejection, and resume-equals-fresh results."""
import numpy as np
import pytest

from biokanga.align.params import AlignParams
from biokanga.align.pipeline import pad_rows
from biokanga.index.chunked import build_chunked_index
from biokanga.parallel.chunked import ChunkedAligner
from biokanga.sim.simreads import random_genome, simulate_reads
from biokanga.utils.checkpoint import SweepCheckpoint, config_signature


def _setup():
    seqs = random_genome([("c", 40000)], seed=4)
    _, reads, _ = simulate_reads(seqs, 512, read_len=100, sub_rate=0.01,
                                 seed=2)
    lengths = np.full(512, 100, np.int32)
    blocks = []
    for s in range(0, 512, 256):
        r, l = pad_rows(reads[s : s + 256], lengths[s : s + 256])
        blocks.append((r, l))
    ci = build_chunked_index(seqs, num_chunks=2, overlap=256, lut_bases=8)
    return ci, blocks


def test_checkpoint_resume_equals_fresh(tmp_path):
    ci, blocks = _setup()
    params = AlignParams(batch_size=256)
    cdir = str(tmp_path / "ck")

    ca = ChunkedAligner(ci, params)
    fresh = ca.align_blocks(blocks)
    ca.align_blocks(blocks, checkpoint_dir=cdir)
    # 2 chunks x 2 blocks persisted
    import os

    cells = [f for f in os.listdir(cdir) if f.endswith(".npz")]
    assert len(cells) == 4

    # simulate a killed run: drop one cell, resume with an aligner whose
    # chunk loads are counted
    os.remove(str(tmp_path / "ck" / cells[0]))
    ca2 = ChunkedAligner(ci, params)
    n_loads = 0
    orig = ca2.engine_for

    def counting(k):
        nonlocal n_loads
        n_loads += 1
        return orig(k)

    ca2.engine_for = counting
    resumed = ca2.align_blocks(blocks, checkpoint_dir=cdir)
    assert n_loads == 1  # only the chunk with the missing cell rebuilt
    for a, b in zip(fresh, resumed):
        for key in ("unique", "locus", "best_mm", "is_rc", "inst"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)

    # stale-signature rejection
    with pytest.raises(ValueError):
        SweepCheckpoint(cdir, "different-signature")


def first_sig(cdir):
    import json
    import os

    return json.load(open(os.path.join(cdir, "MANIFEST.json")))["signature"]


def test_config_signature_changes():
    a = config_signature([np.arange(5), "x", (1, 2)])
    b = config_signature([np.arange(5), "x", (1, 3)])
    c = config_signature([np.arange(5), "x", (1, 2)])
    assert a != b and a == c
