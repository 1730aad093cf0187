"""Resumable non-chunked runs (VERDICT r2 weak #7): per-block
single-index align checkpoints and per-group EC checkpoints resume a
killed run to IDENTICAL results.
"""
import numpy as np

from biokanga.cli import main as cli_main
from biokanga.pacbio.ecreads import ECParams, ec_reads, ec_reads_checkpointed
from biokanga.seq.fasta import write_fasta
from biokanga.sim.simreads import random_genome, simulate_reads


def _noisy_long_reads(g, n, L, err, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, len(g) - L))
        r = list(g[s : s + L])
        i = 0
        res = []
        while i < len(r):
            u = rng.random()
            if u < err * 0.4:
                res.append(int(rng.integers(0, 4)))      # ins
                continue
            if u < err * 0.7:
                i += 1                                   # del
                continue
            if u < err:
                res.append((r[i] + int(rng.integers(1, 4))) % 4)
            else:
                res.append(r[i])
            i += 1
        out.append(np.array(res, np.int8))
    return out


def test_single_index_align_checkpoint_resume(tmp_path):
    seqs = random_genome([("chr1", 80_000)], seed=5)
    fa = tmp_path / "g.fa"
    write_fasta(str(fa), seqs)
    names, reads, _ = simulate_reads(seqs, 900, read_len=100,
                                     sub_rate=0.01, seed=7)
    rd = tmp_path / "r.fa"
    write_fasta(str(rd), zip(names, reads))
    idxp = str(tmp_path / "g.npz")
    assert cli_main(["index", "-i", str(fa), "-o", idxp,
                     "--lut-bases", "8"]) == 0
    ck = str(tmp_path / "ck")
    s1 = str(tmp_path / "o1.sam")
    assert cli_main(["align", "-i", str(rd), "-I", idxp, "-o", s1,
                     "--batch-size", "256",
                     "--checkpoint-dir", ck]) == 0
    import os
    cells = [f for f in os.listdir(ck) if f.endswith(".npz")]
    assert len(cells) == 4  # 900 reads / 256
    # delete one cell -> partial resume recomputes only that block
    os.remove(os.path.join(ck, sorted(cells)[1]))
    s2 = str(tmp_path / "o2.sam")
    assert cli_main(["align", "-i", str(rd), "-I", idxp, "-o", s2,
                     "--batch-size", "256",
                     "--checkpoint-dir", ck]) == 0
    body = lambda p: [ln for ln in open(p) if not ln.startswith("@")]
    assert body(s1) == body(s2)


def test_ec_checkpoint_resume(tmp_path):
    g = random_genome([("chr1", 30_000)], seed=11)[0][1]
    reads = _noisy_long_reads(g, 24, 3000, 0.04, seed=3)
    p = ECParams()
    want, _ = ec_reads(reads, p)
    ck = str(tmp_path / "eck")
    got1, st1 = ec_reads_checkpointed(reads, p, checkpoint_dir=ck,
                                      group=8)
    # resume from the persisted groups (no recompute) -> identical
    got2, st2 = ec_reads_checkpointed(reads, p, checkpoint_dir=ck,
                                      group=8)
    assert len(got1) == len(want) == len(got2)
    for a, b in zip(got1, got2):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got1, want):
        np.testing.assert_array_equal(a, b)
    assert st1["overlaps_used"] == st2["overlaps_used"]
