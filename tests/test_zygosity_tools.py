"""genzygosity / pescaffold / alignsbs / synthetic index tests."""
import numpy as np

from biokanga.cli import main
from biokanga.index.build import build_index
from biokanga.tools.zygosity import aligns_bootstrap, zygosity_matrix


def test_zygosity_matrix_shared_segment():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 4, size=5000).astype(np.int8)
    b = rng.integers(0, 4, size=5000).astype(np.int8)
    c = a.copy()                      # identical to a
    b[0:2500] = a[0:2500]             # half shared with a
    idx = build_index([("a", a), ("b", b), ("c", c)], lut_bases=8)
    M, totals = zygosity_matrix(idx, K=20)
    assert np.allclose(np.diag(M), 1.0)
    assert M[0, 2] > 0.99 and M[2, 0] > 0.99   # identical pair
    assert 0.4 < M[1, 0] < 0.6                  # half-shared
    assert M[0, 1] > 0.4


def test_alignsbs_detects_difference():
    # balanced libraries: only features 0 and 3 truly differ (relative
    # abundances are compositional, so the test keeps totals equal)
    ca = np.array([100, 100, 100, 300])
    cb = np.array([300, 100, 100, 100])
    obs, pv = aligns_bootstrap(ca, cb, iterations=500, seed=4)
    assert pv[0] < 0.05 and pv[3] < 0.05
    assert pv[1] > 0.2 and pv[2] > 0.2


def test_pescaffold_cli(tmp_path):
    def write_sam(path, recs):
        with open(path, "w") as f:
            f.write("@SQ\tSN:ctg1\tLN:5000\n@SQ\tSN:ctg2\tLN:5000\n"
                    "@SQ\tSN:ctg3\tLN:5000\n")
            for qn, chrom, pos, rc in recs:
                f.write(f"{qn}\t{16 if rc else 0}\t{chrom}\t{pos}\t60\t"
                        f"50M\t*\t0\t0\t{'A'*50}\t*\n")

    s1 = str(tmp_path / "pe1.sam")
    s2 = str(tmp_path / "pe2.sam")
    # ctg1 3' links ctg2 5' via 3 pairs; ctg3 isolated
    write_sam(s1, [(f"p{i}", "ctg1", 4800, False) for i in range(3)]
              + [("q1", "ctg3", 100, False)])
    write_sam(s2, [(f"p{i}", "ctg2", 100, True) for i in range(3)]
              + [("q1", "ctg3", 400, True)])
    out = str(tmp_path / "sc.csv")
    assert main(["pescaffold", "-i", s1, "-u", s2, "-o", out]) == 0
    rows = [l.split(",") for l in open(out).read().splitlines()[1:]]
    by_scaffold = {}
    for r in rows:
        by_scaffold.setdefault(r[0], []).append(r[2].strip('"'))
    assert any(set(v) == {"ctg1", "ctg2"} for v in by_scaffold.values())


def test_synthetic_index_mode(tmp_path):
    out = str(tmp_path / "synth.idx.npz")
    assert main(["index", "-m", "2", "-s", "1", "-o", out,
                 "--lut-bases", "8"]) == 0
    from biokanga.index.build import load_index

    idx = load_index(out)
    assert idx.total_len == 1_000_000
    assert idx.entry_names == ["synth"]
