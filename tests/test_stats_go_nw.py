"""CStats parity (Fisher/chi-sq/binomial), GO enrichment, and batched
Needleman-Wunsch vs a scalar Gotoh oracle."""
import numpy as np
import pytest

from biokanga.ops.nw import nw_score_batch, nw_score_numpy
from biokanga.utils.stats import (benjamini_hochberg, binomial,
                                      calc_chisqr, calc_nck, chisqr_pval,
                                      fishers_exact_test, prob_k_eql_k)


def test_fisher_and_chisq():
    # classic tea-tasting table
    p = fishers_exact_test(3, 1, 1, 3)
    assert p == pytest.approx(0.24286, abs=1e-4)
    assert fishers_exact_test(10, 0, 0, 10) < 1e-3
    assert chisqr_pval(1, 3.841) == pytest.approx(0.05, abs=1e-3)
    cells = np.array([[20, 30], [30, 20]])
    chi = calc_chisqr(cells)
    assert chi == pytest.approx(4.0, abs=1e-9)
    # expected < 5 guard
    assert calc_chisqr(np.array([[1, 2], [3, 4]])) == -1.0


def test_binomials():
    assert calc_nck(5, 2) == pytest.approx(10.0)
    assert prob_k_eql_k(10, 5, 0.5) == pytest.approx(0.24609, abs=1e-4)
    assert binomial(10, 10, 0.5) == pytest.approx(1.0)
    q = benjamini_hochberg(np.array([0.01, 0.02, 0.5]))
    assert q[0] == pytest.approx(0.03) and q[2] == pytest.approx(0.5)


def _mini_go(tmp_path):
    obo = tmp_path / "go.obo"
    obo.write_text(
        "format-version: 1.2\n\n[Term]\nid: GO:0000001\n"
        "name: root\nnamespace: biological_process\n\n"
        "[Term]\nid: GO:0000002\nname: child\n"
        "namespace: biological_process\nis_a: GO:0000001 ! root\n\n"
        "[Term]\nid: GO:0000003\nname: other\n"
        "namespace: biological_process\nis_a: GO:0000001 ! root\n")
    gaf = tmp_path / "assoc.gaf"
    rows = []
    for g in ("g1", "g2", "g3", "g4"):
        rows.append(f"DB\t{g}id\t{g}\t\tGO:0000002\tref\tIEA\t\tP\t\t\t"
                    f"protein\ttaxon:9606\t20240101\tDB\n")
    for g in ("g5", "g6", "g7", "g8", "g9", "g10"):
        rows.append(f"DB\t{g}id\t{g}\t\tGO:0000003\tref\tIEA\t\tP\t\t\t"
                    f"protein\ttaxon:9606\t20240101\tDB\n")
    gaf.write_text("!gaf-version: 2.1\n" + "".join(rows))
    return str(obo), str(gaf)


def test_go_enrichment(tmp_path):
    from biokanga.tools.go_tools import (ancestor_closure,
                                             go_enrichment, parse_gaf,
                                             parse_obo)

    obo, gaf = _mini_go(tmp_path)
    terms = parse_obo(obo)
    assert len(terms) == 3
    clo = ancestor_closure(terms)
    assert clo["GO:0000002"] == {"GO:0000002", "GO:0000001"}
    assoc = parse_gaf(gaf)
    assert assoc["g1"] == {"GO:0000002"}

    study = ["g1", "g2", "g3", "g4"]
    pop = [f"g{i}" for i in range(1, 11)]
    rows = go_enrichment(study, pop, obo, gaf)
    by_id = {r[0]: r for r in rows}
    # all 4 study genes in GO:0000002, only 4/10 population
    assert by_id["GO:0000002"][3] == 4 and by_id["GO:0000002"][5] == 4
    assert by_id["GO:0000002"][7] < 0.05
    # the root annotates everything -> no enrichment
    assert by_id["GO:0000001"][7] == pytest.approx(1.0)


def test_go_cli(tmp_path):
    from biokanga.cli import main

    obo, gaf = _mini_go(tmp_path)
    study = tmp_path / "study.txt"
    study.write_text("g1\ng2\ng3\ng4\n")
    pop = tmp_path / "pop.txt"
    pop.write_text("".join(f"g{i}\n" for i in range(1, 11)))
    out = tmp_path / "enr.csv"
    assert main(["goenrichment", "-i", str(study), "-I", str(pop),
                 "-b", obo, "-a", gaf, "-o", str(out)]) == 0
    assert "GO:0000002" in out.read_text()
    out2 = tmp_path / "assoc.csv"
    assert main(["goassoc", "-b", obo, "-a", gaf, "-o", str(out2)]) == 0
    assert len(out2.read_text().splitlines()) == 1 + 4 * 2 + 6 * 2


def test_nw_batch_vs_oracle(rng):
    B, La, Lb = 12, 24, 30
    a = rng.integers(0, 4, size=(B, La)).astype(np.int8)
    b = rng.integers(0, 4, size=(B, Lb)).astype(np.int8)
    # make a few pairs related so scores aren't all-noise
    b[0, :La] = a[0]
    b[1, 3:La + 3] = a[1]
    got = nw_score_batch(a, b)
    for i in range(B):
        assert got[i] == nw_score_numpy(a[i], b[i]), f"pair {i}"
    # identical sequences score full match minus the length-difference
    # gap: open (-3-1) then extend (-1) x remaining
    assert got[0] == La * 1 + (-3 - 1) + (-1) * (Lb - La - 1)
