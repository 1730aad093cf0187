"""Chromatin/structure family tests: conformation octamer model, MNase
scoring, nucleosome prediction, site potentials, centroids.

Oracle style: brute-force per-window reference implementations checked
against the vectorised paths (SURVEY §4 test strategy)."""
import numpy as np
import pytest

from biokanga.chromatin.conformation import (
    OCT_PARAM_NAMES, N_OCT, conformation_profile, idx_to_oligo,
    load_octamer_params, octamer_to_idx, oligo_indices,
    step_octamer_indices)
from biokanga.chromatin.nucleosomes import (
    baseline_normalise, call_dyads, load_mnase_prefs, mnase_window_scores,
    moving_average, site_cut_probs)
from biokanga.cli import main


def _write_params(path, octamers=None, value=1.0):
    """Small octamer-params CSV (22 values per row)."""
    rows = octamers or {"ACGTACGT": 5.0, "AAAAAAAA": 2.0}
    with open(path, "w") as f:
        f.write("octamer," + ",".join(OCT_PARAM_NAMES) + "\n")
        for oct_, v in rows.items():
            f.write(oct_ + "," + ",".join(str(v + i) for i in range(22))
                    + "\n")
    return rows


def test_octamer_idx_roundtrip():
    for s in ("AAAAAAAA", "ACGTACGT", "TTTTTTTT", "GATCGATC"):
        assert idx_to_oligo(octamer_to_idx(s), 8) == s
    # MSB-first GenSeqIdx convention: "AAAAAAAC" == 1
    assert octamer_to_idx("AAAAAAAC") == 1
    assert octamer_to_idx("CAAAAAAA") == 4 ** 7


def test_oligo_indices_bruteforce(rng):
    codes = rng.integers(0, 5, size=300).astype(np.int8)  # incl. N=4
    for k in (2, 5, 8):
        idx = oligo_indices(codes, k)
        assert idx.size == 300 - k + 1
        for i in range(0, idx.size, 17):
            w = codes[i:i + k]
            if (w >= 4).any():
                assert idx[i] == -1
            else:
                expect = 0
                for b in w:
                    expect = expect * 4 + int(b)
                assert idx[i] == expect


def test_conformation_profile(tmp_path, rng):
    p = tmp_path / "oct.csv"
    _write_params(p)
    table = load_octamer_params(str(p))
    assert table.shape == (N_OCT, 22)
    assert table[octamer_to_idx("ACGTACGT"),
                 OCT_PARAM_NAMES.index("twist")] == 5.0
    assert table[octamer_to_idx("ACGTACGT"),
                 OCT_PARAM_NAMES.index("minorgroove")] == pytest.approx(16.0)
    # profile over seq containing ACGTACGT: step at centre of that
    # octamer picks up its value
    codes = np.array([0, 1, 2, 3, 0, 1, 2, 3], dtype=np.int8)
    prof = conformation_profile(codes, table, "twist")
    assert prof.size == 7
    # step 3 (between bases 3 and 4) uses the unpadded octamer
    assert prof[3] == pytest.approx(5.0)
    # steps via step_octamer_indices agree with A-padding
    idx = step_octamer_indices(codes)
    assert idx[3] == octamer_to_idx("ACGTACGT")
    assert idx[0] == octamer_to_idx("AAAACGTA")


def test_mnase_scores_bruteforce(rng, tmp_path):
    prefs = np.zeros(N_OCT)
    rng_idx = rng.integers(0, N_OCT, size=500)
    prefs[rng_idx] = rng.uniform(0.001, 0.2, size=500)
    codes = rng.integers(0, 4, size=400).astype(np.int8)
    win = 147
    got = mnase_window_scores(codes, prefs, win)
    assert got.size == 400 - win + 1
    p = site_cut_probs(codes, prefs)
    for s in range(0, got.size, 29):
        prod = 1.0
        for o in range(s, s + win - 7):
            prod *= 1.0 - p[o]
        assert got[s] == pytest.approx(1.0 - prod, abs=1e-9)


def test_load_mnase_prefs(tmp_path):
    p = tmp_path / "prefs.csv"
    p.write_text('"octamer","gcnt","scnt","ratio"\n'
                 '"ACGTACGT",100,10,0.125\n"TTTTAAAA",50,1,0.0325\n')
    prefs = load_mnase_prefs(str(p))
    assert prefs[octamer_to_idx("ACGTACGT")] == 0.125
    assert prefs[octamer_to_idx("TTTTAAAA")] == 0.0325
    assert prefs.sum() == pytest.approx(0.1575)


def test_smoothing_and_dyads():
    x = np.zeros(1000)
    x[200] = 100.0
    x[600] = 80.0
    x[610] = 60.0  # within 147 of 600 -> suppressed
    sm = moving_average(x, 10)
    assert sm.sum() == pytest.approx(x.sum(), rel=1e-6)
    dyads = call_dyads(x, 147, min_score=1.0)
    assert 200 in dyads and 600 in dyads and 610 not in dyads
    bn = baseline_normalise(x, 250)
    assert bn.min() >= 0
    assert bn[200] > bn[190]


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for name, s in seqs:
            f.write(f">{name}\n{s}\n")


def test_dna_site_potential(tmp_path):
    from biokanga.tools.chromatin_tools import dna_site_potential

    genome = tmp_path / "g.fa"
    seq = "ACGTACGTACGTAAAATTTTCCCCGGGGACGT" * 8
    _write_fasta(genome, [("chr1", seq)])
    reads = tmp_path / "r.bed"
    # read start at 10 (+): octamer at 6..13
    reads.write_text("chr1\t10\t46\tr1\t0\t+\nchr1\t20\t56\tr2\t0\t+\n")
    out = tmp_path / "pot.csv"
    n = dna_site_potential(str(reads), str(genome), str(out))
    assert n == N_OCT
    want1 = seq[6:14]
    rows = {ln.split(",")[0].strip('"'): ln.split(",")[1:]
            for ln in out.read_text().splitlines()}
    assert int(rows[want1][1]) >= 1
    # ratio column parses as float and genome counts total to seq len-7
    total_gen = sum(int(v[0]) for v in rows.values())
    assert total_gen == len(seq) - 7


def test_simulate_mnase_and_prednucs(tmp_path, rng):
    from biokanga.tools.chromatin_tools import (pred_nucleosomes,
                                                    simulate_mnase)

    genome = tmp_path / "g.fa"
    seq = "".join(rng.choice(list("ACGT"), size=3000))
    _write_fasta(genome, [("chr1", seq)])
    out = tmp_path / "mnase.fa"
    n = simulate_mnase(str(genome), str(out), mode=2, numreads=50,
                       readlen=36, seed=3)
    assert n == 50
    lines = out.read_text().splitlines()
    assert sum(1 for ln in lines if ln.startswith(">")) == 50
    # descriptor-encoded ground truth: +strand reads match the genome
    for i in range(0, len(lines), 2):
        f = lines[i][1:].split("|")
        s, st = int(f[4]), f[7]
        if st == "+":
            assert lines[i + 1] == seq[s:s + 36]

    # nucleosome prediction from reads clustered around two loci
    reads = tmp_path / "reads.bed"
    with open(reads, "w") as f:
        for _ in range(40):
            for centre in (500, 1200):
                j = int(rng.integers(-3, 4))
                f.write(f"chr1\t{centre - 73 + j}\t{centre + 74 + j}\t"
                        f"r\t0\t+\n")
    outp = tmp_path / "dyads.bedgraph"
    n = pred_nucleosomes(str(reads), str(outp), fmt=0, min_score=0.5)
    rows = [ln.split("\t") for ln in outp.read_text().splitlines()[1:]]
    loci = sorted(int(r[1]) for r in rows)
    assert any(abs(x - 500) <= 8 for x in loci)
    assert any(abs(x - 1200) <= 8 for x in loci)


def test_predconfnucs_and_profiles(tmp_path, rng):
    from biokanga.tools.chromatin_tools import (gen_struct_profile,
                                                    gen_struct_stats,
                                                    pred_conf_nucs)

    p = tmp_path / "oct.csv"
    # random sparse params so the groove signal has structure
    octs = {idx_to_oligo(int(i), 8): float(v) for i, v in
            zip(rng.integers(0, N_OCT, size=200),
                rng.uniform(2, 8, size=200))}
    _write_params(p, octs)
    genome = tmp_path / "g.fa"
    _write_fasta(genome, [("chr1",
                           "".join(rng.choice(list("ACGT"), size=2000)))])
    out = tmp_path / "nucs.bed"
    pred_conf_nucs(str(genome), str(p), str(out), fmt=4)
    rows = [ln for ln in out.read_text().splitlines()
            if not ln.startswith("track")]
    for r in rows:
        fl = r.split("\t")
        assert int(fl[2]) - int(fl[1]) == 147  # the 147 bp core

    prof_out = tmp_path / "prof.csv"
    n = gen_struct_profile(str(genome), str(p), str(prof_out),
                           param="twist", trunclength=100)
    assert n == 1
    assert len(prof_out.read_text().splitlines()[1].split(",")) == 100

    stats_out = tmp_path / "stats.csv"
    assert gen_struct_stats(str(p), str(stats_out)) == N_OCT


def test_gencomposition(tmp_path):
    from biokanga.tools.chromatin_tools import gen_composition

    genome = tmp_path / "g.fa"
    _write_fasta(genome, [("c1", "ACGTACGT")])  # AC,CG,GT,TA x~2
    out = tmp_path / "comp.csv"
    gen_composition(str(genome), str(out), nmer=2)
    rows = {}
    for ln in out.read_text().splitlines()[1:]:
        fl = [p.strip('"') for p in ln.split(",")]
        if fl[0] == "c1":
            rows[fl[1]] = int(fl[2])
    assert rows["AC"] == 2 and rows["CG"] == 2 and rows["GT"] == 2
    assert rows["TA"] == 1 and rows["AA"] == 0


def test_centroids_roundtrip(tmp_path):
    from biokanga.tools.chromatin_tools import (gen_centroid_metrics,
                                                    proc_centroids)
    from biokanga.tools.converters3 import genbiomultialign

    maf = tmp_path / "a.maf"
    maf.write_text(
        "##maf version=1\n\n"
        "a score=10.0\n"
        "s hg.chr1 0 12 + 1000 ACGTACGTACGT\n"
        "s mm.chr1 0 12 + 900  ACGTACCTACGT\n\n")
    cont = str(tmp_path / "a.algn.npz")
    genbiomultialign([str(maf)], cont)
    out = tmp_path / "cm.csv"
    n = gen_centroid_metrics(cont, str(out), nmer=3)
    assert n > 0
    # centre of GTA at ref pos 5..7 covers the mismatch at pos 6 (G vs C)
    rows = {}
    for ln in out.read_text().splitlines()[1:]:
        fl = [p.strip('"') for p in ln.split(",")]
        rows[fl[0]] = (int(fl[1]), int(fl[2]))
    assert rows["CGT"][0] == 3 and rows["CGT"][1] == 2  # one CGT centre hit
    cent = tmp_path / "cent.csv"
    n2 = proc_centroids(str(out), str(cent))
    assert n2 == n
    got = {ln.split(",")[0].strip('"'): int(ln.split(",")[3])
           for ln in cent.read_text().splitlines()[1:]}
    assert got["CGT"] == round(10000 * 2 / 3)


def test_gennucstats(tmp_path):
    from biokanga.tools.chromatin_tools import gen_nuc_stats

    bkg = tmp_path / "bkg.bed"
    bkg.write_text("chr1\t100\t247\tn1\t0\t+\nchr1\t400\t547\tn2\t0\t+\n")
    smp = tmp_path / "smp.bed"
    smp.write_text("chr1\t103\t250\ts1\t0\t+\nchr1\t700\t847\ts2\t0\t+\n")
    out = tmp_path / "stats.csv"
    total = gen_nuc_stats(str(bkg), str(out), sample_path=str(smp))
    assert total == 2
    row = out.read_text().splitlines()[1].split(",")
    assert row[0] == "2" and row[1] == "1"  # one sample within +/-5


def test_cli_dispatch(tmp_path, rng):
    genome = tmp_path / "g.fa"
    _write_fasta(genome, [("chr1",
                           "".join(rng.choice(list("ACGT"), size=1000)))])
    out = tmp_path / "comp.csv"
    assert main(["gencomposition", "-i", str(genome), "-o", str(out),
                 "-n", "1"]) == 0
    assert len(out.read_text().splitlines()) == 1 + 2 * 4
    sim = tmp_path / "sim.fa"
    assert main(["simulatemnase", "-i", str(genome), "-o", str(sim),
                 "-m", "2", "-n", "20", "-c", "50", "-C", "80"]) == 0
