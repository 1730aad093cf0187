"""Conservation family tests: hypercore random walk, loci projection,
PHYLIP export, rollups, set ops."""
import numpy as np
import pytest

from biokanga.cli import main
from biokanga.tools.conservation import (_hypercore_walk,
                                             gen_align_conf,
                                             gen_align_loci2core,
                                             gen_align_ref2relloci,
                                             gen_align_stats,
                                             gen_element_profiles,
                                             gen_element_seq,
                                             gen_hyperconserved,
                                             gen_hyperdropouts,
                                             gen_loci2gene, gen_norm_wiggle,
                                             gen_rollups,
                                             gen_seq_candidates, gen_ultras,
                                             loci2phylip, process_csv_files)
from biokanga.tools.converters3 import genbiomultialign


def _algn(tmp_path, blocks):
    """blocks: list of list[(src, start, text)] -> .algn container."""
    maf = tmp_path / "t.maf"
    with open(maf, "w") as f:
        f.write("##maf version=1\n\n")
        for rows in blocks:
            f.write("a score=1.0\n")
            for src, start, text in rows:
                size = sum(1 for c in text if c != "-")
                f.write(f"s {src} {start} {size} + 100000 {text}\n")
            f.write("\n")
    out = str(tmp_path / "t.algn.npz")
    genbiomultialign([str(maf)], out)
    return out


def test_hypercore_walk_ultra():
    # 60 identical cols, 1 mismatch, 60 identical: ultra mode finds both
    mm = np.zeros(121, dtype=bool)
    mm[60] = True
    indel = np.zeros(121, dtype=bool)
    els = _hypercore_walk(mm, indel, 100, 50, 50, 0)
    assert len(els) == 2
    assert els[0][2] == 60 and els[1][2] == 60


def test_hypercore_walk_hyper():
    # hyper mode (90% identity) tolerates the single mismatch -> one
    # element spanning all 121 columns
    mm = np.zeros(121, dtype=bool)
    mm[60] = True
    indel = np.zeros(121, dtype=bool)
    els = _hypercore_walk(mm, indel, 90, 10, 100, 100)
    assert len(els) == 1
    assert els[0][2] == 121
    # but a dense mismatch run drives the walk score to zero
    mm2 = np.zeros(200, dtype=bool)
    mm2[100:112] = True
    els2 = _hypercore_walk(mm2, np.zeros(200, bool), 90, 10, 150, 100)
    assert els2 == []


def test_genhyperconserved_e2e(tmp_path):
    cons = "ACGT" * 20  # 80 conserved columns
    div = "AAAACCCCGGGGTTTTACGT"  # divergent tail in rel species
    blocks = [[("hg.chr1", 100, cons + div),
               ("mm.chr2", 500, cons + "TTTTGGGGCCCCAAAATGCA")]]
    algn = _algn(tmp_path, blocks)
    cores = tmp_path / "cores.csv"
    stats = tmp_path / "stats.csv"
    n = gen_hyperconserved(algn, str(stats), str(cores),
                           min_ultra_len=50)
    assert n == 1
    row = cores.read_text().splitlines()[0].split(",")
    assert row[1] == '"ultracore"'
    assert row[3] == '"chr1"'
    assert int(row[4]) == 100 and int(row[6]) == 80
    # ultras alias
    n2 = gen_ultras(algn, str(stats), str(cores), min_ultra_len=50)
    assert n2 == 1


def test_alignstats_conf(tmp_path):
    algn = _algn(tmp_path, [[("hg.chr1", 0, "ACGTACGTAC"),
                             ("mm.chr1", 0, "ACGTACGTAA"),
                             ("rn.chr1", 0, "ACGT-CGTAC")]])
    out = tmp_path / "st.csv"
    n = gen_align_stats(algn, str(out))
    assert n == 2
    rows = {ln.split(",")[0].strip('"'): ln.split(",")
            for ln in out.read_text().splitlines()[1:]}
    assert int(rows["mm"][2]) == 9 and int(rows["mm"][3]) == 1
    assert int(rows["rn"][4]) == 1  # one indel column
    conf = tmp_path / "conf.csv"
    assert gen_align_conf(algn, str(conf)) == 1
    c = float(conf.read_text().splitlines()[1].split(",")[4])
    assert 0.5 < c < 1.0


def test_ref2relloci_and_phylip(tmp_path):
    algn = _algn(tmp_path, [[("hg.chr1", 100, "ACGTACGTAC"),
                             ("mm.chr5", 700, "ACGT-CGTAC")]])
    loci = tmp_path / "loci.csv"
    loci.write_text('1,"ultracore","hg","chr1",102,106,5,"hg,mm",0\n')
    out = tmp_path / "rel.csv"
    n = gen_align_ref2relloci(str(loci), algn, str(out))
    assert n == 1
    fl = out.read_text().strip().split(",")
    # ref 102..106 -> columns 2..6; mm has gap at col 4 -> rel
    # positions 702..705
    assert fl[3] == '"mm"' and fl[4] == '"chr5"'
    assert int(fl[5]) == 702 and int(fl[6]) == 705

    ph = tmp_path / "out.phy"
    assert loci2phylip(str(loci), algn, str(ph)) == 1
    lines = ph.read_text().splitlines()
    assert lines[0].split() == ["2", "5"]
    assert lines[1].startswith("hg") and lines[1].endswith("GTACG")
    assert lines[2].endswith("GT-CG")

    core = tmp_path / "core.csv"
    n = gen_align_loci2core(str(loci), algn, str(core), dist_segs=5)
    assert n == 1
    r = core.read_text().splitlines()[1].split(",")
    assert int(r[5]) == 4 and int(r[7]) == 1  # 4 matches, 1 indel col


def test_dropouts_rollups_csvops(tmp_path):
    ref = tmp_path / "ref.csv"
    ref.write_text('1,"ultracore","hg","chr1",100,199,100,"s",0\n'
                   '2,"ultracore","hg","chr1",500,599,100,"s",0\n')
    rel = tmp_path / "rel.csv"
    rel.write_text('1,"ultracore","mm","chr1",150,250,101,"s",0\n')
    out = tmp_path / "drop.csv"
    assert gen_hyperdropouts(str(ref), str(rel), str(out), mode=0) == 1
    assert ",500," in out.read_text()
    assert gen_hyperdropouts(str(ref), str(rel), str(out), mode=1) == 1
    assert ",100," in out.read_text()
    assert gen_hyperdropouts(str(ref), str(rel), str(out), mode=3) == 3

    roll = tmp_path / "roll.csv"
    assert gen_rollups([str(ref), str(rel)], str(roll)) == 2
    r = roll.read_text().splitlines()[1].split(",")
    assert int(r[1]) == 2 and int(r[2]) == 200

    merged = tmp_path / "merged.csv"
    assert process_csv_files([str(ref), str(rel)], str(merged)) == 3
    assert process_csv_files([str(ref), str(ref)], str(merged),
                             op="common") == 2


def test_elementseq_loci2gene_candidates(tmp_path):
    genome = tmp_path / "g.fa"
    genome.write_text(">chr1\n" + "ACGT" * 50 + "\n")
    loci = tmp_path / "l.csv"
    loci.write_text("chr1,8,11\n")
    fa = tmp_path / "el.fa"
    assert gen_element_seq(str(loci), str(genome), str(fa)) == 1
    assert fa.read_text().splitlines()[1] == "ACGT"

    bed = tmp_path / "g.bed"
    bed.write_text("chr1\t50\t150\tgeneA\t0\t+\n")
    out = tmp_path / "l2g.csv"
    assert gen_loci2gene(str(loci), str(bed), str(out)) == 1
    r = out.read_text().splitlines()[1].split(",")
    assert r[3] == '"geneA"' and int(r[4]) == 39 and "US" in r[5]

    cand = tmp_path / "cand.fa"
    n = gen_seq_candidates(str(genome), str(cand), min_len=100,
                           min_gc=40.0, max_gc=60.0)
    assert n == 1


def test_profiles_normwiggle(tmp_path):
    algn = _algn(tmp_path, [[("hg.chr1", 0, "ACGTACGTACGTACGTACGT"),
                             ("mm.chr1", 0, "ACGTACGTACTTTTTTACGT")]])
    loci = tmp_path / "l.csv"
    loci.write_text("chr1,0,19\n")
    out = tmp_path / "prof.csv"
    assert gen_element_profiles(str(loci), algn, str(out), segs=4) == 1
    vals = [float(v) for v in
            out.read_text().splitlines()[1].split(",")[4:]]
    assert vals[0] == 1.0 and vals[2] < 1.0  # divergence mid-element

    bedin = tmp_path / "r.bed"
    bedin.write_text("chr1\t10\t40\tr\t0\t+\nchr1\t10\t40\tr\t0\t+\n")
    wig = tmp_path / "o.wig"
    n = gen_norm_wiggle(str(bedin), str(wig), mode=0)
    assert n == 1
    assert "1000000.0000" in wig.read_text()  # 2 reads -> 1e6 RPM at one pos


def test_cli_dispatch(tmp_path):
    algn = _algn(tmp_path, [[("hg.chr1", 0, "ACGT" * 30),
                             ("mm.chr1", 0, "ACGT" * 30)]])
    out = tmp_path / "u.csv"
    cores = tmp_path / "c.csv"
    assert main(["genultras", "-i", algn, "-o", str(out),
                 "-O", str(cores), "-n", "50"]) == 0
    assert len(cores.read_text().splitlines()) == 1
    assert main(["genalignstats", "-i", algn, "-o", str(out)]) == 0
    from biokanga.cli import SUBCOMMANDS

    assert "maploci2features" in SUBCOMMANDS
