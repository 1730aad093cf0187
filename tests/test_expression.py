"""Annotation parsing + maploci/gendeseq/rnade/locateroi tests."""
import numpy as np
import pytest

from biokanga.cli import main
from biokanga.seq.annotations import (
    FeatureIndex,
    read_bed,
    read_gff3,
    read_gtf,
)


def _write_sam(path, recs, chroms=(("chr1", 10000),)):
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\n")
        for c, l in chroms:
            f.write(f"@SQ\tSN:{c}\tLN:{l}\n")
        for i, (chrom, pos, strand, length) in enumerate(recs):
            flag = 16 if strand == "-" else 0
            f.write(
                f"r{i}\t{flag}\t{chrom}\t{pos+1}\t60\t{length}M\t*\t0\t0\t"
                f"{'A'*length}\t*\n"
            )


def test_bed12_and_feature_index(tmp_path):
    bed = tmp_path / "f.bed"
    bed.write_text(
        "chr1\t100\t500\tgeneA\t0\t+\t100\t500\t0\t2\t50,100,\t0,300,\n"
        "chr1\t450\t900\tgeneB\t0\t-\n"
        "chr2\t0\t200\tgeneC\t0\t+\n"
    )
    feats = read_bed(str(bed))
    assert len(feats) == 3
    a = feats[0]
    assert a.exons() == [(100, 150), (400, 500)]
    assert a.spliced_len() == 150
    fi = FeatureIndex(feats)
    assert sorted(feats[i].name for i in fi.overlapping("chr1", 460, 470)) == [
        "geneA", "geneB",
    ]
    assert fi.overlapping("chr1", 950, 960) == []
    assert [feats[i].name for i in fi.overlapping("chr2", 10, 20)] == ["geneC"]


def test_gtf_transcript_grouping(tmp_path):
    gtf = tmp_path / "a.gtf"
    gtf.write_text(
        'chr1\tx\texon\t101\t200\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
        'chr1\tx\texon\t301\t400\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
        'chr1\tx\texon\t501\t550\t.\t-\t.\tgene_id "g2"; transcript_id "t2";\n'
    )
    feats = read_gtf(str(gtf))
    t1 = next(f for f in feats if f.name == "t1")
    assert t1.start == 100 and t1.end == 400
    assert t1.exons() == [(100, 200), (300, 400)]


def test_gff3(tmp_path):
    gff = tmp_path / "a.gff3"
    gff.write_text(
        "##gff-version 3\n"
        "chr1\tsrc\tgene\t1001\t2000\t.\t+\t.\tID=gene1;Name=G1\n"
    )
    feats = read_gff3(str(gff), feature_types=("gene",))
    assert feats[0].name == "gene1" and feats[0].start == 1000


def test_maploci_cli(tmp_path):
    bed = tmp_path / "f.bed"
    bed.write_text("chr1\t100\t500\tgA\t0\t+\nchr1\t600\t900\tgB\t0\t-\n")
    sam = str(tmp_path / "a.sam")
    _write_sam(sam, [("chr1", 150, "+", 50), ("chr1", 160, "+", 50),
                     ("chr1", 700, "-", 50), ("chr1", 5000, "+", 50)])
    out = str(tmp_path / "m.csv")
    assert main(["maploci", "-i", sam, "-b", str(bed), "-o", out]) == 0
    rows = {l.split(",")[1]: l for l in open(out).read().splitlines()[1:]}
    assert rows['"gA"'].split(",")[-1] == "2"
    assert rows['"gB"'].split(",")[-1] == "1"
    assert rows['"_unmatched"'].split(",")[-1] == "1"


def test_rnade_classification(tmp_path):
    bed = tmp_path / "f.bed"
    bed.write_text(
        "chr1\t0\t1000\tup\t0\t+\n"
        "chr1\t2000\t3000\tflat\t0\t+\n"
        "chr1\t4000\t6000\tbig\t0\t+\n"  # dominant stable feature so
    )                                     # library normalisation stays fair
    rng = np.random.default_rng(3)
    ctrl = [("chr1", int(p), "+", 50) for p in rng.integers(0, 900, 50)]
    ctrl += [("chr1", int(p), "+", 50) for p in rng.integers(2000, 2900, 50)]
    ctrl += [("chr1", int(p), "+", 50) for p in rng.integers(4000, 5900, 400)]
    expr = [("chr1", int(p), "+", 50) for p in rng.integers(0, 900, 150)]
    expr += [("chr1", int(p), "+", 50) for p in rng.integers(2000, 2900, 50)]
    expr += [("chr1", int(p), "+", 50) for p in rng.integers(4000, 5900, 400)]
    cs, es = str(tmp_path / "c.sam"), str(tmp_path / "e.sam")
    _write_sam(cs, ctrl)
    _write_sam(es, expr)
    out = str(tmp_path / "de.csv")
    assert main(["rnade", "-c", cs, "-e", es, "-b", str(bed), "-o", out]) == 0
    rows = {l.split(",")[0]: l.split(",") for l in
            open(out).read().splitlines()[1:]}
    up = rows['"up"']
    flat = rows['"flat"']
    assert float(up[3]) > 2.0          # ~2.5x after library normalisation
    assert '"none"' == flat[5]
    assert up[5] in ('"moderate"', '"high"', '"low"')

    # gendeseq table on the same inputs
    tab = str(tmp_path / "tab.csv")
    assert main(["gendeseq", "-c", cs, "-e", es, "-b", str(bed),
                 "-o", tab]) == 0
    lines = open(tab).read().splitlines()
    assert lines[0] == '"Feature","Ctrl1","Expr1"'
    assert '"up",50,150' in lines


def test_locateroi_cli(tmp_path):
    sam = str(tmp_path / "a.sam")
    recs = [("chr1", 1000 + 10 * i, "+", 200) for i in range(30)]
    _write_sam(sam, recs)
    out = str(tmp_path / "roi.csv")
    assert main(["locateroi", "-i", sam, "-o", out, "--min-cov", "3",
                 "--min-len", "100"]) == 0
    rows = open(out).read().splitlines()[1:]
    assert len(rows) == 1
    f = rows[0].split(",")
    assert int(f[2]) >= 1000 and int(f[3]) <= 1500


def test_rnade_bootstrap_cis():
    """Poisson-bootstrap CIs + p-values: a strongly-DE feature gets a
    small p-value and a fold CI excluding 1; an unchanged feature gets a
    large p-value and a CI containing 1."""
    import numpy as np

    from biokanga.tools.expression import _bootstrap_de

    rng = np.random.default_rng(3)
    c = np.stack([np.full(10, 50.0), np.full(10, 40.0)])
    e = np.stack([np.full(10, 10.0), np.full(10, 40.0)])
    out = _bootstrap_de(c, e, scale=1.0, iters=400)
    # feature 0: 5x down
    assert out[0, 2] < 0.5          # fold hi95 well below 1
    assert out[0, 6] <= 0.01        # p-value small
    # feature 1: unchanged
    assert out[1, 1] < 1.0 < out[1, 2]
    assert out[1, 6] > 0.2


def test_rnade_region_modes():
    import numpy as np

    from biokanga.seq.annotations import Feature
    from biokanga.tools.expression import region_intervals

    ft = Feature("c", 100, 1000, "g", strand="+",
                 exon_starts=[0, 400, 800], exon_sizes=[100, 100, 100],
                 attrs={"thick_start": 150, "thick_end": 950})
    assert region_intervals(ft, "feature") == [(100, 1000)]
    assert region_intervals(ft, "exons") == [(100, 200), (500, 600),
                                             (900, 1000)]
    assert region_intervals(ft, "introns") == [(200, 500), (600, 900)]
    assert region_intervals(ft, "cds") == [(150, 200), (500, 600),
                                           (900, 950)]
    assert region_intervals(ft, "utr5") == [(100, 150)]
    assert region_intervals(ft, "utr3") == [(950, 1000)]
    assert region_intervals(ft, "utr") == [(100, 150), (950, 1000)]
    # minus strand swaps UTR ends
    ft.strand = "-"
    assert region_intervals(ft, "utr5") == [(950, 1000)]
