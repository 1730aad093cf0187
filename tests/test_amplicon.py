"""Amplicon MID-barcode demux (ePMAmplicon/ePMAmpliconNoMerge,
biokanga/MergeReadPairs.h:14-17, barcode table MergeReadPairs.cpp:33-57):
plate-well identification from 5'/3' barcodes, trimming, per-well files."""
import numpy as np

from biokanga.cli import main
from biokanga.seq.encode import revcomp
from biokanga.seq.fasta import read_seqs, write_fastq
from biokanga.sim.simreads import random_genome
from biokanga.tools.mergeoverlaps import PlateBarcodes


def _amplicon_pairs(rng, bc, wells, insert=120, L=90):
    """Build PE reads of barcoded amplicons for the given wells."""
    r1s, r2s, tags = [], [], []
    for w in wells:
        col = (w - 1) % 12
        row = (w - 1) // 12
        core = rng.integers(0, 4, size=insert - 12).astype(np.int8)
        amplicon = np.concatenate(
            [bc.cols[col], core, revcomp(bc.rows[row])]
        )
        r1s.append(amplicon[:L].copy())
        r2s.append(revcomp(amplicon[-L:]))
        tags.append(w)
    return r1s, r2s, tags


def test_map_se_and_pe_wells():
    bc = PlateBarcodes()
    rng = np.random.default_rng(5)
    for w in (1, 12, 13, 96, 37):
        col = (w - 1) % 12
        row = (w - 1) // 12
        core = rng.integers(0, 4, size=60).astype(np.int8)
        amp = np.concatenate([bc.cols[col], core, revcomp(bc.rows[row])])
        assert bc.map_se(amp) == w
        # PE: 5' of PE1 = column; 5' of PE2 = row (sense)
        r1 = amp[:40]
        r2 = revcomp(amp)[:40]
        assert bc.map_pe(r1, r2) == w
    # garbage barcodes -> well 0
    assert bc.map_se(rng.integers(0, 4, size=80).astype(np.int8)) == 0


def test_amplicon_cli_demux(tmp_path):
    bc = PlateBarcodes()
    rng = np.random.default_rng(7)
    wells = [3, 3, 3, 17, 17, 96]
    r1s, r2s, tags = _amplicon_pairs(rng, bc, wells)
    fq1 = str(tmp_path / "p1.fastq")
    fq2 = str(tmp_path / "p2.fastq")
    write_fastq(fq1, [(f"a{i}", r, None) for i, r in enumerate(r1s)])
    write_fastq(fq2, [(f"a{i}", r, None) for i, r in enumerate(r2s)])
    prefix = str(tmp_path / "amp")
    assert main(["mergeoverlaps", "-i", fq1, "-u", fq2, "-o", prefix,
                 "-m", "2", "-l", "16"]) == 0
    got3 = list(read_seqs(prefix + ".Well3.SE.fastq"))
    got17 = list(read_seqs(prefix + ".Well17.SE.fastq"))
    got96 = list(read_seqs(prefix + ".Well96.SE.fastq"))
    assert len(got3) == 3 and len(got17) == 2 and len(got96) == 1
    # barcodes trimmed: merged amplicon length = insert - 2*6
    assert all(len(r.codes) == 120 - 12 for r in got3)

    # no-merge mode: PE1/PE2 per-well files, 5' barcodes trimmed
    prefix2 = str(tmp_path / "ampnm")
    assert main(["mergeoverlaps", "-i", fq1, "-u", fq2, "-o", prefix2,
                 "-m", "3"]) == 0
    p1 = list(read_seqs(prefix2 + ".Well3.PE1.fastq"))
    p2 = list(read_seqs(prefix2 + ".Well3.PE2.fastq"))
    assert len(p1) == 3 and len(p2) == 3
    assert all(len(r.codes) == 90 - 6 for r in p1)
