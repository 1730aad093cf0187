"""Device-batched assembly pass (assembly/scale_overlap) vs the
host-verified pass, plus an E2E readset assembly through the scaled path.
"""
import numpy as np

from biokanga.assembly.assemble import assemble, one_pass, one_pass_scaled
from biokanga.seq.encode import revcomp
from biokanga.sim.simreads import random_genome, simulate_reads


def _reads_from(genome, n, L, seed, sub_rate=0.0):
    names, reads, truths = simulate_reads(
        [("chr1", genome)], n, read_len=L, sub_rate=sub_rate, seed=seed
    )
    return [np.asarray(r, np.int8) for r in reads]


def _lens(seqs):
    return sorted(len(s) for s in seqs)


def test_scaled_pass_not_weaker_than_host_pass():
    # the bidirected pass (2n oriented targets) discovers every dovetail
    # the fwd-target host pass can, plus rc-target ones — merges and
    # total-merged-bases must not regress
    g = random_genome([("chr1", 8000)], seed=3)[0][1]
    reads = _reads_from(g, 600, 100, seed=5)
    a, ma = one_pass([r.copy() for r in reads], 40)
    b, mb = one_pass_scaled([r.copy() for r in reads], 40)
    assert mb >= ma
    assert max(_lens(b)) >= max(_lens(a))


def test_scaled_pass_with_errors_and_rc():
    g = random_genome([("chr1", 6000)], seed=11)[0][1]
    reads = _reads_from(g, 500, 100, seed=7, sub_rate=0.005)
    # flip half the reads to reverse-complement
    rng = np.random.default_rng(0)
    reads = [revcomp(r) if rng.random() < 0.5 else r for r in reads]
    a, ma = one_pass([r.copy() for r in reads], 40)
    b, mb = one_pass_scaled([r.copy() for r in reads], 40)
    assert mb >= ma
    assert max(_lens(b)) >= max(_lens(a))


def test_scaled_assembly_e2e():
    g = random_genome([("chr1", 20000)], seed=21)[0][1]
    reads = _reads_from(g, 2400, 100, seed=9)  # 12x
    contigs, st = assemble(reads, scaled=True, max_passes=30)
    assert st.max_contig >= 15000  # near-complete single-contig recovery
    # the longest contig must be a true genome segment (either strand)
    big = max(contigs, key=len)
    gs = g.tobytes()
    assert (big.tobytes() in gs) or (revcomp(big).tobytes() in gs)
