"""Assembly + scaffolding tests: tiled reads reassemble the source,
PE links order contigs."""
import numpy as np
import pytest

from biokanga.assembly.assemble import assemble, one_pass
from biokanga.assembly.scaffold import components, pe_links, scaffold
from biokanga.seq.encode import revcomp
from biokanga.sim.simreads import random_genome


def tile_reads(g, read_len=100, stride=40):
    return [g[i : i + read_len].copy()
            for i in range(0, len(g) - read_len + 1, stride)]


def test_one_pass_merges_tiled_reads():
    g = random_genome([("s", 1000)], seed=5)[0][1]
    reads = tile_reads(g, 100, 40)  # 60bp overlaps
    merged, n = one_pass(reads, min_overlap=50)
    assert n > 0
    assert len(merged) < len(reads)


def test_assemble_reconstructs_source():
    g = random_genome([("s", 3000)], seed=8)[0][1]
    reads = tile_reads(g, 100, 30)
    contigs, st = assemble(reads, init_overlap=90, final_overlap=25)
    contigs.sort(key=len, reverse=True)
    assert st.max_contig >= 2900, f"max contig {st.max_contig}"
    # the big contig must be a subsequence-equal of the genome
    big = contigs[0]
    assert len(big) <= len(g)
    # locate by prefix
    for ofs in range(len(g) - len(big) + 1):
        if np.array_equal(g[ofs : ofs + len(big)], big):
            break
    else:
        pytest.fail("largest contig does not match the source genome")


def test_assemble_mixed_orientation():
    g = random_genome([("s", 1500)], seed=12)[0][1]
    reads = tile_reads(g, 100, 35)
    rng = np.random.default_rng(4)
    reads = [revcomp(r) if rng.random() < 0.5 else r for r in reads]
    contigs, st = assemble(reads, init_overlap=60, final_overlap=25)
    assert st.max_contig >= 600  # rc-aware merging must still build runs


def test_scaffold_orders_contigs():
    g = random_genome([("s", 6000)], seed=33)[0][1]
    # two contigs with a 200bp gap
    c1 = g[0:2500].copy()
    c2 = g[2700:5500].copy()
    # PE reads spanning the gap: mate1 near c1 3' end (fwd), mate2 rc near
    # c2 5' start; insert 500
    r1s, r2s = [], []
    rng = np.random.default_rng(6)
    for _ in range(20):
        p = int(rng.integers(2100, 2350))
        frag = g[p : p + 500]
        r1s.append(frag[:100].copy())
        r2s.append(revcomp(frag[-100:]))
    r1 = np.stack(r1s).astype(np.int8)
    r2 = np.stack(r2s).astype(np.int8)
    lens = np.full(20, 100, np.int32)

    edges = pe_links([c1, c2], r1, lens, r2, lens, insert_size=500)
    assert edges, "no PE link edges found"
    comp = components(2, edges)
    assert any(len(c) == 2 for c in comp)

    scaffolds, paths = scaffold([c1, c2], r1, lens, r2, lens,
                                insert_size=500, min_votes=2)
    assert len(scaffolds) == 1
    assert len(paths[0]) == 2
    s = scaffolds[0]
    assert len(s) >= len(c1) + len(c2)
    # joined in the right order: starts with c1, ends with c2
    assert np.array_equal(s[: len(c1)], c1)
    assert np.array_equal(s[-len(c2):], c2)


def test_containment_removal_unfragments():
    """Contained/duplicate reads previously broke mutual-best chains;
    with containment removal a clean 20x read set assembles into few
    long contigs covering the source."""
    import numpy as np

    from biokanga.assembly.assemble import assemble, remove_contained
    from biokanga.sim.simreads import random_genome

    rng = np.random.default_rng(3)
    g = random_genome([("g", 8000)], seed=5)[0][1]
    L = 150
    starts = rng.integers(0, 8000 - L, size=8000 * 12 // L)
    reads = [g[s : s + L].copy() for s in starts]
    # plant exact duplicates + contained fragments
    reads += [reads[0].copy(), reads[1][:100].copy()]
    contigs, st = assemble(reads)
    lens = sorted((len(c) for c in contigs), reverse=True)
    assert lens[0] > 4000
    assert sum(lens) < 1.3 * 8000  # little redundancy survives


def test_kmer_containment_dedup_indel_tolerant():
    """A contig equal to a kept one except for a single INDEL (which
    defeats Hamming containment entirely) is collapsed; genuinely novel
    sequence survives."""
    import numpy as np

    from biokanga.assembly.assemble import kmer_containment_dedup
    from biokanga.seq.encode import revcomp

    rng = np.random.default_rng(4)
    big = rng.integers(0, 4, size=5000, dtype=np.int8)
    # near-duplicate: window of big with one base DELETED mid-way
    dup = np.concatenate([big[100:2100], big[2101:4100]])
    # rc near-duplicate with one inserted base
    ins = np.insert(big[500:3500], 1500, 2).astype(np.int8)
    dup_rc = revcomp(ins)
    novel = rng.integers(0, 4, size=3000, dtype=np.int8)
    out = kmer_containment_dedup([dup, big, novel, dup_rc])
    outb = {o.tobytes() for o in out}
    assert big.tobytes() in outb and novel.tobytes() in outb
    assert dup.tobytes() not in outb and dup_rc.tobytes() not in outb
