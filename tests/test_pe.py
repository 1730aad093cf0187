"""Paired-end pairing + orphan rescue tests (BASELINE config 2 shape)."""
import numpy as np
import pytest

from biokanga.align.params import AlignParams
from biokanga.align.pe import PEAligner, PEParams, classify_pairs
from biokanga.align.pipeline import AlignEngine
from biokanga.index.build import build_index
from biokanga.index.device import to_device
from biokanga.sim.simreads import random_genome, simulate_reads


@pytest.fixture(scope="module")
def pe_setup():
    seqs = random_genome([("chrA", 40000), ("chrB", 25000)], seed=55)
    idx = build_index(seqs, lut_bases=8)
    engine = AlignEngine(to_device(idx), AlignParams())
    return seqs, idx, engine


def _simulate_pe(seqs, n, seed=12, sub_rate=0.0):
    names, codes, truths = simulate_reads(
        seqs, n, read_len=100, sub_rate=sub_rate, seed=seed, pe=True,
        insert_min=200, insert_max=500,
    )
    r1 = codes[0::2].copy()
    r2 = codes[1::2].copy()
    t1 = truths[0::2]
    t2 = truths[1::2]
    L = np.full(n, 100, dtype=np.int32)
    return r1, t1, r2, t2, L


def test_proper_pairs(pe_setup):
    seqs, idx, engine = pe_setup
    r1, t1, r2, t2, L = _simulate_pe(seqs, 100)
    pe = PEAligner(engine, PEParams(pair_min_len=100, pair_max_len=600))
    res = pe.align_pairs(r1, L, r2, L)
    assert res["proper"].sum() > 95
    # truth: insert within simulated range, loci match descriptors
    starts = idx.entry_starts
    name_to_ei = {n: i for i, (n, _) in enumerate(seqs)}
    for i in range(100):
        if not res["proper"][i]:
            continue
        e1 = int(starts[name_to_ei[t1[i].chrom]])
        assert int(res["res1"]["locus"][i]) == e1 + t1[i].start - 1
        assert int(res["res2"]["locus"][i]) == e1 + t2[i].start - 1
        assert 200 <= res["insert"][i] <= 500


def test_insert_range_rejects(pe_setup):
    seqs, idx, engine = pe_setup
    r1, t1, r2, t2, L = _simulate_pe(seqs, 60)
    # max insert below the simulated min insert => nothing proper
    pe = PEAligner(engine, PEParams(pair_min_len=25, pair_max_len=150,
                                    rescue=False))
    res = pe.align_pairs(r1, L, r2, L)
    assert res["proper"].sum() == 0


def test_orphan_rescue(pe_setup):
    seqs, idx, engine = pe_setup
    r1, t1, r2, t2, L = _simulate_pe(seqs, 80, seed=3)
    # corrupt mate2 of some pairs so badly it cannot seed (random bases)
    rng = np.random.default_rng(7)
    corrupt = rng.choice(80, size=15, replace=False)
    for i in corrupt:
        # heavy scatter of substitutions: every 7th base changed defeats
        # 9-base cores but stays within ~15 subs (> MaxTotMM though)
        r2[i, ::5] = (r2[i, ::5] + 1) % 4
    pe = PEAligner(engine, PEParams(pair_min_len=100, pair_max_len=600))
    res_nr = PEAligner(engine, PEParams(pair_min_len=100, pair_max_len=600,
                                        rescue=False)).align_pairs(
        r1, L, r2.copy(), L
    )
    # corrupted mates exceed the mismatch budget => not proper even with
    # rescue; instead corrupt mildly: 3 subs clustered in cores
    assert res_nr["proper"][corrupt].sum() == 0


def test_orphan_rescue_recovers_mild_corruption(pe_setup):
    seqs, idx, engine = pe_setup
    r1, t1, r2, t2, L = _simulate_pe(seqs, 60, seed=21)
    rng = np.random.default_rng(17)
    corrupt = rng.choice(60, size=12, replace=False)
    for i in corrupt:
        # 8 subs placed inside every core window (offsets 0,11,...,77 with
        # core len ~13): hit positions 4, 15, 26, ... 92 — one per core —
        # so seeding fails but total subs stay within the budget (10)
        r2[i, 4:93:11] = (r2[i, 4:93:11] + 1) % 4
    no_rescue = PEAligner(
        engine, PEParams(pair_min_len=100, pair_max_len=600, rescue=False)
    ).align_pairs(r1, L, r2.copy(), L)
    with_rescue = PEAligner(
        engine, PEParams(pair_min_len=100, pair_max_len=600)
    ).align_pairs(r1, L, r2.copy(), L)
    rescued = int(with_rescue["proper"][corrupt].sum()) - int(
        no_rescue["proper"][corrupt].sum()
    )
    assert rescued > 5  # windowed rescue recovers seed-dead mates
    # and rescued loci are the true ones
    starts = idx.entry_starts
    name_to_ei = {n: i for i, (n, _) in enumerate(seqs)}
    for i in corrupt:
        if with_rescue["proper"][i] and not no_rescue["proper"][i]:
            e = int(starts[name_to_ei[t2[i].chrom]])
            assert int(with_rescue["res2"]["locus"][i]) == e + t2[i].start - 1


def test_launch_finish_equals_align_pairs():
    import numpy as np

    from biokanga.align.params import AlignParams
    from biokanga.align.pipeline import AlignEngine
    from biokanga.align.pe import PEAligner, PEParams
    from biokanga.index.build import build_index
    from biokanga.index.device import to_device
    from biokanga.sim.simreads import random_genome, simulate_reads

    seqs = random_genome([("c", 30000)], seed=3)
    _, reads, _ = simulate_reads(seqs, 128, read_len=100, sub_rate=0.01,
                                 seed=4, pe=True, insert_min=200,
                                 insert_max=400)
    r1, r2 = reads[0::2], reads[1::2]
    ln = np.full(128, 100, np.int32)
    pea = PEAligner(
        AlignEngine(to_device(build_index(seqs, lut_bases=8)),
                    AlignParams(batch_size=128)),
        PEParams(pair_min_len=150, pair_max_len=450),
    )
    a = pea.align_pairs(r1, ln, r2, ln)
    b = pea.finish_pairs(pea.launch_pairs(r1, ln, r2, ln))
    np.testing.assert_array_equal(a["proper"], b["proper"])
    np.testing.assert_array_equal(a["res1"]["locus"], b["res1"]["locus"])
    np.testing.assert_array_equal(a["res2"]["locus"], b["res2"]["locus"])
