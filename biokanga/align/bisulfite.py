"""Bisulfite (methylation-context) alignment.

Parity role: the reference's bisulfite mode — a T/C- and A/G-collapsed
index copy is built at SfxBlock2Disk time (libbiokanga/SfxArrayV2.cpp:
440-459) and reads are aligned in collapsed space (kanga align bisulfite
processing mode).

Design: two collapsed indexes (CT for the converted top strand, GA
for the converted bottom strand), each searched by the standard batched
seed-extend engine with the READ also C->T collapsed:

  pass 1: CT(read)  vs CT(genome), sense strand only
  pass 2: rc(CT(read)) vs GA(genome) (the engine's antisense path)

A true top-strand read matches pass 1 exactly; a bottom-strand read
satisfies rc(CT(read)) == GA(genome window).  Results merge host-side
over the engines' top-K candidate lists with the same best/next-best
MMDelta margin rule as the primary aligner.
"""
from __future__ import annotations

import numpy as np

from ..seq.encode import ct_collapse
from .pipeline import AlignEngine


class BisulfiteAligner:
    """Two-engine bisulfite aligner (CT sense + GA antisense)."""

    def __init__(self, engine_ct: AlignEngine, engine_ga: AlignEngine):
        assert engine_ct.params.strand == "sense"
        assert engine_ga.params.strand == "antisense"
        self.ct = engine_ct
        self.ga = engine_ga

    def align_batch(self, reads: np.ndarray, lengths: np.ndarray) -> dict:
        creads = ct_collapse(reads)
        out_ct, _ = self.ct.launch(creads, lengths)
        out_ga, _ = self.ga.launch(creads, lengths)
        import jax

        r_ct = {k: np.asarray(v) for k, v in jax.device_get(out_ct).items()}
        r_ga = {k: np.asarray(v) for k, v in jax.device_get(out_ga).items()}
        return self._merge(r_ct, r_ga, lengths)

    def _merge(self, r_ct: dict, r_ga: dict, lengths: np.ndarray) -> dict:
        return merge_two_pass(r_ct, r_ga, lengths, self.ct.params)


def merge_two_pass(r_fwd: dict, r_alt: dict, lengths: np.ndarray,
                   ap) -> dict:
    """Union two engines' top-K lists (forward pass + alternate-strand
    pass) and re-apply the best/next-best MMDelta margin rule.  Shared by
    the bisulfite (CT/GA) and SOLiD colorspace (fwd/reversed) aligners."""
    mm = np.concatenate([r_fwd["ml_mm"], r_alt["ml_mm"]], axis=1).astype(
        np.int32)
    loci = np.concatenate([r_fwd["ml_loci"], r_alt["ml_loci"]], axis=1)
    K = r_fwd["ml_mm"].shape[1]
    strand = np.zeros_like(mm, dtype=bool)
    strand[:, K:] = True  # alternate pass == bottom strand (reported as rc)

    order = np.argsort(mm, axis=1, kind="stable")
    mm_s = np.take_along_axis(mm, order, axis=1)
    loci_s = np.take_along_axis(loci, order, axis=1)
    str_s = np.take_along_axis(strand, order, axis=1)

    if ap.max_subs_per100 == 0:
        max_tot = np.zeros(len(lengths), np.int32)
    else:
        max_tot = np.clip(
            np.floor(lengths * (ap.max_subs_per100 / 100.0) + 0.5
                     ).astype(np.int32), 1, 63)
    Ko = max(1, ap.max_multi)
    best = mm_s[:, 0]
    next_mm = mm_s[:, 1] if mm_s.shape[1] > 1 else np.full_like(best, 255)
    inst = (mm == best[:, None]).sum(axis=1)
    any_hit = best <= max_tot
    unique = any_hit & ((next_mm - best) >= ap.min_edit_dist)
    return {
        "unique": unique,
        "any_hit": any_hit,
        "best_mm": np.minimum(best, 255).astype(np.uint8),
        "inst": inst.astype(np.int32),
        "locus": loci_s[:, 0].astype(np.int32),
        "is_rc": str_s[:, 0],
        "overflow": np.asarray(r_fwd["overflow"]) | np.asarray(
            r_alt["overflow"]),
        "n_over": np.maximum(np.asarray(r_fwd["n_over"]),
                             np.asarray(r_alt["n_over"])),
        "cap_trunc": np.asarray(r_fwd["cap_trunc"]) | np.asarray(
            r_alt["cap_trunc"]),
        # valid-hit masking as in the accept stage (align/pipeline.py):
        # rows beyond the per-read budget are not alignments
        "ml_loci": np.where(mm_s[:, :Ko] <= max_tot[:, None],
                            loci_s[:, :Ko], -1),
        "ml_mm": np.where(mm_s[:, :Ko] <= max_tot[:, None],
                          np.minimum(mm_s[:, :Ko], 255), 255
                          ).astype(np.uint8),
        "ml_rc": np.where(mm_s[:, :Ko] <= max_tot[:, None],
                          str_s[:, :Ko], False),
    }
