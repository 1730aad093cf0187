"""DNA-conformation / chromatin subsystem.

batched equivalent of the reference's structural-property stack:
CConformation/CTwister octamer parameter model
(libbiokanga/Conformation.h, Twister.h), CCentroid fixation/transition
tables (libbiokanga/Centroid.h), and the MNase site-preference model
shared by prednucleosomes / SimulateMNase / DNAseqSitePotential.

Design: every structural property is a 4^8 (octamer) or 4^k (oligo)
lookup table held as a device array; per-sequence profiles are a single
vectorised gather (`jnp.take`) over sliding-window oligo indices — the
reference's per-step scalar loops (Twister.cpp GetStructParams) become
one bandwidth-bound batched op.
"""
from .conformation import (OCT_PARAM_NAMES, load_octamer_params,
                           oligo_indices, step_octamer_indices,
                           conformation_profile)
from .nucleosomes import (load_mnase_prefs, mnase_window_scores,
                          moving_average, baseline_normalise, call_dyads)

__all__ = [
    "OCT_PARAM_NAMES", "load_octamer_params", "oligo_indices",
    "step_octamer_indices", "conformation_profile", "load_mnase_prefs",
    "mnase_window_scores", "moving_average", "baseline_normalise",
    "call_dyads",
]
