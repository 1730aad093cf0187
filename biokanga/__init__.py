"""biokanga — an accelerator NGS sequence-analysis framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of the
BioKanga NGS toolkit (csiro-crop-informatics/biokanga): genome indexing,
seed-and-extend short-read alignment with Hamming-distance acceptance,
local alignment (blitz), read simulation, QC, filtering, marker discovery,
SNP calling, and long-read error correction — batched array programs on
a GPU (one CUDA kernel for banded Smith-Waterman), with `jax.sharding`
meshes across cards instead of pthreads/TCP.

This is NOT a port: the reference is studied for *what* it computes
(see SURVEY.md); the implementation here is an independent batched design.
"""

__version__ = "0.1.0"

# Version string reported by the CLI; the reference reports "4.4.2"
# (biokanga/biokanga.cpp:38-45). We keep our own line.
FRAMEWORK_NAME = "biokanga"
