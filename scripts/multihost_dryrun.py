"""Multi-host dryrun: run this script once per process to validate the
jax.distributed sharded-align path on a simulated multi-host CPU cluster.

  python scripts/multihost_dryrun.py <process_id> <num_processes> <port>

Each process owns 4 virtual CPU devices; the global (dp, sp) mesh spans
all processes.  Every process builds the same chunked index (same seed),
parses only its own round-robin share of the reads (host_block_iter
semantics), and the SPMD align step runs with cross-host collectives.
Prints one OK line with per-host accepted counts.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = int(sys.argv[3])

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from biokanga.parallel.multihost import (  # noqa: E402
    global_batch,
    global_mesh,
    init_multihost,
    local_results,
)

init_multihost(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc

import numpy as np  # noqa: E402

from biokanga.align.params import AlignParams  # noqa: E402
from biokanga.index.chunked import build_chunked_index  # noqa: E402
from biokanga.parallel.sharded import (  # noqa: E402
    build_sharded_align_fn,
    shard_chunked_index,
)
from biokanga.sim.simreads import random_genome, simulate_reads  # noqa: E402

n_sp = 4
n_dp = (4 * nproc) // n_sp
mesh = global_mesh(n_dp, n_sp)

seqs = random_genome([("c1", 30000), ("c2", 20000)], seed=31)
ci = build_chunked_index(seqs, num_chunks=n_sp, overlap=256, lut_bases=8)
params = AlignParams(cand_per_core=32)
sidx = shard_chunked_index(ci, mesh)

# every host simulates the SAME read set but keeps only its dp share
B_global = n_dp * 64
_, reads, _ = simulate_reads(seqs, B_global, read_len=100, sub_rate=0.02,
                             seed=13)
lengths = np.full(B_global, 100, np.int32)
per_host = B_global // nproc
lo, hi = pid * per_host, (pid + 1) * per_host

dp_params = params.derive(100, ci.total_len)
step = build_sharded_align_fn(mesh, sidx, params, dp_params,
                              H=params.cand_per_core)
with mesh:
    greads, glens = global_batch(mesh, reads[lo:hi], lengths[lo:hi])
    out = step(greads, glens)
    host = local_results({"unique": out["unique"], "locus": out["locus"],
                          "chunk": out["chunk"]})

n_acc = int(host["unique"].sum())
glob = sidx.bases[host["chunk"]] + host["locus"].astype(np.int64)
assert n_acc > per_host * 0.9, f"only {n_acc}/{per_host} accepted"
print(f"multihost dryrun OK: process {pid}/{nproc}, mesh dp={n_dp} x "
      f"sp={n_sp} over {jax.device_count()} global devices, "
      f"{n_acc}/{per_host} local reads accepted, max global locus "
      f"{int(glob[host['unique']].max())}")
