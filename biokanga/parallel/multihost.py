"""Multi-host distribution: jax.distributed + per-host input sharding.

Capability match for the reference's two multi-node mechanisms (SURVEY
§2.7): uhamming's static sweep partitioning across up to 10,000 nodes
(/root/reference/uhamming/uhamming.cpp:222-238) and the BKS TCP work
service (pacbiokanga/BKSRequester.cpp).  Batched form:

- `init_multihost` wires the JAX process group (coordinator + process
  ranks — the keepalive/negotiation role of BKScommon.h moves into the
  JAX runtime's own heartbeat layer).
- The (dp, sp) mesh spans ALL hosts' devices; the genome-range chunks
  ('sp') live one per shard exactly as in the single-host sharded path,
  so index HBM never replicates across hosts; read batches ('dp') are
  fed per host.
- `host_block_iter` splits the FASTQ stream across hosts round-robin
  (every host parses only its own blocks — the multi-host input
  pipeline), and `global_batch` assembles the globally-shaped device
  array from each host's local block via
  jax.make_array_from_process_local_data.

The same ShardedAligner step function runs unchanged: shard_map +
all_gather collectives ride the cards' interconnect within a host and
the network across hosts —
placement follows the mesh, no code change.
"""
from __future__ import annotations

import numpy as np


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Initialise the JAX process group (idempotent)."""
    import jax

    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(n_dp: int, n_sp: int):
    """(dp, sp) mesh over ALL processes' devices.  dp must be a multiple
    of the process count so every host feeds whole dp sub-blocks."""
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices())
    assert devs.size >= n_dp * n_sp, (
        f"need {n_dp * n_sp} global devices, have {devs.size}"
    )
    return Mesh(devs[: n_dp * n_sp].reshape(n_dp, n_sp), ("dp", "sp"))


def host_block_iter(paths, block_size: int, process_id: int,
                    num_processes: int):
    """Round-robin block assignment: host p parses blocks p, p+N, p+2N…
    of the concatenated input stream (the multi-host input pipeline —
    each host decompresses/parses only its share)."""
    from ..seq.fasta import read_blocks

    i = 0
    if isinstance(paths, str):
        paths = [paths]
    for path in paths:
        for blk in read_blocks(path, block_size=block_size):
            if i % num_processes == process_id:
                yield blk
            i += 1


def global_batch(mesh, local_reads: np.ndarray, local_lengths: np.ndarray):
    """Assemble the globally-shaped (B_global, L) array from this host's
    dp sub-block (B_global = local B x num_processes)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    reads = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("dp", None)), np.ascontiguousarray(local_reads)
    )
    lengths = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("dp")), np.ascontiguousarray(local_lengths)
    )
    return reads, lengths


def local_results(out: dict) -> dict:
    """Per-host slice of a sharded align step's output dict (each host
    gets the rows of its own dp sub-blocks)."""
    import jax

    host = {}
    for k, v in out.items():
        if hasattr(v, "addressable_shards"):
            # outputs are replicated over 'sp': keep ONE copy per distinct
            # dp index range
            seen = {}
            for s in v.addressable_shards:
                key = s.index[0].start or 0
                if key not in seen:
                    seen[key] = np.asarray(s.data)
            host[k] = np.concatenate(
                [seen[key] for key in sorted(seen)]
            )
        else:
            host[k] = np.asarray(v)
    return host
