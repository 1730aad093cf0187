"""Distributed Smith-Waterman job execution over a device mesh.

Batched replacement for the BKS TCP work-server RPC
(pacbiokanga/BKSRequester.cpp / BKSProvider.cpp / PBSWService.cpp and the
framed-packet protocol BKScommon.h:20-80): where the reference negotiates
TCP sessions, ships <=64MB payloads to provider daemons and re-queues
jobs on keepalive timeouts, the batched design shards a BATCH of SW jobs
over the mesh's 'dp' axis with jax.sharding — scheduling, transport and
failure handling collapse into SPMD dispatch + XLA collectives.
The requester/provider dynamic-balance loop (PBErrCorrect.h:207-213)
becomes static even sharding of the job batch.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.sw import banded_sw_batch


@dataclass
class SWJobBatch:
    """A batch of banded SW jobs (the BKS 'job queue' analogue)."""
    a: np.ndarray      # (B, La) int8
    b: np.ndarray      # (B, Lb) int8
    alen: np.ndarray
    blen: np.ndarray
    diag: np.ndarray


def make_sw_mesh(n_devices: int | None = None) -> Mesh:
    devs = np.asarray(jax.devices())
    n = n_devices or devs.size
    return Mesh(devs[:n].reshape(n), ("dp",))


def run_sw_jobs(
    mesh: Mesh,
    jobs: SWJobBatch,
    W: int,
    return_moves: bool = False,
):
    """Execute the job batch data-parallel over the mesh.

    Jobs are padded to a multiple of the 'dp' axis size and placed with
    batch-dim sharding; XLA partitions the scan over devices with no
    communication (embarrassingly parallel, like the reference's
    independent SW service instances).
    """
    n_dp = mesh.shape["dp"]
    B = jobs.a.shape[0]
    Bp = -(-B // n_dp) * n_dp

    def pad(x, fill):
        if x.shape[0] == Bp:
            return x
        out = np.full((Bp,) + x.shape[1:], fill, dtype=x.dtype)
        out[:B] = x
        return out

    sh = NamedSharding(mesh, P("dp"))
    a = jax.device_put(pad(jobs.a, 4), NamedSharding(mesh, P("dp", None)))
    b = jax.device_put(pad(jobs.b, 4), NamedSharding(mesh, P("dp", None)))
    alen = jax.device_put(pad(jobs.alen, 0), sh)
    blen = jax.device_put(pad(jobs.blen, 0), sh)
    diag = jax.device_put(pad(jobs.diag, 0), sh)

    La, Lb = jobs.a.shape[1], jobs.b.shape[1]
    best, bi, bk, moves = banded_sw_batch(a, b, alen, blen, diag, W, La, Lb)
    out = {
        "score": np.asarray(best)[:B],
        "best_i": np.asarray(bi)[:B],
        "best_k": np.asarray(bk)[:B],
    }
    if return_moves:
        out["moves"] = np.asarray(moves)[:B]
    return out
