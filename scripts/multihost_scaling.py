"""Virtual multi-host scaling measurement (VERDICT r2 item 10).

Runs the REAL multi-host path (jax.distributed CPU cluster, per-host
FASTQ-share input, dp x sp sharded align step with cross-host
collectives) at 1 host and 2 hosts on the same total workload and
reports relative scaling plus input-pipeline overlap.  Virtual CPU
devices mean the ABSOLUTE rate is meaningless; the RELATIVE number is
the executable proxy this 1-chip environment allows for the >=80%
north-star (BASELINE.md).

Worker mode (internal):  python multihost_scaling.py --worker PID NPROC PORT
Driver mode (default):   python multihost_scaling.py
Prints one JSON line (driver mode).
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_SP = 4
DEV_PER_HOST = 4
READS_PER_DP = 2048      # fixed TOTAL work: B_global = n_dp * READS_PER_DP
N_BATCHES = 8


def worker(pid: int, nproc: int, port: int) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEV_PER_HOST}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from biokanga.align.params import AlignParams
    from biokanga.index.chunked import build_chunked_index
    from biokanga.parallel.multihost import (
        global_batch,
        global_mesh,
        init_multihost,
        local_results,
    )
    from biokanga.parallel.sharded import (
        build_sharded_align_fn,
        shard_chunked_index,
    )
    from biokanga.sim.simreads import random_genome, simulate_reads

    init_multihost(f"localhost:{port}", nproc, pid)
    n_dp = (DEV_PER_HOST * nproc) // N_SP
    mesh = global_mesh(n_dp, N_SP)
    seqs = random_genome([("c1", 200_000), ("c2", 200_000)], seed=31)
    ci = build_chunked_index(seqs, num_chunks=N_SP, overlap=256,
                             lut_bases=10)
    params = AlignParams(cand_per_core=32)
    sidx = shard_chunked_index(ci, mesh)
    # fixed TOTAL workload regardless of nproc: 4 dp-shards' worth
    # (the 4-host cluster's natural dp width, so the 1-host run does
    # 4x its per-step work and scaling is strong-scaling)
    B_global = 4 * READS_PER_DP
    _, reads, _ = simulate_reads(seqs, B_global, read_len=100,
                                 sub_rate=0.02, seed=13)
    lengths = np.full(B_global, 100, np.int32)
    per_host = B_global // nproc
    lo = pid * per_host

    dp_params = params.derive(100, ci.total_len)
    step = build_sharded_align_fn(mesh, sidx, params, dp_params,
                                  H=params.cand_per_core)
    t_input = 0.0
    with mesh:
        # warmup/compile
        g = global_batch(mesh, reads[lo:lo + per_host],
                         lengths[lo:lo + per_host])
        local_results({"unique": step(*g)["unique"]})
        t0 = time.monotonic()
        n_acc = 0
        for it in range(N_BATCHES):
            ti = time.monotonic()
            greads, glens = global_batch(mesh, reads[lo:lo + per_host],
                                         lengths[lo:lo + per_host])
            t_input += time.monotonic() - ti
            out = step(greads, glens)
            host = local_results({"unique": out["unique"]})
            n_acc += int(host["unique"].sum())
        dt = time.monotonic() - t0
    print(json.dumps({"pid": pid, "nproc": nproc, "wall_s": dt,
                      "input_s": t_input,
                      "reads_total": B_global * N_BATCHES,
                      "n_acc": n_acc}), flush=True)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def run_cluster(nproc: int):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(pid), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(nproc)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    rows = []
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
        rows.append(json.loads(o.strip().splitlines()[-1]))
    return rows


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
        return
    ladder = {}
    reads = None
    for nproc in (1, 2, 4):
        rows = run_cluster(nproc)
        reads = rows[0]["reads_total"]
        wall = max(r["wall_s"] for r in rows)
        ladder[nproc] = {
            "wall_s": round(wall, 2),
            "reads_per_s_total": round(reads / wall, 1),
            "reads_per_s_per_host": round(reads / wall / nproc, 1),
            "input_frac_of_wall": round(
                max(r["input_s"] for r in rows) / wall, 3),
        }
    rate1 = ladder[1]["reads_per_s_total"]
    print(json.dumps({
        "metric": "multihost_virtual_scaling",
        "value": round(ladder[4]["reads_per_s_total"] / rate1 / 4, 3),
        "unit": "frac_linear_1to4",
        "detail": {
            "reads_total": reads,
            "scaling_1to2": round(
                ladder[2]["reads_per_s_total"] / rate1, 3),
            "scaling_1to4": round(
                ladder[4]["reads_per_s_total"] / rate1, 3),
            "hosts": ladder,
            "note": ("virtual 4-dev CPU hosts on a 2-vCPU VM; absolute "
                     "rates are CPU-backend numbers and the 4-host row "
                     "oversubscribes 16 XLA devices onto 2 cores — the "
                     "relative ladder is the executable proxy this "
                     "1-chip environment allows"),
        },
    }))


if __name__ == "__main__":
    main()
