"""PE headline decomposition (VERDICT r4 item 5 / weak-1): where do the
PE reads/s go — device graph, uploads, or host pairing?

Cells (bench.py's exact PE shape: 65,536 pairs/batch x 8 batches,
100 bp, 4.6 Mbp genome, insert 200-500):
  full    — bench.py's double-buffered launch/finish PE path
  launch  — launch-only loop (uploads + device graph; host pairing
            excluded, one final device_get)
  device  — chained executions of the fused 2N-row primary graph on ONE
            pre-staged batch (no upload in the loop): the PE
            device-graph ceiling, analogue of the round-4 SE 464k figure
  host    — one finish_pairs on a completed launch (classify + orphan
            rescue + reclassify), timed host-side

Prints one JSON line. Match: reference ProcessPairedEnds
(biokanga/Aligner.cpp:2876).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    from biokanga.align.params import AlignParams
    from biokanga.align.pe import PEAligner, PEParams
    from biokanga.align.pipeline import AlignEngine
    from biokanga.index.build import build_index
    from biokanga.index.device import to_device
    from biokanga.sim.simreads import random_genome, simulate_reads
    from biokanga.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    genome_len = 4_600_000
    read_len = 100
    batch = 65536
    n_pairs = 8 * batch
    epochs = 4

    seqs = random_genome([("chr", genome_len)], seed=42)
    idx = build_index(seqs, lut_bases=10)
    _, pe_reads, _ = simulate_reads(
        seqs, n_pairs, read_len=read_len, sub_rate=0.01, seed=17,
        pe=True, insert_min=200, insert_max=500)
    r1, r2 = pe_reads[0::2], pe_reads[1::2]
    pe_len = np.full(n_pairs, read_len, dtype=np.int32)

    engine = AlignEngine(to_device(idx), AlignParams(batch_size=batch))
    pea = PEAligner(engine, PEParams(pair_min_len=100, pair_max_len=600))
    pea.align_pairs(r1[:batch], pe_len[:batch], r2[:batch],
                    pe_len[:batch])  # compile everything once
    out = {}

    # ---- full (bench.py loop) ----
    dt = float("inf")
    for _ in range(epochs):
        t0 = time.monotonic()
        pending = None
        for i in range(0, n_pairs, batch):
            nxt = pea.launch_pairs(r1[i:i + batch], pe_len[i:i + batch],
                                   r2[i:i + batch], pe_len[i:i + batch])
            if pending is not None:
                pea.finish_pairs(pending)
            pending = nxt
        pea.finish_pairs(pending)
        dt = min(dt, time.monotonic() - t0)
    out["full_reads_per_s"] = round(2 * n_pairs / dt, 0)

    # ---- launch-only (uploads + device graph; no host pairing) ----
    dt = float("inf")
    for _ in range(epochs):
        t0 = time.monotonic()
        last = None
        for i in range(0, n_pairs, batch):
            last = engine.launch_primary(
                np.concatenate([r1[i:i + batch], r2[i:i + batch]]),
                np.concatenate([pe_len[i:i + batch],
                                pe_len[i:i + batch]]))
        jax.device_get(last[2])
        dt = min(dt, time.monotonic() - t0)
    out["launch_only_reads_per_s"] = round(2 * n_pairs / dt, 0)

    # ---- device-graph ceiling: chained executions, one staged batch ----
    # Reuse launch_primary's jitted fn by re-dispatching the SAME host
    # batch; uploads amortize via a pre-pinned device copy: stage once,
    # then call the underlying jitted fn directly with device args.
    reads2n = np.concatenate([r1[:batch], r2[:batch]])
    len2n = np.concatenate([pe_len[:batch], pe_len[:batch]])
    from biokanga.align.pipeline import _host_pack_2bit

    fp = engine._fast_params(reads2n)
    dp, H, cap = ((fp.dp, fp.H, fp.cand_cap) if fp is not None
                  else (None, None, None))
    if dp is None:
        dp = engine.params.derive(read_len, engine.didx.total_len)
        H = engine.params.cand_per_core
        cap = engine.params.max_cand_per_strand
    codes2, nmask = _host_pack_2bit(reads2n)
    upload = "p2" if nmask is None else "p2n"
    fn = engine._fn(dp, H, engine.params.strand,
                    engine.didx.packed is not None, int(cap), True,
                    upload=upload, read_len=read_len, occ_skip=True)
    d = engine.didx
    dev_args = [d.genome, d.entry_starts, d.pos_rows, d.key_hi, d.key_lo,
                d.lut, jax.device_put(codes2),
                jax.device_put(len2n)]
    if nmask is not None:
        dev_args.append(jax.device_put(nmask))
    if d.owned is not None:
        dev_args.append(d.owned)
    if d.packed is not None:
        dev_args.append(d.packed.rows)
        if d.packed.has_n:
            dev_args.append(d.packed.n_rows)
    o = fn(*dev_args)
    jax.device_get(o)
    K = 8
    dt = float("inf")
    for _ in range(epochs):
        t0 = time.monotonic()
        o = None
        for _k in range(K):
            o = fn(*dev_args)
        jax.device_get(o)
        dt = min(dt, time.monotonic() - t0)
    out["device_graph_reads_per_s"] = round(K * 2 * batch / dt, 0)

    # ---- host pairing share ----
    pend = pea.launch_pairs(r1[:batch], pe_len[:batch], r2[:batch],
                            pe_len[:batch])
    state = pend[0]
    res = engine.finish_primary(state)  # device_get + completion now
    t0 = time.monotonic()
    N = batch
    res1 = {k: (v[:N] if hasattr(v, "__len__") else v)
            for k, v in res.items()}
    res2 = {k: (v[N:] if hasattr(v, "__len__") else v)
            for k, v in res.items()}
    pea._pair_and_rescue(res1, res2, r1[:batch], pe_len[:batch],
                         r2[:batch], pe_len[:batch])
    out["host_pairing_s_per_batch"] = round(time.monotonic() - t0, 3)
    out["batch_pairs"] = batch

    print(json.dumps({"metric": "pe_decomposition", **out}))


if __name__ == "__main__":
    main()
