"""Profile the EXACT 3 Gbp sweep inner loop: steady-state device chunk
build + double-buffered launch_primary/finish_primary over read blocks
(+ checkpoint save cost) — finds where the ~90-130 s/chunk of
BENCH_3G's sweep actually goes.

Usage: python scripts/profile_sweep_loop.py [--mbp 250] [--blocks 4]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=250.0)
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--lut-bases", type=int, default=13)
    args = ap.parse_args()

    import jax

    from biokanga.align.params import AlignParams
    from biokanga.align.pipeline import pad_rows
    from biokanga.index.device_build import DeviceBuildChunkedAligner
    from biokanga.sim.simreads import simulate_reads

    n = int(args.mbp * 1e6)
    rng = np.random.default_rng(7)
    # TWO chunks of identical padded shape -> steady-state build timing
    codes = rng.integers(0, 4, size=2 * n, dtype=np.int8)
    B, L = args.batch, 100
    _, reads, truths = simulate_reads([("chr1", codes)], B, read_len=L,
                                      sub_rate=0.01, seed=5)
    params = AlignParams(batch_size=B)
    ca = DeviceBuildChunkedAligner([("chr1", codes)], params,
                                   max_chunk=n, overlap=2048,
                                   lut_bases=args.lut_bases)
    print(f"chunks: {ca.num_chunks}, pad {ca.pad_n/1e6:.0f} Mbp",
          flush=True)

    for k in range(min(2, ca.num_chunks)):
        t0 = time.monotonic()
        codes_k, es, own = ca._chunk_codes(k)
        t_host = time.monotonic() - t0
        t0 = time.monotonic()
        eng = ca.engine_for(k)
        jax.block_until_ready(eng.didx.key_hi)
        t_build = time.monotonic() - t0
        print(f"chunk {k}: host codes {t_host:.2f}s  device build "
              f"{t_build:.2f}s", flush=True)

    blocks = []
    for i in range(args.blocks):
        blocks.append(pad_rows(reads, np.full(B, L, np.int32)))

    eng = ca.engine_for(0)
    # block loop, double-buffered, per-phase timing
    t_launch = t_finish = 0.0
    pend = None
    t0 = time.monotonic()
    for b, (r, ln) in enumerate(blocks):
        ta = time.monotonic()
        st = eng.launch_primary(r, ln)
        t_launch += time.monotonic() - ta
        if pend is not None:
            ta = time.monotonic()
            eng.finish_primary(pend)
            t_finish += time.monotonic() - ta
        pend = st
    ta = time.monotonic()
    res = eng.finish_primary(pend)
    t_finish += time.monotonic() - ta
    t_all = time.monotonic() - t0
    print(f"first-block loop: {t_all:.2f}s (launch {t_launch:.2f} "
          f"finish {t_finish:.2f})", flush=True)

    t0 = time.monotonic()
    pend = None
    nres = 0
    for b, (r, ln) in enumerate(blocks):
        st = eng.launch_primary(r, ln)
        if pend is not None:
            out = eng.finish_primary(pend)
            nres += 1
        pend = st
    out = eng.finish_primary(pend)
    t_all = time.monotonic() - t0
    rate = args.blocks * B / t_all
    print(f"steady loop {args.blocks} blocks: {t_all:.2f}s -> "
          f"{rate:,.0f} reads/s/chunk-sweep", flush=True)

    # checkpoint save cost
    import tempfile

    from biokanga.utils.checkpoint import SweepCheckpoint
    d = tempfile.mkdtemp()
    ck = SweepCheckpoint(d, "sig")
    t0 = time.monotonic()
    ck.save(0, 0, out)
    print(f"ckpt save: {time.monotonic() - t0:.2f}s", flush=True)


if __name__ == "__main__":
    main()
