"""Stage profile of one align sweep against a BIG (250 Mbp) device-built
chunk — the large-table gather regime (VERDICT r2 item 4 / PERF.md cliff).

Times: chunk build, candidate stage (pack+LUT+pos-gather+dedup), packed
extension, full align_core, for one 32k batch, plus candidate statistics.

Usage: python scripts/profile_bigchunk.py [--mbp 250] [--batch 32768]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def timeit(fn, *args, n=3):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.monotonic()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.monotonic() - t0) / n, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=250.0)
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--lut-bases", type=int, default=13)
    ap.add_argument("--H", type=int, default=0)
    ap.add_argument("--cap", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from biokanga.align.params import AlignParams
    from biokanga.align.pipeline import AlignEngine, _strand_candidates
    from biokanga.index.device_build import device_build_index
    from biokanga.ops.extend_packed import hamming_extend_packed, pack_reads
    from biokanga.sim.simreads import simulate_reads

    n = int(args.mbp * 1e6)
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=n, dtype=np.int8)
    B, L = args.batch, 100

    _, reads, truths = simulate_reads([("chr1", codes)], B, read_len=L,
                                      sub_rate=0.01, seed=5)
    lengths = np.full(B, L, np.int32)

    t0 = time.monotonic()
    didx = device_build_index(codes, np.array([0, n], np.int64),
                              lut_bases=args.lut_bases)
    jax.block_until_ready(didx.key_hi)
    t_build = time.monotonic() - t0
    print(f"device build {args.mbp:.0f} Mbp: {t_build:.2f} s "
          f"(incl first jit)")

    params = AlignParams()
    dp = params.derive(L, n)
    H = args.H or params.cand_per_core
    cap = args.cap or params.max_cand_per_strand
    print(f"derived: core_len={dp.core_len} offsets={dp.offsets} "
          f"H={H} cap={cap} max_steps={didx.max_bsearch_steps}")

    reads_d = jnp.asarray(reads)
    lengths_d = jnp.asarray(lengths)

    # index arrays MUST be jit arguments, not closure constants — closed-
    # over device arrays are embedded in the compiled program (GBs)
    f_cand = jax.jit(
        lambda kh, kl, lt, pr, r: _strand_candidates(
            (kh, kl, lt, pr, didx.lut_bases, didx.max_bsearch_steps),
            r, dp, H, cap))
    t, (loci, vmask, novr, ovf) = timeit(
        f_cand, didx.key_hi, didx.key_lo, didx.lut, didx.pos_rows, reads_d)
    nv = np.asarray(vmask).sum(axis=1)
    print(f"candidates (1 strand): {t*1e3:8.1f} ms   "
          f"valid/read mean={nv.mean():.1f} max={nv.max()} "
          f"overflow={np.asarray(ovf).mean():.4f}")

    rcodes, rnlane = jax.jit(pack_reads)(reads_d, lengths_d)
    from biokanga.ops.extend_packed import PackedGenome
    pk = didx.packed

    def ext(rows, nrows, es, lc, vm, rc, rn, ln):
        return hamming_extend_packed(
            PackedGenome(rows=rows, n_rows=nrows, length=pk.length),
            es, lc, vm, rc, rn, ln)

    f_ext = jax.jit(ext)
    t, _ = timeit(f_ext, pk.rows, pk.n_rows, didx.entry_starts,
                  loci, vmask, rcodes, rnlane, lengths_d)
    print(f"extension  (1 strand): {t*1e3:8.1f} ms   "
          f"({B * loci.shape[1] / t / 1e6:.0f} M row-gathers/s)")

    engine = AlignEngine(didx, params)
    t0 = time.monotonic()
    res = engine.align_with_rescue(reads, lengths)
    t_first = time.monotonic() - t0
    t0 = time.monotonic()
    res = engine.align_with_rescue(reads, lengths)
    t_full = time.monotonic() - t0
    ok = res["unique"]
    corr = sum(int(res["locus"][i] == truths[i].start - 1)
               for i in range(B) if ok[i])
    print(f"full align_with_rescue: first={t_first:.2f}s steady={t_full:.2f}s "
          f"-> {B / t_full:,.0f} reads/s")
    print(f"unique={ok.mean():.4f} correct_of_unique="
          f"{corr / max(int(ok.sum()), 1):.4f}")


if __name__ == "__main__":
    main()
