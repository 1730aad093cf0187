"""Microbenchmark: strategies for random 64 B row gathers from LARGE
(cache-miss regime) tables — the big-genome cliff (PERF.md, VERDICT r2
item 4).

Variants:
  plain     — x[idx] as-is (the round-2 baseline: ~44 M rows/s @128 MB)
  sorted    — sort indices, gather in ascending order, invert permutation
              (re-test of the round-2 'locality' experiment, which was
              only measured in the small-table regime where the plain
              gather was already fast)
  sortnoinv — sorted gather without the inverse permutation (lower bound
              for consumers that can work in sorted order)

Usage: python scripts/probe_gather.py [--mb 128] [--n 6291456]
"""
from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, n=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.monotonic()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.monotonic() - t0) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=128.0)
    ap.add_argument("--n", type=int, default=6_291_456)  # 32k reads x 192
    args = ap.parse_args()

    R = int(args.mb * 1e6 / 64)
    rng = np.random.default_rng(0)
    table = jnp.asarray(
        rng.integers(0, 2**32, size=(R, 16), dtype=np.uint32)
    )
    idx = jnp.asarray(rng.integers(0, R, size=args.n, dtype=np.int32))
    print(f"table {table.nbytes/1e6:.0f} MB ({R} rows), {args.n} gathers")

    # consume each gathered row XORed with its own index — defeats the
    # XLA rewrite of gather-then-reduce into reduce-then-gather (the
    # first probe version measured 130 TB/s "gathers": the table was
    # row-summed once and only scalars were gathered)
    def consume(v, i_):
        return (v ^ i_[:, None].astype(jnp.uint32)).sum(dtype=jnp.uint32)

    f_plain = jax.jit(lambda t, i: consume(t[i], i))
    t = timeit(f_plain, table, idx)
    print(f"plain      {t*1e3:8.1f} ms  {args.n/t/1e6:7.1f} M rows/s")

    def sorted_noinv(t_, i_):
        si = jnp.sort(i_)
        return consume(t_[si], si)

    t = timeit(jax.jit(sorted_noinv), table, idx)
    print(f"sortnoinv  {t*1e3:8.1f} ms  {args.n/t/1e6:7.1f} M rows/s")

    # components
    t = timeit(jax.jit(lambda i_: jnp.sort(i_)), idx)
    print(f"  sort alone      {t*1e3:8.1f} ms")
    si = jnp.sort(idx)
    t = timeit(f_plain, table, si)
    print(f"  presorted gather{t*1e3:8.1f} ms  {args.n/t/1e6:7.1f} M rows/s")

    # gather from a SMALL table for reference
    Rs = int(2.3e6 / 64)
    ts = table[:Rs]
    idxs = jnp.asarray(rng.integers(0, Rs, size=args.n, dtype=np.int32))
    t = timeit(f_plain, ts, idxs)
    print(f"small(2.3MB){t*1e3:7.1f} ms  {args.n/t/1e6:7.1f} M rows/s")

    # small-table sweep: find the size where the fast regime ends
    for mb in (4, 8, 16, 32, 64):
        Rm = int(mb * 1e6 / 64)
        if Rm > R:
            break
        tm = table[:Rm]
        im = jnp.asarray(rng.integers(0, Rm, size=args.n, dtype=np.int32))
        t = timeit(f_plain, tm, im)
        print(f"small({mb:3d}MB){t*1e3:7.1f} ms  {args.n/t/1e6:7.1f} M rows/s")

    # partitioned: sort once, then scan static sub-table slices small
    # enough that XLA gathers them at the small-table rate.  Per-slice
    # candidate segments are padded to a static cap P (overflow would be
    # handled by the classic path; with uniform loci P = 2x mean never
    # overflows in practice — the probe reports the overflow count).
    n_ = args.n
    for sub_mb in (2, 4, 8):
        T = max(1, int(args.mb / sub_mb))
        while R % T:
            T -= 1
        Rs_p = R // T
        P = int(2.0 * n_ / T + 1023) & ~1023

        def partitioned(t_, i_):
            si = jnp.sort(i_)
            bounds = jnp.searchsorted(
                si, jnp.arange(T + 1, dtype=jnp.int32) * Rs_p)
            offs = bounds[:-1]
            cnt = bounds[1:] - offs
            over = jnp.maximum(cnt - P, 0).sum()

            def body(carry, k):
                acc = carry
                sl = jax.lax.dynamic_slice(t_, (k * Rs_p, 0), (Rs_p, 16))
                # barrier: stop XLA fusing the slice INTO the gather
                # (without it the 4/8MB cells measured exactly the
                # large-table rate — the slice never materialised)
                sl = jax.lax.optimization_barrier(sl)
                pos = jnp.clip(offs[k] + jnp.arange(P), 0, n_ - 1)
                li = jnp.clip(si[pos] - k * Rs_p, 0, Rs_p - 1)
                v = sl[li] ^ li[:, None].astype(jnp.uint32)
                m = (jnp.arange(P) < cnt[k])[:, None]
                return acc + jnp.where(m, v, 0).sum(dtype=jnp.uint32), None

            acc, _ = jax.lax.scan(
                body, jnp.uint32(0), jnp.arange(T, dtype=jnp.int32))
            return acc, over

        t = timeit(jax.jit(partitioned), table, idx)
        print(f"part {sub_mb}MB T={T:3d} P={P:6d} {t*1e3:8.1f} ms  "
              f"{n_/t/1e6:7.1f} M rows/s  "
              f"overflow={int(jax.jit(partitioned)(table, idx)[1])}")


if __name__ == "__main__":
    main()
