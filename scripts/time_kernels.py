"""Time each kernel decision on the GPU against what XLA makes of the
plain version, at the shapes the smoke run uses.  One JSON line per
measurement, with the card's name and power limit on the first line.

  sort   lax.sort of the aligner's candidate matrices in four layouts:
         (C, B) transposed or (B, C) row-major, each padded to a power of
         two or not, at the fast-pass and classic-pass shapes of 100 bp
         reads against a 100 Mbp genome
  sw     the packed-moves SW kernel (ops/sw_moves.sw_moves_cuda) against
         its plain-JAX form (sw_moves_ref) and ops/sw.banded_sw_batch, at
         EC widths (W = 96, 10 kb queries); the kernel's outputs are
         checked bit-equal to sw_moves_ref first
  ec     EC end to end (500 x 10 kb CLR reads, 7% error, 2 rounds) with
         the SW kernel and with the plain-JAX engine in its place, in
         turns (kernel, plain, plain, kernel), after one warm-up each
  trace  the sorts' share of align device time: a profiler trace of SE
         align batches (100 bp reads, 100 Mbp genome) reduced to device
         time per op, sort ops against all ops

Usage: python scripts/time_kernels.py [--only sort|sw|trace] [--pairs 4096]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

I32_MAX = np.int32(2**31 - 1)


def card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def timed(fn, *args, reps=5):
    """(compile+first-run s, median steady ms) of fn(*args)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)) * 1e3


def pad_pow2(x, axis):
    n = x.shape[axis]
    P = 1 << (n - 1).bit_length()
    if P == n:
        return x
    pw = [(0, 0)] * x.ndim
    pw[axis] = (0, P - n)
    return jnp.pad(x, pw, constant_values=I32_MAX)


def sort_variant(transposed: bool, padded: bool, nkeys: int):
    def f(*ops):
        C = ops[0].shape[1]
        if transposed:
            ops = [o.T for o in ops]
            if padded:
                ops = [pad_pow2(o, 0) for o in ops]
            out = jax.lax.sort(tuple(ops), dimension=0, num_keys=nkeys)
            return tuple(o[:C].T for o in out)
        if padded:
            ops = [pad_pow2(o, 1) for o in ops]
        out = jax.lax.sort(tuple(ops), dimension=1, num_keys=nkeys)
        return tuple(o[:, :C] for o in out)
    return jax.jit(f)


def run_sort(batches):
    from biokanga.align.params import AlignParams

    p = AlignParams()
    dp = p.derive(100, 100_000_000)
    fp = p.derive_fast(100, 100_000_000, 12)
    shapes = [
        ("fast", len(fp.dp.offsets) * fp.H, 2 * fp.cand_cap),
        ("classic", len(dp.offsets) * p.cand_per_core,
         2 * p.max_cand_per_strand),
    ]
    rng = np.random.default_rng(0)
    for B in batches:
        for name, C_dedup, C_final in shapes:
            x = rng.integers(0, 2**30, (B, C_dedup), dtype=np.int32)
            x[rng.random(x.shape) < 0.3] = I32_MAX
            k = rng.integers(0, 40, (B, C_final), dtype=np.int32)
            v = rng.integers(0, 2**30, (B, C_final), dtype=np.int32)
            x, k, v = map(jnp.asarray, (x, k, v))
            want1 = np.asarray(jax.lax.sort(x, dimension=1))
            want2 = [np.asarray(o) for o in
                     jax.lax.sort((k, v), dimension=1, num_keys=2)]
            for tr in (True, False):
                for pd in (True, False):
                    f1 = sort_variant(tr, pd, 1)
                    f2 = sort_variant(tr, pd, 2)
                    assert np.array_equal(np.asarray(f1(x)[0]), want1)
                    got2 = f2(k, v)
                    assert all(np.array_equal(np.asarray(g), w)
                               for g, w in zip(got2, want2))
                    _, ms1 = timed(f1, x)
                    _, ms2 = timed(f2, k, v)
                    print(json.dumps({
                        "what": "sort", "pass": name, "B": B,
                        "layout": "(C,B)" if tr else "(B,C)",
                        "pow2_pad": pd, "dedup_C": C_dedup,
                        "dedup_ms": ms1, "final_C": C_final,
                        "final_ms": ms2}), flush=True)


def run_sw(n_pairs, La, W, with_scan):
    from biokanga.ops.sw import banded_sw_batch
    from biokanga.ops.sw_moves import (
        build_cuda_library,
        normalize_band,
        sw_moves_cuda,
        sw_moves_ref,
    )
    from biokanga.ops.sw_trace import traceback_cols_packed
    from biokanga.sim.clr import clr_pairs

    t0 = time.perf_counter()
    build_cuda_library()
    print(json.dumps({"what": "sw_build", "seconds":
                      time.perf_counter() - t0}), flush=True)
    a, b, alen, blen, diag = clr_pairs(n_pairs, La, W)
    bwin, jlo, jhi = normalize_band(b, blen, diag, La, W)
    args = tuple(map(jnp.asarray, (a, bwin, alen, jlo, jhi)))
    ker = jax.jit(lambda *x: sw_moves_cuda(*x, W))
    ref = jax.jit(lambda *x: sw_moves_ref(*x, W))
    got = [np.asarray(o) for o in ker(*args)]
    want = [np.asarray(o) for o in ref(*args)]
    eq = {n: bool(np.array_equal(g, w))
          for n, g, w in zip(("best", "best_i", "best_k", "moves"), got,
                             want)}
    bw32 = jnp.asarray(bwin.astype(np.int32))
    dec_g = traceback_cols_packed(jnp.asarray(got[3]), jnp.asarray(got[1]),
                                  jnp.asarray(got[2]), bw32, W, La)
    dec_w = traceback_cols_packed(jnp.asarray(want[3]),
                                  jnp.asarray(want[1]),
                                  jnp.asarray(want[2]), bw32, W, La)
    eq["columns"] = all(np.array_equal(np.asarray(g), np.asarray(w))
                        for g, w in zip(dec_g, dec_w))
    cells = float(n_pairs) * La * (2 * W + 1)
    c_k, ms_k = timed(ker, *args, reps=3)
    c_r, ms_r = timed(ref, *args, reps=3)
    row = {"what": "sw", "pairs": n_pairs, "La": La, "W": W,
           "bit_equal": eq, "kernel_ms": ms_k, "kernel_first_s": c_k,
           "xla_packed_ms": ms_r, "xla_packed_first_s": c_r,
           "kernel_gcups": cells / ms_k / 1e6,
           "xla_packed_gcups": cells / ms_r / 1e6}
    if with_scan:
        Lb = b.shape[1]
        scan = jax.jit(lambda a_, b_, al, bl, dg: banded_sw_batch(
            a_, b_, al, bl, dg, W, La, Lb))
        sargs = tuple(map(jnp.asarray, (a, b, alen, blen, diag)))
        c_s, ms_s = timed(scan, *sargs, reps=1)
        s_best = np.asarray(scan(*sargs)[0])
        row.update(xla_scan_ms=ms_s, xla_scan_first_s=c_s,
                   xla_scan_gcups=cells / ms_s / 1e6,
                   scan_best_equal=bool(np.array_equal(s_best, got[0])))
    print(json.dumps(row), flush=True)
    if not all(eq.values()):
        raise SystemExit("sw kernel differs from sw_moves_ref")


def device_op_times(trace_dir):
    """{op name: device ns}, busy ns and window ns of the GPU planes of
    the one profile under trace_dir."""
    import glob

    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    pd = ProfileData.from_file(path)
    ops, spans, lines_seen = {}, [], set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        lines_seen.update(ln.name for ln in lines)
        op_lines = [ln for ln in lines if ln.name == "XLA Ops"] or [
            ln for ln in lines
            if "module" not in ln.name.lower()
            and "step" not in ln.name.lower()]
        for line in op_lines:
            for ev in line.events:
                ops[ev.name] = ops.get(ev.name, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return ops, busy, window, sorted(lines_seen)


def run_trace(n_batches, batch):
    from biokanga.align.params import AlignParams
    from biokanga.align.pipeline import AlignEngine
    from biokanga.index.build import build_index
    from biokanga.index.device import to_device
    from biokanga.sim.simreads import random_genome, simulate_reads

    seqs = random_genome([(f"chr{i + 1}", 20_000_000) for i in range(5)],
                         seed=11)
    idx = build_index(seqs, lut_bases=12)
    eng = AlignEngine(to_device(idx), AlignParams(batch_size=batch))
    _, reads, _ = simulate_reads(seqs, n_batches * batch, read_len=100,
                                 sub_rate=0.01, seed=21)
    lengths = np.full(batch, 100, np.int32)
    blocks = [reads[i: i + batch] for i in range(0, len(reads), batch)]
    for blk in blocks[:2]:                       # compile outside
        eng.align_with_rescue(blk, lengths)
    tdir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "trace_align")
    import shutil

    shutil.rmtree(tdir, ignore_errors=True)
    t0 = time.perf_counter()
    with jax.profiler.trace(tdir):
        for blk in blocks[2:]:
            eng.align_with_rescue(blk, lengths)
    wall = time.perf_counter() - t0
    ops, busy, window, lines = device_op_times(tdir)
    sort_ns = sum(v for k, v in ops.items() if "sort" in k.lower())
    total = sum(ops.values())
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "what": "align_trace", "batches": n_batches - 2, "batch": batch,
        "host_wall_s": wall, "device_op_ms": total / 1e6,
        "device_busy_ms": busy / 1e6, "device_window_ms": window / 1e6,
        "idle_share_of_window": 1 - busy / window if window else None,
        "sort_ms": sort_ns / 1e6,
        "sort_share_of_device_ops": sort_ns / total if total else None,
        "top_ops_ms": {k: v / 1e6 for k, v in top},
        "gpu_plane_lines": lines}), flush=True)


def run_ec(n_reads):
    from biokanga.ops import sw_moves
    from biokanga.pacbio import ecreads
    from biokanga.pacbio.ecreads import ECParams, ec_reads
    from biokanga.sim.clr import clr_reads

    reads, _ = clr_reads(n_reads, 10_000, 200, 0.07, seed=3)
    p = ECParams(max_targets=48)
    engines = {"kernel": sw_moves.sw_moves_impl,
               "xla_plain": lambda platform: sw_moves.sw_moves_ref}
    out = {}
    try:
        for name in ("kernel", "xla_plain", "xla_plain", "kernel"):
            ecreads.sw_moves_impl = engines[name]
            if name not in out:                      # warm-up / compile
                first, _ = ec_reads(reads, p, rounds=2)
                out[name] = {"first": first, "walls": []}
            t0 = time.perf_counter()
            got, st = ec_reads(reads, p, rounds=2)
            out[name]["walls"].append(time.perf_counter() - t0)
            assert all(np.array_equal(g, w)
                       for g, w in zip(got, out[name]["first"]))
    finally:
        ecreads.sw_moves_impl = sw_moves.sw_moves_impl
    same = all(np.array_equal(g, w) for g, w in
               zip(out["kernel"]["first"], out["xla_plain"]["first"]))
    print(json.dumps({"what": "ec_engines", "reads": n_reads,
                      "kernel_wall_s": out["kernel"]["walls"],
                      "xla_plain_wall_s": out["xla_plain"]["walls"],
                      "corrected_equal": bool(same)}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("sort", "sw", "trace", "ec"),
                    default=None)
    ap.add_argument("--pairs", type=int, default=4096)
    ap.add_argument("--la", type=int, default=10240)
    ap.add_argument("--w", type=int, default=96)
    ap.add_argument("--batches", default="4096,65536")
    ap.add_argument("--no-scan", action="store_true",
                    help="skip timing ops/sw.banded_sw_batch")
    a = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("time_kernels.py measures the GPU; none found")
    d = jax.devices()[0]
    print(json.dumps({"card": card(), "device_kind": d.device_kind}),
          flush=True)
    if a.only in (None, "sw"):
        run_sw(a.pairs, a.la, a.w, not a.no_scan)
    if a.only in (None, "sort"):
        run_sort([int(x) for x in a.batches.split(",")])
    if a.only in (None, "trace"):
        run_trace(10, 4096)
    if a.only in (None, "ec"):
        run_ec(500)


if __name__ == "__main__":
    main()
