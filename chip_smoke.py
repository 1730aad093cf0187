#!/usr/bin/env python3
"""Smoke run of biokanga's main paths on NVIDIA GPUs.

  python chip_smoke.py               one card: phases 1-4 below
  python chip_smoke.py --four-cards  four cards: the sharded aligner and
                                     mesh EC against one card, nothing else

Phases (one JSON line each; any failure stops the run with a non-zero
exit and no result line):

  1 se      `index` of a 100 Mbp random genome (5 x 20 Mbp), then `align`
            of 262,144 x 100 bp reads at 1% substitutions, all through
            biokanga.cli.main; every SAM record checked against the origin
            in its read name
  2 pe      `align` of 131,072 2 x 100 bp pairs (inserts 200-500, orphan
            rescue on) on the same index
  3 ec      `ecreads` of 500 x 10 kb CLR reads at 7% error from a 200 kb
            genome; 32-mer recovery before and after
  4 kernels the CUDA SW kernel against its plain-JAX reference at 4,096
            pairs, 10 kb, W = 96 (scores, best cells, move words and
            decoded columns bit-equal), and the EC vote deltas against an
            integer scatter-add

The line before the last gives the card's name and power limit as
nvidia-smi reports them; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Work files go to build/smoke/ and are removed at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "smoke")


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def check(ok, what) -> None:
    """A phase's pass condition (not an assert: it must survive -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax.monitoring

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration

    def lap(self) -> float:
        s, self.seconds = self.seconds, 0.0
        return s


def sam_truth(path: str, paired: bool):
    """(records, mapped, at true origin, proper pairs) of a SAM file of
    simreads reads."""
    from biokanga.sim.simreads import SimReadTruth

    n = mapped = correct = proper = 0
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            q = line.split("\t", 4)
            flag = int(q[1])
            n += 1
            if paired and flag & 0x2:
                proper += 1
            if flag & 0x4:
                continue
            mapped += 1
            t = SimReadTruth.parse(q[0])
            strand = "-" if flag & 0x10 else "+"
            correct += (q[2] == t.chrom and int(q[3]) == t.start
                        and strand == t.strand)
    return n, mapped, correct, proper


def phase_se(cli, clock, genome_entries, n_reads):
    from biokanga.seq.fasta import write_fasta
    from biokanga.sim.simreads import random_genome

    fa = os.path.join(WORK, "genome.fa")
    idx = os.path.join(WORK, "genome.idx.npz")
    write_fasta(fa, random_genome(genome_entries, seed=11))
    t0 = time.perf_counter()
    check(cli.main(["index", "-i", fa, "-o", idx]) == 0, "index")
    t_index = time.perf_counter() - t0
    reads = os.path.join(WORK, "se.fq")
    check(cli.main(["simreads", "-i", fa, "-o", reads, "-n", str(n_reads),
                    "-l", "100", "--sub-rate", "0.01", "--seed", "21"]) == 0,
          "simreads")
    sam = os.path.join(WORK, "se.sam")
    clock.lap()
    t0 = time.perf_counter()
    check(cli.main(["align", "-i", reads, "-I", idx, "-o", sam]) == 0,
          "align")
    t_align = time.perf_counter() - t0
    n, mapped, correct, _ = sam_truth(sam, paired=False)
    row = dict(phase="se", genome_bp=sum(n for _, n in genome_entries),
               reads=n_reads, records=n, index_build_s=t_index,
               align_wall_s=t_align, reads_per_s=n_reads / t_align,
               compile_s=clock.lap(), unique_frac=mapped / n_reads,
               truth_of_unique=correct / max(mapped, 1))
    emit(**row)
    check(n == n_reads, "one SAM record per read")
    check(row["unique_frac"] >= 0.95, row)
    check(row["truth_of_unique"] >= 0.99, row)
    return fa, idx


def phase_pe(cli, clock, fa, idx, n_pairs):
    r1 = os.path.join(WORK, "pe1.fq")
    r2 = os.path.join(WORK, "pe2.fq")
    check(cli.main(["simreads", "-i", fa, "-o", r1, "-O", r2, "--pe",
                    "-n", str(n_pairs), "-l", "100", "--sub-rate", "0.01",
                    "--insert-min", "200", "--insert-max", "500",
                    "--seed", "22"]) == 0, "simreads --pe")
    sam = os.path.join(WORK, "pe.sam")
    clock.lap()
    t0 = time.perf_counter()
    check(cli.main(["align", "-i", r1, "-u", r2, "-I", idx, "-o", sam])
          == 0, "align PE")
    t_align = time.perf_counter() - t0
    n, mapped, correct, proper = sam_truth(sam, paired=True)
    row = dict(phase="pe", pairs=n_pairs, records=n, align_wall_s=t_align,
               pairs_per_s=n_pairs / t_align, compile_s=clock.lap(),
               proper_pair_frac=proper / n, mapped_frac=mapped / n,
               truth_of_mapped=correct / max(mapped, 1))
    emit(**row)
    check(n == 2 * n_pairs, "two SAM records per pair")
    check(row["proper_pair_frac"] >= 0.95, row)
    check(row["truth_of_mapped"] >= 0.99, row)


def phase_ec(cli, clock, n_reads, read_len, genome_kb):
    import numpy as np

    from biokanga.pacbio import ecreads
    from biokanga.seq.fasta import read_seqs, write_fasta
    from biokanga.sim.clr import clr_reads, kmer_recovery

    reads, truths = clr_reads(n_reads, read_len, genome_kb, 0.07, seed=3)
    fa = os.path.join(WORK, "clr.fa")
    out = os.path.join(WORK, "clr.ec.fa")
    write_fasta(fa, ((f"read{i:06d}", r) for i, r in enumerate(reads)))
    # host wall of every SW step (band windows, SW, decode, votes), less
    # the compilation that happens inside it
    sw_seconds = [0.0]
    inner = ecreads._sw_and_vote

    def timed_sw(*a, **k):
        t, c = time.perf_counter(), clock.seconds
        try:
            return inner(*a, **k)
        finally:
            sw_seconds[0] += (time.perf_counter() - t
                              - (clock.seconds - c))

    ecreads._sw_and_vote = timed_sw
    clock.lap()
    t0 = time.perf_counter()
    try:
        check(cli.main(["ecreads", "-i", fa, "-o", out]) == 0, "ecreads")
    finally:
        ecreads._sw_and_vote = inner
    wall = time.perf_counter() - t0
    corrected = {int(r.name[4:]): r.codes for r in read_seqs(out)}
    pre = float(np.mean([kmer_recovery(r, t)
                         for r, t in zip(reads, truths)]))
    post = float(np.mean([kmer_recovery(corrected.get(i, reads[i]), t)
                          for i, t in enumerate(truths)]))
    compile_s = clock.lap()
    row = dict(phase="ec", reads=n_reads, read_len=read_len,
               genome_kb=genome_kb, wall_s=wall, compile_s=compile_s,
               sw_step_s=sw_seconds[0],
               sw_step_share_excl_compile=sw_seconds[0] / (wall - compile_s),
               kmer32_recovery_pre=pre, kmer32_recovery_post=post)
    emit(**row)
    check(post >= 0.99, row)


def phase_kernels(n_pairs, La, W):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from biokanga.ops.sw_moves import (
        normalize_band,
        sw_moves_cuda,
        sw_moves_ref,
    )
    from biokanga.ops.sw_trace import traceback_cols_packed
    from biokanga.pacbio.ecreads import _vote_deltas, vote_deltas_reference
    from biokanga.sim.clr import clr_pairs

    a, b, alen, blen, diag = clr_pairs(n_pairs, La, W, seed=1)
    bwin, jlo, jhi = normalize_band(b, blen, diag, La, W)
    args = tuple(map(jnp.asarray, (a, bwin, alen, jlo, jhi)))
    got = jax.jit(lambda *x: sw_moves_cuda(*x, W))(*args)
    want = sw_moves_ref(*args, W)
    eq = {k: bool(jnp.array_equal(g, w)) for k, g, w in
          zip(("best", "best_i", "best_k", "moves"), got, want)}
    bw32 = jnp.asarray(bwin, jnp.int32)
    dec = traceback_cols_packed(got[3], got[1], got[2], bw32, W, La)
    dec_w = traceback_cols_packed(want[3], want[1], want[2], bw32, W, La)
    eq["columns"] = all(bool(jnp.array_equal(g, w))
                        for g, w in zip(dec, dec_w))
    rng = np.random.default_rng(2)
    N = 500
    pids = jnp.asarray(rng.integers(0, N, n_pairs).astype(np.int32))
    ok = got[0] >= 60
    vd = jax.jit(_vote_deltas, static_argnums=5)(*dec, pids, ok, N)
    vr = jax.jit(vote_deltas_reference, static_argnums=5)(*dec, pids, ok, N)
    eq["vote_deltas"] = all(bool(jnp.array_equal(g, w))
                            for g, w in zip(vd, vr))
    emit(phase="kernels", sw_pairs=n_pairs, La=La, W=W,
         accepted_pairs=int(ok.sum()), bit_equal=eq)
    check(all(eq.values()), eq)


def four_cards(clock, chunk_bp, n_reads, ec_reads_n):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from biokanga.align.params import AlignParams
    from biokanga.pacbio.ecreads import ECParams, ec_reads
    from biokanga.parallel.chunked import ChunkedAligner
    from biokanga.parallel.sharded import ShardedAligner, make_mesh
    from biokanga.sim.clr import clr_reads
    from biokanga.sim.multichunk import check_planted, chunked_problem

    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 devices, have {len(devs)}")
    t0 = time.perf_counter()
    prob = chunked_problem(4, chunk_bp, n_reads, lut_bases=12)
    t_build = time.perf_counter() - t0
    emit(phase="chunked_index", chunks=4, chunk_real_bp=chunk_bp,
         build_s=t_build)
    params = AlignParams()
    clock.lap()
    t0 = time.perf_counter()
    sa = ShardedAligner(make_mesh(1, 4, devices=devs), prob.ci, params)
    out_s = sa.align(prob.reads, prob.lengths)
    t_sharded = time.perf_counter() - t0
    placement = {int(s.index[0].start or 0): str(s.device)
                 for s in sa.sidx.genome.addressable_shards}
    t0 = time.perf_counter()
    with jax.default_device(devs[0]):
        out_c = ChunkedAligner(prob.ci, params).align(prob.reads,
                                                      prob.lengths)
    t_chunked = time.perf_counter() - t0
    keys = ("unique", "locus", "best_mm", "next_mm", "inst")
    eq = {k: bool(np.array_equal(np.asarray(out_s[k]), np.asarray(out_c[k])))
          for k in keys}
    check_planted(out_s, prob)
    max_locus = int(out_s["locus"][out_s["unique"]].max())
    emit(phase="sharded_align", mesh="dp=1 x sp=4", chunk_real_bp=chunk_bp,
         reads=len(prob.reads), index_build_s=t_build,
         sharded_wall_s=t_sharded, chunked_one_card_wall_s=t_chunked,
         compile_s=clock.lap(), chunk_device=placement,
         unique=int(out_s["unique"].sum()), max_global_locus=max_locus,
         equal=eq)
    check(all(eq.values()), eq)
    check(len(set(placement.values())) == 4, placement)

    reads, _ = clr_reads(ec_reads_n, 10_000, 200, 0.07, seed=3)
    p = ECParams(max_targets=48)
    t0 = time.perf_counter()
    got, st = ec_reads(reads, p, mesh=Mesh(np.asarray(devs), ("dp",)),
                       rounds=2)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    with jax.default_device(devs[0]):
        want, st1 = ec_reads(reads, p, rounds=2)
    t_one = time.perf_counter() - t0
    same = len(got) == len(want) and all(
        np.array_equal(g, w) for g, w in zip(got, want))
    emit(phase="mesh_ec", reads=ec_reads_n, mesh="dp=4",
         mesh_wall_s=t_mesh, one_card_wall_s=t_one,
         overlaps_mesh=st["overlaps_used"], overlaps_one=st1["overlaps_used"],
         corrected_equal=bool(same))
    check(same and st["overlaps_used"] == st1["overlaps_used"],
          "mesh EC equals one-card EC")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from biokanga import cli

    emit(phase="device", kind=devs[0].device_kind, count=len(devs))
    card = card_line()
    clock = CompileClock()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        if args.four_cards:
            four_cards(clock, chunk_bp=100_000_000, n_reads=65_536,
                       ec_reads_n=500)
        else:
            fa, idx = phase_se(cli, clock,
                               [(f"chr{i + 1}", 20_000_000) for i in range(5)],
                               n_reads=262_144)
            phase_pe(cli, clock, fa, idx, n_pairs=131_072)
            phase_ec(cli, clock, n_reads=500, read_len=10_000, genome_kb=200)
            phase_kernels(n_pairs=4096, La=10_240, W=96)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
