"""Stage-level profiling of the align pipeline on the current device."""
import time

import jax
import jax.numpy as jnp
import numpy as np

from biokanga.align.params import AlignParams
from biokanga.align.pipeline import _rc_reads, _strand_candidates
from biokanga.index.build import build_index
from biokanga.index.device import to_device
from biokanga.ops.extend_packed import hamming_extend_packed, pack_reads
from biokanga.ops.lookup import pack_read_kmers, seed_range_lookup
from biokanga.sim.simreads import random_genome, simulate_reads


def timeit(fn, *args, n=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.monotonic()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.monotonic() - t0) / n


def main():
    B, L = 8192, 100
    seqs = random_genome([("chr", 4_600_000)], seed=42)
    idx = build_index(seqs, lut_bases=12)
    didx = to_device(idx)
    params = AlignParams()
    dp = params.derive(L, idx.total_len)
    H = params.cand_per_core
    cap = params.max_cand_per_strand
    print(f"derived: {dp}")
    print(f"max_bsearch_steps={didx.max_bsearch_steps}")

    names, reads, _ = simulate_reads(seqs, B, read_len=L, sub_rate=0.01, seed=9)
    lengths = np.full(B, L, dtype=np.int32)
    reads_d = jnp.asarray(reads)
    lengths_d = jnp.asarray(lengths)

    arrays = (didx.key_hi, didx.key_lo, didx.lut, didx.pos_sorted,
              didx.lut_bases, didx.max_bsearch_steps)

    f_pack = jax.jit(lambda r: pack_read_kmers(r, dp.offsets, dp.core_len))
    print(f"pack_kmers:      {timeit(f_pack, reads_d)*1e3:8.1f} ms")

    q = f_pack(reads_d)

    f_lookup = jax.jit(
        lambda qlh, qll, qhh, qhl: seed_range_lookup(
            didx.key_hi, didx.key_lo, didx.lut, didx.lut_bases,
            qlh, qll, qhh, qhl, core_len=dp.core_len,
            max_steps=didx.max_bsearch_steps,
        )
    )
    print(f"range_lookup:    {timeit(f_lookup, *q[:4])*1e3:8.1f} ms")

    f_cand = jax.jit(
        lambda r: _strand_candidates(arrays, r, dp, H, cap)
    )
    print(f"candidates(all): {timeit(f_cand, reads_d)*1e3:8.1f} ms")

    loci, vmask, novr, ovf = f_cand(reads_d)
    n_valid = int(np.asarray(vmask).sum(axis=1).mean())
    print(f"  mean valid candidates/read/strand: {n_valid} (cap {cap})")

    f_packr = jax.jit(lambda r, l: pack_reads(r, l))
    rcodes, rnlane = f_packr(reads_d, lengths_d)
    print(f"pack_reads:      {timeit(f_packr, reads_d, lengths_d)*1e3:8.1f} ms")

    f_ext = jax.jit(
        lambda lc, vm, rc, rn, ln: hamming_extend_packed(
            didx.packed, didx.entry_starts, lc, vm, rc, rn, ln
        )
    )
    print(f"extend_packed:   {timeit(f_ext, loci, vmask, rcodes, rnlane, lengths_d)*1e3:8.1f} ms")

    f_rc = jax.jit(lambda r, l: _rc_reads(r, l))
    print(f"rc_reads:        {timeit(f_rc, reads_d, lengths_d)*1e3:8.1f} ms")

    # full batch for reference
    from biokanga.align.pipeline import AlignEngine

    engine = AlignEngine(didx, params)
    engine.align_batch(reads, lengths)  # compile
    t0 = time.monotonic()
    engine.align_batch(reads, lengths)
    t = time.monotonic() - t0
    print(f"full batch:      {t*1e3:8.1f} ms  -> {B/t:,.0f} reads/s")


if __name__ == "__main__":
    main()
