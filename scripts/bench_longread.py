"""Long-read envelope demo (VERDICT r2 item 8).

1) Reads of 100 Kbp and 256 Kbp (the reference cMaxReadLen,
   libbiokanga/commdefs.h:158-161) with substitution errors, aligned by
   the segment+stitch long-read path (align/longread.py) against a
   10 Mbp genome — verified against the planted locus, forward and rc.
2) Banded SW (ops/sw.py lax.scan wavefront) on a >=100 Kbp pair with
   5% combined sub/indel error — the reference SSW envelope is 256 Kbp
   (pacbiokanga/SSW.h).

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mbp", type=float, default=10.0)
    ap.add_argument("--sw-len", type=int, default=100_000)
    ap.add_argument("--batch-reads", type=int, default=64)
    a = ap.parse_args()

    from biokanga.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    import jax
    import jax.numpy as jnp

    from biokanga.align.longread import LongReadAligner
    from biokanga.align.params import AlignParams
    from biokanga.align.pipeline import AlignEngine
    from biokanga.index.build import build_index
    from biokanga.index.device import to_device
    from biokanga.seq.encode import revcomp
    from biokanga.sim.simreads import random_genome

    rng = np.random.default_rng(71)
    gbp = int(a.genome_mbp * 1e6)
    seqs = random_genome([("chr1", gbp)], seed=72)
    codes = seqs[0][1]
    idx = to_device(build_index(seqs))
    eng = AlignEngine(idx, AlignParams(batch_size=4096))
    lra = LongReadAligner(eng)

    out = {"genome_bp": gbp, "reads": []}
    for L, n_subs, as_rc in ((100_000, 40, False), (100_000, 40, True),
                             (262_144, 60, False)):
        st = int(rng.integers(0, gbp - L))
        r = codes[st : st + L].copy()
        pos = rng.choice(L, n_subs, replace=False)
        r[pos] = (r[pos] + rng.integers(1, 4, n_subs)) % 4
        if as_rc:
            r = revcomp(r)
        reads = r[None, :]
        lens = np.array([L], np.int32)
        t0 = time.monotonic()
        res = lra.align(reads, lens)
        dt = time.monotonic() - t0
        out["reads"].append({
            "read_len": L, "planted_subs": n_subs, "rc": as_rc,
            "unique": bool(res["unique"][0]),
            "locus_correct": bool(res["unique"][0]
                                  and int(res["locus"][0]) == st
                                  and bool(res["is_rc"][0]) == as_rc),
            "mm_found": int(res["best_mm"][0]),
            "seconds": round(dt, 2),
        })

    # ---- batched long-read throughput (VERDICT r3 weak-6 closure) ------
    NB, LB = a.batch_reads, 100_000
    mat = np.full((NB, LB), 4, np.int8)
    lens = np.full(NB, LB, np.int32)
    truth = []
    for i in range(NB):
        st = int(rng.integers(0, gbp - LB))
        r = codes[st: st + LB].copy()
        pos = rng.choice(LB, 40, replace=False)
        r[pos] = (r[pos] + rng.integers(1, 4, 40)) % 4
        rc = bool(rng.integers(0, 2))
        mat[i] = revcomp(r) if rc else r
        truth.append((st, rc))
    t0 = time.monotonic()
    res = lra.align(mat, lens)
    dt = time.monotonic() - t0
    n_ok = sum(int(res["unique"][i] and int(res["locus"][i]) == truth[i][0]
                   and bool(res["is_rc"][i]) == truth[i][1])
               for i in range(NB))
    out["batch_100kbp"] = {
        "n_reads": NB, "read_len": LB, "locus_correct": n_ok,
        "seconds": round(dt, 2),
        "reads_per_s": round(NB / dt, 2),
        "mbp_per_s": round(NB * LB / dt / 1e6, 1),
    }

    # ---- banded SW pair: lax.scan kernel (long-pair SW verification is
    # an open item; the EC SW kernel is ops/sw_moves.py) ---------------
    from biokanga.ops.sw import banded_sw_batch
    from biokanga.sim.clr import mutate_clr

    L, W = a.sw_len, 1024
    st = int(rng.integers(0, gbp - L - 8000))
    w = codes[st: st + L]
    q = mutate_clr(w, np.full(L, 0.05), rng)
    Lq = len(q)
    cells = Lq * (2 * W + 1)
    alen = np.array([Lq], np.int32)
    blen = np.array([L], np.int32)
    dg = np.zeros(1, np.int32)
    qa, ta = jnp.asarray(q[None, :]), jnp.asarray(w[None, :])
    t0 = time.monotonic()
    sb, si, sk, _ = banded_sw_batch(
        qa, ta, jnp.asarray(alen), jnp.asarray(blen),
        jnp.asarray(dg), W, Lq, L)
    s_scan = int(jax.device_get(sb)[0])
    dt_s = time.monotonic() - t0
    out["banded_sw"] = {"query_len": Lq, "target_len": L,
                        "band_half_width": W, "score": s_scan,
                        "seconds": round(dt_s, 2),
                        "gcups": round(cells / dt_s / 1e9, 3)}
    print(json.dumps({"metric": "longread_envelope", "detail": out}))
    with open(os.path.join(REPO, "LONGREAD_r04.json"), "w") as f:
        json.dump({"metric": "longread_envelope", "detail": out}, f,
                  indent=1)


if __name__ == "__main__":
    main()
