"""Realistic-repeat genome row (VERDICT r3 item 7): a 100 Mbp genome
with LINE/SINE/LTR/satellite families + GC isochores
(sim/repeatgenome.py), 262,144 SE 100 bp reads simulated from it, run
through BOTH aligners:

  ours      — one device-built chunk on the chip; reads/s, unique_frac
              (< 1 on repeats), truth-correct of unique
  reference — refbuild/bin/biokanga index+align -M5 -T2 on the same
              fasta/reads; agreement scored over (chrom,pos,strand)

Stages (--stage gen|ours|ref|score) so the CPU reference run can
overlap chip work.  Writes BENCH_REPEAT.json at --stage score.
Reference machinery exercised: over-occurring seed suppression
(InitOverOccKMers, MaxIter SfxArrayV2.h:12).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
REF_BIN = os.path.join(REPO, "refbuild", "bin", "biokanga")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", required=True,
                    choices=["gen", "ours", "ref", "score"])
    ap.add_argument("--mbp", type=float, default=100.0)
    ap.add_argument("--reads", type=int, default=262_144)
    ap.add_argument("--dir", default="/tmp/bench_repeat")
    a = ap.parse_args()
    os.makedirs(a.dir, exist_ok=True)
    npy = os.path.join(a.dir, "g.npy")

    if a.stage == "gen":
        from biokanga.sim.repeatgenome import repeat_genome
        from biokanga.sim.simreads import simulate_reads

        t0 = time.monotonic()
        codes, stats = repeat_genome(int(a.mbp * 1e6), seed=97)
        np.save(npy, codes)
        # fasta for the reference binary
        with open(os.path.join(a.dir, "g.fa"), "w") as f:
            f.write(">chr1\n")
            s = codes.astype(np.uint8)
            lut = np.frombuffer(b"ACGTN", np.uint8)
            row = lut[s]
            for i in range(0, len(row), 1 << 20):
                blk = row[i: i + (1 << 20)].tobytes().decode()
                for j in range(0, len(blk), 70):
                    f.write(blk[j: j + 70] + "\n")
        names, reads, truths = simulate_reads(
            [("chr1", codes)], a.reads, read_len=100, sub_rate=0.01,
            seed=98)
        np.save(os.path.join(a.dir, "reads.npy"), reads)
        with open(os.path.join(a.dir, "r.fa"), "w") as f:
            lut = np.frombuffer(b"ACGTN", np.uint8)
            for nm, r in zip(names, reads):
                f.write(f">{nm}\n{lut[r.astype(np.uint8)].tobytes().decode()}\n")
        with open(os.path.join(a.dir, "gen.json"), "w") as f:
            json.dump({"stats": stats, "gen_s": round(
                time.monotonic() - t0, 1)}, f)
        print(json.dumps({"stage": "gen", "stats": stats}))
        return

    if a.stage == "ours":
        import jax

        from biokanga.align.params import AlignParams
        from biokanga.align.pipeline import AlignEngine, pad_rows
        from biokanga.index.device_build import device_build_index
        from biokanga.sim.simreads import SimReadTruth
        from biokanga.utils.jaxcache import enable_persistent_cache

        enable_persistent_cache()
        codes = np.load(npy)
        reads = np.load(os.path.join(a.dir, "reads.npy"))
        names = [line[1:].strip() for line in
                 open(os.path.join(a.dir, "r.fa")) if line[0] == ">"]
        n = len(codes)
        t0 = time.monotonic()
        didx = device_build_index(codes, np.array([0, n], np.int64),
                                  lut_bases=13)
        jax.block_until_ready(didx.pos_rows)
        t_build = time.monotonic() - t0
        B = 32768
        eng = AlignEngine(didx, AlignParams(batch_size=B))
        lens = np.full(len(reads), 100, np.int32)
        # compile every graph the run will use (fast pass + classic +
        # rescue ladder shapes) before the timed region
        eng.align_many([pad_rows(reads[:B], lens[:B])])
        eng.warm_ladder(100)
        blocks = [pad_rows(reads[i:i + B], lens[i:i + B])
                  for i in range(0, len(reads), B)]
        t0 = time.monotonic()
        n_unique = n_any = n_correct = 0
        loci = []
        rcs = []
        uqs = []
        for res in eng.align_many(blocks):
            n_unique += int(res["unique"].sum())
            n_any += int(res["any_hit"].sum())
            loci.append(res["locus"].copy())
            rcs.append(res["is_rc"].copy())
            uqs.append(res["unique"].copy())
        dt = time.monotonic() - t0
        loci = np.concatenate(loci)[: len(reads)]
        rcs = np.concatenate(rcs)[: len(reads)]
        uqs = np.concatenate(uqs)[: len(reads)]
        for i, nm in enumerate(names):
            t = SimReadTruth.parse(nm)
            if t is None or not uqs[i]:
                continue
            n_correct += int(int(loci[i]) == t.start - 1)
        out = {
            "reads_per_s": round(len(reads) / dt, 1),
            "align_s": round(dt, 2),
            "index_build_s": round(t_build, 2),
            "unique_frac": round(n_unique / len(reads), 4),
            "any_hit_frac": round(n_any / len(reads), 4),
            "truth_correct_of_unique": round(
                n_correct / max(n_unique, 1), 4),
        }
        with open(os.path.join(a.dir, "ours.json"), "w") as f:
            json.dump(out, f)
        print(json.dumps({"stage": "ours", **out}))
        return

    if a.stage == "ref":
        t0 = time.monotonic()
        r = subprocess.run(
            [REF_BIN, "index", "-i", "g.fa", "-o", "g.sfx", "-r", "t",
             "-T2", "-F", "idx.log"], cwd=a.dir, capture_output=True,
            text=True, timeout=7200)
        t_idx = time.monotonic() - t0
        assert r.returncode == 0, r.stdout + r.stderr
        t0 = time.monotonic()
        r = subprocess.run(
            [REF_BIN, "align", "-i", "r.fa", "-I", "g.sfx", "-o",
             "ref.sam", "-M5", "-T2", "-F", "aln.log"], cwd=a.dir,
            capture_output=True, text=True, timeout=7200)
        t_aln = time.monotonic() - t0
        assert r.returncode == 0, r.stdout + r.stderr
        out = {"index_s_T2": round(t_idx, 1),
               "align_s_T2": round(t_aln, 1)}
        with open(os.path.join(a.dir, "ref.json"), "w") as f:
            json.dump(out, f)
        print(json.dumps({"stage": "ref", **out}))
        return

    # score: reference SAM truth + agreement context
    from biokanga.sim.simreads import SimReadTruth

    ref_map = {}
    n_ref_mapped = 0
    for line in open(os.path.join(a.dir, "ref.sam")):
        if line[0] == "@":
            continue
        f = line.rstrip("\n").split("\t")
        flag = int(f[1])
        if flag & 0x900:
            continue
        mapped = not (flag & 0x4)
        n_ref_mapped += int(mapped)
        ref_map[f[0]] = (int(f[3]) if mapped else -1)
    n_ref_correct = 0
    for nm, pos in ref_map.items():
        t = SimReadTruth.parse(nm)
        if t is not None and pos == t.start:
            n_ref_correct += 1
    ours = json.load(open(os.path.join(a.dir, "ours.json")))
    ref = json.load(open(os.path.join(a.dir, "ref.json")))
    gen = json.load(open(os.path.join(a.dir, "gen.json")))
    n_reads = len(ref_map)
    ref_rate = n_reads / ref["align_s_T2"]
    out = {
        "metric": "repeat_genome_reads_per_sec_per_chip",
        "value": ours["reads_per_s"],
        "unit": "reads/s",
        "vs_baseline": round(ours["reads_per_s"] / ref_rate, 2),
        "detail": {
            "genome_mbp": a.mbp, "n_reads": n_reads,
            "repeat_stats": gen["stats"],
            "ours": ours,
            "reference_T2": {
                **ref,
                "reads_per_s": round(ref_rate, 1),
                "mapped_frac": round(n_ref_mapped / n_reads, 4),
                "truth_correct_of_mapped": round(
                    n_ref_correct / max(n_ref_mapped, 1), 4),
            },
        },
    }
    with open(os.path.join(REPO, "BENCH_REPEAT.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
