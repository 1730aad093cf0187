"""Assembly at scale vs the reference binary (VERDICT r2 item 6).

Simulates PE 2x150 bp at ~30x over a multi-Mbp genome, assembles the
readset with BOTH assemblers on the SAME reads, and scores contig count,
N50, and misassemblies (error-free reads => every true contig must be an
exact substring of the genome, either strand).

  reference: refbuild/bin/biokanga assemb -a pe1.fa -A pe2.fa  (-T2)
  ours:      biokanga assemble() scaled device-batched path
             (assembly/scale_overlap.best_right_extensions)

Prints one JSON line with both rows.  Genome size configurable:
  python scripts/bench_assembly.py --mbp 5 --cov 30
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
REF_BIN = os.path.join(REPO, "refbuild", "bin", "biokanga")


def n50(lengths):
    if not lengths:
        return 0
    ls = sorted(lengths, reverse=True)
    half = sum(ls) / 2
    acc = 0
    for x in ls:
        acc += x
        if acc >= half:
            return x
    return ls[-1]


def misassemblies(contigs, genome, min_len=1000):
    """Error-free reads: every contig >= min_len must be an exact
    substring of the genome (either strand)."""
    from biokanga.seq.encode import revcomp

    gs = genome.tobytes()
    bad = 0
    checked = 0
    for c in contigs:
        if len(c) < min_len:
            continue
        checked += 1
        if c.tobytes() not in gs and revcomp(c).tobytes() not in gs:
            bad += 1
    return bad, checked


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=5.0)
    ap.add_argument("--cov", type=float, default=30.0)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--insert-min", type=int, default=250)
    ap.add_argument("--insert-max", type=int, default=500)
    ap.add_argument("--dir", default="/tmp/bench_assembly")
    ap.add_argument("--skip-ref", action="store_true")
    ap.add_argument("--skip-ours", action="store_true")
    a = ap.parse_args()
    os.makedirs(a.dir, exist_ok=True)

    from biokanga.seq.fasta import write_fasta
    from biokanga.sim.simreads import random_genome, simulate_reads

    gbp = int(a.mbp * 1e6)
    seqs = random_genome([("chr1", gbp)], seed=33)
    genome = seqs[0][1]
    n_pairs = int(gbp * a.cov / (2 * a.read_len))
    names, reads, truths = simulate_reads(
        seqs, n_pairs, read_len=a.read_len, sub_rate=0.0, seed=44,
        pe=True, insert_min=a.insert_min, insert_max=a.insert_max,
    )
    pe1 = os.path.join(a.dir, "pe1.fa")
    pe2 = os.path.join(a.dir, "pe2.fa")
    write_fasta(pe1, ((names[i], reads[i]) for i in range(0, 2 * n_pairs, 2)))
    write_fasta(pe2, ((names[i], reads[i]) for i in range(1, 2 * n_pairs, 2)))
    out = {"genome_bp": gbp, "coverage": a.cov, "n_pairs": n_pairs,
           "read_len": a.read_len}

    if not a.skip_ref:
        t0 = time.monotonic()
        r = subprocess.run(
            [REF_BIN, "assemb", "-a", "pe1.fa", "-A", "pe2.fa",
             "-o", "ref_contigs.fa", "-T2", "-F", "asm.log"],
            cwd=a.dir, capture_output=True, text=True, timeout=7200,
        )
        dt = time.monotonic() - t0
        if r.returncode != 0:
            out["ref"] = {"error": (r.stdout + r.stderr)[-500:]}
        else:
            from biokanga.seq.fasta import read_seqs

            # reference may emit .fasta.SE / paired variants; gather all
            produced = [f for f in os.listdir(a.dir)
                        if f.startswith("ref_contigs")]
            contigs = []
            for f in produced:
                contigs.extend(
                    rr.codes for rr in read_seqs(os.path.join(a.dir, f)))
            contigs = [c for c in contigs if len(c) >= 300]
            bad, checked = misassemblies(contigs, genome)
            out["ref"] = {
                "wall_s": round(dt, 1), "n_contigs": len(contigs),
                "n50": n50([len(c) for c in contigs]),
                "max_contig": max((len(c) for c in contigs), default=0),
                "total_bp": int(sum(len(c) for c in contigs)),
                "misassembled": bad, "checked": checked,
                "files": produced,
            }
        print(json.dumps({"ref_partial": out.get("ref")}), flush=True)

    if not a.skip_ours:
        from biokanga.assembly.assemble import assemble

        seq_list = [np.asarray(r, np.int8) for r in reads]
        t0 = time.monotonic()

        def prog(p, ov, merges, n):
            print(f"pass {p} ov={ov} merges={merges} n={n} "
                  f"t={time.monotonic()-t0:.0f}s", flush=True)

        contigs, st = assemble(seq_list, progress=prog)
        dt = time.monotonic() - t0
        contigs = [c for c in contigs if len(c) >= 300]
        bad, checked = misassemblies(contigs, genome)
        out["ours"] = {
            "wall_s": round(dt, 1), "n_contigs": len(contigs),
            "n50": n50([len(c) for c in contigs]),
            "max_contig": max((len(c) for c in contigs), default=0),
            "total_bp": int(sum(len(c) for c in contigs)),
            "misassembled": bad, "checked": checked,
            "passes": st.passes,
        }

    row = {"metric": "assembly_n50", "detail": out}
    # merge partial stage outputs into one evidence file: --skip-ours /
    # --skip-ref runs update the same BENCH_ASM.json
    # multi-size evidence file: one row per (genome size, coverage),
    # partial --skip-* runs merge into the same key
    path = os.path.join(REPO, "BENCH_ASM.json")
    data = {"metric": "assembly_n50", "rows": {}}
    if os.path.exists(path):
        old = json.load(open(path))
        if "rows" in old:
            data = old
        elif "detail" in old:  # round-4 single-row layout
            d = old["detail"]
            data["rows"][f"{d.get('genome_bp', 0) / 1e6:g}mbp_"
                         f"{d.get('coverage', 0):g}x_r4"] = d
    key = f"{a.mbp:g}mbp_{a.cov:g}x"
    prev = data["rows"].get(key, {})
    for k in ("ref", "ours"):
        if k in prev and k not in out:
            out[k] = prev[k]
    data["rows"][key] = out
    ours_n50 = [r["ours"]["n50"] for r in data["rows"].values()
                if "ours" in r and "n50" in r.get("ours", {})]
    data["value"] = max(ours_n50, default=0)
    data["unit"] = "bp"
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
