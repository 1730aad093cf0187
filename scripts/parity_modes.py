"""Hard-mode parity vs the rebuilt reference binary (VERDICT r2 item 2).

Measures agreement with `refbuild/bin/biokanga` on the alignment modes
beyond substitution-only SE/PE (those are at 100.000%, BASELINE.md):

  indel    — reference simreads with micro-InDels (-X/-x) -> align -a :
             CIGAR/pos agreement (LocateInDels parity,
             libbiokanga/SfxArrayV2.cpp:7348)
  splice   — synthetic spliced reads -> align -A : xMyNzM agreement
             (LocateSpliceJuncts, SfxArrayV2.cpp:7022)
  multihit — repeat-planted genome -> default mlmode slough : agreement on
             unique-mapped classification + loci (AssignMultiMatches,
             biokanga/Aligner.cpp:5109)
  snp      — simreads -N planted SNPs -> align SNP calling : called-locus
             row agreement (ProcessSNPs/OutputSNPs, Aligner.cpp:7609,6803)

Usage: python scripts/parity_modes.py [--outdir DIR] [--nreads 8192]
       [modes ...]   (default: all four)
Prints one summary JSON line; detail tables to stdout.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
REF_BIN = os.path.join(REPO, "refbuild", "bin", "biokanga")


def run(args, cwd, timeout=1200):
    r = subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"{args}:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    return r


def our_cli(argv):
    from biokanga.cli import main as cli_main

    rc = cli_main(argv)
    assert rc == 0, f"biokanga {argv} rc={rc}"


def write_genome(path, seqs):
    with open(path, "w") as f:
        for name, codes in seqs:
            f.write(f">{name}\n")
            s = "".join("ACGTN"[c] for c in codes)
            for i in range(0, len(s), 70):
                f.write(s[i : i + 70] + "\n")


def build_indexes(tmp, seqs):
    write_genome(os.path.join(tmp, "g.fa"), seqs)
    run([REF_BIN, "index", "-i", "g.fa", "-o", "g.sfx", "-r", "t",
         "-F", "idx.log"], tmp)
    our_cli(["index", "-i", os.path.join(tmp, "g.fa"), "-o",
             os.path.join(tmp, "g_ours.npz")])


def sam_agreement(ref_sam, our_sam):
    from sam_parity import compare, load_sam

    ref = load_sam(ref_sam)
    ours = load_sam(our_sam)
    cats = compare(ref, ours)
    n = sum(v for k, v in cats.items() if k != "extra_in_ours")
    agree = cats["exact_match"] + cats["both_unmapped"]
    return agree / max(n, 1), dict(cats), n


# ------------------------------------------------------------ modes ------

def mode_indel(tmp, nreads):
    d = os.path.join(tmp, "indel")
    os.makedirs(d, exist_ok=True)
    from biokanga.sim.simreads import random_genome

    seqs = random_genome([("chr1", 500_000)], seed=11)
    build_indexes(d, seqs)
    run([REF_BIN, "simreads", "-m0", "-M3", "-n", str(nreads), "-l", "100",
         "-X", "0.5", "-x", "5", "-i", "g.fa", "-o", "r.fa",
         "-F", "sim.log"], d)
    run([REF_BIN, "align", "-i", "r.fa", "-I", "g.sfx", "-o", "ref.sam",
         "-a", "5", "-M5", "-T2", "-F", "aln.log"], d)
    our_cli(["align", "-i", os.path.join(d, "r.fa"), "-I",
             os.path.join(d, "g_ours.npz"), "-o", os.path.join(d, "ours.sam"),
             "-a", "5"])
    pct, cats, n = sam_agreement(os.path.join(d, "ref.sam"),
                                 os.path.join(d, "ours.sam"))
    return {"mode": "indel", "agree_pct": round(100 * pct, 3), "n": n,
            "cats": cats}


def mode_splice(tmp, nreads):
    d = os.path.join(tmp, "splice")
    os.makedirs(d, exist_ok=True)
    from biokanga.sim.simreads import random_genome

    seqs = random_genome([("chr1", 500_000)], seed=13)
    build_indexes(d, seqs)
    codes = seqs[0][1]
    rng = np.random.default_rng(7)
    L = 100
    names, rows = [], []
    # reads share a pool of junctions (>= 2 reads each) — the reference
    # REMOVES orphan splice junctions unsupported by >= 2 reads
    # (RemoveOrphanSpliceJuncts, biokanga/Aligner.cpp), so per-read
    # unique junctions would be 100% culled on its side
    n_junc = max(1, nreads // 16)
    juncs = []
    for _ in range(n_junc):
        gap = int(rng.integers(100, 50_000))
        J = int(rng.integers(L + 1, len(codes) - (L + gap) - 1))
        juncs.append((J, gap))
    for i in range(nreads):
        J, gap = juncs[int(rng.integers(n_junc))]
        split = int(rng.integers(30, L - 30))        # >=30bp each exon
        a0 = J - split
        b0 = J + gap
        read = np.concatenate([codes[a0:J], codes[b0 : b0 + (L - split)]])
        names.append(
            f"lcl|splice|{i:08d}|chr1|{a0 + 1}|{b0 + (L - split)}|{L}"
            f"|+|{split}|{gap}"
        )
        rows.append(read.astype(np.int8))
    from biokanga.seq.fasta import write_fasta

    write_fasta(os.path.join(d, "rs.fa"), zip(names, rows))
    run([REF_BIN, "align", "-i", "rs.fa", "-I", "g.sfx", "-o", "ref.sam",
         "-A", "50000", "-M5", "-T2", "-F", "aln.log"], d)
    our_cli(["align", "-i", os.path.join(d, "rs.fa"), "-I",
             os.path.join(d, "g_ours.npz"), "-o", os.path.join(d, "ours.sam"),
             "-A", "50000"])
    pct, cats, n = sam_agreement(os.path.join(d, "ref.sam"),
                                 os.path.join(d, "ours.sam"))
    # truth recovery for BOTH (pos + N-gap CIGAR correct vs construction)
    def truth_score(sam):
        from sam_parity import load_sam

        m = load_sam(sam)
        ok = 0
        for key, (rn, pos, strand, cigar, mapped) in m.items():
            f = key.split("|")
            a0 = int(f[4]) - 1
            split, gap = int(f[8]), int(f[9])
            want = f"{split}M{gap}N{L - split}M"
            ok += int(mapped and pos == a0 + 1 and cigar == want)
        return ok / max(len(m), 1)

    return {"mode": "splice", "agree_pct": round(100 * pct, 3), "n": n,
            "ref_truth_pct": round(100 * truth_score(
                os.path.join(d, "ref.sam")), 3),
            "our_truth_pct": round(100 * truth_score(
                os.path.join(d, "ours.sam")), 3),
            "cats": cats}


def mode_multihit(tmp, nreads):
    d = os.path.join(tmp, "multihit")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, size=400_000, dtype=np.int8)
    # plant repeat families: 6 source segments of 2 kb, copied 1..6 times
    # with 0.5% divergence, tandem and dispersed
    g = [base]
    total = len(base)
    for fam in range(6):
        seg0 = int(rng.integers(0, 350_000))
        seg = base[seg0 : seg0 + 2000].copy()
        for copy in range(fam + 1):
            c = seg.copy()
            mut = rng.random(len(c)) < 0.005
            c[mut] = (c[mut] + rng.integers(1, 4, mut.sum())) % 4
            g.append(c.astype(np.int8))
            total += len(c)
    codes = np.concatenate(g)
    seqs = [("chr1", codes)]
    build_indexes(d, seqs)
    run([REF_BIN, "simreads", "-m0", "-M3", "-n", str(nreads), "-l", "100",
         "-z", "0.01", "-g3", "-i", "g.fa", "-o", "r.fa", "-F", "sim.log"],
        d)
    run([REF_BIN, "align", "-i", "r.fa", "-I", "g.sfx", "-o", "ref.sam",
         "-M5", "-R", "5", "-T2", "-F", "aln.log"], d)
    our_cli(["align", "-i", os.path.join(d, "r.fa"), "-I",
             os.path.join(d, "g_ours.npz"), "-o", os.path.join(d, "ours.sam"),
             "-R", "5"])
    pct, cats, n = sam_agreement(os.path.join(d, "ref.sam"),
                                 os.path.join(d, "ours.sam"))
    return {"mode": "multihit", "agree_pct": round(100 * pct, 3), "n": n,
            "cats": cats}


def mode_snp(tmp, nreads):
    d = os.path.join(tmp, "snp")
    os.makedirs(d, exist_ok=True)
    from biokanga.sim.simreads import random_genome

    seqs = random_genome([("chr1", 500_000)], seed=17)
    build_indexes(d, seqs)
    # plant SNPs with the reference simulator at 500/Mbp, 30x coverage
    run([REF_BIN, "simreads", "-m0", "-M3", "-n", str(max(nreads, 150_000)),
         "-l", "100", "-N", "500", "-u", "truth_snps.bed",
         "-i", "g.fa", "-o", "r.fa", "-F", "sim.log"], d)
    run([REF_BIN, "align", "-i", "r.fa", "-I", "g.sfx", "-o", "ref.sam",
         "-M5", "-T2", "-p", "5", "-S", "refsnp.csv", "-F", "aln.log"], d)
    our_cli(["align", "-i", os.path.join(d, "r.fa"), "-I",
             os.path.join(d, "g_ours.npz"), "-o", os.path.join(d, "ours.sam"),
             "-O", os.path.join(d, "oursnp.csv"), "-p", "5"])

    def load_snps(path):
        import csv

        out = {}
        with open(path) as f:
            rd = csv.reader(f)
            head = next(rd)
            ix = {c.strip('"'): i for i, c in enumerate(head)}
            for row in rd:
                if not row:
                    continue
                out[(row[ix["Chrom"]].strip('"'),
                     int(row[ix["StartLoci"]]))] = row[ix["RefBase"]].strip(
                         '"')
        return out

    ref = load_snps(os.path.join(d, "refsnp.csv"))
    ours = load_snps(os.path.join(d, "oursnp.csv"))
    both = set(ref) & set(ours)
    union = set(ref) | set(ours)
    jac = len(both) / max(len(union), 1)
    return {"mode": "snp", "ref_rows": len(ref), "our_rows": len(ours),
            "rows_in_both": len(both),
            "agree_pct": round(100 * jac, 3),
            "pct_of_ref_called": round(100 * len(both) / max(len(ref), 1),
                                       3)}


MODES = {"indel": mode_indel, "splice": mode_splice,
         "multihit": mode_multihit, "snp": mode_snp}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("modes", nargs="*", default=list(MODES))
    ap.add_argument("--outdir", default="/tmp/parity_modes")
    ap.add_argument("--nreads", type=int, default=8192)
    ap.add_argument("--cpu", action="store_true",
                    help="force the JAX CPU backend (agreement is "
                    "backend-independent; frees the chip for benches)")
    a = ap.parse_args()
    if a.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    os.makedirs(a.outdir, exist_ok=True)
    results = []
    for m in (a.modes or list(MODES)):
        print(f"== {m} ==", flush=True)
        r = MODES[m](a.outdir, a.nreads)
        print(json.dumps(r, indent=1), flush=True)
        results.append(r)
    print(json.dumps({"parity_modes": results}))


if __name__ == "__main__":
    main()
