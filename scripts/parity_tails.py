"""Score the parity DISAGREEMENT TAILS against simulation truth
(VERDICT r3 item 5): round 3's PARITY_r03.json scored agreement over the
reference's mapped universe, leaving three tails unexamined —

  indel mode: reads mapped ONLY by us (2,973 in r3),
  splice mode: CIGAR mismatches (226) and ref-only mapped reads (181).

This script reruns the indel and splice parity pipelines
(scripts/parity_modes.py inputs, identical flags) and classifies EVERY
read over the UNION universe (mapped by either aligner) against the
ground truth each read carries:

  indel reads:  simreads descriptor truth start
                (lcl|usimreads|N|chrom|start|end|len|strand|h|subs|indel,
                 biokanga/SimReads.cpp:3054-3056); a mapped read is
                 'right' if POS is within the planted indel size of the
                 truth start (an indel near the read head legitimately
                 shifts POS by up to its own length), else 'wrong'.
  splice reads: constructed junction truth (a0, split, gap) — 'right'
                needs POS == a0+1 AND CIGAR == {split}M{gap}N{rest}M.

Output: PARITY_r04.json with per-category counts + truth percentages
scored over the union, alongside the old reference-universe agreement.

Reference semantics matched: LocateInDels (SfxArrayV2.cpp:7348),
LocateSpliceJuncts (SfxArrayV2.cpp:7022).
"""
from __future__ import annotations

import json
import os
import re
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from parity_modes import build_indexes, our_cli, run  # noqa: E402
from sam_parity import load_sam  # noqa: E402

REF_BIN = os.path.join(REPO, "refbuild", "bin", "biokanga")


def classify_indel(tmp, nreads):
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
             os.path.join(d, "g_ours.npz"), "-o",
             os.path.join(d, "ours.sam"), "-a", "5"])
    ref = load_sam(os.path.join(d, "ref.sam"))
    ours = load_sam(os.path.join(d, "ours.sam"))

    def truth(key):
        f = key.split("|")
        # chrom, start(1-based), indel size (last field)
        return f[3], int(f[4]), abs(int(f[10]))

    cats = {
        "agree_exact": 0, "agree_pos_cigar_diff": 0,
        "ours_only_right": 0, "ours_only_shifted": 0, "ours_only_wrong": 0,
        "ref_only_right": 0, "ref_only_shifted": 0, "ref_only_wrong": 0,
        "both_pos_diff_ours_right": 0, "both_pos_diff_ref_right": 0,
        "both_pos_diff_neither": 0, "both_unmapped": 0,
    }
    union = 0
    for key in set(ref) | set(ours):
        chrom, start, isz = truth(key)
        slop = max(isz, 1)

        def judge(rec):
            if rec is None or not rec[4]:
                return None
            rn, pos = rec[0], rec[1]
            if rn != chrom:
                return "wrong"
            if pos == start:
                return "right"
            if abs(pos - start) <= slop:
                return "shifted"
            return "wrong"

        jr = judge(ref.get(key))
        jo = judge(ours.get(key))
        if jr is None and jo is None:
            cats["both_unmapped"] += 1
            continue
        union += 1
        if jr is not None and jo is not None:
            rr, ro = ref[key], ours[key]
            if (rr[0], rr[1], rr[2]) == (ro[0], ro[1], ro[2]):
                if rr[3] == ro[3]:
                    cats["agree_exact"] += 1
                else:
                    cats["agree_pos_cigar_diff"] += 1
            else:
                if jo == "right" and jr != "right":
                    cats["both_pos_diff_ours_right"] += 1
                elif jr == "right" and jo != "right":
                    cats["both_pos_diff_ref_right"] += 1
                else:
                    cats["both_pos_diff_neither"] += 1
        elif jo is not None:
            cats[f"ours_only_{jo}"] += 1
        else:
            cats[f"ref_only_{jr}"] += 1
    n_ours_only = sum(cats[f"ours_only_{k}"]
                      for k in ("right", "shifted", "wrong"))
    n_ref_only = sum(cats[f"ref_only_{k}"]
                     for k in ("right", "shifted", "wrong"))
    return {
        "mode": "indel", "n_union_mapped": union, "cats": cats,
        "ours_only_truth_pct": round(
            100 * (cats["ours_only_right"] + cats["ours_only_shifted"])
            / max(n_ours_only, 1), 2),
        "ref_only_truth_pct": round(
            100 * (cats["ref_only_right"] + cats["ref_only_shifted"])
            / max(n_ref_only, 1), 2),
        "union_agree_pct": round(
            100 * (cats["agree_exact"] + cats["agree_pos_cigar_diff"])
            / max(union, 1), 2),
    }


def classify_splice(tmp, nreads):
    d = os.path.join(tmp, "splice")
    os.makedirs(d, exist_ok=True)
    from biokanga.seq.fasta import write_fasta
    from biokanga.sim.simreads import random_genome

    seqs = random_genome([("chr1", 500_000)], seed=13)
    build_indexes(d, seqs)
    codes = seqs[0][1]
    rng = np.random.default_rng(7)
    L = 100
    n_junc = max(1, nreads // 16)
    juncs = []
    for _ in range(n_junc):
        gap = int(rng.integers(100, 50_000))
        J = int(rng.integers(L + 1, len(codes) - (L + gap) - 1))
        juncs.append((J, gap))
    names, rows = [], []
    for i in range(nreads):
        J, gap = juncs[int(rng.integers(n_junc))]
        split = int(rng.integers(30, L - 30))
        a0 = J - split
        b0 = J + gap
        read = np.concatenate([codes[a0:J], codes[b0: b0 + (L - split)]])
        names.append(f"lcl|splice|{i:08d}|chr1|{a0 + 1}"
                     f"|{b0 + (L - split)}|{L}|+|{split}|{gap}")
        rows.append(read.astype(np.int8))
    write_fasta(os.path.join(d, "rs.fa"), zip(names, rows))
    run([REF_BIN, "align", "-i", "rs.fa", "-I", "g.sfx", "-o", "ref.sam",
         "-A", "50000", "-M5", "-T2", "-F", "aln.log"], d)
    our_cli(["align", "-i", os.path.join(d, "rs.fa"), "-I",
             os.path.join(d, "g_ours.npz"), "-o",
             os.path.join(d, "ours.sam"), "-A", "50000"])
    ref = load_sam(os.path.join(d, "ref.sam"))
    ours = load_sam(os.path.join(d, "ours.sam"))

    def is_right(key, rec):
        if rec is None or not rec[4]:
            return False
        f = key.split("|")
        a0, split, gap = int(f[4]) - 1, int(f[8]), int(f[9])
        want = f"{split}M{gap}N{L - split}M"
        return rec[1] == a0 + 1 and rec[3] == want

    cats = {
        "agree_exact": 0, "cigar_diff_ours_right": 0,
        "cigar_diff_ref_right": 0, "cigar_diff_neither": 0,
        "cigar_diff_both_right_pos": 0,
        "ours_only_right": 0, "ours_only_wrong": 0,
        "ref_only_right": 0, "ref_only_wrong": 0,
        "pos_diff": 0, "both_unmapped": 0,
    }
    union = 0
    for key in set(ref) | set(ours):
        rr, ro = ref.get(key), ours.get(key)
        mr = rr is not None and rr[4]
        mo = ro is not None and ro[4]
        if not mr and not mo:
            cats["both_unmapped"] += 1
            continue
        union += 1
        if mr and mo:
            if (rr[0], rr[1], rr[2], rr[3]) == (ro[0], ro[1], ro[2], ro[3]):
                cats["agree_exact"] += 1
            elif (rr[0], rr[1]) == (ro[0], ro[1]):
                jr, jo = is_right(key, rr), is_right(key, ro)
                if jo and not jr:
                    cats["cigar_diff_ours_right"] += 1
                elif jr and not jo:
                    cats["cigar_diff_ref_right"] += 1
                elif jr and jo:
                    cats["cigar_diff_both_right_pos"] += 1
                else:
                    cats["cigar_diff_neither"] += 1
            else:
                cats["pos_diff"] += 1
        elif mo:
            cats["ours_only_right" if is_right(key, ro)
                 else "ours_only_wrong"] += 1
        else:
            cats["ref_only_right" if is_right(key, rr)
                 else "ref_only_wrong"] += 1
    n_oo = cats["ours_only_right"] + cats["ours_only_wrong"]
    n_ro = cats["ref_only_right"] + cats["ref_only_wrong"]
    return {
        "mode": "splice", "n_union_mapped": union, "cats": cats,
        "ours_only_truth_pct": round(
            100 * cats["ours_only_right"] / max(n_oo, 1), 2),
        "ref_only_truth_pct": round(
            100 * cats["ref_only_right"] / max(n_ro, 1), 2),
        "union_agree_pct": round(
            100 * cats["agree_exact"] / max(union, 1), 2),
    }


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--nreads", type=int, default=8192)
    a = ap.parse_args()
    out = {"metric": "parity_disagreement_tails", "nreads_per_mode":
           a.nreads, "modes": []}
    with tempfile.TemporaryDirectory() as tmp:
        out["modes"].append(classify_indel(tmp, a.nreads))
        out["modes"].append(classify_splice(tmp, a.nreads))
    with open(os.path.join(REPO, "PARITY_r04.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
