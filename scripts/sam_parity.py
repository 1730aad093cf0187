"""SAM parity scorer: compare two SAM files read-by-read.

Scores the fraction of reads whose accepted alignment matches between a
reference `biokanga align` run and a biokanga run on the same inputs
(BASELINE.md north-star "SAM equality %": chrom, loci, strand, CIGAR,
flags).  Reads are keyed by QNAME; secondary/supplementary lines ignored.

Usage: python3 scripts/sam_parity.py ref.sam ours.sam [--pos-slop 0]
"""
from __future__ import annotations

import argparse
import sys
from collections import Counter


def load_sam(path: str):
    """qname -> (rname, pos, strand, cigar, mapped, |tlen|)

    |TLEN| rides at index 5 so PE insert-size drift is scoreable;
    existing consumers index 0-4 and are unaffected."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                continue
            qname, flag, rname, pos, _, cigar = fields[:6]
            flag = int(flag)
            if flag & 0x900:  # secondary/supplementary
                continue
            key = qname
            if flag & 0x1:  # PE: key by mate
                key = qname + ("/1" if flag & 0x40 else "/2")
            mapped = not (flag & 0x4)
            strand = "-" if flag & 0x10 else "+"
            out[key] = (rname, int(pos), strand, cigar, mapped,
                        abs(int(fields[8])))
    return out


def compare(ref: dict, ours: dict, pos_slop: int = 0):
    cats = Counter()
    for key, r in ref.items():
        o = ours.get(key)
        if o is None:
            cats["missing_in_ours"] += 1
            continue
        if not r[4] and not o[4]:
            cats["both_unmapped"] += 1
            continue
        if r[4] != o[4]:
            cats["mapped_in_ref_only" if r[4] else "mapped_in_ours_only"] += 1
            continue
        if r[0] != o[0]:
            cats["chrom_mismatch"] += 1
        elif r[2] != o[2]:
            cats["strand_mismatch"] += 1
        elif abs(r[1] - o[1]) > pos_slop:
            cats["pos_mismatch"] += 1
        elif r[3] != o[3]:
            cats["cigar_mismatch"] += 1
        elif len(r) > 5 and len(o) > 5 and r[5] != o[5]:
            cats["tlen_mismatch"] += 1
        else:
            cats["exact_match"] += 1
    for key in ours:
        if key not in ref:
            cats["extra_in_ours"] += 1
    return cats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ref_sam")
    ap.add_argument("our_sam")
    ap.add_argument("--pos-slop", type=int, default=0)
    a = ap.parse_args()
    ref = load_sam(a.ref_sam)
    ours = load_sam(a.our_sam)
    cats = compare(ref, ours, a.pos_slop)
    n = sum(v for k, v in cats.items() if k != "extra_in_ours")
    agree = cats["exact_match"] + cats["both_unmapped"]
    for k, v in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"{k:22s} {v:10d}  ({100.0 * v / max(n, 1):.3f}%)")
    pct = 100.0 * agree / max(n, 1)
    print(f"\nSAM equality: {agree}/{n} = {pct:.3f}%")
    return 0 if pct > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
