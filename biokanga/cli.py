"""CLI: name -> subcommand dispatch, mirroring the reference's subprocess
table (biokanga/biokanga.cpp:101-130 `SubProcesses[]`).

`@paramfile` response files are supported exactly like the reference's
argtable2 `arg_parsefromfile` (libbiokanga/Utility.cpp:793): any argument
starting with '@' is replaced by the whitespace/newline-separated tokens
of that file.

Usage:  python -m biokanga <subcommand> [args...]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from . import __version__
from .utils.diagnostics import StopWatch, open_diagnostics


def _expand_response_files(argv: list[str]) -> list[str]:
    out: list[str] = []
    for a in argv:
        if a.startswith("@") and len(a) > 1:
            with open(a[1:]) as f:
                out.extend(f.read().split())
        else:
            out.append(a)
    return out


# ---------------------------------------------------------------- index ----

def cmd_index(argv: list[str]) -> int:
    """`biokanga index` parity: genome FASTA -> on-disk index
    (reference front-end biokanga/kangax.cpp:59)."""
    p = argparse.ArgumentParser(prog="biokanga index")
    p.add_argument("-i", "--infasta", action="append", default=None,
                   help="input FASTA file(s), gzip ok (repeatable)")
    p.add_argument("-o", "--out", required=True, help="output index file (.npz)")
    p.add_argument("-r", "--ref", default="", help="reference species/tag")
    p.add_argument("-m", "--mode", type=int, default=0, choices=(0, 1, 2),
                   help="0 standard; 1 bisulfite methylation index "
                        "(kangax -m1 role); 2 synthetic pseudorandom "
                        "genome benchmark (kangax -m2 role)")
    p.add_argument("-C", "--colorspace", action="store_true",
                   help="SOLiD colorspace index (kangax -C role): genome "
                        "is dibase-color transformed before indexing")
    p.add_argument("-s", "--synthetic-mbp", type=int, default=100,
                   help="mode 2: synthetic genome size in Mbp")
    p.add_argument("--lut-bases", type=int, default=0,
                   help="prefix LUT width in bases (0 = auto: 10 for "
                        "genomes <= 20 Mbp — 4 MB cache-friendly table, "
                        "core lengths there are <= 10 — else 12)")
    p.add_argument("--chunks", type=int, default=0,
                   help="force this many genome-range chunks (multi-chip "
                        "'sp' degree); 0 = auto (chunked only past 2^31 "
                        "bases — the reference's 5-byte-element capacity, "
                        "Docs/biokanga.index.txt:27-32)")
    p.add_argument("--chunk-overlap", type=int, default=2048,
                   help="chunk slice overlap in bases; must cover the "
                        "longest alignment window (PE: >= pairmaxlen)")
    p.add_argument("-q", "--sumrslts", default=None,
                   help="log experiment/params/results to this SQLite DB")
    p.add_argument("-F", "--log", default=None)
    args = p.parse_args(argv)
    log = open_diagnostics(args.log)
    sw = StopWatch()
    from .index.build import build_index, build_index_from_fasta, save_index

    def auto_lut(total_bp: int) -> int:
        if args.lut_bases:
            return args.lut_bases
        return 10 if total_bp <= 20_000_000 else 12

    if args.mode == 2:
        from .sim.simreads import random_genome

        nbp = args.synthetic_mbp * 1_000_000
        seqs = random_genome([("synth", nbp)], seed=1)
        log.info("synthetic genome: %d Mbp (RAM-only benchmark mode)",
                 args.synthetic_mbp)
        idx = build_index(seqs, lut_bases=auto_lut(nbp))
    elif args.mode == 1:
        if not args.infasta:
            p.error("-i/--infasta required for -m1")
        from .index.build import build_bisulfite_indexes, save_bisulfite_index
        from .seq.fasta import read_seqs

        seqs = []
        for path in args.infasta:
            seqs.extend((r.name, r.codes) for r in read_seqs(path))
        ct, ga = build_bisulfite_indexes(
            seqs, lut_bases=auto_lut(sum(len(x) for _, x in seqs)))
        log.info("bisulfite-indexed %d entries, %d bp in %.1fs",
                 ct.num_entries, ct.total_len, sw.mark("build"))
        save_bisulfite_index(ct, ga, args.out)
        log.info("bisulfite index written to %s (%.1fs)", args.out,
                 sw.elapsed())
        return 0
    elif args.colorspace:
        from .index.build import build_colorspace_index
        from .seq.fasta import read_seqs

        if not args.infasta:
            p.error("-i/--infasta required for -C")
        seqs = []
        for path in args.infasta:
            seqs.extend((r.name, r.codes) for r in read_seqs(path))
        idx = build_colorspace_index(
            seqs, lut_bases=auto_lut(sum(len(x) for _, x in seqs)))
    else:
        if not args.infasta:
            p.error("-i/--infasta required unless -m2")
        from .seq.fasta import read_seqs

        seqs = []
        for path in args.infasta:
            seqs.extend((r.name, r.codes) for r in read_seqs(path))
        total = sum(len(s) for _, s in seqs)
        if args.chunks > 0 or total >= 2**31:
            from .index.chunked import build_chunked_index, save_chunked_index

            nchunks = args.chunks or -(-total // ((1 << 31) - 2**20))
            ci = build_chunked_index(
                seqs, num_chunks=nchunks, overlap=args.chunk_overlap,
                lut_bases=args.lut_bases or 12,
            )
            log.info(
                "chunk-indexed %d entries, %d bp total across %d chunks "
                "in %.1fs", len(ci.entry_names), ci.total_len,
                ci.num_chunks, sw.mark("build"),
            )
            save_chunked_index(ci, args.out)
            log.info("chunked index written to %s (%.1fs)", args.out,
                     sw.elapsed())
            return 0
        idx = build_index(seqs, lut_bases=auto_lut(total))
    log.info(
        "indexed %d entries, %d bp total in %.1fs",
        idx.num_entries, idx.total_len, sw.mark("build"),
    )
    save_index(idx, args.out)
    log.info("index written to %s (%.1fs)", args.out, sw.elapsed())
    if args.sumrslts:
        from .utils.sqlite_summaries import SQLiteSummaries

        db = SQLiteSummaries(args.sumrslts)
        db.log_run("index", {"infasta": args.infasta, "out": args.out,
                             "lut_bases": args.lut_bases},
                   {"entries": idx.num_entries, "total_bp": idx.total_len,
                    "seconds": round(sw.elapsed(), 2)})
        db.close()
    return 0


# ---------------------------------------------------------------- align ----

def cmd_align(argv: list[str]) -> int:
    """`biokanga align` parity: reads FASTA/FASTQ vs index -> SAM
    (reference front-end biokanga/kanga.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga align")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-u", "--pair", action="append", default=None,
                   help="PE 3' mate file(s); enables paired-end processing")
    p.add_argument("-d", "--pairminlen", type=int, default=100)
    p.add_argument("-D", "--pairmaxlen", type=int, default=1000)
    p.add_argument("-E", "--pairstrand", action="store_true",
                   help="accept mates on the same strand")
    p.add_argument("-I", "--sfx", required=True, help="index file from `index`")
    p.add_argument("-o", "--out", required=True, help="output SAM path")
    p.add_argument("-O", "--snpfile", default=None,
                   help="call SNPs and write reference-layout CSV here")
    p.add_argument("--snpvcf", default=None, help="also write SNPs as VCF")
    p.add_argument("--disnp", default=None,
                   help="write DiSNP haplotype CSV here (needs -O)")
    p.add_argument("--trisnp", default=None,
                   help="write TriSNP haplotype CSV here (needs -O)")
    p.add_argument("--snpcentroid", default=None,
                   help="write SNP centroid (7-mer context) distribution "
                        "CSV here (needs -O; Aligner.cpp:8003 role)")
    p.add_argument("-q", "--sumrslts", default=None,
                   help="log experiment/params/results to this SQLite DB")
    p.add_argument("-p", "--minsnpreads", type=int, default=5)
    p.add_argument("-P", "--qvalue", type=float, default=0.05)
    p.add_argument("--snpnonrefpcnt", type=float, default=25.0)
    p.add_argument("-s", "--substitutions", type=int, default=10,
                   help="max subs per 100bp (default 10)")
    p.add_argument("-e", "--editdelta", type=int, default=1, choices=(1, 2))
    p.add_argument("-m", "--mode", default="default",
                   choices=("ultra", "more", "default", "less"))
    p.add_argument("-Q", "--strand", default="both",
                   choices=("both", "sense", "antisense"))
    p.add_argument("-R", "--maxmulti", type=int, default=5)
    p.add_argument("-a", "--microindellen", type=int, default=0,
                   help="accept microInDels up to this length (0..20)")
    p.add_argument("-A", "--splicejunctlen", type=int, default=0,
                   help="RNA mode: accept splice junctions separated by up"
                        " to this distance (25..100000)")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("-F", "--log", default=None)
    p.add_argument("-x", "--trim5", type=int, default=0)
    p.add_argument("-y", "--trim3", type=int, default=0)
    p.add_argument("--min-accept-len", type=int, default=0)
    p.add_argument("-C", "--minchimericlen", type=int, default=0,
                   help="accept chimeric flank-trimmed alignments covering"
                        " at least this %% of the read (50..99; 0 off)")
    p.add_argument("--stats", default=None,
                   help="write alignment stats CSV here")
    p.add_argument("--no-mlassign", action="store_true",
                   help="disable multi-hit assignment clustering")
    p.add_argument("-k", "--pcrdedupe", type=int, default=0,
                   help="demote PCR duplicates at identical (locus,strand)"
                        " beyond this many copies (0 off)")
    p.add_argument("-Y", "--priorityregionbed", default=None,
                   help="only accept hits overlapping these BED regions")
    p.add_argument("--peinsertdist", default=None,
                   help="PE mode: write insert-size distribution CSV here")
    p.add_argument("--minflankexacts", type=int, default=0,
                   help="autotrim aligned flanks until at least this many "
                        "exactly matching flank bases (AutoTrimFlanks, "
                        "Aligner.cpp:1608; reference -x)")
    p.add_argument("--pcrprimersubs", type=int, default=0,
                   help="align with subs+this budget, then correct 5' PCR "
                        "primer artefacts over the first 12bp back to subs "
                        "(PCR5PrimerCorrect, Aligner.cpp:2000; ref -6)")
    p.add_argument("--lociconstraints", default=None,
                   help="loci base constraints CSV chrom,start,end,bases "
                        "(IdentifyConstraintViolations, Aligner.cpp:2599; "
                        "reference -5)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="chunked-genome runs: persist per-(chunk,block) "
                        "partials here and resume a killed run at the "
                        "first missing cell")
    args = p.parse_args(argv)
    log = open_diagnostics(args.log)
    sw = StopWatch()

    from .align.params import AlignParams, Sensitivity
    from .align.pipeline import AlignEngine, pad_rows
    from .align.sam import write_alignments_sam
    from .index.build import load_index
    from .index.device import to_device
    from .seq.fasta import read_blocks
    from .seq.rds import is_rds, read_rds_blocks, rds_info

    def _input_blocks(path, mate=None):
        """FASTA/FASTQ or packed .rds container (Aligner.cpp:8312 parity)."""
        if is_rds(path):
            return read_rds_blocks(path, block_size=args.batch_size,
                                   mate=mate)
        return read_blocks(path, block_size=args.batch_size)

    # .bam output: write SAM to a temp path, convert at the end — hoisted
    # above the bisulfite/chunked/colorspace branches so every align mode
    # honours it
    bam_out = None
    if args.out.endswith(".bam"):
        bam_out = args.out
        args.out = args.out + ".tmp.sam"

    def finish_bam() -> None:
        if bam_out:
            import os

            from .align.bam import sam_to_bam

            sam_to_bam(args.out, bam_out)
            os.remove(args.out)

    from .index.build import is_bisulfite_index

    if is_bisulfite_index(args.sfx):
        from .align.bisulfite import BisulfiteAligner
        from .index.build import load_bisulfite_index

        ict, iga = load_bisulfite_index(args.sfx)
        params_ct = AlignParams(
            max_subs_per100=args.substitutions,
            min_edit_dist=args.editdelta, max_multi=args.maxmulti,
            mode=Sensitivity(args.mode), strand="sense",
            batch_size=args.batch_size,
        )
        params_ga = dataclasses.replace(params_ct, strand="antisense")
        bs = BisulfiteAligner(
            AlignEngine(to_device(ict), params_ct),
            AlignEngine(to_device(iga), params_ga),
        )
        log.info("bisulfite index loaded: %d bp, %d entries (%.1fs)",
                 ict.total_len, ict.num_entries, sw.mark("load"))
        n_total = n_unique = 0
        with open(args.out, "w") as out:
            first = True
            for path in args.inreads:
                for blk in read_blocks(path, block_size=args.batch_size):
                    codes, lens = pad_rows(blk.codes, blk.lengths)
                    res = bs.align_batch(codes, lens)
                    write_alignments_sam(
                        out, ict.entry_names, ict.entry_starts,
                        blk.names, blk.codes, blk.lengths, res,
                        write_header=first,
                    )
                    first = False
                    n_total += len(blk.names)
                    n_unique += int(res["unique"].sum())
        log.info("bisulfite-aligned %d reads: %d unique (%.2f%%) in %.1fs",
                 n_total, n_unique, 100.0 * n_unique / max(n_total, 1),
                 sw.elapsed())
        finish_bam()
        return 0

    from .index.chunked import is_chunked_index

    if is_chunked_index(args.sfx):
        # genome-range chunked index (>2^31-base genomes): sequential
        # chunk sweeps with exact merge (parallel/chunked.py)
        from .align.pe import PEParams
        from .index.chunked import load_chunked_index
        from .parallel.chunked import ChunkedAligner, ChunkedPEAligner

        ci = load_chunked_index(args.sfx)
        log.info("chunked index loaded: %d bp, %d entries, %d chunks "
                 "(%.1fs)", ci.total_len, len(ci.entry_names),
                 ci.num_chunks, sw.mark("load"))
        params = AlignParams(
            max_subs_per100=args.substitutions,
            min_edit_dist=args.editdelta, max_multi=args.maxmulti,
            mode=Sensitivity(args.mode), strand=args.strand,
            batch_size=args.batch_size,
        )
        ca = ChunkedAligner(ci, params)
        n_total = n_unique = 0
        if args.pair:
            pea = ChunkedPEAligner(ca, PEParams(
                pair_min_len=args.pairminlen,
                pair_max_len=args.pairmaxlen,
                pair_same_strand=args.pairstrand,
            ))
            from .align.sam import write_pe_sam

            n_pairs = n_proper = 0
            with open(args.out, "w") as out:
                first = True
                for p1, p2 in zip(args.inreads, args.pair):
                    for blk1, blk2 in zip(
                        _input_blocks(p1), _input_blocks(p2)
                    ):
                        r1, l1 = pad_rows(blk1.codes, blk1.lengths)
                        r2, l2 = pad_rows(blk2.codes, blk2.lengths)
                        res = pea.align_pairs(r1, l1, r2, l2)
                        nb = len(blk1.names)
                        sub = lambda d: {
                            k: (v[:nb] if hasattr(v, "__len__") else v)
                            for k, v in d.items()
                        }
                        res_v = {
                            "res1": sub(res["res1"]),
                            "res2": sub(res["res2"]),
                            "proper": res["proper"][:nb],
                            "insert": res["insert"][:nb],
                        }
                        write_pe_sam(
                            out, ci.entry_names, ci.entry_starts,
                            blk1.names, blk1.codes, blk1.lengths,
                            blk2.names, blk2.codes, blk2.lengths,
                            res_v,
                            write_header=first,
                        )
                        first = False
                        n_pairs += nb
                        n_proper += int(res["proper"][:nb].sum())
            log.info("chunk-aligned %d pairs: %d proper (%.2f%%) in %.1fs",
                     n_pairs, n_proper,
                     100.0 * n_proper / max(n_pairs, 1), sw.elapsed())
            finish_bam()
            return 0
        # SE: chunk-major streaming over all blocks
        blocks, names_list = [], []
        for path in args.inreads:
            for blk in _input_blocks(path):
                codes, lens = pad_rows(blk.codes, blk.lengths)
                blocks.append((codes, lens))
                names_list.append((blk.names, blk.codes, blk.lengths))
        results = ca.align_blocks(blocks,
                                  checkpoint_dir=args.checkpoint_dir)
        if args.microindellen or args.splicejunctlen:
            from .parallel.chunked import ChunkedExtendedAligner

            cea = ChunkedExtendedAligner(ca, args.microindellen,
                                         args.splicejunctlen)
            n_resc = cea.fallthrough_blocks(blocks, results)
            log.info("chunked indel/splice fall-through rescued %d reads",
                     n_resc)
        from .align.sam import write_alignments_sam

        with open(args.out, "w") as out:
            first = True
            for (names, codes0, lens0), res in zip(names_list, results):
                write_alignments_sam(
                    out, ci.entry_names, ci.entry_starts,
                    names, codes0, lens0, res, write_header=first,
                )
                first = False
                n_total += len(names)
                n_unique += int(res["unique"][: len(names)].sum())
        if args.snpfile:
            # second chunk sweep: per-chunk tiled pileup + device-side
            # candidate compaction (align/snp.ChunkedPileup)
            from .align.snp import ChunkedPileup, SNPParams, write_snps_csv
            from .seq.encode import revcomp

            sp = SNPParams(
                min_snp_reads=args.minsnpreads,
                snp_nonref_pcnt=args.snpnonrefpcnt / 100.0,
                qvalue=args.qvalue,
            )
            cp = ChunkedPileup(
                ci.bases, [c.total_len for c in ci.chunks], ci.owned,
                ci.overlap,
            )
            for k in range(ci.num_chunks):
                eng = ca.engine_for(k)
                pad_n = int(eng.didx.genome.shape[0])
                cp.start_chunk(k, pad_n)
                esl = np.clip(ci.entry_starts - ci.bases[k], 0,
                              ci.chunks[k].total_len)
                for (codes, lens), res in zip(blocks, results):
                    chunk = np.clip(
                        np.searchsorted(ci.bases, res["locus"],
                                        side="right") - 1,
                        0, ci.num_chunks - 1,
                    )
                    acc = res["unique"] & (chunk == k)
                    if not acc.any():
                        continue
                    aligned = codes.copy()
                    for i in np.nonzero(res["is_rc"] & acc)[0]:
                        L0 = int(lens[i])
                        aligned[i, :L0] = revcomp(codes[i, :L0])
                    cp.add_batch(
                        eng.didx.genome,
                        (res["locus"] - ci.bases[k]).astype(np.int64),
                        aligned, lens, acc,
                    )
                cp.finish_chunk(eng.didx.genome, esl, sp)

            gstarts = ci.entry_starts

            def ref_base(e, loci):
                g = int(gstarts[e]) + int(loci)
                kk = int(np.clip(
                    np.searchsorted(ci.bases, g, side="right") - 1,
                    0, ci.num_chunks - 1,
                ))
                return int(ci.chunks[kk].codes[g - int(ci.bases[kk])])

            calls = cp.finalize_calls(ref_base, ci.entry_names,
                                      ci.entry_starts, sp)
            write_snps_csv(args.snpfile, calls)
            log.info("chunked SNP calling: %d accepted calls -> %s",
                     len(calls), args.snpfile)
        log.info("chunk-aligned %d reads: %d unique (%.2f%%) in %.1fs",
                 n_total, n_unique, 100.0 * n_unique / max(n_total, 1),
                 sw.elapsed())
        finish_bam()
        return 0

    idx = load_index(args.sfx)
    didx = to_device(idx)
    log.info("index loaded: %d bp, %d entries (%.1fs)",
             idx.total_len, idx.num_entries, sw.mark("load"))

    if idx.space == "color":
        # SOLiD colorspace index: color reads, two-pass sense engine
        # (kanga align colorspace mode; SfxArrayV2.cpp:300-380)
        from .align.colorspace import ColorspaceAligner
        from .seq.fasta import read_csfasta_blocks

        cs_params = AlignParams(
            max_subs_per100=args.substitutions,
            min_edit_dist=args.editdelta, max_multi=args.maxmulti,
            mode=Sensitivity(args.mode), strand="sense",
            batch_size=args.batch_size,
        )
        cs = ColorspaceAligner(AlignEngine(didx, cs_params))
        n_total = n_unique = 0
        with open(args.out, "w") as out:
            first = True
            for path in args.inreads:
                for blk in read_csfasta_blocks(path,
                                               block_size=args.batch_size):
                    codes, lens = pad_rows(blk.codes, blk.lengths)
                    res = cs.align_batch(codes, lens)
                    write_alignments_sam(
                        out, idx.entry_names, idx.entry_starts,
                        blk.names, blk.codes, blk.lengths, res,
                        write_header=first, space="color",
                    )
                    first = False
                    n_total += len(blk.names)
                    n_unique += int(res["unique"].sum())
        log.info("colorspace-aligned %d reads: %d unique (%.2f%%) in %.1fs",
                 n_total, n_unique, 100.0 * n_unique / max(n_total, 1),
                 sw.elapsed())
        finish_bam()
        return 0

    params = AlignParams(
        # PCR5PrimerCorrect mode aligns with a widened sub budget, then
        # corrects back to -s (reference -6 semantics, kanga.cpp:251)
        max_subs_per100=args.substitutions + args.pcrprimersubs,
        min_edit_dist=args.editdelta,
        max_multi=args.maxmulti,
        mode=Sensitivity(args.mode),
        strand=args.strand,
        batch_size=args.batch_size,
    )
    engine = AlignEngine(didx, params)
    constraints = None
    if args.lociconstraints:
        from .align.postpass import load_loci_constraints

        constraints = load_loci_constraints(args.lociconstraints)

    # PE-interleaved rds container with no -u: split mates internally
    pe_mates = None
    if (not args.pair and len(args.inreads) == 1
            and is_rds(args.inreads[0]) and rds_info(args.inreads[0]).is_pe):
        args.pair = list(args.inreads)
        pe_mates = (0, 1)

    if args.pair:
        from .align.pe import PEAligner, PEParams
        from .align.sam import write_pe_sam

        pe = PEAligner(
            engine,
            PEParams(
                pair_min_len=args.pairminlen,
                pair_max_len=args.pairmaxlen,
                pair_same_strand=args.pairstrand,
            ),
        )
        from .align.reports import AlignStats as _AS

        pe_stats = _AS()
        n_pairs = n_proper = 0
        with open(args.out, "w") as out:
            first = True

            def emit(pending, blk1, blk2):
                nonlocal first, n_pairs, n_proper
                res = pe.finish_pairs(pending)
                nb = len(blk1.names)
                sub = lambda d: {
                    k: (v[:nb] if hasattr(v, "__len__") else v)
                    for k, v in d.items()
                }
                res_v = {
                    "res1": sub(res["res1"]), "res2": sub(res["res2"]),
                    "proper": res["proper"][:nb],
                    "insert": res["insert"][:nb],
                }
                write_pe_sam(
                    out, idx.entry_names, idx.entry_starts,
                    blk1.names, blk1.codes, blk1.lengths,
                    blk2.names, blk2.codes, blk2.lengths,
                    res_v, write_header=first,
                )
                first = False
                n_pairs += nb
                n_proper += int(res["proper"][:nb].sum())
                if args.peinsertdist:
                    pe_stats.add_inserts(res["insert"][:nb],
                                         res["proper"][:nb])

            # double-buffered: next block's fused align runs on device
            # while this block pairs/rescues/writes on host
            inflight = None
            for p1, p2 in zip(args.inreads, args.pair):
                m1, m2 = pe_mates if pe_mates else (None, None)
                for blk1, blk2 in zip(
                    _input_blocks(p1, mate=m1),
                    _input_blocks(p2, mate=m2),
                ):
                    r1, l1 = pad_rows(blk1.codes, blk1.lengths)
                    r2, l2 = pad_rows(blk2.codes, blk2.lengths)
                    nxt = (pe.launch_pairs(r1, l1, r2, l2), blk1, blk2)
                    if inflight is not None:
                        emit(*inflight)
                    inflight = nxt
            if inflight is not None:
                emit(*inflight)
        if args.peinsertdist:
            pe_stats.write_csv(args.peinsertdist)
        log.info(
            "paired %d pairs: %d proper (%.2f%%) in %.1fs",
            n_pairs, n_proper, 100.0 * n_proper / max(n_pairs, 1), sw.elapsed(),
        )
        finish_bam()
        return 0

    pileup = None
    hap = None
    if args.snpfile:
        from .align.snp import HaplotypeTracker, PileupAccumulator

        pileup = PileupAccumulator(didx)
        if args.disnp or args.trisnp:
            hap = HaplotypeTracker()

    ext = None
    if args.microindellen or args.splicejunctlen:
        from .align.pipeline import ExtendedAligner

        ext = ExtendedAligner(engine, args.microindellen, args.splicejunctlen)

    from .align.multihit import assign_multihits, chimeric_pass
    from .align.reports import AlignStats

    prio = None
    if args.priorityregionbed:
        from .align.postpass import PriorityRegionFilter

        prio = PriorityRegionFilter(args.priorityregionbed,
                                    idx.entry_names, idx.entry_starts)
    stats = AlignStats()
    ckpt = None
    if args.checkpoint_dir:
        # per-block resumability for LONG single-index runs (the chunked
        # path already checkpoints per (chunk, block)); post-passes are
        # deterministic in (codes, lens, res) and replay on resume
        from .utils.checkpoint import SweepCheckpoint, config_signature

        ckpt = SweepCheckpoint(
            args.checkpoint_dir,
            config_signature(["se_single", args.sfx, params,
                              list(args.inreads), args.batch_size,
                              args.trim5, args.trim3]),
        )
    blk_i = 0
    mh_loci, mh_rows = [], []   # pending multi-hit reads for assignment
    uq_loci, uq_lens = [], []
    n_total = n_unique = n_multi = n_none = 0
    with open(args.out, "w") as out:
        first = True
        for path in args.inreads:
            for blk in _input_blocks(path):
                if args.trim5 or args.trim3:
                    blk.codes = blk.codes[:, args.trim5:]
                    if args.trim3:
                        blk.codes = blk.codes[:, : -args.trim3 or None]
                    blk.lengths = np.clip(
                        blk.lengths - args.trim5 - args.trim3, 0, None
                    )
                codes, lens = pad_rows(blk.codes, blk.lengths)
                if ckpt is not None and ckpt.has(0, blk_i):
                    res = ckpt.load(0, blk_i)
                elif ext is not None:
                    res = ext.align(codes, lens)
                else:
                    res = engine.align_with_rescue(codes, lens)
                if ckpt is not None and not ckpt.has(0, blk_i):
                    ckpt.save(0, blk_i, res)
                blk_i += 1
                if args.min_accept_len:
                    res["unique"] &= lens >= args.min_accept_len
                if args.minchimericlen:
                    res = chimeric_pass(engine, codes, lens, res,
                                        args.minchimericlen)
                    stats.chimeric += int(
                        (res.get("clip5", np.zeros(1)) > 0).sum()
                        + (res.get("clip3", np.zeros(1)) > 0).sum()
                    )
                if args.pcrdedupe:
                    from .align.postpass import reduce_pcr_duplicates

                    reduce_pcr_duplicates(res, lens, keep=args.pcrdedupe)
                if constraints:
                    from .align.postpass import (
                        identify_constraint_violations,
                    )

                    identify_constraint_violations(
                        codes, lens, res, idx.codes, idx.entry_names,
                        idx.entry_starts, constraints,
                    )
                if args.pcrprimersubs:
                    from .align.postpass import pcr5_primer_correct

                    pcr5_primer_correct(codes, lens, res, idx.codes,
                                        args.substitutions, klen=12)
                    n0 = len(blk.names)
                    blk.codes[:n0] = codes[:n0, : blk.codes.shape[1]]
                if args.minflankexacts:
                    from .align.postpass import auto_trim_flanks

                    auto_trim_flanks(codes, lens, res, idx.codes,
                                     args.minflankexacts)
                if args.splicejunctlen:
                    from .align.postpass import remove_orphan_splice_juncts

                    remove_orphan_splice_juncts(res, lens)
                if args.microindellen:
                    from .align.postpass import remove_orphan_microindels

                    remove_orphan_microindels(res, lens)
                if prio is not None:
                    prio.apply(res, lens)
                if pileup is not None:
                    pileup.add_alignments(codes, lens, res)
                    if hap is not None:
                        hap.add_alignments(codes, lens, res)
                n = len(blk.names)
                stats.add_batch(res, n)
                u_mask = res["unique"][:n]
                uq_loci.append(res["locus"][:n][u_mask])
                uq_lens.append(lens[:n][u_mask])
                if not args.no_mlassign:
                    m_mask = res["any_hit"][:n] & ~u_mask & (
                        res["inst"][:n] <= args.maxmulti
                    )
                    for ri in np.nonzero(m_mask)[0]:
                        mh_rows.append(
                            (blk.names[ri], blk.codes[ri, : blk.lengths[ri]],
                             int(lens[ri]), res["ml_mm"][ri].copy(),
                             res["ml_rc"][ri].copy())
                        )
                        # only the tied-best loci are assignment
                        # candidates (AssignMultiMatches operates on the
                        # accepted multimatch set, Aligner.cpp:5109);
                        # rows beyond them are junk-candidate artefacts
                        cand_row = res["ml_loci"][ri].astype(np.int64)
                        cand_row[res["ml_mm"][ri]
                                 != res["best_mm"][ri]] = -1
                        mh_loci.append(cand_row)
                write_alignments_sam(
                    out, idx.entry_names, idx.entry_starts,
                    blk.names, blk.codes, blk.lengths, res,
                    write_header=first,
                )
                first = False
                u = int(res["unique"].sum())
                h = int(res["any_hit"].sum())
                n_total += n
                n_unique += u
                n_multi += h - u
                n_none += n - h

        # multi-hit assignment clustering (AssignMultiMatches role)
        if mh_rows:
            from .align.sam import SamRecord
            from .seq.encode import codes_to_ascii, revcomp

            uql = np.concatenate(uq_loci) if uq_loci else np.zeros(0, int)
            uqn = np.concatenate(uq_lens) if uq_lens else np.zeros(0, int)
            cand = np.stack(mh_loci)
            assigned, okm = assign_multihits(
                uql, uqn, cand, idx.total_len
            )
            starts = idx.entry_starts
            lines = []
            for mi in np.nonzero(okm)[0]:
                name, rcodes, ln, mlmm, mlrc = mh_rows[mi]
                locus = int(assigned[mi])
                ent = int(np.searchsorted(starts, locus, "right")) - 1
                kk = int(np.argmin(np.abs(cand[mi] - locus)))
                rc = bool(mlrc[kk])
                seq = codes_to_ascii(
                    revcomp(rcodes) if rc else rcodes
                ).decode()
                lines.append(SamRecord(
                    qname=name, flag=16 if rc else 0,
                    rname=idx.entry_names[ent],
                    pos=locus - int(starts[ent]) + 1, mapq=3,
                    cigar=f"{len(rcodes)}M", seq=seq, qual="*",
                    tags=(f"NM:i:{int(mlmm[kk])}",),
                ).line())
            if lines:
                out.write("\n".join(lines) + "\n")
            stats.multi_assigned = int(okm.sum())
            n_unique += int(okm.sum())
            n_multi -= int(okm.sum())

    if args.stats:
        stats.write_csv(args.stats)
        log.info("stats written to %s", args.stats)
    log.info(
        "aligned %d reads: %d unique (%.2f%%), %d multi, %d unaligned in %.1fs"
        " (%.0f reads/s)",
        n_total, n_unique, 100.0 * n_unique / max(n_total, 1), n_multi, n_none,
        sw.elapsed(), n_total / max(sw.elapsed(), 1e-9),
    )

    if pileup is not None:
        from .align.snp import SNPParams, call_snps, write_snps_csv, write_snps_vcf

        counts, match, mismatch = pileup.finalize()
        calls = call_snps(
            counts, match, mismatch, idx.codes, idx.entry_names,
            idx.entry_starts,
            SNPParams(
                min_snp_reads=args.minsnpreads,
                snp_nonref_pcnt=args.snpnonrefpcnt / 100.0,
                qvalue=args.qvalue,
            ),
        )
        write_snps_csv(args.snpfile, calls)
        if hap is not None:
            from .align.snp import write_haplotypes_csv

            if args.disnp:
                write_haplotypes_csv(
                    args.disnp,
                    hap.haplotypes(calls, idx.entry_names, idx.entry_starts, 2),
                    order=2,
                )
            if args.trisnp:
                write_haplotypes_csv(
                    args.trisnp,
                    hap.haplotypes(calls, idx.entry_names, idx.entry_starts, 3),
                    order=3,
                )
        if args.snpvcf:
            write_snps_vcf(args.snpvcf, calls, idx.entry_names,
                           np.diff(idx.entry_starts))
        if args.snpcentroid:
            from .align.snp import snp_centroids, write_snp_centroids_csv

            write_snp_centroids_csv(
                args.snpcentroid,
                *snp_centroids(counts, idx.codes, calls, idx.entry_names,
                               idx.entry_starts,
                               min_reads=args.minsnpreads),
            )
        log.info("called %d SNPs -> %s", len(calls), args.snpfile)
    if bam_out:
        import os

        from .align.bam import sam_to_bam

        sam_to_bam(args.out, bam_out)
        os.remove(args.out)
    if args.sumrslts:
        from .utils.sqlite_summaries import SQLiteSummaries

        db = SQLiteSummaries(args.sumrslts)
        db.log_run("align", {"inreads": args.inreads, "sfx": args.sfx,
                             "substitutions": args.substitutions,
                             "editdelta": args.editdelta, "mode": args.mode},
                   {"total": n_total, "unique": n_unique, "multi": n_multi,
                    "unaligned": n_none,
                    "seconds": round(sw.elapsed(), 2)})
        db.close()
    return 0


# ------------------------------------------------------------- simreads ----

def cmd_simreads(argv: list[str]) -> int:
    """`biokanga simreads` parity (biokanga/SimReads.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga simreads")
    p.add_argument("-i", "--infasta", required=True)
    p.add_argument("-o", "--out", required=True, help="output FASTA/FASTQ")
    p.add_argument("-O", "--out2", default=None,
                   help="PE mate-2 output file (with --pe)")
    p.add_argument("-n", "--numreads", type=int, default=10000)
    p.add_argument("-l", "--readlen", type=int, default=100)
    p.add_argument("--sub-rate", type=float, default=0.0)
    p.add_argument("--pe", action="store_true")
    p.add_argument("--insert-min", type=int, default=200)
    p.add_argument("--insert-max", type=int, default=500)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("-H", "--hammings", default=None,
                   help=".hmg.npz from uhamming; read descriptors carry "
                        "the source window's min-Hamming")
    p.add_argument("-C", "--colorspace", action="store_true",
                   help="emit SOLiD colorspace reads (.csfasta, primer T)")
    p.add_argument("-N", "--snprate", type=int, default=0,
                   help="plant simulated SNPs at this rate per Mbp "
                        "(SimReads.cpp:2437 role)")
    p.add_argument("--outsnps", default=None,
                   help="write simulated-SNP truth BED here (with -N)")
    p.add_argument("-X", "--indelrate", type=float, default=0.0,
                   help="per-read InDel probability 0..1 (SimInDels role)")
    p.add_argument("-x", "--indelsize", type=int, default=3,
                   help="max InDel size 1..9")
    p.add_argument("-g", "--generrmode", default="none",
                   choices=("none", "fixed", "static", "dyn"),
                   help="induced sequencer-error mode (etSEMode)")
    p.add_argument("-z", "--seqerrrate", type=float, default=0.01,
                   help="dyn mode per-base error rate / fixed mode count")
    p.add_argument("-Z", "--unifomdist", action="store_true",
                   help="uniform error placement (default: Illumina "
                        "3'-weighted spatial profile when -g is set)")
    p.add_argument("-R", "--proprandreads", type=float, default=0.0,
                   help="proportion of completely random reads 0..0.9")
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs, write_fasta, write_fastq
    from .sim.simreads import plant_snps, simulate_reads

    seqs = [(r.name, r.codes) for r in read_seqs(args.infasta)]
    if args.snprate:
        seqs, _snps = plant_snps(seqs, args.snprate, seed=args.seed,
                                 bed_path=args.outsnps)
    hmg = None
    if args.hammings:
        from .tools.uhamming import load_hmg

        hmg, _, _, _ = load_hmg(args.hammings)
    names, codes, truths = simulate_reads(
        seqs, args.numreads, read_len=args.readlen,
        sub_rate=args.sub_rate, seed=args.seed, pe=args.pe,
        insert_min=args.insert_min, insert_max=args.insert_max,
        hammings=hmg,
        indel_rate=args.indelrate, indel_size=args.indelsize,
        error_mode=args.generrmode, error_rate=args.seqerrrate,
        error_uniform=args.unifomdist or args.generrmode == "none",
        prop_random=args.proprandreads,
    )

    def write(path, recs):
        if args.colorspace:
            from .seq.fasta import write_csfasta

            write_csfasta(path, recs)
        elif path.endswith((".fastq", ".fq", ".fastq.gz", ".fq.gz")):
            write_fastq(path, ((n, c, None) for n, c in recs))
        else:
            write_fasta(path, recs)

    if args.pe and args.out2:
        write(args.out, ((names[i], codes[i]) for i in range(0, len(names), 2)))
        write(args.out2, ((names[i], codes[i]) for i in range(1, len(names), 2)))
    else:
        write(args.out, zip(names, codes))
    return 0


# ------------------------------------------------------------ tools -------

def cmd_fasta2nxx(argv):
    """`biokanga fasta2nxx` parity (biokanga/FastaNxx.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga fasta2nxx")
    p.add_argument("-i", "--infasta", action="append", required=True)
    p.add_argument("-o", "--out", default=None, help="stats CSV (default stdout)")
    args = p.parse_args(argv)
    from .tools.fasta_tools import fasta_nxx

    st = fasta_nxx(args.infasta)
    rows = [
        ("NumSeqs", st.num_seqs), ("TotalBp", st.total_bp),
        ("MinLen", st.min_len), ("MaxLen", st.max_len),
        ("MeanLen", round(st.mean_len, 1)), ("GCPcnt", round(st.gc_pcnt, 2)),
    ] + [(f"N{p_}", v) for p_, v in st.nxx.items()]
    text = "\n".join(f"{k},{v}" for k, v in rows) + "\n"
    if args.out:
        open(args.out, "w").write(text)
    else:
        print(text, end="")
    return 0


def cmd_xfasta(argv):
    """`biokanga xfasta` parity (biokanga/fastaextract.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga xfasta")
    p.add_argument("-i", "--infasta", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-r", "--regex", default=None, help="name filter regex")
    p.add_argument("--min-len", type=int, default=0)
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    args = p.parse_args(argv)
    from .tools.fasta_tools import xfasta_extract

    n = xfasta_extract(args.infasta, args.out, args.regex, args.min_len,
                       args.max_len, args.start, args.end)
    print(f"extracted {n} sequences")
    return 0


def cmd_pseudogenome(argv):
    """`biokanga pseudogenome` parity (biokanga/genpseudogenome.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga pseudogenome")
    p.add_argument("-i", "--infasta", action="append", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-O", "--outbed", default=None)
    p.add_argument("-n", "--name", default="PseudoG")
    p.add_argument("--sep-ns", type=int, default=100)
    args = p.parse_args(argv)
    from .tools.fasta_tools import gen_pseudogenome

    n, total = gen_pseudogenome(args.infasta, args.out, args.outbed,
                                args.name, args.sep_ns)
    print(f"concatenated {n} sequences, {total} bp")
    return 0


def cmd_filter(argv):
    """`biokanga filter` parity (CArtefactReduce, biokanga/ArtefactReduce.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga filter")
    p.add_argument("-i", "--inreads", required=True)
    p.add_argument("-u", "--pair", default=None)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-U", "--outpair", default=None)
    p.add_argument("--trim5", type=int, default=0)
    p.add_argument("--trim3", type=int, default=0)
    p.add_argument("-n", "--maxns", type=int, default=1)
    p.add_argument("--min-phred", type=int, default=0)
    p.add_argument("--min-len", type=int, default=50)
    p.add_argument("--no-dedupe", action="store_true")
    p.add_argument("--near-dedupe", action="store_true",
                   help="also drop NEAR-duplicate reads (Hamming <= "
                        "--near-max-subs; ArtefactReduce sparse-index "
                        "near-dup role, Kangadna.h:100-107)")
    p.add_argument("--near-max-subs", type=int, default=2)
    p.add_argument("-c", "--contaminants", default=None,
                   help="adaptor/contaminant FASTA")
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs
    from .tools.filter_reads import FilterParams, filter_reads

    adapters = []
    contam_db = None
    if args.contaminants:
        # sequences using the reference naming convention ('@' flank /
        # '&' vector codes, Contaminants.cpp:195-203) load as a full
        # CContaminants DB; plain adaptor FASTAs keep the legacy
        # treat-as-3'-adaptor behavior
        heads = [l for l in open(args.contaminants)
                 if l.startswith(">")]
        if any(("@" in h) or ("&" in h) for h in heads):
            from .seq.contaminants import Contaminants

            contam_db = Contaminants.load(args.contaminants)
        else:
            adapters = [r.codes for r in read_seqs(args.contaminants)]
    st = filter_reads(
        args.inreads, args.out,
        FilterParams(
            trim5=args.trim5, trim3=args.trim3, max_ns=args.maxns,
            min_phred=args.min_phred, min_len=args.min_len,
            dedupe=not args.no_dedupe, adapters=adapters,
            contaminants=contam_db,
            near_dedupe=args.near_dedupe,
            near_max_subs=args.near_max_subs,
        ),
        pair_inpath=args.pair, pair_outpath=args.outpair,
    )
    print(
        f"filter: {st.accepted}/{st.total} accepted "
        f"(dups {st.rej_dup}, Ns {st.rej_ns}, phred {st.rej_phred}, "
        f"len {st.rej_len}, adapter-trimmed {st.trimmed_adapter})"
    )
    return 0


def cmd_ngsqc(argv):
    """`biokanga ngsqc` parity (CReadStats, biokanga/ReadStats.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga ngsqc")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True, help="HTML report path")
    p.add_argument("-k", "--kmer", type=int, default=5)
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("-c", "--contaminants", default=None,
                   help="contaminants multifasta ('@'/'&' overlay-code "
                        "naming convention, Contaminants.cpp:195-203)")
    args = p.parse_args(argv)
    from .tools.ngsqc import collect_qc, write_html_report

    cdb = None
    if args.contaminants:
        from .seq.contaminants import Contaminants

        cdb = Contaminants.load(args.contaminants)
    st = collect_qc(args.inreads, kmer_k=args.kmer,
                    max_reads=args.max_reads, contaminants=cdb)
    write_html_report(st, args.out)
    print(f"ngsqc: {st.n_reads} reads, {st.n_bases} bases -> {args.out}")
    return 0


def cmd_mergeoverlaps(argv):
    """`biokanga mergeoverlaps` parity (CMergeReadPairs)."""
    p = argparse.ArgumentParser(prog="biokanga mergeoverlaps")
    p.add_argument("-i", "--in1", required=True)
    p.add_argument("-u", "--in2", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--unmerged1", default=None)
    p.add_argument("--unmerged2", default=None)
    p.add_argument("-l", "--min-overlap", type=int, default=16)
    p.add_argument("-s", "--max-subs-pcnt", type=float, default=5.0)
    p.add_argument("-m", "--mode", type=int, default=0, choices=(0, 1, 2, 3),
                   help="0 combined, 1 separate, 2 amplicon with 5'/3' MID "
                        "barcode well demux + merging, 3 amplicon no-merge"
                        " (ePMAmplicon/ePMAmpliconNoMerge roles)")
    args = p.parse_args(argv)
    from .tools.mergeoverlaps import MergeParams, merge_overlaps

    if args.mode >= 2:
        from .tools.mergeoverlaps import merge_amplicons

        n, w, counts = merge_amplicons(
            args.in1, args.in2, args.out,
            MergeParams(args.min_overlap, args.max_subs_pcnt),
            no_merge=args.mode == 3,
        )
        print(f"amplicon demux: {w}/{n} pairs assigned to "
              f"{len(counts)} wells")
        return 0
    n, m = merge_overlaps(
        args.in1, args.in2, args.out,
        MergeParams(args.min_overlap, args.max_subs_pcnt),
        args.unmerged1, args.unmerged2,
    )
    print(f"merged {m}/{n} pairs")
    return 0


def cmd_ssr(argv):
    """`biokanga ssr` parity (CSSRDiscovery, biokanga/SSRdiscovery.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga ssr")
    p.add_argument("-i", "--infasta", action="append", required=True)
    p.add_argument("-o", "--out", required=True, help="CSV output")
    p.add_argument("-O", "--outbed", default=None)
    p.add_argument("--min-unit", type=int, default=1)
    p.add_argument("--max-unit", type=int, default=6)
    p.add_argument("-r", "--min-repeats", type=int, default=5)
    args = p.parse_args(argv)
    from .tools.ssr import discover_ssrs, write_ssrs_bed, write_ssrs_csv

    hits = discover_ssrs(args.infasta, args.min_unit, args.max_unit,
                         args.min_repeats)
    write_ssrs_csv(args.out, hits)
    if args.outbed:
        write_ssrs_bed(args.outbed, hits)
    print(f"found {len(hits)} SSRs")
    return 0


def cmd_filtchrom(argv):
    """`biokanga filtchrom` parity (CFilterSAMAlignments)."""
    p = argparse.ArgumentParser(prog="biokanga filtchrom")
    p.add_argument("-i", "--insam", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-z", "--chrom", required=True, help="chrom regex")
    p.add_argument("-Z", "--exclude", action="store_true")
    args = p.parse_args(argv)
    from .tools.sam_tools import filter_sam_by_chrom

    total, kept = filter_sam_by_chrom(args.insam, args.out, args.chrom,
                                      args.exclude)
    print(f"kept {kept}/{total} records")
    return 0


def cmd_remaploci(argv):
    """`biokanga remaploci` parity (CRemapLoci)."""
    p = argparse.ArgumentParser(prog="biokanga remaploci")
    p.add_argument("-i", "--insam", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-b", "--bed", required=True, help="parts BED")
    args = p.parse_args(argv)
    from .tools.sam_tools import remap_sam

    remapped, dropped = remap_sam(args.insam, args.out, args.bed)
    print(f"remapped {remapped}, dropped {dropped}")
    return 0


def cmd_blitz(argv):
    """`biokanga blitz` parity (CBlitz, biokanga/Blitz.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga blitz")
    p.add_argument("-i", "--inquery", required=True, help="query FASTA")
    p.add_argument("-I", "--sfx", required=True, help="index file")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-M", "--format", default="psl",
                   choices=("psl", "pslx", "bed", "maf"))
    p.add_argument("-C", "--corelen", type=int, default=20)
    p.add_argument("-c", "--coredelta", type=int, default=0)
    p.add_argument("-m", "--sensitivity", default="default",
                   choices=("default", "more", "ultra", "less"))
    p.add_argument("-s", "--minpathscore", type=int, default=75)
    p.add_argument("-a", "--minalignedpct", type=int, default=25)
    p.add_argument("-R", "--maxpaths", type=int, default=10)
    p.add_argument("-F", "--log", default=None)
    args = p.parse_args(argv)
    log = open_diagnostics(args.log)
    sw = StopWatch()
    from .index.build import load_index
    from .index.device import to_device
    from .seq.fasta import read_seqs
    from .tools.blitz import (
        PSL_HEADER, BlitzParams, bed_row, blitz_query, maf_block, psl_row,
    )

    idx = load_index(args.sfx)
    didx = to_device(idx)
    bp = BlitzParams(
        core_len=args.corelen, core_delta=args.coredelta,
        sensitivity=args.sensitivity, min_path_score=args.minpathscore,
        min_aligned_pct=args.minalignedpct, max_paths=args.maxpaths,
    )
    n_q = n_paths = 0
    with open(args.out, "w") as f:
        if args.format in ("psl", "pslx"):
            f.write(PSL_HEADER)
        for rec in read_seqs(args.inquery):
            paths = blitz_query(didx, rec.name, rec.codes, bp)
            n_q += 1
            n_paths += len(paths)
            for path in paths:
                if args.format == "psl":
                    f.write(psl_row(path) + "\n")
                elif args.format == "pslx":
                    from .tools.blitz import pslx_row

                    f.write(pslx_row(path, didx, rec.codes) + "\n")
                elif args.format == "bed":
                    f.write(bed_row(path) + "\n")
                else:
                    f.write(maf_block(path, didx, rec.codes))
    log.info("blitz: %d queries -> %d paths in %.1fs", n_q, n_paths,
             sw.elapsed())
    return 0


def cmd_uhamming(argv):
    """`uhamming` tool parity (uhamming/uhamming.cpp): genome min-Hamming
    sweep with node partitioning (-n/-N, mode 2) and merge (mode 3)."""
    p = argparse.ArgumentParser(prog="biokanga uhamming")
    p.add_argument("-m", "--mode", type=int, default=0,
                   choices=(0, 2, 3), help="0 full, 2 node partial, 3 merge")
    p.add_argument("-i", "--infasta", default=None)
    p.add_argument("-I", "--inhmg", action="append", default=None,
                   help="mode 3: partial .hmg.npz files to merge")
    p.add_argument("-o", "--out", required=True, help=".hmg.npz output")
    p.add_argument("-O", "--outcsv", default=None)
    p.add_argument("-K", "--seqlen", type=int, default=100)
    p.add_argument("-n", "--numnodes", type=int, default=1)
    p.add_argument("-N", "--node", type=int, default=1)
    p.add_argument("--no-rc", action="store_true")
    args = p.parse_args(argv)
    from .tools.uhamming import (
        hamming_sweep, load_hmg, merge_partials, save_hmg, window_validity,
        write_hamming_csv,
    )

    if args.mode == 3:
        parts = []
        names = starts = K = None
        for f in args.inhmg or []:
            h, names, starts, K = load_hmg(f)
            parts.append(h)
        merged = merge_partials(parts)
        save_hmg(args.out, merged, names, starts, K)
        if args.outcsv:
            write_hamming_csv(args.outcsv, merged, names, starts)
        print(f"merged {len(parts)} partials")
        return 0

    import numpy as np

    from .seq.fasta import read_seqs

    seqs = [(r.name, r.codes) for r in read_seqs(args.infasta)]
    starts = np.zeros(len(seqs) + 1, dtype=np.int64)
    for i, (_, s) in enumerate(seqs):
        starts[i + 1] = starts[i] + len(s)
    codes = np.concatenate([s for _, s in seqs])
    n = len(codes)
    top = n - args.seqlen + 1
    if args.mode == 2:
        lo = 1 + (top - 1) * (args.node - 1) // args.numnodes
        hi = 1 + (top - 1) * args.node // args.numnodes
    else:
        lo, hi = 1, top
    h = hamming_sweep(codes, starts, K=args.seqlen, shift_lo=lo, shift_hi=hi,
                      include_rc=(not args.no_rc) and args.mode == 0)
    save_hmg(args.out, h, [x for x, _ in seqs], starts, args.seqlen)
    if args.outcsv:
        write_hamming_csv(args.outcsv, h, [x for x, _ in seqs], starts)
    print(f"uhamming: {n} loci, shifts [{lo},{hi})")
    return 0


def cmd_kmarkers(argv, fasta_out=False):
    """`biokanga kmarkers` / `prekmarkers` parity (CMarkerKMers/CLocKMers)."""
    prog = "prekmarkers" if fasta_out else "kmarkers"
    p = argparse.ArgumentParser(prog=f"biokanga {prog}")
    p.add_argument("-I", "--sfx", required=True,
                   help="index over the multi-cultivar concatenation")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-k", "--kmerlen", type=int, default=50)
    p.add_argument("-c", "--cultivar", action="append", default=None,
                   help="entryname=cultivar mapping (repeatable); default: "
                        "each entry is its own cultivar")
    p.add_argument("--min-count", type=int, default=1)
    p.add_argument("--max-other", type=int, default=0)
    args = p.parse_args(argv)
    from .index.build import load_index
    from .tools.markers import kmer_markers, write_kmer_markers

    idx = load_index(args.sfx)
    mapping = {}
    for spec in args.cultivar or []:
        k, v = spec.split("=", 1)
        mapping[k] = v
    e2c = [mapping.get(n, n) for n in idx.entry_names]
    ms = kmer_markers(idx, e2c, K=args.kmerlen, min_count=args.min_count,
                      max_other_count=args.max_other)
    write_kmer_markers(args.out, ms, fasta=fasta_out)
    print(f"{len(ms)} K-mer markers")
    return 0


def cmd_snpmarkers(argv):
    """`biokanga snpmarkers` parity (CMarkers, biokanga/Markers.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga snpmarkers")
    p.add_argument("-i", "--snpcsv", action="append", required=True,
                   help="cultivar=snps.csv (repeatable)")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--min-cov", type=int, default=5)
    args = p.parse_args(argv)
    from .tools.markers import snp_markers, write_snp_markers

    csvs = {}
    for spec in args.snpcsv:
        c, path = spec.split("=", 1)
        csvs[c] = path
    ms = snp_markers(csvs, min_cov=args.min_cov)
    write_snp_markers(args.out, ms, sorted(csvs))
    print(f"{len(ms)} SNP markers")
    return 0


def cmd_markerseqs(argv):
    """`biokanga markerseqs` parity (CMarkerSeq)."""
    p = argparse.ArgumentParser(prog="biokanga markerseqs")
    p.add_argument("-I", "--sfx", required=True)
    p.add_argument("-i", "--snpcsv", action="append", required=True,
                   help="cultivar=snps.csv")
    p.add_argument("-o", "--out", required=True, help="marker FASTA")
    p.add_argument("--flank5", type=int, default=100)
    p.add_argument("--flank3", type=int, default=100)
    args = p.parse_args(argv)
    from .index.build import load_index
    from .seq.fasta import write_fasta
    from .tools.markers import marker_seqs, snp_markers

    idx = load_index(args.sfx)
    csvs = dict(s.split("=", 1) for s in args.snpcsv)
    ms = snp_markers(csvs, min_cov=1)
    seqs = marker_seqs(idx, ms, args.flank5, args.flank3)
    write_fasta(args.out, seqs)
    print(f"{len(seqs)} marker sequences")
    return 0


def cmd_maploci(argv):
    """`biokanga maploci` parity (CMapLoci2Feat)."""
    p = argparse.ArgumentParser(prog="biokanga maploci")
    p.add_argument("-i", "--insam", required=True)
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--strand", action="store_true",
                   help="require matching strand")
    args = p.parse_args(argv)
    from .seq.annotations import read_bed
    from .tools.expression import (
        map_loci_to_features, read_sam_loci, write_maploci_csv,
    )

    feats = read_bed(args.bed)
    counts, unm = map_loci_to_features(read_sam_loci(args.insam), feats,
                                       args.strand)
    write_maploci_csv(args.out, feats, counts, unm)
    print(f"mapped onto {len(feats)} features ({unm} unmatched)")
    return 0


def cmd_gendeseq(argv):
    """`biokanga gendeseq` parity (genDESeq.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga gendeseq")
    p.add_argument("-c", "--control", action="append", required=True)
    p.add_argument("-e", "--experiment", action="append", required=True)
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("-o", "--out", required=True)
    args = p.parse_args(argv)
    from .seq.annotations import read_bed
    from .tools.expression import gen_deseq_table

    feats = read_bed(args.bed)
    gen_deseq_table(feats, args.control, args.experiment, args.out)
    print(f"count table: {len(feats)} features x "
          f"{len(args.control) + len(args.experiment)} samples")
    return 0


def cmd_rnade(argv):
    """`biokanga rnade` parity (kangade.cpp DE characterisation)."""
    p = argparse.ArgumentParser(prog="biokanga rnade")
    p.add_argument("-c", "--control", required=True)
    p.add_argument("-e", "--experiment", required=True)
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--bins", type=int, default=10)
    p.add_argument("--min-cnts", type=int, default=10)
    p.add_argument("--confidence-iters", type=int, default=1000,
                   help="Poisson-noise bootstrap iterations for CIs + "
                        "p-values (kangade cMaxConfidenceIterations role;"
                        " 0 disables)")
    p.add_argument("-r", "--region", default="feature",
                   choices=("feature", "exons", "introns", "cds", "utr",
                            "utr5", "utr3"),
                   help="functional region to count (kangade -r 0..6)")
    args = p.parse_args(argv)
    from .seq.annotations import read_bed
    from .tools.expression import rnade, write_rnade_csv

    res = rnade(read_bed(args.bed), args.control, args.experiment,
                num_bins=args.bins, min_feat_cnts=args.min_cnts,
                confidence_iters=args.confidence_iters,
                region=args.region)
    write_rnade_csv(args.out, res)
    print(f"rnade: {len(res)} features characterised")
    return 0


def cmd_locateroi(argv):
    """`biokanga locateroi` parity (CLocateROI)."""
    p = argparse.ArgumentParser(prog="biokanga locateroi")
    p.add_argument("-i", "--insam", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--min-cov", type=int, default=2)
    p.add_argument("--min-len", type=int, default=100)
    args = p.parse_args(argv)
    import re as _re

    from .tools.expression import locate_roi, write_roi_csv

    chrom_lens = {}
    with open(args.insam) as f:
        for line in f:
            if not line.startswith("@"):
                break
            if line.startswith("@SQ"):
                name = _re.search(r"SN:(\S+)", line)
                ln = _re.search(r"LN:(\d+)", line)
                if name and ln:
                    chrom_lens[name.group(1)] = int(ln.group(1))
    rois = locate_roi(args.insam, chrom_lens, args.min_cov, args.min_len)
    write_roi_csv(args.out, rois)
    print(f"{len(rois)} regions of interest")
    return 0


def cmd_snps2sqlite(argv):
    """`biokanga snps2sqlite` parity (csv2sqlite SNP schema loader)."""
    p = argparse.ArgumentParser(prog="biokanga snps2sqlite")
    p.add_argument("-i", "--incsv", required=True)
    p.add_argument("-o", "--db", required=True)
    p.add_argument("-n", "--name", default="experiment")
    p.add_argument("-c", "--cultivar", default="cultivar")
    args = p.parse_args(argv)
    from .utils.sqlite_summaries import snps_to_sqlite

    n = snps_to_sqlite(args.db, args.incsv, args.name, args.cultivar)
    print(f"loaded {n} SNPs into {args.db}")
    return 0


def cmd_psl2sqlite(argv):
    """`biokanga psl2sqlite` parity (CSQLitePSL loader)."""
    p = argparse.ArgumentParser(prog="biokanga psl2sqlite")
    p.add_argument("-i", "--inpsl", required=True)
    p.add_argument("-o", "--db", required=True)
    p.add_argument("-n", "--name", default="experiment")
    args = p.parse_args(argv)
    from .utils.sqlite_summaries import psl_to_sqlite

    n = psl_to_sqlite(args.db, args.inpsl, args.name)
    print(f"loaded {n} alignments into {args.db}")
    return 0


def cmd_de2sqlite(argv):
    """`biokanga de2sqlite` parity (CSQLiteDE loader)."""
    p = argparse.ArgumentParser(prog="biokanga de2sqlite")
    p.add_argument("-i", "--incsv", required=True)
    p.add_argument("-o", "--db", required=True)
    p.add_argument("-n", "--name", default="experiment")
    args = p.parse_args(argv)
    from .utils.sqlite_summaries import de_to_sqlite

    n = de_to_sqlite(args.db, args.incsv, args.name)
    print(f"loaded {n} DE rows into {args.db}")
    return 0


def cmd_assemb(argv):
    """`biokanga assemb` parity (CdeNovoAssemb, deNovoAssemb.cpp:109)."""
    p = argparse.ArgumentParser(prog="biokanga assemb")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True, help="contig FASTA")
    p.add_argument("--init-overlap", type=int, default=150)
    p.add_argument("--final-overlap", type=int, default=25)
    p.add_argument("--min-seq-len", type=int, default=80)
    p.add_argument("--max-subs-100", type=float, default=1.0)
    p.add_argument("-F", "--log", default=None)
    args = p.parse_args(argv)
    log = open_diagnostics(args.log)
    sw = StopWatch()
    from .assembly.assemble import assemble
    from .seq.fasta import read_seqs, write_fasta

    seqs = []
    for path in args.inreads:
        seqs.extend(r.codes for r in read_seqs(path))
    contigs, st = assemble(
        seqs, init_overlap=args.init_overlap,
        final_overlap=args.final_overlap, min_seq_len=args.min_seq_len,
        max_subs_per_100=args.max_subs_100,
    )
    contigs.sort(key=len, reverse=True)
    write_fasta(args.out, ((f"contig{i+1}", c)
                           for i, c in enumerate(contigs)))
    log.info(
        "assembled %d seqs -> %d contigs (%d bp, max %d) in %d passes,"
        " %.1fs", len(seqs), st.n_contigs, st.total_bp, st.max_contig,
        st.passes, sw.elapsed(),
    )
    return 0


def cmd_scaffold(argv):
    """`biokanga scaffold` parity (CScaffolder, Scaffolder.cpp:772)."""
    p = argparse.ArgumentParser(prog="biokanga scaffold")
    p.add_argument("-c", "--contigs", required=True)
    p.add_argument("-i", "--pe1", required=True)
    p.add_argument("-u", "--pe2", required=True)
    p.add_argument("-o", "--out", required=True, help="scaffold FASTA")
    p.add_argument("--insert-size", type=int, default=400)
    p.add_argument("--min-votes", type=int, default=2)
    p.add_argument("-F", "--log", default=None)
    args = p.parse_args(argv)
    log = open_diagnostics(args.log)
    from .assembly.scaffold import scaffold
    from .seq.fasta import read_blocks, read_seqs, write_fasta

    contigs = [r.codes for r in read_seqs(args.contigs)]
    b1 = next(read_blocks(args.pe1, block_size=1 << 30))
    b2 = next(read_blocks(args.pe2, block_size=1 << 30))
    scaffolds, paths = scaffold(
        contigs, b1.codes, b1.lengths, b2.codes, b2.lengths,
        insert_size=args.insert_size, min_votes=args.min_votes,
    )
    write_fasta(args.out, ((f"scaffold{i+1}", s)
                           for i, s in enumerate(scaffolds)))
    n_joined = sum(1 for p_ in paths if len(p_) > 1)
    log.info("%d contigs -> %d scaffolds (%d joined paths)",
             len(contigs), len(scaffolds), n_joined)
    return 0


# ------------------------------------------------- pacbiokanga family -----

def cmd_ecreads(argv):
    """`pacbiokanga ecreads` parity (CPBErrCorrect, PBErrCorrect.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga ecreads")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True, help="corrected FASTA")
    p.add_argument("--seed-len", type=int, default=12)
    p.add_argument("--min-seed-votes", type=int, default=8)
    p.add_argument("--sw-band", type=int, default=96)
    p.add_argument("--min-score", type=int, default=60)
    p.add_argument("--max-targets", type=int, default=48,
                   help="overlap candidates per probe")
    p.add_argument("--rounds", type=int, default=2,
                   help="iterated-consensus rounds (round 2 corrects "
                        "round 1's output; 0.956 -> 0.998 32-mer "
                        "recovery on the CLR head-to-head)")
    p.add_argument("--target-chunk", type=int, default=0,
                   help="index at most this many target reads at a time "
                        "(bounds HBM residency; 0 = all)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="resumable per-group correction checkpoints")
    p.add_argument("-F", "--log", default=None)
    args = p.parse_args(argv)
    log = open_diagnostics(args.log)
    sw = StopWatch()
    from .pacbio.ecreads import ECParams, ec_reads, ec_reads_checkpointed
    from .seq.fasta import read_seqs, write_fasta

    names, reads = [], []
    for path in args.inreads:
        for r in read_seqs(path):
            names.append(r.name)
            reads.append(r.codes)
    ecp = ECParams(seed_len=args.seed_len,
                   min_seed_votes=args.min_seed_votes,
                   sw_band=args.sw_band, min_overlap_score=args.min_score,
                   max_targets=args.max_targets)
    if args.checkpoint_dir:
        corrected, stats = ec_reads_checkpointed(
            reads, ecp, checkpoint_dir=args.checkpoint_dir)
    else:
        corrected, stats = ec_reads(
            reads, ecp, target_chunk=args.target_chunk or None,
            rounds=max(1, args.rounds))
    write_fasta(args.out, zip(names, corrected))
    log.info("ecreads: %d reads, %d overlaps used, %.1fs",
             stats["reads"], stats["overlaps_used"], sw.elapsed())
    return 0


def cmd_pbcontigs(argv):
    """`pacbiokanga contigs` parity (CPBAssemb): assemble error-corrected
    long reads with a relaxed-identity overlap schedule."""
    p = argparse.ArgumentParser(prog="biokanga contigs")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--min-overlap", type=int, default=500)
    p.add_argument("--final-overlap", type=int, default=100)
    p.add_argument("--max-subs-100", type=float, default=5.0)
    p.add_argument("--no-kmer-dedup", action="store_true",
                   help="skip the indel-tolerant k-mer containment "
                        "collapse of redundant contigs")
    args = p.parse_args(argv)
    from .assembly.assemble import assemble, kmer_containment_dedup
    from .seq.fasta import read_seqs, write_fasta

    seqs = []
    for path in args.inreads:
        seqs.extend(r.codes for r in read_seqs(path))
    contigs, st = assemble(
        seqs, init_overlap=args.min_overlap,
        final_overlap=args.final_overlap, min_seq_len=200,
        max_subs_per_100=args.max_subs_100,
    )
    if not args.no_kmer_dedup:
        # corrected CLR reads carry residual INDELS that defeat the
        # Hamming containment pass; collapse contigs whose canonical
        # 32-mers are already covered by kept longer contigs
        # (PBAssemb contained-sequence culling role)
        contigs = kmer_containment_dedup(contigs)
        st.n_contigs = len(contigs)
        st.total_bp = int(sum(len(c) for c in contigs))
        st.max_contig = int(max((len(c) for c in contigs), default=0))
    contigs.sort(key=len, reverse=True)
    write_fasta(args.out, ((f"contig{i+1}", c)
                           for i, c in enumerate(contigs)))
    print(f"{len(seqs)} reads -> {st.n_contigs} contigs (max {st.max_contig})")
    return 0


def cmd_eccontigs(argv):
    """`pacbiokanga eccontigs` parity (CPBECContigs): error-correct
    assembled contigs with (HiFi/corrected) reads."""
    p = argparse.ArgumentParser(prog="biokanga eccontigs")
    p.add_argument("-c", "--contigs", required=True)
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--sw-band", type=int, default=96)
    p.add_argument("--min-score", type=int, default=60)
    args = p.parse_args(argv)
    import numpy as _np

    from .index.build import build_index
    from .index.device import to_device
    from .pacbio.ecreads import ECParams, correct_read, find_overlap_candidates
    from .seq.encode import revcomp as _rc
    from .seq.fasta import read_seqs, write_fasta

    contigs = [(r.name, r.codes) for r in read_seqs(args.contigs)]
    reads = []
    for path in args.inreads:
        reads.extend(r.codes for r in read_seqs(path))
    ecp = ECParams(sw_band=args.sw_band, min_overlap_score=args.min_score)
    # index the READS (+rc); each contig is corrected as a probe
    entries = [(f"r{i}", s) for i, s in enumerate(reads)]
    entries += [(f"rc{i}", _rc(s)) for i, s in enumerate(reads)]
    idx = build_index(entries, lut_bases=8)
    didx = to_device(idx)
    n = len(reads)
    out = []
    for name, ctg in contigs:
        cands = []
        for e, diag, v in find_overlap_candidates(didx, idx, -1, ctg, ecp):
            t = reads[e] if e < n else _rc(reads[e - n])
            cands.append((t, diag))
        fixed, used = correct_read(ctg, cands, ecp)
        out.append((name, fixed))
    write_fasta(args.out, out)
    print(f"corrected {len(out)} contigs")
    return 0


def cmd_kmerdist(argv):
    """`pacbiokanga kmerdist` parity (CMAFKMerDist): exact-match K-mer
    distribution comparison between sequence sets."""
    p = argparse.ArgumentParser(prog="biokanga kmerdist")
    p.add_argument("-i", "--infasta", action="append", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-k", "--kmerlen", type=int, default=4)
    args = p.parse_args(argv)
    import numpy as _np

    from .seq.fasta import read_seqs

    k = args.kmerlen
    with open(args.out, "w") as f:
        hdr = ['"KMer"'] + [f'"{path}"' for path in args.infasta]
        f.write(",".join(hdr) + "\n")
        tables = []
        for path in args.infasta:
            counts = _np.zeros(4**k, dtype=_np.int64)
            for rec in read_seqs(path):
                c = rec.codes
                val = _np.zeros(len(c), _np.int64)
                ok = _np.ones(len(c), bool)
                if len(c) < k:
                    continue
                v = _np.zeros(len(c) - k + 1, _np.int64)
                good = _np.ones(len(c) - k + 1, bool)
                for j in range(k):
                    cj = c[j : len(c) - k + 1 + j]
                    good &= cj < 4
                    v = v * 4 + _np.clip(cj, 0, 3)
                counts += _np.bincount(v[good], minlength=4**k)
            tables.append(counts)
        for m in range(4**k):
            kmer = "".join(
                "ACGT"[(m >> (2 * (k - 1 - j))) & 3] for j in range(k)
            )
            f.write(
                f'"{kmer}",' + ",".join(str(int(t[m])) for t in tables) + "\n"
            )
    print(f"kmerdist: {4**k} {k}-mers x {len(args.infasta)} sets")
    return 0


def cmd_kangar(argv):
    """`kangar` tool parity (kangar/kangar.cpp): raw-read preprocessor —
    FASTA/FASTQ -> packed `.rds` container (CProcRawReads V5/V6 role,
    libbiokanga/ProcRawReads.h:53,75)."""
    p = argparse.ArgumentParser(prog="biokanga kangar")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-u", "--pair", action="append", default=None,
                   help="PE mate files; writes a PE-interleaved container")
    p.add_argument("-o", "--out", required=True, help="output .rds.npz")
    p.add_argument("-x", "--trim5", type=int, default=0)
    p.add_argument("-y", "--trim3", type=int, default=0)
    p.add_argument("--max-ns", type=int, default=None,
                   help="drop reads with more than this many N bases")
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs
    from .seq.rds import write_rds

    def prep(codes):
        c = codes[args.trim5: len(codes) - args.trim3 or None]
        if args.max_ns is not None and int((c == 4).sum()) > args.max_ns:
            return None
        return c

    def gen():
        if args.pair:
            for p1, p2 in zip(args.inreads, args.pair):
                for r1, r2 in zip(read_seqs(p1), read_seqs(p2)):
                    c1, c2 = prep(r1.codes), prep(r2.codes)
                    if c1 is None or c2 is None:
                        continue
                    yield (r1.name, c1)
                    yield (r2.name, c2)
        else:
            for path in args.inreads:
                for r in read_seqs(path):
                    c = prep(r.codes)
                    if c is not None:
                        yield (r.name, c)

    n = write_rds(args.out, gen(), pe_interleaved=bool(args.pair))
    print(f"kangar: {n} reads packed -> {args.out}"
          + (" (PE interleaved)" if args.pair else ""))
    return 0


def cmd_kangapr(argv):
    """`kangapr` tool parity (kangapr/kangapr.cpp:113-127, SampleReads.cpp):
    NGS preprocess-reads sampler — emit every Nth read starting at an offset,
    capped at a max sample count, SE (-m0) or PE (-m1) with both mates kept
    in lockstep."""
    p = argparse.ArgumentParser(prog="biokanga kangapr")
    p.add_argument("-m", "--mode", type=int, default=0, choices=[0, 1],
                   help="0 SE reads in -i files, 1 PE reads in -i/-I files")
    p.add_argument("-s", "--sampleof", type=int, default=1,
                   help="start sampling from this read (1-based)")
    p.add_argument("-S", "--samplenth", type=int, default=1,
                   help="sample every Nth read")
    p.add_argument("-M", "--maxsamples", type=int, default=0,
                   help="max samples (0 = until last read)")
    p.add_argument("-i", "--in1", action="append", required=True)
    p.add_argument("-I", "--in2", action="append", default=None)
    p.add_argument("-o", "--out1", required=True)
    p.add_argument("-O", "--out2", default=None)
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs, write_fasta, write_fastq

    if args.mode == 1 and (not args.in2 or not args.out2):
        p.error("PE mode needs -I and -O")

    def sample(records):
        kept = 0
        for i, rec in enumerate(records, start=1):
            if i < args.sampleof or (i - args.sampleof) % args.samplenth:
                continue
            if args.maxsamples and kept >= args.maxsamples:
                return
            kept += 1
            yield rec

    def chain(paths):
        for path in paths:
            yield from read_seqs(path)

    def emit(out_path, recs):
        rows = [(r.name, r.codes, r.qual) for r in recs]
        if rows and rows[0][2] is not None:
            write_fastq(out_path, rows)
        else:
            write_fasta(out_path, [(n, c) for n, c, _ in rows])
        return len(rows)

    if args.mode == 0:
        n = emit(args.out1, sample(chain(args.in1)))
        print(f"kangapr: sampled {n} SE reads -> {args.out1}")
    else:
        pairs = list(sample(zip(chain(args.in1), chain(args.in2))))
        n = emit(args.out1, (a for a, _ in pairs))
        emit(args.out2, (b for _, b in pairs))
        print(f"kangapr: sampled {n} PE pairs -> {args.out1},{args.out2}")
    return 0


def cmd_filterreads(argv):
    """`filterreads` tool parity (filterreads/): filter a packed `.rds`
    container by length / N-count / exact-duplicate status."""
    p = argparse.ArgumentParser(prog="biokanga filterreads")
    p.add_argument("-i", "--inrds", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--min-len", type=int, default=0)
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--max-ns", type=int, default=None)
    p.add_argument("--dedupe", action="store_true",
                   help="drop exact duplicate sequences (keep first)")
    p.add_argument("-x", "--trim5", type=int, default=0)
    p.add_argument("-y", "--trim3", type=int, default=0)
    args = p.parse_args(argv)
    from .seq.rds import FLAG_PE2, RDSFile, write_rds

    f = RDSFile(args.inrds)
    seen: set[bytes] = set()
    kept = dropped = 0
    out_recs = []
    for name, codes, fl in f.records():
        c = codes[args.trim5: len(codes) - args.trim3 or None]
        ok = len(c) >= args.min_len
        if args.max_len is not None:
            ok &= len(c) <= args.max_len
        if ok and args.max_ns is not None:
            ok = int((c == 4).sum()) <= args.max_ns
        if ok and args.dedupe:
            key = c.tobytes()
            if key in seen:
                ok = False
            else:
                seen.add(key)
        if ok:
            out_recs.append((name, c, fl))
            kept += 1
        else:
            dropped += 1
    write_rds(args.out, out_recs)
    print(f"filterreads: {kept} kept, {dropped} dropped -> {args.out}")
    return 0


def cmd_swservice(argv):
    """`pacbiokanga swservice` parity (CPBSWService, PBSWService.cpp:35,282).

    The reference runs a provider daemon that negotiates a BKS TCP session
    and executes SW jobs shipped from a requester (BKSProvider.cpp).  The
    batched service is SPMD: a job batch (probe/target FASTA pairs) is
    sharded over the device mesh 'dp' axis and executed as one banded-SW
    dispatch (parallel/swservice.py) — transport, negotiation and keepalive
    failure handling collapse into jax.sharding placement.
    """
    p = argparse.ArgumentParser(prog="biokanga swservice")
    p.add_argument("-a", "--probes", required=True, help="probe FASTA")
    p.add_argument("-b", "--targets", required=True, help="target FASTA")
    p.add_argument("-o", "--out", required=True, help="scores CSV")
    p.add_argument("--sw-band", type=int, default=96)
    p.add_argument("--pairs", default="zip", choices=("zip", "cross"),
                   help="pair probes/targets 1:1 (zip) or all-vs-all")
    p.add_argument("-n", "--ndevices", type=int, default=None)
    args = p.parse_args(argv)
    import numpy as _np

    from .parallel.swservice import SWJobBatch, make_sw_mesh, run_sw_jobs
    from .seq.fasta import read_seqs

    probes = [(r.name, r.codes) for r in read_seqs(args.probes)]
    targets = [(r.name, r.codes) for r in read_seqs(args.targets)]
    if args.pairs == "zip":
        if len(probes) != len(targets):
            print("zip pairing needs equal probe/target counts",
                  file=sys.stderr)
            return 2
        pairs = list(zip(range(len(probes)), range(len(targets))))
    else:
        pairs = [(i, j) for i in range(len(probes))
                 for j in range(len(targets))]
    La = max(len(c) for _, c in probes)
    Lb = max(len(c) for _, c in targets)
    B = len(pairs)
    a = _np.full((B, La), 4, _np.int8)
    b = _np.full((B, Lb), 4, _np.int8)
    alen = _np.zeros(B, _np.int32)
    blen = _np.zeros(B, _np.int32)
    for r, (i, j) in enumerate(pairs):
        pa, pb = probes[i][1], targets[j][1]
        a[r, : len(pa)] = pa
        b[r, : len(pb)] = pb
        alen[r], blen[r] = len(pa), len(pb)
    mesh = make_sw_mesh(args.ndevices)
    out = run_sw_jobs(
        mesh, SWJobBatch(a, b, alen, blen, _np.zeros(B, _np.int32)),
        W=args.sw_band,
    )
    with open(args.out, "w") as f:
        f.write('"Probe","Target","Score","EndProbeOfs","EndTargOfs"\n')
        for r, (i, j) in enumerate(pairs):
            f.write(f'"{probes[i][0]}","{targets[j][0]}",'
                    f'{int(out["score"][r])},{int(out["best_i"][r])},'
                    f'{int(out["best_k"][r])}\n')
    print(f"swservice: {B} SW jobs over {mesh.shape['dp']} devices")
    return 0


def cmd_pbfilter(argv):
    """`pacbiokanga filter` parity (CPBFilter): retained-SMRTbell removal."""
    p = argparse.ArgumentParser(prog="biokanga pbfilter")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--min-subread-len", type=int, default=500)
    p.add_argument("--max-adapter-mm", type=int, default=9)
    p.add_argument("--trim-ends", type=int, default=0)
    args = p.parse_args(argv)
    from .pacbio.pbfilter import PBFilterParams, pb_filter
    from .seq.fasta import read_seqs, write_fasta

    reads = []
    for path in args.inreads:
        reads.extend((r.name, r.codes) for r in read_seqs(path))
    kept, st = pb_filter(
        reads,
        PBFilterParams(min_subread_len=args.min_subread_len,
                       max_adapter_mm=args.max_adapter_mm,
                       trim_ends=args.trim_ends),
    )
    write_fasta(args.out, kept)
    print(f"pbfilter: {st.reads_in} reads in, {st.reads_with_adapter} with "
          f"retained adapter, {st.subreads_out} subreads out "
          f"({st.bases_out}/{st.bases_in} bases)")
    return 0


def _simple_cmd(fn_name, arg_specs, result_fmt="{n} records",
                module="converters"):
    """Factory for thin converter subcommands over tools/ modules."""

    def cmd(argv):
        p = argparse.ArgumentParser(prog=f"biokanga {fn_name}")
        for flags, kw in arg_specs:
            p.add_argument(*flags, **kw)
        args = p.parse_args(argv)
        import importlib

        mod = importlib.import_module(f".tools.{module}", __package__)
        fn = getattr(mod, fn_name)
        kwargs = {k: v for k, v in vars(args).items()}
        n = fn(**kwargs)
        print(result_fmt.format(n=n))
        return 0

    cmd.__doc__ = f"converter: tools/{module}.{fn_name}"
    return cmd


_IO = [(("-i", "--inpath"), dict(required=True)),
       (("-o", "--outpath"), dict(required=True))]

cmd_bed2csv = _simple_cmd("bed2csv", _IO)
cmd_csv2bed = _simple_cmd("csv2bed", _IO)
cmd_csv2fasta = _simple_cmd(
    "csv2fasta", _IO + [(("--seq-col",), dict(default="seq")),
                        (("--name-col",), dict(default="name"))])
cmd_fasta2bed = _simple_cmd("fasta2bed", _IO)
cmd_bedfilter = _simple_cmd(
    "bed_filter", _IO + [(("-z", "--chrom-regex"), dict(default=None)),
                         (("--min-len",), dict(type=int, default=0)),
                         (("--max-len",), dict(type=int, default=None))])
cmd_bedmerge = _simple_cmd(
    "bed_merge", _IO + [(("-g", "--max-gap"), dict(type=int, default=0))])
cmd_gfffilter = _simple_cmd(
    "gff_filter", _IO + [(("-t", "--feature-types"), dict(action="append",
                                                          default=None)),
                         (("-r", "--attr-regex"), dict(default=None))])
cmd_genwiggle = _simple_cmd(
    "gen_wiggle",
    [(("-i", "--sam-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-n", "--normalise"), dict(action="store_true")),
     (("-s", "--span"), dict(type=int, default=1))],
    "{n} wiggle values")
cmd_splitmultifasta = _simple_cmd(
    "split_multifasta",
    [(("-i", "--inpath"), dict(required=True)),
     (("-o", "--outdir"), dict(required=True)),
     (("-p", "--prefix"), dict(default=""))],
    "{n} files")
cmd_fastafilter = _simple_cmd(
    "fasta_filter", _IO + [(("--min-len",), dict(type=int, default=0))])
cmd_fastatope = _simple_cmd(
    "fasta_to_pe",
    [(("-i", "--inpath"), dict(required=True)),
     (("-o", "--out1"), dict(required=True)),
     (("-O", "--out2"), dict(required=True))],
    "{n} pairs")
cmd_psl2csv = _simple_cmd("psl2csv", _IO, "{n} PSL rows", "converters2")
cmd_blast2csv = _simple_cmd("blast2csv", _IO, "{n} BLAST rows",
                            "converters2")
cmd_csv2stats = _simple_cmd("csv2stats", _IO, "{n} numeric columns",
                            "converters2")
cmd_csvfilter = _simple_cmd(
    "csvfilter",
    _IO + [(("-c", "--column"), dict(required=True)),
           (("-p", "--op"), dict(default="eq",
                                 choices=("eq", "ne", "lt", "le", "gt",
                                          "ge", "match"))),
           (("-V", "--value"), dict(required=True))],
    "{n} rows kept", "converters2")
cmd_csvmerge = _simple_cmd(
    "csvmerge",
    [(("-i", "--inpaths"), dict(action="append", required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-k", "--key"), dict(required=True))],
    "{n} merged keys", "converters2")
cmd_csv2feat = _simple_cmd("csv2feat", _IO, "{n} features", "converters2")
cmd_fasta2dist = _simple_cmd(
    "fasta2dist", _IO + [(("-k", "--kmerlen"), dict(type=int, default=4))],
    "{n} x {n} distance matrix", "converters2")
cmd_agp2genome = _simple_cmd(
    "agp2genome",
    [(("-a", "--agp-path"), dict(required=True)),
     (("-c", "--contigs-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True))],
    "{n} assembled objects", "converters2")
cmd_dmpbioseq = _simple_cmd(
    "dmpbioseq", _IO + [(("-n", "--max-seqs"), dict(type=int, default=None))],
    "{n} sequences dumped", "converters2")
cmd_hammingdist = _simple_cmd(
    "hamming_dist", _IO + [(("-w", "--window"), dict(type=int, default=0))],
    "{n} rows", "converters2")
cmd_genbioseq = _simple_cmd(
    "genbioseq",
    [(("-i", "--inpaths"), dict(action="append", required=True)),
     (("-o", "--outpath"), dict(required=True))],
    "{n} sequences packed", "converters3")
cmd_genbiobed = _simple_cmd(
    "genbiobed", _IO, "{n} features packed", "converters3")
cmd_genbiomultialign = _simple_cmd(
    "genbiomultialign",
    [(("-i", "--inpaths"), dict(action="append", required=True)),
     (("-o", "--outpath"), dict(required=True))],
    "{n} alignment blocks packed", "converters3")
cmd_fasta2struct = _simple_cmd(
    "fasta2struct",
    _IO + [(("-c", "--param"), dict(default="minorgroove",
                                    choices=("energy", "minorgroove",
                                             "majorgroove", "twist", "roll",
                                             "tilt", "rise", "slide",
                                             "shift"))),
           (("-p", "--params-file"), dict(default=None)),
           (("-C", "--winlen"), dict(type=int, default=0)),
           (("-n", "--trunc"), dict(type=int, default=0))],
    "{n} conformation profiles", "converters3")


cmd_quickcount = _simple_cmd(
    "quickcount",
    _IO + [(("-k", "--kmerlen"), dict(type=int, default=4)),
           (("-m", "--mode"), dict(default="all",
                                   choices=("all", "perseq", "norm")))],
    "{n} N-mer rows", "misc_tools")
cmd_loci2dist = _simple_cmd(
    "loci2dist", _IO + [(("-b", "--bin-size"), dict(type=int, default=10))],
    "{n} length bins", "misc_tools")
cmd_ufilter = _simple_cmd(
    "ufilter",
    _IO + [(("-z", "--include"), dict(default=None)),
           (("-Z", "--exclude"), dict(default=None))],
    "{n} rows kept", "misc_tools")
cmd_gensampler = _simple_cmd(
    "gensampler",
    _IO + [(("-n", "--n-samples"), dict(type=int, required=True)),
           (("-l", "--sample-len"), dict(type=int, required=True)),
           (("-b", "--bed-path"), dict(default=None)),
           (("-x", "--exclude"), dict(action="store_true")),
           (("-S", "--seed"), dict(type=int, default=1))],
    "{n} samples", "misc_tools")


def cmd_kangahrdx(argv):
    """`kangahrdx` tool parity (CHomozyReduce): homozygotic-region read
    reduction via canonical seed-key grouping."""
    p = argparse.ArgumentParser(prog="biokanga kangahrdx")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--max-copies", type=int, default=2)
    p.add_argument("--seed-len", type=int, default=32)
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs, write_fasta
    from .tools.misc_tools import homozy_reduce

    reads = []
    for path in args.inreads:
        reads.extend((r.name, r.codes) for r in read_seqs(path))
    kept, st = homozy_reduce(reads, max_copies=args.max_copies,
                             seed_len=args.seed_len)
    write_fasta(args.out, kept)
    print(f"kangahrdx: {st['reads_in']} reads in, {st['reads_out']} kept "
          f"({st['groups']} region groups)")
    return 0


def cmd_kangaradseq(argv):
    """`KangaRADSeq` tool parity: barcode demux + restriction-site check."""
    p = argparse.ArgumentParser(prog="biokanga kangaradseq")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-b", "--barcodes", required=True,
                   help="CSV of sample,barcode rows")
    p.add_argument("-O", "--outdir", required=True)
    p.add_argument("-e", "--enzyme", default="sbfI")
    p.add_argument("--max-bc-mm", type=int, default=1)
    args = p.parse_args(argv)
    import csv as _csv
    import os

    from .seq.fasta import read_seqs, write_fasta
    from .tools.misc_tools import radseq_demux

    barcodes = {}
    with open(args.barcodes) as f:
        for row in _csv.reader(f):
            if len(row) >= 2 and row[1].strip('"').strip():
                s = row[0].strip('"')
                if s.lower() in ("sample", "name"):
                    continue
                barcodes[s] = row[1].strip('"')
    reads = []
    for path in args.inreads:
        reads.extend((r.name, r.codes) for r in read_seqs(path))
    groups, st = radseq_demux(reads, barcodes, enzyme=args.enzyme,
                              max_bc_mm=args.max_bc_mm)
    os.makedirs(args.outdir, exist_ok=True)
    for sample, recs in groups.items():
        if recs:
            write_fasta(os.path.join(args.outdir, f"{sample}.fa"), recs)
    print(f"kangaradseq: {st['assigned']}/{st['reads_in']} assigned "
          f"({st['bad_site']} bad site, {st['no_barcode']} no barcode)")
    return 0


def cmd_csv2sqlite(argv):
    """`csv2sqlite` tool parity (csv2sqlite/, 3,624 LoC): load any CSV
    into a SQLite table, types inferred per column."""
    p = argparse.ArgumentParser(prog="biokanga csv2sqlite")
    p.add_argument("-i", "--incsv", required=True)
    p.add_argument("-o", "--db", required=True)
    p.add_argument("-t", "--table", default=None,
                   help="table name (default: CSV basename)")
    args = p.parse_args(argv)
    import csv as _csv
    import os
    import re as _re
    import sqlite3

    table = args.table or _re.sub(
        r"\W", "_", os.path.splitext(os.path.basename(args.incsv))[0])
    with open(args.incsv) as f:
        rd = _csv.reader(f)
        header = [c.strip('"') for c in next(rd)]
        rows = [r for r in rd if r]

    def coltype(j):
        intish = floatish = True
        for r in rows:
            v = r[j].strip('"') if j < len(r) else ""
            if not v:
                continue
            try:
                float(v)
            except ValueError:
                return "TEXT"
            floatish = True
            try:
                int(v)
            except ValueError:
                intish = False
        return "INTEGER" if intish else ("REAL" if floatish else "TEXT")

    types = [coltype(j) for j in range(len(header))]
    con = sqlite3.connect(args.db)
    cols = ", ".join(f'"{h}" {t}' for h, t in zip(header, types))
    con.execute(f'DROP TABLE IF EXISTS "{table}"')
    con.execute(f'CREATE TABLE "{table}" ({cols})')
    ph = ",".join("?" * len(header))

    def conv(v, t):
        v = v.strip('"')
        if v == "":
            return None
        if t == "INTEGER":
            return int(v)
        if t == "REAL":
            return float(v)
        return v

    con.executemany(
        f'INSERT INTO "{table}" VALUES ({ph})',
        ([conv(r[j] if j < len(r) else "", types[j])
          for j in range(len(header))] for r in rows),
    )
    con.commit()
    con.close()
    print(f"csv2sqlite: {len(rows)} rows -> {args.db}:{table}")
    return 0


def cmd_alignvalidate(argv):
    """CAlignValidate parity (libbiokanga/AlignValidate.h:67-96): score a
    SAM result set against simreads ground-truth descriptors, or compute
    reciprocal-overlap stats between two SAM result sets."""
    p = argparse.ArgumentParser(prog="biokanga alignvalidate")
    p.add_argument("-i", "--insam", required=True)
    p.add_argument("-r", "--refsam", default=None,
                   help="second SAM to compare against (else use simreads"
                        " descriptors as truth)")
    p.add_argument("-o", "--out", default=None, help="optional CSV report")
    p.add_argument("--tolerance", type=int, default=2,
                   help="max locus offset still counted correct")
    args = p.parse_args(argv)

    def read_sam(path):
        hits = {}
        for line in open(path):
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            if int(f[1]) & 0x900:  # secondary/supplementary
                continue
            if f[2] == "*":
                hits[f[0]] = None
            else:
                hits[f[0]] = (f[2], int(f[3]) - 1, (int(f[1]) & 16) != 0)
        return hits

    got = read_sam(args.insam)
    rows = []
    if args.refsam:
        ref = read_sam(args.refsam)
        both = agree = only_a = only_b = 0
        for name, h in got.items():
            r = ref.get(name)
            if h and r:
                both += 1
                if (h[0] == r[0] and abs(h[1] - r[1]) <= args.tolerance
                        and h[2] == r[2]):
                    agree += 1
            elif h:
                only_a += 1
        for name, r in ref.items():
            if r and got.get(name) is None:
                only_b += 1
        rows = [("AlignedBoth", both), ("Agree", agree),
                ("OnlyIn", only_a), ("OnlyInRef", only_b)]
        print(f"alignvalidate: {agree}/{both} agree "
              f"({100.0 * agree / max(both, 1):.2f}%), "
              f"{only_a} only in -i, {only_b} only in -r")
    else:
        from .sim.simreads import SimReadTruth

        tot = correct = wrong = unaligned = 0
        for name, h in got.items():
            try:
                t = SimReadTruth.parse(name)
            except Exception:
                continue
            tot += 1
            if h is None:
                unaligned += 1
            elif (h[0] == t.chrom and abs(h[1] - t.start) <= args.tolerance
                  and h[2] == (t.strand == "-")):
                correct += 1
            else:
                wrong += 1
        rows = [("Total", tot), ("Correct", correct), ("Wrong", wrong),
                ("Unaligned", unaligned)]
        print(f"alignvalidate: {correct}/{tot} correct "
              f"({100.0 * correct / max(tot, 1):.2f}%), {wrong} wrong, "
              f"{unaligned} unaligned")
    if args.out:
        with open(args.out, "w") as f:
            f.write('"Metric","Value"\n')
            for k, v in rows:
                f.write(f'"{k}",{v}\n')
    return 0


def cmd_rnafragsim(argv):
    """`RNAFragSim` tool parity: simulate RNA-seq fragments/reads from
    transcript BED features over a genome."""
    p = argparse.ArgumentParser(prog="biokanga rnafragsim")
    p.add_argument("-i", "--genome", required=True)
    p.add_argument("-b", "--bed", required=True, help="transcript BED")
    p.add_argument("-o", "--out", required=True, help="output FASTQ")
    p.add_argument("-O", "--truthcsv", default=None,
                   help="write per-transcript true counts CSV")
    p.add_argument("-n", "--nfrags", type=int, default=10000)
    p.add_argument("-l", "--readlen", type=int, default=100)
    p.add_argument("--frag-min", type=int, default=150)
    p.add_argument("--frag-max", type=int, default=400)
    p.add_argument("--expr-alpha", type=float, default=1.0)
    p.add_argument("-S", "--seed", type=int, default=1)
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs, write_fastq
    from .sim.extra import rna_frag_sim

    seqs = [(r.name, r.codes) for r in read_seqs(args.genome)]
    names, reads, counts = rna_frag_sim(
        seqs, args.bed, args.nfrags, frag_min=args.frag_min,
        frag_max=args.frag_max, read_len=args.readlen, seed=args.seed,
        expr_alpha=args.expr_alpha,
    )
    write_fastq(args.out, ((n, r, None) for n, r in zip(names, reads)))
    if args.truthcsv:
        with open(args.truthcsv, "w") as f:
            f.write('"Transcript","TrueCount"\n')
            for name, c in counts:
                f.write(f'"{name}",{c}\n')
    print(f"rnafragsim: {len(reads)} fragments over {len(counts)} "
          "transcripts")
    return 0


def cmd_usimdiffexpr(argv):
    """`usimdiffexpr` tool parity: simulate a differential-expression
    count table with controlled fold changes."""
    p = argparse.ArgumentParser(prog="biokanga usimdiffexpr")
    p.add_argument("-o", "--out", required=True, help="counts CSV")
    p.add_argument("-O", "--truthcsv", default=None)
    p.add_argument("-n", "--nfeatures", type=int, default=1000)
    p.add_argument("--nctrl", type=int, default=3)
    p.add_argument("--nexpt", type=int, default=3)
    p.add_argument("--de-frac", type=float, default=0.1)
    p.add_argument("--fold-change", type=float, default=4.0)
    p.add_argument("--dispersion", type=float, default=0.2)
    p.add_argument("-S", "--seed", type=int, default=1)
    args = p.parse_args(argv)
    from .sim.extra import sim_diff_expr

    names, ctrl, expt, truth = sim_diff_expr(
        args.nfeatures, n_ctrl=args.nctrl, n_expt=args.nexpt,
        de_frac=args.de_frac, fold_change=args.fold_change,
        dispersion=args.dispersion, seed=args.seed,
    )
    with open(args.out, "w") as f:
        hdr = (['"Feature"']
               + [f'"Ctrl{i+1}"' for i in range(args.nctrl)]
               + [f'"Expt{i+1}"' for i in range(args.nexpt)])
        f.write(",".join(hdr) + "\n")
        for i, name in enumerate(names):
            row = [f'"{name}"'] + [str(int(x)) for x in ctrl[i]]
            row += [str(int(x)) for x in expt[i]]
            f.write(",".join(row) + "\n")
    if args.truthcsv:
        with open(args.truthcsv, "w") as f:
            f.write('"Feature","TrueFoldChange"\n')
            for name, t in zip(names, truth):
                f.write(f'"{name}",{t:.4f}\n')
    n_de = int((truth != 1.0).sum())
    print(f"usimdiffexpr: {args.nfeatures} features, {n_de} DE")
    return 0


def cmd_kangarg(argv):
    """`kangarg` tool parity: genome K-mer randomiser — shuffle each
    sequence preserving exact k-mer composition (CShuffle role)."""
    p = argparse.ArgumentParser(prog="biokanga kangarg")
    p.add_argument("-i", "--inpath", required=True)
    p.add_argument("-o", "--outpath", required=True)
    p.add_argument("-k", "--kmerlen", type=int, default=2,
                   help="conserved k-mer order (1=plain shuffle)")
    p.add_argument("-S", "--seed", type=int, default=1)
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs, write_fasta
    from .sim.extra import klet_shuffle

    out = []
    for i, rec in enumerate(read_seqs(args.inpath)):
        out.append((rec.name,
                    klet_shuffle(rec.codes, k=args.kmerlen,
                                 seed=args.seed + i)))
    write_fasta(args.outpath, out)
    print(f"kangarg: {len(out)} sequences shuffled (k={args.kmerlen})")
    return 0


def cmd_findapproxmatches(argv):
    """`FindShortApproxMatches` tool parity: every locus where each short
    query matches within a mismatch budget (one-hot conv scan as one convolution)."""
    p = argparse.ArgumentParser(prog="biokanga findapproxmatches")
    p.add_argument("-i", "--queries", required=True, help="query FASTA")
    p.add_argument("-I", "--genome", required=True,
                   help="genome FASTA or index .npz")
    p.add_argument("-o", "--out", required=True, help="hits CSV")
    p.add_argument("-s", "--max-mm", type=int, default=2)
    p.add_argument("-Q", "--strand", default="both",
                   choices=("both", "sense"))
    args = p.parse_args(argv)
    import numpy as _np

    from .ops.shortmatch import find_short_matches
    from .seq.fasta import read_seqs

    if args.genome.endswith(".npz"):
        from .index.build import load_index

        idx = load_index(args.genome)
        genome = _np.asarray(idx.codes)
        entry_names = idx.entry_names
        entry_starts = _np.asarray(idx.entry_starts)
    else:
        recs = [(r.name, r.codes) for r in read_seqs(args.genome)]
        genome = _np.concatenate([c for _, c in recs])
        entry_names = [n for n, _ in recs]
        entry_starts = _np.zeros(len(recs) + 1, _np.int64)
        _np.cumsum([len(c) for _, c in recs], out=entry_starts[1:])
    qrecs = [(r.name, r.codes) for r in read_seqs(args.queries)]
    # group queries by width (the conv wants one W per dispatch)
    by_w: dict[int, list[int]] = {}
    for i, (_, c) in enumerate(qrecs):
        by_w.setdefault(len(c), []).append(i)
    n = 0
    with open(args.out, "w") as f:
        f.write('"Query","Chrom","Loci","Strand","Mismatches"\n')
        for w, ids in sorted(by_w.items()):
            hits = find_short_matches(
                genome, [qrecs[i][1] for i in ids], max_mm=args.max_mm,
                both_strands=args.strand == "both",
            )
            for qi, locus, strand, mm in hits:
                e = int(_np.searchsorted(entry_starts, locus,
                                         side="right")) - 1
                f.write(f'"{qrecs[ids[qi]][0]}","{entry_names[e]}",'
                        f"{locus - int(entry_starts[e])},"
                        f'"{strand}",{mm}\n')
                n += 1
    print(f"findapproxmatches: {n} hits for {len(qrecs)} queries")
    return 0


def cmd_genzygosity(argv):
    """`genzygosity` tool parity: chrom-vs-chrom K-mer sharing matrix."""
    p = argparse.ArgumentParser(prog="biokanga genzygosity")
    p.add_argument("-I", "--sfx", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-k", "--kmerlen", type=int, default=20)
    args = p.parse_args(argv)
    from .index.build import load_index
    from .tools.zygosity import write_zygosity_csv, zygosity_matrix

    idx = load_index(args.sfx)
    M, totals = zygosity_matrix(idx, K=args.kmerlen)
    write_zygosity_csv(args.out, idx.entry_names, M)
    print(f"{len(idx.entry_names)}x{len(idx.entry_names)} zygosity matrix")
    return 0


def cmd_pescaffold(argv):
    """`biokanga pescaffold` parity (CPEScaffold, PEScaffold.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga pescaffold")
    p.add_argument("-i", "--pe1sam", required=True)
    p.add_argument("-u", "--pe2sam", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--min-votes", type=int, default=2)
    args = p.parse_args(argv)
    from .tools.pescaffold import pe_scaffold, write_pescaffold_csv

    paths = pe_scaffold(args.pe1sam, args.pe2sam, args.min_votes)
    write_pescaffold_csv(args.out, paths)
    joined = sum(1 for x in paths if len(x) > 1)
    print(f"{len(paths)} scaffold paths ({joined} multi-contig)")
    return 0


def cmd_alignsbs(argv):
    """`biokanga alignsbs` parity (CAlignsBootstrap)."""
    p = argparse.ArgumentParser(prog="biokanga alignsbs")
    p.add_argument("-a", "--sama", required=True)
    p.add_argument("-b", "--samb", required=True)
    p.add_argument("-B", "--bed", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-n", "--iterations", type=int, default=1000)
    p.add_argument("--no-replacement", action="store_true")
    args = p.parse_args(argv)
    import numpy as _np

    from .seq.annotations import read_bed
    from .tools.expression import map_loci_to_features, read_sam_loci
    from .tools.zygosity import aligns_bootstrap

    feats = read_bed(args.bed)
    ca, _ = map_loci_to_features(read_sam_loci(args.sama), feats)
    cb, _ = map_loci_to_features(read_sam_loci(args.samb), feats)
    obs, pvals = aligns_bootstrap(
        ca, cb, iterations=args.iterations,
        with_replacement=not args.no_replacement,
    )
    with open(args.out, "w") as f:
        f.write('"Feature","CntsA","CntsB","ObsDiff","PValue"\n')
        for ft, a_, b_, o, pv in zip(feats, ca, cb, obs, pvals):
            f.write(f'"{ft.name}",{int(a_)},{int(b_)},{o:.6g},{pv:.4f}\n')
    print(f"bootstrapped {len(feats)} features x {args.iterations} iters")
    return 0


# --------------------------------------------- chromatin/structure family --
# (SURVEY §2.6 chromatin/structure tools; see tools/chromatin_tools.py for
# per-tool reference citations)

cmd_dnasitepotential = _simple_cmd(
    "dna_site_potential",
    [(("-i", "--reads-path"), dict(required=True)),
     (("-I", "--genome-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-s", "--strand"), dict(default=None, choices=("+", "-")))],
    "{n} octamer rows", "chromatin_tools")
cmd_rnasitepotential = _simple_cmd(
    "rna_site_potential",
    [(("-i", "--reads-path"), dict(required=True)),
     (("-I", "--genome-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-s", "--strand"), dict(default=None, choices=("+", "-")))],
    "{n} octamer rows", "chromatin_tools")
cmd_simulatemnase = _simple_cmd(
    "simulate_mnase",
    [(("-i", "--genome-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-I", "--prefs-path"), dict(default=None)),
     (("-m", "--mode"), dict(type=int, default=0, choices=(0, 1, 2))),
     (("-n", "--numreads"), dict(type=int, default=10000)),
     (("-l", "--readlen"), dict(type=int, default=36)),
     (("-c", "--cutmin"), dict(type=int, default=122)),
     (("-C", "--cutmax"), dict(type=int, default=172)),
     (("-s", "--strand"), dict(default=None, choices=("+", "-"))),
     (("--seed",), dict(type=int, default=1))],
    "{n} simulated MNase reads", "chromatin_tools")
cmd_prednucleosomes = _simple_cmd(
    "pred_nucleosomes",
    [(("-i", "--reads-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-g", "--genome-path"), dict(default=None)),
     (("-I", "--prefs-path"), dict(default=None)),
     (("-M", "--fmt"), dict(type=int, default=0)),
     (("-a", "--movavg"), dict(type=int, default=10)),
     (("-A", "--basewin"), dict(type=int, default=250)),
     (("-t", "--title"), dict(default="prednucs")),
     (("--min-score",), dict(type=float, default=1.0))],
    "{n} track rows", "chromatin_tools")
cmd_predconfnucs = _simple_cmd(
    "pred_conf_nucs",
    [(("-i", "--genome-path"), dict(required=True)),
     (("-I", "--conf-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-M", "--fmt"), dict(type=int, default=0)),
     (("-a", "--movavg"), dict(type=int, default=10)),
     (("-A", "--basewin"), dict(type=int, default=250)),
     (("-t", "--title"), dict(default="confnucs"))],
    "{n} track rows", "chromatin_tools")
cmd_genstructprofile = _simple_cmd(
    "gen_struct_profile",
    [(("-i", "--fasta-path"), dict(required=True)),
     (("-p", "--params-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("--param",), dict(default="minorgroove")),
     (("-T", "--trunclength"), dict(type=int, default=147)),
     (("-u", "--ofsstart"), dict(type=int, default=0)),
     (("-n", "--nsamples"), dict(type=int, default=0))],
    "{n} profiles", "chromatin_tools")
cmd_genstructstats = _simple_cmd(
    "gen_struct_stats",
    [(("-i", "--params-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-s", "--sort-flanking"), dict(action="store_true"))],
    "{n} octamer rows", "chromatin_tools")
cmd_gennucstats = _simple_cmd(
    "gen_nuc_stats",
    [(("-i", "--bkg-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-I", "--sample-path"), dict(default=None)),
     (("-b", "--bkgdyadofs"), dict(type=int, default=73)),
     (("-s", "--smpldyadofs"), dict(type=int, default=73)),
     (("-w", "--winddyad"), dict(type=int, default=5))],
    "{n} dyads", "chromatin_tools")
cmd_gencomposition = _simple_cmd(
    "gen_composition",
    [(("-i", "--genome-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-n", "--nmer"), dict(type=int, default=2))],
    "{n} composition rows", "chromatin_tools")
cmd_gencentroidmetrics = _simple_cmd(
    "gen_centroid_metrics",
    [(("-i", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-n", "--nmer"), dict(type=int, default=5)),
     (("-r", "--ref-species"), dict(default=None))],
    "{n} oligo rows", "chromatin_tools")
cmd_proccentroids = _simple_cmd(
    "proc_centroids",
    [(("-i", "--inpath"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-m", "--mode"), dict(type=int, default=0))],
    "{n} centroid rows", "chromatin_tools")


# --------------------------------------------------- conservation family --
# (SURVEY §2.6 comparative-genomics/conservation tools; per-tool reference
# citations in tools/conservation.py)

cmd_genhyperconserved = _simple_cmd(
    "gen_hyperconserved",
    [(("-i", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-O", "--cores-path"), dict(default=None)),
     (("-r", "--ref-species"), dict(default=None)),
     (("-s", "--species"), dict(action="append", default=None)),
     (("-y", "--min-ident"), dict(type=int, default=90)),
     (("-n", "--min-ultra-len"), dict(type=int, default=50)),
     (("-N", "--min-hyper-len"), dict(type=int, default=0)),
     (("-X", "--max-mismatches"), dict(type=int, default=100)),
     (("-j", "--indels-as-mismatches"), dict(action="store_true")),
     (("-k", "--slough-ref-indels"), dict(action="store_true"))],
    "{n} conserved elements", "conservation")
cmd_genultras = _simple_cmd(
    "gen_ultras",
    [(("-i", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-O", "--cores-path"), dict(default=None)),
     (("-r", "--ref-species"), dict(default=None)),
     (("-s", "--species"), dict(action="append", default=None)),
     (("-n", "--min-ultra-len"), dict(type=int, default=50))],
    "{n} ultra elements", "conservation")
cmd_genhyperdropouts = _simple_cmd(
    "gen_hyperdropouts",
    [(("-i", "--ref-path"), dict(required=True)),
     (("-I", "--rel-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-p", "--mode"), dict(type=int, default=0, choices=(0, 1, 2, 3)))],
    "{n} elements", "conservation")
cmd_genalignstats = _simple_cmd(
    "gen_align_stats",
    [(("-i", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True))],
    "{n} species rows", "conservation")
cmd_genalignconf = _simple_cmd(
    "gen_align_conf",
    [(("-i", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-m", "--mode"), dict(type=int, default=0, choices=(0, 1, 2)))],
    "{n} blocks", "conservation")
cmd_genalignref2relloci = _simple_cmd(
    "gen_align_ref2relloci",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-I", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-r", "--ref-species"), dict(default=None))],
    "{n} mapped loci", "conservation")
cmd_genalignloci2core = _simple_cmd(
    "gen_align_loci2core",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-I", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-d", "--dist-segs"), dict(type=int, default=10))],
    "{n} profile rows", "conservation")
cmd_loci2phylip = _simple_cmd(
    "loci2phylip",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-I", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-x", "--mode"), dict(type=int, default=0, choices=(0, 1)))],
    "{n} phylip blocks", "conservation")
cmd_genrollups = _simple_cmd(
    "gen_rollups",
    [(("-i", "--inpaths"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-m", "--mode"), dict(type=int, default=0))],
    "{n} files rolled up", "conservation")
cmd_genelementseq = _simple_cmd(
    "gen_element_seq",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-I", "--genome-path"), dict(required=True)),
     (("-o", "--out-fasta"), dict(required=True)),
     (("-f", "--flank"), dict(type=int, default=0))],
    "{n} element sequences", "conservation")
cmd_genloci2gene = _simple_cmd(
    "gen_loci2gene",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-b", "--bed-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-L", "--updnstream"), dict(type=int, default=2000))],
    "{n} loci classified", "conservation")
cmd_genseqcandidates = _simple_cmd(
    "gen_seq_candidates",
    [(("-i", "--fasta-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("--min-len",), dict(type=int, default=50)),
     (("--max-len",), dict(type=int, default=1 << 30)),
     (("--max-n-pct",), dict(type=float, default=5.0)),
     (("--min-gc",), dict(type=float, default=0.0)),
     (("--max-gc",), dict(type=float, default=100.0))],
    "{n} candidates", "conservation")
cmd_genelementprofiles = _simple_cmd(
    "gen_element_profiles",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-I", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-d", "--segs"), dict(type=int, default=10))],
    "{n} element profiles", "conservation")
cmd_processcsvfiles = _simple_cmd(
    "process_csv_files",
    [(("-i", "--inpaths"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-m", "--op"), dict(default="merge", choices=("merge", "common")))],
    "{n} loci", "conservation")
cmd_gennormwiggle = _simple_cmd(
    "gen_norm_wiggle",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-m", "--mode"), dict(type=int, default=0, choices=(0, 1))),
     (("-s", "--span"), dict(type=int, default=1))],
    "{n} wiggle values", "conservation")


cmd_goenrichment = _simple_cmd(
    "go_enrichment_csv",
    [(("-i", "--study-path"), dict(required=True)),
     (("-I", "--pop-path"), dict(required=True)),
     (("-b", "--obo-path"), dict(required=True)),
     (("-a", "--gaf-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-n", "--min-count"), dict(type=int, default=2))],
    "{n} enriched terms", "go_tools")
cmd_goassoc = _simple_cmd(
    "go_assoc_dump",
    [(("-b", "--obo-path"), dict(required=True)),
     (("-a", "--gaf-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True))],
    "{n} associations", "go_tools")


SUBCOMMANDS = {
    "index": cmd_index,
    "uhamming": cmd_uhamming,
    "genzygosity": cmd_genzygosity,
    "rnafragsim": cmd_rnafragsim,
    "csv2sqlite": cmd_csv2sqlite,
    "alignvalidate": cmd_alignvalidate,
    "usimdiffexpr": cmd_usimdiffexpr,
    "kangarg": cmd_kangarg,
    "findapproxmatches": cmd_findapproxmatches,
    "pescaffold": cmd_pescaffold,
    "alignsbs": cmd_alignsbs,
    "bed2csv": cmd_bed2csv,
    "csv2bed": cmd_csv2bed,
    "csv2fasta": cmd_csv2fasta,
    "fasta2bed": cmd_fasta2bed,
    "bedfilter": cmd_bedfilter,
    "bedmerge": cmd_bedmerge,
    "gfffilter": cmd_gfffilter,
    "gtffilter": cmd_gfffilter,
    "genwiggle": cmd_genwiggle,
    "splitmultifasta": cmd_splitmultifasta,
    "fastafilter": cmd_fastafilter,
    "fasta2pe": cmd_fastatope,
    "psl2csv": cmd_psl2csv,
    "blast2csv": cmd_blast2csv,
    "csv2stats": cmd_csv2stats,
    "csvfilter": cmd_csvfilter,
    "csvmerge": cmd_csvmerge,
    "csv2feat": cmd_csv2feat,
    "fasta2dist": cmd_fasta2dist,
    "agp2genome": cmd_agp2genome,
    "dmpbioseq": cmd_dmpbioseq,
    "hammingdist": cmd_hammingdist,
    "genbioseq": cmd_genbioseq,
    "genbiobed": cmd_genbiobed,
    "genbiomultialign": cmd_genbiomultialign,
    "fasta2struct": cmd_fasta2struct,
    "ecreads": cmd_ecreads,
    "swservice": cmd_swservice,
    "pbfilter": cmd_pbfilter,
    "kangar": cmd_kangar,
    "kangapr": cmd_kangapr,
    "filterreads": cmd_filterreads,
    "contigs": cmd_pbcontigs,
    "eccontigs": cmd_eccontigs,
    "kmerdist": cmd_kmerdist,
    "assemb": cmd_assemb,
    "scaffold": cmd_scaffold,
    "snps2sqlite": cmd_snps2sqlite,
    "snpm2sqlite": cmd_snps2sqlite,
    "psl2sqlite": cmd_psl2sqlite,
    "de2sqlite": cmd_de2sqlite,
    "maploci": cmd_maploci,
    "gendeseq": cmd_gendeseq,
    "rnade": cmd_rnade,
    "locateroi": cmd_locateroi,
    "kmarkers": cmd_kmarkers,
    "prekmarkers": lambda argv: cmd_kmarkers(argv, fasta_out=True),
    "locmarkers": lambda argv: cmd_kmarkers(argv, fasta_out=True),
    "snpmarkers": cmd_snpmarkers,
    "genmarkers": cmd_snpmarkers,
    "quickcount": cmd_quickcount,
    "loci2dist": cmd_loci2dist,
    "ufilter": cmd_ufilter,
    "gensampler": cmd_gensampler,
    "kangahrdx": cmd_kangahrdx,
    "kangaradseq": cmd_kangaradseq,
    "markerseqs": cmd_markerseqs,
    "align": cmd_align,
    "simreads": cmd_simreads,
    "blitz": cmd_blitz,
    "fasta2nxx": cmd_fasta2nxx,
    "xfasta": cmd_xfasta,
    "pseudogenome": cmd_pseudogenome,
    "filter": cmd_filter,
    "ngsqc": cmd_ngsqc,
    "mergeoverlaps": cmd_mergeoverlaps,
    "ssr": cmd_ssr,
    "filtchrom": cmd_filtchrom,
    "remaploci": cmd_remaploci,
    "dnaseqsitepotential": cmd_dnasitepotential,
    "rnaseqsitepotential": cmd_rnasitepotential,
    "simulatemnase": cmd_simulatemnase,
    "prednucleosomes": cmd_prednucleosomes,
    "predconfnucs": cmd_predconfnucs,
    "genstructprofile": cmd_genstructprofile,
    "genstructstats": cmd_genstructstats,
    "gennucstats": cmd_gennucstats,
    "gencomposition": cmd_gencomposition,
    "gencentroidmetrics": cmd_gencentroidmetrics,
    "proccentroids": cmd_proccentroids,
    "genhyperconserved": cmd_genhyperconserved,
    "genultras": cmd_genultras,
    "genhyperdropouts": cmd_genhyperdropouts,
    "genalignstats": cmd_genalignstats,
    "genalignconf": cmd_genalignconf,
    "genalignref2relloci": cmd_genalignref2relloci,
    "genalignloci2core": cmd_genalignloci2core,
    "loci2phylip": cmd_loci2phylip,
    "genrollups": cmd_genrollups,
    "genelementseq": cmd_genelementseq,
    "genloci2gene": cmd_genloci2gene,
    "genseqcandidates": cmd_genseqcandidates,
    "genelementprofiles": cmd_genelementprofiles,
    "processcsvfiles": cmd_processcsvfiles,
    "gennormwiggle": cmd_gennormwiggle,
    "maploci2features": cmd_maploci,
    "goenrichment": cmd_goenrichment,
    "goassoc": cmd_goassoc,
}


# subcommands whose own parser defines -q/--sumrslts and logs a richer
# row than the generic dispatch wrapper would
_OWN_SUMRSLTS = {"index", "align"}


def _extract_sumrslts(argv: list[str]):
    """Pop a -q/--sumrslts DB path from a subcommand's argv (the
    dispatch-level half of the reference's gExperimentID globals: every
    subprocess logs experiment/process/params/results,
    biokanga/biokanga.cpp:134-137, SQLiteSummaries.cpp:600,719,1057)."""
    out, db = [], None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-q", "--sumrslts") and i + 1 < len(argv):
            db = argv[i + 1]
            i += 2
            continue
        if a.startswith("--sumrslts="):
            db = a.split("=", 1)[1]
            i += 1
            continue
        out.append(a)
        i += 1
    return out, db


def main(argv: list[str] | None = None) -> int:
    argv = _expand_response_files(list(sys.argv[1:] if argv is None else argv))
    if not argv or argv[0] in ("-h", "--help"):
        names = ", ".join(sorted(SUBCOMMANDS))
        print(f"biokanga {__version__}\nsubcommands: {names}")
        return 0
    if argv[0] in ("-v", "--version"):
        print(__version__)
        return 0
    cmd = argv[0]
    if cmd not in SUBCOMMANDS:
        print(f"unknown subcommand '{cmd}'", file=sys.stderr)
        return 2
    from .utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    sub_argv = argv[1:]
    db_path = None
    if cmd not in _OWN_SUMRSLTS:
        sub_argv, db_path = _extract_sumrslts(sub_argv)
    if db_path is None:
        return SUBCOMMANDS[cmd](sub_argv)
    import time as _time

    t0 = _time.monotonic()
    rc = 1
    try:
        rc = SUBCOMMANDS[cmd](sub_argv)
        return rc
    finally:
        from .utils.sqlite_summaries import SQLiteSummaries

        db = SQLiteSummaries(db_path)
        db.log_run(cmd, {"argv": " ".join(sub_argv)},
                   {"result_code": int(rc) if rc is not None else 0,
                    "seconds": round(_time.monotonic() - t0, 2)})
        db.close()


if __name__ == "__main__":
    raise SystemExit(main())
