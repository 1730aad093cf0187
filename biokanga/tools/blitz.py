"""Blitz — BLAT-like local alignment (capability match for `biokanga
blitz`, CBlitz, biokanga/Blitz.cpp: Process :594, ProcAlignQuerySeqs
:1243, IdentifyHighScorePaths/HighScoreSW :1495/:1407).

Reference behavior reproduced:
- seed cores of CoreLen (default 20, Blitz.h:11) slid at CoreDelta
  (default (CoreLen+1)/2, Blitz.cpp:989-1002 by sensitivity)
- over-occurring cores suppressed beyond the sensitivity explore depth
  (cDfltSensCoreIters 1500, Blitz.h:52-55; InitOverOccKMers role)
- seeds merged along diagonals into maximal exact blocks, then chained
  into highest-scoring collinear paths with the reference's scoring:
  match +1, mismatch -2, gap open -5, gap extend -1 per 10bp capped at
  10, gaps > 100kbp break paths (Blitz.h:28-45)
- paths accepted if score >= MinPathScore (default 75) and the query
  aligns over >= MinQueryLenAlignedPct (default 25%) of its length
- PSL / PSLX / BED / MAF output rows

Design: seed lookup + diagonal merge are batched device ops reusing
the index machinery; the collinear-chain DP runs as a lax.scan over
nodes with all (prev, next) gap costs vectorised per step.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..index.device import DeviceIndex
from ..seq.encode import codes_to_ascii, revcomp

# Blitz.h scoring constants
C_DFLT_CORE_LEN = 20
C_DFLT_PATH_SCORE = 75
C_DFLT_MATCH = 1
C_DFLT_MISMATCH = 2
C_DFLT_GAP_OPEN = 5
C_GAP_EXTEND_COST = 1       # per 10 bp
C_GAP_EXTEND_LIMIT = 10
C_GAP_MAX_LEN = 100_000
C_DFLT_MIN_ALIGNED_PCT = 25
C_DFLT_CORE_ITERS = 1500
C_DFLT_MAX_PATHS = 10
C_MAX_OVERLAP_FLOAT = 8


@dataclass(frozen=True)
class BlitzParams:
    core_len: int = C_DFLT_CORE_LEN
    core_delta: int = 0                 # 0 = per-sensitivity default
    sensitivity: str = "default"        # default|more|ultra|less
    min_path_score: int = C_DFLT_PATH_SCORE
    min_aligned_pct: int = C_DFLT_MIN_ALIGNED_PCT
    max_paths: int = C_DFLT_MAX_PATHS
    match_score: int = C_DFLT_MATCH
    mismatch_score: int = C_DFLT_MISMATCH
    gap_open: int = C_DFLT_GAP_OPEN
    max_occs: int = 64                  # per-core occurrence cap (device)
    max_nodes: int = 512                # chain DP node cap per query/strand

    def effective_delta(self) -> int:
        if self.core_delta:
            return self.core_delta
        cl = self.core_len
        return {
            "default": (cl + 1) // 2,
            "more": (cl + 2) // 3,
            "ultra": (cl + 3) // 4,
            "less": cl,
        }[self.sensitivity]


@dataclass
class BlitzPath:
    qname: str
    qsize: int
    strand: str
    qstart: int            # 0-based, on + strand of the query
    qend: int
    tname: str
    tsize: int
    tstart: int
    tend: int
    score: int
    matches: int
    block_sizes: list = field(default_factory=list)
    q_starts: list = field(default_factory=list)
    t_starts: list = field(default_factory=list)


def _seed_nodes(didx: DeviceIndex, q: np.ndarray, p: BlitzParams):
    """Exact-core seed (qofs, tloci) pairs for one query strand, via the
    rolling-key batched SA lookup (ops/lookup.rolling_seed_lookup — one
    compiled graph regardless of query length, so the reference's 16 Mbp
    query envelope, Blitz.h:59-60, traces instantly), capped per core and
    with over-occurring cores suppressed (explore-depth semantics)."""
    from ..ops.lookup import rolling_seed_lookup

    k = min(p.core_len, 16)
    delta = p.effective_delta()
    L = len(q)
    S = max((L - k) // delta + 1, 0)
    if S == 0:
        return np.zeros((0, 2), dtype=np.int64)
    H = p.max_occs
    Lpad = -(-L // 256) * 256
    seq = np.full((1, Lpad), 4, np.int8)
    seq[0, :L] = q
    pos, valid, size = rolling_seed_lookup(
        didx.key_hi, didx.key_lo, didx.lut, didx.pos_rows,
        jnp.asarray(seq), k, delta,
        max((Lpad - k) // delta + 1, 1), H, didx.lut_bases,
        didx.max_bsearch_steps,
    )
    pos = np.asarray(pos)[0]
    valid = np.asarray(valid)[0].copy()
    size = np.asarray(size)[0]
    valid &= (size <= C_DFLT_CORE_ITERS)[:, None]
    Sreal = min(S, pos.shape[0])
    valid = valid[:Sreal]
    pos = pos[:Sreal]
    qofs = (np.arange(Sreal, dtype=np.int64) * delta)[:, None]
    out = np.stack(
        [np.broadcast_to(qofs, pos.shape)[valid],
         pos[valid].astype(np.int64)], axis=1
    )
    return out


def _merge_diag_blocks(nodes: np.ndarray, core_len: int):
    """Merge exact-core seeds on the same diagonal into maximal blocks —
    vectorised (lexsort + run detection; no per-seed loop).
    nodes: (N, 2) [qofs, tofs]. Returns (M, 3) [qstart, tstart, length]."""
    if len(nodes) == 0:
        return np.zeros((0, 3), dtype=np.int64)
    diag = nodes[:, 1] - nodes[:, 0]
    order = np.lexsort((nodes[:, 0], diag))
    q = nodes[order, 0]
    t = nodes[order, 1]
    d = diag[order]
    # cores sorted by q within a diagonal each cover [q, q+core_len), so a
    # run extends while the next core starts within the previous cover
    brk = np.concatenate(
        [[True], (d[1:] != d[:-1]) | (q[1:] > q[:-1] + core_len)]
    )
    starts = np.nonzero(brk)[0]
    ends = np.concatenate([starts[1:], [len(q)]]) - 1
    return np.stack(
        [q[starts], t[starts], q[ends] + core_len - q[starts]], axis=1
    ).astype(np.int64)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("M", "gap_open"))
def _chain_scan(q0, t0, ln, score, valid, M: int, gap_open: int):
    """Collinear-chain DP as a device scan over blocks sorted by
    (t, q): per step the (M,) predecessor candidates evaluate as one
    vector op — the lax.scan realisation of HighScoreSW path chaining
    (biokanga/Blitz.cpp:1407,1495)."""
    idxs = jnp.arange(M, dtype=jnp.int32)
    NEGB = jnp.int32(-(10**9))

    def step(f, i):
        dq = q0[i] - (q0 + ln)
        dt = t0[i] - (t0 + ln)
        ok = (idxs < i) & valid & valid[i]
        ok &= (dq > -C_MAX_OVERLAP_FLOAT) & (dt > -C_MAX_OVERLAP_FLOAT)
        ok &= (dq <= C_GAP_MAX_LEN) & (dt <= C_GAP_MAX_LEN)
        gap = jnp.maximum(jnp.maximum(dq, dt), 0)
        gcost = jnp.where(
            gap > 0,
            gap_open + jnp.minimum(gap // 10 * C_GAP_EXTEND_COST,
                                   C_GAP_EXTEND_LIMIT),
            0,
        )
        cand = jnp.where(ok, f - gcost, NEGB)
        j = jnp.argmax(cand).astype(jnp.int32)
        best = cand[j]
        take = best > 0
        fi = jnp.where(take, score[i] + best, score[i])
        f = f.at[i].set(jnp.where(valid[i], fi, NEGB))
        return f, jnp.where(take, j, -1)

    f0 = jnp.full((M,), NEGB, jnp.int32)
    f, pred = jax.lax.scan(step, f0, idxs)
    return f, pred


def _chain_blocks(blocks: np.ndarray, p: BlitzParams):
    """Collinear chaining with the reference's path scoring. Returns list
    of (score, [block indices]) best-first, greedily non-overlapping.
    The quadratic DP runs on device (_chain_scan) with blocks padded to
    a power-of-two bucket; path extraction is host-side."""
    M = len(blocks)
    if M == 0:
        return []
    order = np.lexsort((blocks[:, 0], blocks[:, 1]))
    b = blocks[order]
    Mp = 64
    while Mp < M:
        Mp *= 2
    q0 = np.zeros(Mp, np.int32)
    t0 = np.zeros(Mp, np.int32)
    ln = np.zeros(Mp, np.int32)
    q0[:M], t0[:M], ln[:M] = b[:, 0], b[:, 1], b[:, 2]
    score = ln * p.match_score
    valid = np.arange(Mp) < M
    f, pred = _chain_scan(
        jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(ln),
        jnp.asarray(score), jnp.asarray(valid), Mp, p.gap_open,
    )
    # int64 on host: np.where would WRAP the -1e12 mask value into an
    # int32 result (NumPy 2 casts the scalar to the array dtype)
    f = np.asarray(f).astype(np.int64)
    pred = np.asarray(pred)
    # extract up to max_paths non-overlapping chains best-first
    used = np.zeros(Mp, dtype=bool)
    used[M:] = True
    paths = []
    for _ in range(p.max_paths):
        masked = np.where(used, -(10**12), f)
        i = int(np.argmax(masked))
        if masked[i] < p.min_path_score:
            break
        chain = []
        while i >= 0 and not used[i]:
            chain.append(i)
            used[i] = True
            i = int(pred[i])
        chain.reverse()
        if not chain:
            break
        paths.append((int(f[chain[-1]]), [order[c] for c in chain]))
    return paths


def blitz_query(
    didx: DeviceIndex, qname: str, q: np.ndarray, p: BlitzParams | None = None
) -> list[BlitzPath]:
    """Align one query (both strands) and return accepted paths."""
    p = p or BlitzParams()
    starts = np.asarray(jax.device_get(didx.entry_starts))
    qsize = len(q)
    out: list[BlitzPath] = []
    for strand, qs in (("+", q), ("-", revcomp(q))):
        nodes = _seed_nodes(didx, qs, p)
        blocks = _merge_diag_blocks(nodes, min(p.core_len, 16))
        if len(blocks) > p.max_nodes:
            # keep the longest blocks (explore-depth style suppression)
            blocks = blocks[np.argsort(blocks[:, 2])[::-1][: p.max_nodes]]
        # split blocks by target entry so paths never span entries
        ent = np.searchsorted(starts, blocks[:, 1], side="right") - 1 if len(
            blocks
        ) else np.zeros(0, int)
        for e in np.unique(ent):
            eb = blocks[ent == e]
            for score, chain in _chain_blocks(eb, p):
                rows = eb[np.asarray(chain)]
                qstart = int(rows[0][0])
                qend = int(rows[-1][0] + rows[-1][2])
                if (qend - qstart) * 100 < p.min_aligned_pct * qsize:
                    continue
                tstart = int(rows[0][1])
                tend = int(rows[-1][1] + rows[-1][2])
                e0 = int(starts[e])
                path = BlitzPath(
                    qname=qname, qsize=qsize, strand=strand,
                    qstart=qstart, qend=qend,
                    tname=didx.entry_names[int(e)],
                    tsize=int(starts[e + 1] - e0),
                    tstart=tstart - e0, tend=tend - e0,
                    score=score,
                    matches=int(rows[:, 2].sum()),
                    block_sizes=[int(x) for x in rows[:, 2]],
                    q_starts=[int(x) for x in rows[:, 0]],
                    t_starts=[int(x - e0) for x in rows[:, 1]],
                )
                out.append(path)
    out.sort(key=lambda x: -x.score)
    return out[: p.max_paths]


# ---------------------------------------------------------------- output --

PSL_HEADER = (
    "psLayout version 3\n\n"
    "match\tmis- \trep. \tN's\tQ gap\tQ gap\tT gap\tT gap\tstrand\tQ        "
    "\tQ   \tQ    \tQ  \tT        \tT   \tT    \tT  \tblock\tblockSizes "
    "\tqStarts\t tStarts\n"
    "     \tmatch\tmatch\t   \tcount\tbases\tcount\tbases\t      \tname     "
    "\tsize\tstart\tend\tname     \tsize\tstart\tend\tcount\n"
    + "-" * 159 + "\n"
)


def psl_row(p: BlitzPath) -> str:
    qnum_ins = tnum_ins = qbase_ins = tbase_ins = 0
    for i in range(1, len(p.block_sizes)):
        dq = p.q_starts[i] - (p.q_starts[i - 1] + p.block_sizes[i - 1])
        dt = p.t_starts[i] - (p.t_starts[i - 1] + p.block_sizes[i - 1])
        if dq > 0:
            qnum_ins += 1
            qbase_ins += dq
        if dt > 0:
            tnum_ins += 1
            tbase_ins += dt
    # PSL: for '-' strand, qStarts are in rc-query coords (BLAT convention)
    return "\t".join(
        str(x)
        for x in (
            p.matches, 0, 0, 0, qnum_ins, qbase_ins, tnum_ins, tbase_ins,
            p.strand, p.qname, p.qsize,
            p.qstart if p.strand == "+" else p.qsize - p.qend,
            p.qend if p.strand == "+" else p.qsize - p.qstart,
            p.tname, p.tsize, p.tstart, p.tend,
            len(p.block_sizes),
            ",".join(map(str, p.block_sizes)) + ",",
            ",".join(map(str, p.q_starts)) + ",",
            ",".join(map(str, p.t_starts)) + ",",
        )
    )


def pslx_row(p: BlitzPath, didx: DeviceIndex, q: np.ndarray) -> str:
    """PSLX = PSL + per-block query and target sequences (Blitz.h:84-91
    eBLZRsltsPSLX role)."""
    starts = np.asarray(jax.device_get(didx.entry_starts))
    genome = np.asarray(jax.device_get(didx.genome))
    e0 = int(starts[didx.entry_names.index(p.tname)])
    qs = q if p.strand == "+" else revcomp(q)
    qseqs, tseqs = [], []
    for qstart, tstart, bl in zip(p.q_starts, p.t_starts, p.block_sizes):
        qseqs.append(
            codes_to_ascii(qs[qstart : qstart + bl]).decode().lower()
        )
        tseqs.append(
            codes_to_ascii(
                genome[e0 + tstart : e0 + tstart + bl]
            ).decode().lower()
        )
    return (psl_row(p) + "\t" + ",".join(qseqs) + ",\t"
            + ",".join(tseqs) + ",")


def bed_row(p: BlitzPath) -> str:
    sizes = ",".join(map(str, p.block_sizes)) + ","
    rel = ",".join(str(t - p.tstart) for t in p.t_starts) + ","
    return "\t".join(
        str(x)
        for x in (
            p.tname, p.tstart, p.tend, p.qname, min(p.score, 1000), p.strand,
            p.tstart, p.tend, 0, len(p.block_sizes), sizes, rel,
        )
    )


def maf_block(p: BlitzPath, didx: DeviceIndex, q: np.ndarray) -> str:
    starts = np.asarray(jax.device_get(didx.entry_starts))
    genome = np.asarray(jax.device_get(didx.genome))
    e0 = int(starts[didx.entry_names.index(p.tname)])
    tseq = codes_to_ascii(
        genome[e0 + p.tstart : e0 + p.tend]
    ).decode()
    qs = q if p.strand == "+" else revcomp(q)
    qseq = codes_to_ascii(qs[p.qstart : p.qend]).decode()
    return (
        f"a score={p.score}\n"
        f"s {p.tname} {p.tstart} {p.tend - p.tstart} + {p.tsize} {tseq}\n"
        f"s {p.qname} {p.qstart} {p.qend - p.qstart} {p.strand} {p.qsize} "
        f"{qseq}\n\n"
    )
