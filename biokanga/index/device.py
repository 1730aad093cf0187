"""Device-resident index arrays (HBM) + transfer from the host build."""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.extend_packed import PackedGenome, pack_genome
from .build import GenomeIndex

# pos_sorted is padded by this many slots so candidate runs can be read with
# contiguous dynamic slices (no per-element clip); engines assert H <= this.
MAX_CAND_PER_CORE = 4096


@dataclass
class DeviceIndex:
    """HBM-resident arrays of a GenomeIndex (single shard).

    The sharded multi-chip variant lives in biokanga/parallel/.
    """

    genome: jax.Array        # (n,) int8
    entry_starts: jax.Array  # (E+1,) int32 (single shard < 2^31 bases)
    pos_rows: jax.Array      # (ceil(n+pad)/64, 64) int32 tail-padded sorted
    #                          positions in 64-int rows — fast aligned gathers
    key_hi: jax.Array        # (n,) uint32
    key_lo: jax.Array        # (n,) uint32
    lut: jax.Array           # (4^P+1,) int32
    lut_bases: int
    entry_names: list[str]
    packed: PackedGenome | None = None  # 2-bit row-packed genome (fast path)
    # ceil(log2(max LUT bucket + 1)) + 1 — static binary-search trip bound
    max_bsearch_steps: int = 31
    # genome-range chunk ownership limit (traced int32 scalar): alignments
    # must START at a local offset < owned; None = whole index owned
    # (biokanga/index/chunked.py sets this for multi-chunk genomes)
    owned: jax.Array | None = None
    # length of the whole genome when this index is one chunk of it: the
    # core-length ladder follows the genome's size, not the chunk's
    # (Aligner.cpp:8722-8741); None = this index is the whole genome
    genome_len: int | None = None

    @property
    def total_len(self) -> int:
        return int(self.genome.shape[0])

    @property
    def ladder_len(self) -> int:
        """Genome length the seed-core ladder is derived from."""
        return self.total_len if self.genome_len is None else self.genome_len

    @property
    def pos_sorted(self) -> jax.Array:
        """Flat view of the tail-padded sorted positions (first total_len
        entries are the real suffix order)."""
        return self.pos_rows.reshape(-1)


def to_device(idx: GenomeIndex, device=None, pack: bool = True) -> DeviceIndex:
    put = lambda a: jax.device_put(np.asarray(a), device)
    packed = None
    if pack:
        pg = pack_genome(idx.codes)
        packed = PackedGenome(
            rows=put(pg.rows),
            n_rows=None if pg.n_rows is None else put(pg.n_rows),
            length=pg.length,
        )
    pos_padded = np.concatenate(
        [idx.pos_sorted.astype(np.int32),
         np.zeros(MAX_CAND_PER_CORE, np.int32)]
    )
    n_rows64 = len(pos_padded) // 64
    pos_rows = pos_padded[: n_rows64 * 64].reshape(n_rows64, 64)
    max_bucket = int(np.diff(idx.lut.astype(np.int64)).max())
    steps = max(1, int(np.ceil(np.log2(max_bucket + 1))) + 1)
    return DeviceIndex(
        genome=put(idx.codes),
        entry_starts=put(idx.entry_starts.astype(np.int32)),
        pos_rows=put(pos_rows),
        key_hi=put(idx.key_hi),
        key_lo=put(idx.key_lo),
        lut=put(idx.lut.astype(np.int32)),
        lut_bases=idx.lut_bases,
        entry_names=list(idx.entry_names),
        packed=packed,
        max_bsearch_steps=steps,
    )
