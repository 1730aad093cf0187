"""Base encoding.

Design: a flat 3-bit-in-int8 "code" alphabet on device (A=0, C=1, G=2, T=3,
N=4) instead of the reference's 4-bit nibble `etSeqBase` model
(reference: libbiokanga/commdefs.h:108-124).  int8 code arrays are what the
VPU compares; 2-bit *packed* forms (16 bases / uint32) are used only for
index keys and HBM-compact storage.

N semantics: any comparison involving a code >= 4 counts as a mismatch
(the reference's eBaseN never matches in its extension loops).
"""
from __future__ import annotations

import numpy as np

# Device/host code values
A, C, G, T, N = 0, 1, 2, 3, 4
CODE_DTYPE = np.int8

# ASCII -> code translation table (uppercase+lowercase; everything else -> N).
_ASCII2CODE = np.full(256, N, dtype=np.int8)
for _ch, _code in (("A", A), ("C", C), ("G", G), ("T", T), ("U", T)):
    _ASCII2CODE[ord(_ch)] = _code
    _ASCII2CODE[ord(_ch.lower())] = _code

_CODE2ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement: A<->T, C<->G, N->N
_COMP = np.array([T, G, C, A, N], dtype=np.int8)


def ascii_to_codes(seq: bytes | bytearray | np.ndarray) -> np.ndarray:
    """ASCII sequence bytes -> int8 code array (vectorised table lookup)."""
    if isinstance(seq, (bytes, bytearray)):
        arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        arr = np.asarray(seq, dtype=np.uint8)
    return _ASCII2CODE[arr]


def codes_to_ascii(codes: np.ndarray) -> bytes:
    codes = np.asarray(codes)
    return _CODE2ASCII[np.clip(codes, 0, 4)].tobytes()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of an int8 code array (host, numpy)."""
    return _COMP[np.clip(codes[..., ::-1], 0, 4)]


# bisulfite collapse tables (SfxArrayV2.cpp:440-459 builds the collapsed
# index copies at SfxBlock2Disk time): CT maps C->T, GA maps G->A
_CT = np.array([A, T, G, T, N], dtype=np.int8)
_GA = np.array([A, C, A, T, N], dtype=np.int8)


def ct_collapse(codes: np.ndarray) -> np.ndarray:
    """Bisulfite C->T collapse (unmethylated-C conversion space)."""
    return _CT[np.clip(codes, 0, 4)]


def ga_collapse(codes: np.ndarray) -> np.ndarray:
    """Bisulfite G->A collapse (the reverse-strand conversion space)."""
    return _GA[np.clip(codes, 0, 4)]


def to_colorspace(codes: np.ndarray) -> np.ndarray:
    """SOLiD colorspace transform of a base-code sequence: color[i] =
    dibase code of (b[i], b[i+1]), which under A=0,C=1,G=2,T=3 is the XOR
    of the two base codes (the reference's colorspace index transform,
    SfxArrayV2.cpp:300-380).  Length L -> L-1; any step touching an N
    yields 4 (no-call '.').  Colors are strand-symmetric: the colorspace
    of the reverse complement is the reversed color string."""
    c = np.asarray(codes, dtype=np.int8)
    a, b = c[:-1], c[1:]
    valid = (a >= 0) & (a < 4) & (b >= 0) & (b < 4)
    return np.where(valid, a ^ b, 4).astype(np.int8)


def revcomp_jnp(codes):
    """Reverse complement on device: A<->T, C<->G via (3 - c), N stays N."""
    import jax.numpy as jnp

    flipped = codes[..., ::-1]
    return jnp.where(flipped >= 4, flipped, 3 - flipped).astype(codes.dtype)


def pack_kmers_u32(codes: np.ndarray, k: int, starts: np.ndarray) -> np.ndarray:
    """Pack k (<=16) bases starting at each position in `starts` into uint32.

    Base at the start position occupies the MOST significant 2 bits so that
    integer order == lexicographic order of the k-mer (the property the index
    range queries rely on). Codes >= 4 (N) are packed as 0 (A); callers mask
    or reject N-containing matches at extension time.
    """
    assert 1 <= k <= 16
    out = np.zeros(starts.shape, dtype=np.uint32)
    n = codes.shape[0]
    for j in range(k):
        idx = starts + j
        base = np.where(idx < n, codes[np.minimum(idx, n - 1)], 0).astype(np.uint32)
        base = np.where(base >= 4, 0, base)
        out |= base << np.uint32(2 * (15 - j))
    return out


def pack_query_u32(codes: np.ndarray, k: int):
    """Pack the first k (<=16) bases of a 1-D query into (lo_key, hi_key).

    lo_key = pad bits 0 (minimum 16-mer with this k-prefix),
    hi_key = pad bits 1 (maximum 16-mer with this k-prefix).
    """
    assert 1 <= k <= 16
    key = 0
    for j in range(k):
        b = int(codes[j])
        if b >= 4:
            b = 0
        key |= b << (2 * (15 - j))
    pad_mask = (1 << (2 * (16 - k))) - 1
    return np.uint32(key), np.uint32(key | pad_mask)
