"""Sequence utilities: k-mer encoding, reverse complement, vectorised ranks
(a copy of the parts of ``dnascent_tpu/utils/seqtools.py`` the port calls).

Base encoding follows the reference convention A=0, T=1, G=2, C=3 with the
*leftmost* base most significant (reference: src/data_IO.cpp:129-141).
"""

from __future__ import annotations

import numpy as np

# A=0, T=1, G=2, C=3 (reference: data_IO.cpp:131); everything else -> -1
_BASE_CODE = np.full(256, -1, dtype=np.int8)
for b, v in [("A", 0), ("T", 1), ("G", 2), ("C", 3)]:
    _BASE_CODE[ord(b)] = v
    _BASE_CODE[ord(b.lower())] = v

# IUPAC reverse complement (reference: src/common.h:91-153)
_COMPLEMENT = {
    "A": "T", "T": "A", "G": "C", "C": "G", "U": "A",
    "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
    "B": "V", "V": "B", "D": "H", "H": "D", "N": "N", "-": "-",
}
_COMP_TABLE = np.arange(256, dtype=np.uint8)
for k, v in _COMPLEMENT.items():
    _COMP_TABLE[ord(k)] = ord(v)
    _COMP_TABLE[ord(k.lower())] = ord(v)


def encode_bases(seq: str) -> np.ndarray:
    """Sequence string -> int8 array of base codes (-1 for non-ACGT)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _BASE_CODE[raw]


def reverse_complement(seq: str) -> str:
    """IUPAC-aware reverse complement (reference: common.h:91-153)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _COMP_TABLE[raw][::-1].tobytes().decode("ascii")


def kmer2index(kmer: str, k: int | None = None) -> int:
    """Single-kmer rank, base-4 with A=0,T=1,G=2,C=3 (data_IO.cpp:129-141)."""
    if k is None:
        k = len(kmer)
    codes = encode_bases(kmer[:k])
    if (codes < 0).any():
        raise ValueError(f"kmer {kmer!r} contains non-ACGT characters")
    r = 0
    for c in codes:
        r = r * 4 + int(c)
    return r


def index2kmer(index: int, k: int) -> str:
    bases = "ATGC"
    out = []
    for _ in range(k):
        out.append(bases[index % 4])
        index //= 4
    return "".join(reversed(out))


def kmer_ranks(seq: str, k: int) -> np.ndarray:
    """Vectorised ranks of every k-mer of ``seq``.

    Returns int64 array of length ``len(seq)-k+1``; positions whose k-mer
    contains a non-ACGT base get rank -1.
    """
    codes = encode_bases(seq).astype(np.int64)
    n = codes.size - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    bad = codes < 0
    safe = np.where(bad, 0, codes)
    ranks = np.zeros(n, dtype=np.int64)
    for i in range(k):
        ranks += safe[i : i + n] << (2 * (k - 1 - i))
    anybad = np.zeros(n, dtype=bool)
    for i in range(k):
        anybad |= bad[i : i + n]
    ranks[anybad] = -1
    return ranks


def core_index_from_codes(codes: np.ndarray) -> np.ndarray:
    """CNN 'core' sequence index of 9-mers given per-position base codes.

    The core is the middle 5-mer (positions 2..6 of the 9-mer), encoded base-4
    then +1 so that 0 stays a padding value (reference: src/reads.h:112-124).
    ``codes`` has shape (..., 9).
    """
    core = codes[..., 2:7]
    r = np.zeros(core.shape[:-1], dtype=np.int64)
    for i in range(5):
        r = r * 4 + core[..., i]
    return r + 1


def residual_index_from_codes(codes: np.ndarray) -> np.ndarray:
    """CNN 'residual' sequence index: outer bases 0,1,7,8 of the 9-mer,
    base-4 encoded then +1 (reference: src/reads.h:125-138)."""
    res = np.concatenate([codes[..., 0:2], codes[..., 7:9]], axis=-1)
    r = np.zeros(res.shape[:-1], dtype=np.int64)
    for i in range(4):
        r = r * 4 + res[..., i]
    return r + 1

