"""K-mer rank arithmetic from base codes, as torch ops (port of
``dnascent_tpu/ops/seqcodes.py``).

Base codes are A=0, T=1, G=2, C=3 with 255 marking non-ACGT (the u8 view of
``utils.seqtools.encode_bases``' -1).  A rank is the base-4 big-endian value
of the k window; a window holding a non-ACGT base gets rank 0, the pipelines'
``where(rank < 0, 0, rank)`` default (data_IO.cpp:131).  The 2-bit packing
and f16 uploads of the JAX package were transfer savings for a remote link
and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ranks_from_codes(codes: torch.Tensor, k: int = 9) -> torch.Tensor:
    """(..., L) u8 base codes -> (..., L-k+1) i64 ranks (0 where the window
    holds a non-ACGT base)."""
    n = codes.shape[-1] - k + 1
    bad = codes == 255
    safe = torch.where(bad, torch.zeros_like(codes), codes).long()
    r = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.long,
                    device=codes.device)
    anybad = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.bool,
                         device=codes.device)
    for i in range(k):
        r = r + (safe[..., i : i + n] << (2 * (k - 1 - i)))
        anybad = anybad | bad[..., i : i + n]
    return torch.where(anybad, torch.zeros_like(r), r)


def flat_ranks_from_codes(codes_flat: torch.Tensor, k: int = 9) -> torch.Tensor:
    """Flat u8 code stream -> same-length rank stream (tail k-1 entries 0).
    Per-read segments must carry their k-1 trailing bases so ranks never mix
    reads."""
    return F.pad(ranks_from_codes(codes_flat, k), (0, k - 1))


def core_index_from_ranks(ranks: torch.Tensor) -> torch.Tensor:
    """9-mer rank -> CNN core-sequence index (digits 2..6, +1)."""
    return ((ranks >> 4) & 1023) + 1


def residual_index_from_ranks(ranks: torch.Tensor) -> torch.Tensor:
    """9-mer rank -> CNN residual-sequence index (digits 0,1,7,8, +1)."""
    return (((ranks >> 16) & 3) * 64 + ((ranks >> 14) & 3) * 16
            + ((ranks >> 2) & 3) * 4 + (ranks & 3) + 1)


def center_is_t_from_ranks(ranks: torch.Tensor) -> torch.Tensor:
    """9-mer rank -> centre base (digit 4) == T."""
    return ((ranks >> 8) & 3) == 1
