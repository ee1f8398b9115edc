"""Placement on one explicit device.

Each batch runs whole on one device named by the caller, so placement is a
copy to that device: a batch-row array and a table every row shares are
placed alike.  Runs over several devices send whole batches to each
(``parallel/compute.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.progress import span


def resolve(device) -> torch.device:
    """Validate a device argument; a CUDA device must exist (no silent CPU
    fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def put_rows(x, device) -> torch.Tensor:
    """Copy a host array to ``device``: a blocking copy from pageable
    memory, which on a card waits for the stream's queued work (an ``h2d``
    wait span)."""
    with span("h2d", wait=True):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def put_scalar(v: float, device) -> torch.Tensor:
    """A 0-d float32 tensor of ``v`` on ``device``: on a card a blocking
    copy as ``put_rows``'s (an ``h2d`` wait span)."""
    with span("h2d", wait=True):
        return torch.tensor(v, dtype=torch.float32, device=device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a host array, once the work that makes it is done
    (a ``readback`` wait span)."""
    with span("readback", wait=True):
        return t.cpu().numpy()

