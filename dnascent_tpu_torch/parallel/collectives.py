"""Cross-process gathers (port of ``dnascent_tpu/parallel/collectives.py``).

Two analyses need whole-dataset statistics when reads are sharded over
processes:

* **forkSense pass 1**: the 1-D 2-means over 2 kb call-fraction windows
  (reference: src/forkSense.cpp:1459-1615).  Each process computes its
  shard's fraction vectors; they are gathered with their global ordinals,
  so every process runs the same 2-means on the same, identically ordered
  global vector, which is the single-process vector by construction.
* **seeBreaks**: the read spans feed a mean+3σ filter and a seeded
  bootstrap (src/seeBreaks.cpp:288-350,537-539); they are gathered the same
  way before the statistics run.

What is gathered is host numpy, so the gathers ride ``torch.distributed``
with the gloo backend (TCP), on a card's host as on the CPU: NCCL needs one
GPU a rank and would move host data through the card for nothing.  With one
process (no process group, or a group of one) a gather is the stable
reorder alone, so sharded and unsharded runs take the same code path.
"""

from __future__ import annotations

import numpy as np


def process_count() -> int:
    """Processes in the run: the process group's size, 1 without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _all_gather(arr: np.ndarray) -> list[np.ndarray]:
    """Every process's ``arr`` (same shape and dtype on each), in rank
    order, carried as raw bytes so any dtype rides the gloo gather."""
    import torch
    import torch.distributed as dist
    raw = torch.from_numpy(
        np.ascontiguousarray(arr).view(np.uint8).reshape(-1))
    out = [torch.empty_like(raw) for _ in range(dist.get_world_size())]
    dist.all_gather(out, raw)
    return [o.numpy().view(arr.dtype).reshape(arr.shape) for o in out]


def gather_ordered(values: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Gather every process's rows and return the global rows sorted by
    ``keys`` (stable), the same on every process.

    ``values``: (n, ...) local rows; ``keys``: (n,) int64 global ordinals,
    unique across processes (a global read index, or one composed with a
    window index).  Shards are padded to the largest before the gather and
    cut back to their gathered lengths after it."""
    values = np.asarray(values)
    keys = np.asarray(keys, dtype=np.int64)
    if process_count() > 1:
        ns = np.concatenate(_all_gather(np.array([values.shape[0]],
                                                 dtype=np.int64)))
        m = int(ns.max())
        if m:
            pad_v = np.zeros((m,) + values.shape[1:], dtype=values.dtype)
            pad_v[: values.shape[0]] = values
            pad_k = np.full(m, -1, dtype=np.int64)
            pad_k[: keys.shape[0]] = keys
            values = np.concatenate([v[:n] for v, n in
                                     zip(_all_gather(pad_v), ns)])
            keys = np.concatenate([k[:n] for k, n in
                                   zip(_all_gather(pad_k), ns)])
    order = np.argsort(keys, kind="stable")
    return values[order]


def window_keys(read_ordinals, counts) -> np.ndarray:
    """Composite per-window ordinals: global read index in the high bits,
    within-read window index below (2^24 windows a read: a 2 kb window grid
    covers reads to 32 Gb)."""
    keys = []
    for o, c in zip(read_ordinals, counts):
        keys.append((np.int64(o) << 24) + np.arange(c, dtype=np.int64))
    return (np.concatenate(keys) if keys else np.empty(0, np.int64))


def barrier(name: str) -> None:
    """Wait until every process reaches this point (a no-op with one
    process).  ``name`` labels the point for readers, as the JAX package's
    barrier names it."""
    if process_count() > 1:
        import torch.distributed as dist
        dist.barrier()
