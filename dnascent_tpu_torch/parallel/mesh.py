"""Process groups, input sharding and the multi-device CNN programs (port
of ``dnascent_tpu/parallel/mesh.py``).

The reference's only parallelism is OpenMP threads over reads plus one
pinned GPU (reference: src/detect.cpp:852, src/tensor.cpp:78-82).  The JAX
package adds SPMD over a ``('data', 'seq')`` mesh; the port keeps what it
computes:

* processes join a ``torch.distributed`` gloo group
  (:func:`init_distributed`); inputs are assigned per process
  (:func:`shard_files_for_host`) and shard outputs merged deterministically
  (``merge.py``);
* :func:`data_parallel_train_step`: one training step with the batch's rows
  split over a device set, one model replica a device, the gradients
  summed onto the first device, then one optimizer step;
* :func:`sequence_sharded_apply`: the CNN over a position axis split over a
  device set, each shard widened by a halo of real neighbouring positions
  (the conv stack's receptive field is local), then cropped and joined.

Both CNN programs run in one process, as the JAX mesh does.
"""

from __future__ import annotations

import atexit
import copy
import os
from typing import Optional

import numpy as np
import torch

from .compute import DeviceLike, as_devices, module_device, \
    replicate_module


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: int = 1,
                     process_id: Optional[int] = None) -> int:
    """Join the gloo process group whose rank 0 listens at ``coordinator``
    (``host:port``) as process ``process_id`` of ``num_processes``, and
    return the process index.  Without ``process_id`` the index is ``RANK``
    from the environment, as torch's launchers set it; without either, an
    error.  Without a coordinator nothing is joined and the index is
    ``process_id`` (0 when None).  The group is destroyed at exit."""
    if coordinator is None:
        return 0 if process_id is None else process_id
    if process_id is None:
        rank = os.environ.get("RANK")
        if rank is None:
            raise ValueError("--coordinator needs --procid (or RANK in the "
                             "environment, as torch's launchers set it)")
        process_id = int(rank)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process index {process_id} outside [0, "
                         f"{num_processes})")
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    atexit.register(shutdown_distributed)
    return process_id


def shutdown_distributed() -> None:
    """Destroy the process group, if this process joined one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_files_for_host(paths: list, process_index: Optional[int] = None,
                         process_count: Optional[int] = None) -> list:
    """Deterministic per-process input assignment (shard by file): every
    ``process_count``-th of the sorted paths from ``process_index``, which
    default to the process group's rank and size (0 and 1 without one)."""
    import torch.distributed as dist
    grouped = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (
        dist.get_rank() if grouped else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if grouped else 1)
    return [p for i, p in enumerate(sorted(paths)) if i % pc == pi]


def _rows(batch: dict, lo: int, hi: int, dev) -> dict:
    return {k: torch.as_tensor(v[lo:hi]).to(dev) for k, v in batch.items()}


def data_parallel_train_step(model: torch.nn.Module, optimizer,
                             devices: DeviceLike):
    """A training step over the device set ``devices`` (the first is the
    device ``model`` lives on; an entry may repeat): ``step(batch)`` splits
    the batch's rows (a dict of core, residual, signal, labels and mask
    arrays, host or torch) over one replica of ``model`` a device, sums the
    masked negative log-probabilities of the labels and their gradients
    onto the first device, divided by the whole batch's mask count (the
    global mask-weighted mean of ``mesh.py``'s loss), takes one
    ``optimizer`` step on ``model`` and returns the loss (a 0-dim tensor on
    the first device).  The replicas take ``model``'s weights at the start
    of every step."""
    from ..pipeline.traincnn import masked_nll

    devices = as_devices(devices)
    home = module_device(model)
    if devices[0] != home:
        raise ValueError(f"the model lives on {home}, the device set starts "
                         f"at {devices[0]}")
    replicas = [model] + [copy.deepcopy(model).to(d) for d in devices[1:]]

    def step(batch: dict) -> torch.Tensor:
        with torch.no_grad():
            for r in replicas[1:]:
                for dst, src in zip(r.state_dict().values(),
                                    model.state_dict().values()):
                    dst.copy_(src)
        for r in replicas:
            r.zero_grad(set_to_none=True)
        n = len(next(iter(batch.values())))
        count = max(float(torch.as_tensor(batch["mask"]).sum()), 1.0)
        loss = torch.zeros((), device=home)
        bounds = np.linspace(0, n, len(replicas) + 1).astype(int)
        for r, dev, lo, hi in zip(replicas, devices, bounds[:-1], bounds[1:]):
            if hi <= lo:
                continue
            total, _ = masked_nll(r, _rows(batch, lo, hi, dev))
            part = total / count
            part.backward()
            loss = loss + part.detach().to(home)
        for r in replicas[1:]:
            for p, q in zip(model.parameters(), r.parameters()):
                if q.grad is None:
                    continue
                g = q.grad.to(home)
                p.grad = g if p.grad is None else p.grad + g
        optimizer.step()
        return loss

    return step


def sequence_sharded_apply(model: torch.nn.Module, devices: DeviceLike,
                           halo: Optional[int] = None):
    """``apply(core_idx, residual_idx, signal)``: ``model`` over (B, L)
    inputs whose position axis is split into one contiguous shard a device
    of ``devices``.  Each shard runs on its device's replica widened by
    ``halo`` real positions on each side (clipped at the sequence ends,
    where the convolutions' own zero padding applies), is cropped back to
    its core and joined on the first device: the unsharded output, for a
    receptive field of at most 2 * halo + 1.  ``halo`` defaults to half the
    model's ``receptive_field()``."""
    devices = as_devices(devices)
    replicas = replicate_module(model, devices)
    if halo is None:
        halo = model.receptive_field() // 2
    home = devices[0]

    def apply(core_idx, residual_idx, signal) -> torch.Tensor:
        L = core_idx.shape[1]
        bounds = np.linspace(0, L, len(devices) + 1).astype(int)
        outs = []
        for dev, a, b in zip(devices, bounds[:-1], bounds[1:]):
            if b <= a:
                continue
            lo, hi = max(0, a - halo), min(L, b + halo)
            part = replicas[dev](*(torch.as_tensor(x)[:, lo:hi].to(dev)
                                   for x in (core_idx, residual_idx, signal)))
            outs.append(part[:, a - lo : b - lo].to(home))
        return torch.cat(outs, dim=1)

    return apply
