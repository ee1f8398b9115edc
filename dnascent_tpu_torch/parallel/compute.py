"""Device sets: the devices a run's batches go to (port of
``dnascent_tpu/parallel/compute.py``).

The JAX package shards each batch's rows over a 1-D ``('data',)`` mesh and
lets GSPMD partition the program.  The port keeps every batch whole and
sends batch *i* to device *i mod N* (``pipeline/detect.run_batches``), each
device with its own batches in flight.  Every batch then runs the kernels
and the CNN at the shapes it has on one device, so N devices give the
one-device output byte for byte by construction: no split changes the
shapes the CNN sees, so cuDNN picks the same algorithms.

A device set is an ordered list of ``torch.device``s, where an entry may
repeat (two replicas on one device).  :func:`device_set` builds it from
``--devices``:

* ``all``: every visible CUDA device;
* ``N``: ``cuda:0`` to ``cuda:N-1``; N above the visible count is an error
  (the JAX package truncates to the devices it has);
* with ``--device cpu``, N replicas on the CPU, the form the tests run
  (``all`` gives one).

Per-device state, the CNN module and the pore-model table, is placed once
on each distinct device of the set (:func:`per_device`,
:func:`replicate_module`).
"""

from __future__ import annotations

import copy
from typing import Callable, Union

import torch

from .. import device as devmod

DeviceLike = Union[str, torch.device, list, tuple]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device's index, so one card has one
    name (the name its tensors report)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def as_devices(device: DeviceLike) -> list[torch.device]:
    """The device set of one device or of a list of them, each resolved
    (a CUDA device must exist)."""
    items = device if isinstance(device, (list, tuple)) else [device]
    devices = [_indexed(devmod.resolve(d)) for d in items]
    if not devices:
        raise ValueError("a device set needs at least one device")
    return devices


def _count(spec) -> int:
    try:
        n = int(spec)
    except (TypeError, ValueError):
        raise ValueError(f"--devices takes 'all' or a positive count, got "
                         f"{spec!r}") from None
    if n < 1:
        raise ValueError(f"--devices takes 'all' or a positive count, got {n}")
    return n


def device_set(devices=None, device="cuda") -> list[torch.device]:
    """The device set of ``--devices`` (None, ``"all"`` or a count) on the
    kind of ``device``.  None gives ``device`` alone."""
    base = devmod.resolve(device)
    if devices is None:
        return as_devices(base)
    if base.type == "cpu":
        return [base] * (1 if devices == "all" else _count(devices))
    if base.index is not None:
        raise ValueError(f"--devices picks cuda:0 onwards; give --device "
                         f"cuda, not {base}")
    visible = torch.cuda.device_count()
    n = visible if devices == "all" else _count(devices)
    if n > visible:
        raise ValueError(f"--devices {n}: only {visible} CUDA device(s) "
                         "visible")
    return [torch.device("cuda", i) for i in range(n)]


def per_device(devices: list, make: Callable[[torch.device], object]) -> dict:
    """{device: make(device)} over the distinct devices of a set."""
    return {d: make(d) for d in dict.fromkeys(devices)}


def module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def replicate_module(module: torch.nn.Module, devices: list) -> dict:
    """{device: the module on it}: ``module`` itself on the device it lives
    on, a copy on each other distinct device of the set."""
    home = module_device(module)
    return per_device(devices, lambda d: module if d == home
                      else copy.deepcopy(module).to(d))
