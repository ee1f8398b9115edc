"""Entry points of the port (counterpart of the root
``__graft_entry__.py``, which serves the JAX package).

``entry(device)``             the forward of the shipping CNN (DetectCNN)
                              with example inputs on ``device``.
``dryrun_multichip(n, device)`` checks the port's two multi-device programs
                              over a device set of n replicas
                              (``parallel/compute.device_set``): one
                              data-parallel training step of a small
                              DetectCNN gives a finite loss, and detect with
                              the reference topology over two read-length
                              buckets on the n devices equals one device's
                              output bitwise.

Both run on the card unless the caller asks for the CPU; on ``cuda`` with
fewer visible cards than n, ``dryrun_multichip`` raises.
"""

from __future__ import annotations

import numpy as np
import torch

# the small DetectCNN of the JAX multi-chip training step
# (__graft_entry__.py:68-69)
TRAIN_CNN = dict(d_model=64, d_core=16, d_residual=8, d_signal=16,
                 dilations=(1, 2))


def entry(device="cuda"):
    """(fn, (core, resid, signal)): ``fn`` the DetectCNN forward (seeded
    untrained weights, eval mode, no autograd) and its inputs at B=4,
    L=512, drawn as the JAX entry draws them, on ``device``."""
    from . import device as devmod
    from .models import cnn

    dev = devmod.resolve(device)
    model = cnn.init_untrained(cnn.DetectCNN(), seed=0).to(dev).eval()
    B, L = 4, 512
    rng = np.random.default_rng(0)
    core = torch.as_tensor(rng.integers(1, 1025, size=(B, L)),
                           dtype=torch.int32, device=dev)
    resid = torch.as_tensor(rng.integers(1, 257, size=(B, L)),
                            dtype=torch.int32, device=dev)
    signal = torch.as_tensor(rng.normal(0, 1, size=(B, L, cnn.RAWDEPTH)),
                             dtype=torch.float32, device=dev)

    @torch.no_grad()
    def fn(core, resid, signal):
        return model(core, resid, signal)

    return fn, (core, resid, signal)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run both multi-device programs over ``n_devices`` replicas of
    ``device`` and raise on any failure: (1) one
    ``mesh.data_parallel_train_step`` of the small DetectCNN gives a finite
    loss; (2) ``detect_reads`` with the reference topology over reads of
    1200 and 2600 bp (``n_devices`` each, seeds 3 and 4, a batch a bucket)
    on the device set gives one device's read set, ``brdu_prob`` and
    ``ref_coords`` bitwise."""
    from .config import DNA_R10
    from .io.poremodel import synthetic_model_set
    from .models import cnn, reference_cnn
    from .parallel import compute, mesh
    from .pipeline.detect import detect_reads
    from .pipeline.source import SimulatedSource
    from .pipeline.traincnn import make_optimizer

    devices = compute.device_set(n_devices, device)

    # (1) the training step, at the JAX dry run's shapes (its batch over a
    # (data, seq) mesh; the port splits rows only)
    model = cnn.init_untrained(cnn.DetectCNN(**TRAIN_CNN), seed=0).to(
        devices[0])
    step = mesh.data_parallel_train_step(
        model, make_optimizer(model.parameters(), 1e-3), devices)
    n_seq = 2 if n_devices % 2 == 0 else 1
    B, L = max(8, (n_devices // n_seq) * 2), 64 * n_seq
    rng = np.random.default_rng(0)
    batch = {
        "core": rng.integers(1, 1025, size=(B, L)).astype(np.int32),
        "residual": rng.integers(1, 257, size=(B, L)).astype(np.int32),
        "signal": rng.normal(0, 1, size=(B, L, cnn.RAWDEPTH)).astype(
            np.float32),
        "labels": rng.integers(0, 3, size=(B, L)).astype(np.int32),
        "mask": np.ones((B, L), dtype=bool),
    }
    loss = float(step(batch))
    if not np.isfinite(loss):
        raise RuntimeError(f"data-parallel training step loss {loss}")

    # (2) detect over two CNN length buckets, the device set against one
    cfg = DNA_R10
    pore_models = synthetic_model_set(cfg)
    det = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(),
        reference_cnn.synthetic_tensors(0)).to(devices[0])

    def run_detect(devs):
        records = []
        for i, length in enumerate((1200, 2600)):
            records.extend(SimulatedSource(pore_models, cfg,
                                           n_reads=n_devices, length=length,
                                           seed=3 + i))
        return dict(detect_reads(records, pore_models, det, cfg, device=devs,
                                 batch_size=n_devices, pipeline_depth=1))

    sharded = run_detect(devices)
    if not sharded:
        raise RuntimeError("detect on the device set produced no reads")
    single = run_detect(devices[0])
    if set(sharded) != set(single):
        raise RuntimeError("detect read set on the device set != one device")
    for rid in sharded:
        if not (np.array_equal(sharded[rid].brdu_prob, single[rid].brdu_prob)
                and np.array_equal(sharded[rid].ref_coords,
                                   single[rid].ref_coords)):
            raise RuntimeError(f"detect mismatch on {rid}")
