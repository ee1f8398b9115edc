"""Wrapper for kernel F (the reference CNN's GRU signal encoder), port of
``dnascent_tpu/models/reference_cnn.py``'s ``_gru_scan_pallas``.

The wrapper runs the kernel for a CUDA tensor and its plain twin (imported
here from ``ops/gru.py``) for a CPU tensor; any other device, dtype, shape
or layout raises.  There is no fallback from the kernel to the twin.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .gru import GRU_UNITS, PACKED_SIZE, gru_encoder_plain
from ..models.cnn import SIG_QUANT_LO, SIG_QUANT_SCALE

__all__ = ["gru_encoder", "gru_encoder_plain", "LAUNCHES"]

LAUNCHES = cuda_lib.LaunchCounter()


def gru_encoder(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """GRU encoder (kernel F).  ``xq`` (N, T) u8 quantised samples (0 =
    padding), ``w`` the (PACKED_SIZE,) f32 vector of ``gru.pack_weights``.
    Returns the second cell's final state, (N, 16) f32."""
    dev = xq.device
    N, T = xq.shape
    cuda_lib.check_tensor(xq, "xq", torch.uint8, (N, T), dev)
    cuda_lib.check_tensor(w, "w", torch.float32, (PACKED_SIZE,), dev)
    if not cuda_lib.use_kernel(dev):
        return gru_encoder_plain(xq, w)
    if N == 0 or T == 0:
        return torch.zeros((N, GRU_UNITS), dtype=torch.float32, device=dev)
    out = torch.empty((N, GRU_UNITS), dtype=torch.float32, device=dev)
    with cuda_lib.on_device(dev):
        err = cuda_lib.lib().dt_gru_encoder(
            xq.data_ptr(), w.data_ptr(), N, T, SIG_QUANT_SCALE, SIG_QUANT_LO,
            out.data_ptr(), cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "gru_encoder")
    LAUNCHES.add()
    return out
