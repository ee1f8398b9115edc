"""The reference CNN trunk's epilogue (``csrc/trunk_epilogue.cu``): the
bias, BatchNorm, residual add, ReLU and cast to the next convolution's
dtype that follow each trunk convolution, in one pass.

It replaces no Pallas kernel (the JAX package leaves this glue to XLA); it
replaces the separate PyTorch ops of ``models/reference_cnn.py``'s module
chain and equals them bit for bit.  The wrapper runs the kernel for a CUDA
tensor and the plain twin below, those same ops, for a CPU tensor; any
other device, dtype, shape or layout raises.  There is no fallback from the
kernel to the twin.

A table is (5, C) f32, rows [bias, mean, inv, gamma, beta] with inv =
rsqrt(var + eps) as the module computes it, or (1, C), [bias] alone, for a
convolution without BatchNorm.  Three forms, chosen by the arguments:
``trunk_epilogue(y, table)`` with a (5, C) table (conv, BN, ReLU), with
``y2, table2`` as well (two convs, each with its BN, added, then ReLU) and
with a (1, C) table (conv, bias, ReLU).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

__all__ = ["trunk_epilogue", "trunk_epilogue_plain", "EPILOGUE_LAUNCHES",
           "TABLE_ROWS"]

EPILOGUE_LAUNCHES = cuda_lib.LaunchCounter()
TABLE_ROWS = 5   # bias, mean, inv, gamma, beta
_CONV_DTYPES = (torch.bfloat16, torch.float32)


def _affine(y: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``Conv`` then ``BatchNorm`` after the conv result, as the modules
    compute them."""
    v = y.float() + table[0][:, None]
    if table.shape[0] == 1:
        return v
    return ((v - table[1][:, None]) * table[2][:, None]
            * table[3][:, None] + table[4][:, None])


def trunk_epilogue_plain(y: torch.Tensor, table: torch.Tensor,
                         y2: Optional[torch.Tensor] = None,
                         table2: Optional[torch.Tensor] = None,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """The module chain's ops: ``relu(affine(y) [+ affine(y2)])`` cast to
    ``out_dtype`` (default: ``y``'s dtype)."""
    v = _affine(y, table)
    if y2 is not None:
        v = v + _affine(y2, table2)
    return torch.relu(v).to(out_dtype or y.dtype)


def _check_table(t: torch.Tensor, name: str, rows: tuple, C: int,
                 dev) -> None:
    if t.dim() != 2 or t.shape[0] not in rows:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"({' or '.join(map(str, rows))}, {C})")
    cuda_lib.check_tensor(t, name, torch.float32, (t.shape[0], C), dev)


def trunk_epilogue(y: torch.Tensor, table: torch.Tensor,
                   y2: Optional[torch.Tensor] = None,
                   table2: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The epilogue after a trunk convolution.  ``y`` contiguous (B, C, L)
    bf16 or f32 conv result; ``table`` its (5, C) or (1, C) f32 table;
    ``y2`` and its (5, C) ``table2``: the second operand of a block's join,
    of ``y``'s device, dtype and shape.  Returns (B, C, L) ``out_dtype``
    (``y``'s dtype, or f32)."""
    dev = y.device
    if y.dim() != 3 or y.dtype not in _CONV_DTYPES:
        raise ValueError(f"y must be (B, C, L) bf16 or f32, got "
                         f"{tuple(y.shape)} {y.dtype}")
    B, C, L = y.shape
    out_dtype = out_dtype or y.dtype
    if out_dtype not in (y.dtype, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} is neither {y.dtype} nor "
                        "torch.float32")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    _check_table(table, "table", (1, TABLE_ROWS) if y2 is None
                 else (TABLE_ROWS,), C, dev)
    if y2 is not None:
        if y2.device != dev or y2.dtype != y.dtype or y2.shape != y.shape \
                or not y2.is_contiguous():
            raise ValueError("y2 must match y's device, dtype, shape and "
                             "contiguity")
        if table2 is None:
            raise ValueError("y2 needs table2")
        _check_table(table2, "table2", (TABLE_ROWS,), C, dev)
    elif table2 is not None:
        raise ValueError("table2 without y2")
    if not cuda_lib.use_kernel(dev):
        return trunk_epilogue_plain(y, table, y2, table2, out_dtype)
    out = torch.empty((B, C, L), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    with cuda_lib.on_device(dev):
        err = cuda_lib.lib().dt_trunk_epilogue(
            y.data_ptr(), table.data_ptr(),
            None if y2 is None else y2.data_ptr(),
            None if table2 is None else table2.data_ptr(),
            B, C, L, int(table.shape[0] == TABLE_ROWS),
            int(y.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), out.data_ptr(),
            cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "trunk_epilogue")
    EPILOGUE_LAUNCHES.add()
    return out
