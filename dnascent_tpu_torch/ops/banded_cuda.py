"""Wrappers for kernels A (banded fill) and B (backtrace chase), port of
``dnascent_tpu/ops/banded_pallas.py``'s lean fill and chase.

A wrapper runs the kernel for a CUDA tensor and its plain twin (imported
here from ``ops/banded.py``) for a CPU tensor; any other device, dtype,
shape or layout raises.  There is no fallback from the kernel to the twin.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .banded import (backtrace_moves_plain, banded_fill_plain, chase_rows,
                     lean_scalars, n_fill_steps)

__all__ = ["banded_fill_lean", "backtrace_moves", "banded_fill_plain",
           "backtrace_moves_plain", "FILL_LAUNCHES", "CHASE_LAUNCHES"]

FILL_LAUNCHES = cuda_lib.LaunchCounter()
CHASE_LAUNCHES = cuda_lib.LaunchCounter()


def banded_fill_lean(events: torch.Tensor, mu: torch.Tensor,
                     n_events: torch.Tensor, n_kmers: torch.Tensor, *,
                     inv_sigma: float, lp_const: float, bandwidth: int = 100,
                     epsilon_skip: float = 1e-30, p_trim: float = 0.01):
    """Static-stdv banded fill (kernel A).  ``events`` (B, E) f32 scaled
    event means, ``mu`` (B, K) f32 model means (+inf = undefined k-mer),
    ``n_events``/``n_kmers`` (B,) i32.  Returns (trace (S, B, W) u8, rights
    (S, B) u8, best_event (B,) i32, best_score (B,) f32)."""
    dev = events.device
    B, E = events.shape
    K = mu.shape[1]
    cuda_lib.check_tensor(events, "events", torch.float32, (B, E), dev)
    cuda_lib.check_tensor(mu, "mu", torch.float32, (B, K), dev)
    cuda_lib.check_tensor(n_events, "n_events", torch.int32, (B,), dev)
    cuda_lib.check_tensor(n_kmers, "n_kmers", torch.int32, (B,), dev)
    kw = dict(inv_sigma=inv_sigma, lp_const=lp_const,
              epsilon_skip=epsilon_skip, p_trim=p_trim)
    if not cuda_lib.use_kernel(dev):
        return banded_fill_plain(events, mu, n_events, n_kmers,
                                 bandwidth=bandwidth, **kw)
    if not 2 <= bandwidth <= 128:
        raise ValueError(f"bandwidth {bandwidth} outside the kernel's 2..128")
    lp_stay, lp_step, lp_skip, lp_trim, h_c = lean_scalars(
        n_events, n_kmers, **kw)
    W = bandwidth
    S = n_fill_steps(E, K)
    trace = torch.empty((S, B, W), dtype=torch.uint8, device=dev)
    rights = torch.empty((S, B), dtype=torch.uint8, device=dev)
    best_event = torch.empty(B, dtype=torch.int32, device=dev)
    best_score = torch.empty(B, dtype=torch.float32, device=dev)
    lib = cuda_lib.lib()
    err = lib.dt_banded_fill_lean(
        events.data_ptr(), mu.data_ptr(), n_events.data_ptr(),
        n_kmers.data_ptr(), lp_stay.data_ptr(), lp_step.data_ptr(),
        B, E, K, W, S, lp_skip, lp_trim, h_c, trace.data_ptr(),
        rights.data_ptr(), best_event.data_ptr(), best_score.data_ptr(),
        cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "banded_fill_lean")
    FILL_LAUNCHES.add()
    return trace, rights, best_event, best_score


def backtrace_moves(trace: torch.Tensor, rights: torch.Tensor,
                    best_event: torch.Tensor, n_kmers: torch.Tensor,
                    bandwidth: int = 100) -> torch.Tensor:
    """Backtrace chase (kernel B) -> (Sp, B) u8 band-ordered move stream
    with PAD gaps, Sp = S rounded up to a multiple of 4."""
    dev = trace.device
    S, B, W = trace.shape
    if W != bandwidth:
        raise ValueError(f"trace width {W} != bandwidth {bandwidth}")
    cuda_lib.check_tensor(trace, "trace", torch.uint8, (S, B, W), dev)
    cuda_lib.check_tensor(rights, "rights", torch.uint8, (S, B), dev)
    cuda_lib.check_tensor(best_event, "best_event", torch.int32, (B,), dev)
    cuda_lib.check_tensor(n_kmers, "n_kmers", torch.int32, (B,), dev)
    if not cuda_lib.use_kernel(dev):
        return backtrace_moves_plain(trace, rights, best_event, n_kmers,
                                     bandwidth)
    Sp = chase_rows(S)
    out = torch.empty((Sp, B), dtype=torch.uint8, device=dev)
    err = cuda_lib.lib().dt_banded_chase(
        trace.data_ptr(), rights.data_ptr(), best_event.data_ptr(),
        n_kmers.data_ptr(), S, Sp, B, W, out.data_ptr(),
        cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "backtrace_moves")
    CHASE_LAUNCHES.add()
    return out
