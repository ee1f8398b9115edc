"""Wrappers for kernels A (static-stdv banded fill), E (per-k-mer-stdv
banded fill) and B (backtrace chase), port of
``dnascent_tpu/ops/banded_pallas.py``'s lean fill, general fill and chase.

A wrapper runs the kernel for a CUDA tensor and its plain twin (imported
here from ``ops/banded.py``) for a CPU tensor; any other device, dtype,
shape or layout raises.  There is no fallback from the kernel to the twin.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .banded import (backtrace_moves_plain, banded_fill_general_plain,
                     banded_fill_plain, chase_rows, emission_coefficients,
                     lean_scalars, n_fill_steps, transition_scalars)

__all__ = ["banded_fill_lean", "banded_fill_general", "backtrace_moves",
           "banded_fill_plain", "banded_fill_general_plain",
           "backtrace_moves_plain", "FILL_LAUNCHES", "GENERAL_FILL_LAUNCHES",
           "CHASE_LAUNCHES"]

FILL_LAUNCHES = cuda_lib.LaunchCounter()
GENERAL_FILL_LAUNCHES = cuda_lib.LaunchCounter()
CHASE_LAUNCHES = cuda_lib.LaunchCounter()


def _fill_outputs(S: int, B: int, W: int, dev):
    return (torch.empty((S, B, W), dtype=torch.uint8, device=dev),
            torch.empty((S, B), dtype=torch.uint8, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.float32, device=dev))


def _check_bandwidth(bandwidth: int) -> None:
    if not 2 <= bandwidth <= 128:
        raise ValueError(f"bandwidth {bandwidth} outside the kernel's 2..128")


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
    _check_bandwidth(bandwidth)
    lp_stay, lp_step, lp_skip, lp_trim, h_c = lean_scalars(
        n_events, n_kmers, **kw)
    W = bandwidth
    S = n_fill_steps(E, K)
    out = _fill_outputs(S, B, W, dev)
    with cuda_lib.on_device(dev):
        err = cuda_lib.lib().dt_banded_fill_lean(
            events.data_ptr(), mu.data_ptr(), n_events.data_ptr(),
            n_kmers.data_ptr(), lp_stay.data_ptr(), lp_step.data_ptr(),
            B, E, K, W, S, lp_skip, lp_trim, h_c,
            *(t.data_ptr() for t in out), cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "banded_fill_lean")
    FILL_LAUNCHES.add()
    return out


def banded_fill_general(events: torch.Tensor, mu: torch.Tensor,
                        inv_sigma: torch.Tensor, lp_const: torch.Tensor,
                        n_events: torch.Tensor, n_kmers: torch.Tensor, *,
                        bandwidth: int = 100, epsilon_skip: float = 1e-30,
                        p_trim: float = 0.01):
    """Per-k-mer-stdv banded fill (kernel E).  ``events`` (B, E) f32 scaled
    event means; ``mu``, ``inv_sigma``, ``lp_const`` (B, K) f32 per query
    k-mer (-inf lp_const = undefined k-mer); ``n_events``/``n_kmers`` (B,)
    i32.  Returns the same four outputs as :func:`banded_fill_lean`."""
    dev = events.device
    B, E = events.shape
    K = mu.shape[1]
    cuda_lib.check_tensor(events, "events", torch.float32, (B, E), dev)
    for name, t in (("mu", mu), ("inv_sigma", inv_sigma),
                    ("lp_const", lp_const)):
        cuda_lib.check_tensor(t, name, torch.float32, (B, K), dev)
    cuda_lib.check_tensor(n_events, "n_events", torch.int32, (B,), dev)
    cuda_lib.check_tensor(n_kmers, "n_kmers", torch.int32, (B,), dev)
    kw = dict(epsilon_skip=epsilon_skip, p_trim=p_trim)
    if not cuda_lib.use_kernel(dev):
        return banded_fill_general_plain(events, mu, inv_sigma, lp_const,
                                         n_events, n_kmers,
                                         bandwidth=bandwidth, **kw)
    _check_bandwidth(bandwidth)
    cA, cB, cC = emission_coefficients(mu, inv_sigma, lp_const)
    lp_stay, lp_step, lp_skip, lp_trim = transition_scalars(
        n_events, n_kmers, **kw)
    W = bandwidth
    S = n_fill_steps(E, K)
    out = _fill_outputs(S, B, W, dev)
    with cuda_lib.on_device(dev):
        err = cuda_lib.lib().dt_banded_fill_general(
            events.data_ptr(), cA.data_ptr(), cB.data_ptr(), cC.data_ptr(),
            n_events.data_ptr(), n_kmers.data_ptr(), lp_stay.data_ptr(),
            lp_step.data_ptr(), B, E, K, W, S, lp_skip, lp_trim,
            *(t.data_ptr() for t in out), cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "banded_fill_general")
    GENERAL_FILL_LAUNCHES.add()
    return out


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
    with cuda_lib.on_device(dev):
        err = cuda_lib.lib().dt_banded_chase(
            trace.data_ptr(), rights.data_ptr(), best_event.data_ptr(),
            n_kmers.data_ptr(), S, Sp, B, W, out.data_ptr(),
            cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "backtrace_moves")
    CHASE_LAUNCHES.add()
    return out
