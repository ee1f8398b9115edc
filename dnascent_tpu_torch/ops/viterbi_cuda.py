"""Wrappers for kernels C (Viterbi fill) and D (Viterbi termination and
backtrace), port of ``dnascent_tpu/ops/viterbi_pallas.py``.

A wrapper runs the kernel for a CUDA tensor and its plain twin (imported
here from ``ops/viterbi.py``) for a CPU tensor; any other device, dtype,
shape or layout raises.  There is no fallback from the kernel to the twin.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .viterbi import viterbi_fill_plain, viterbi_terminate_backtrace_plain

__all__ = ["viterbi_fill_codes", "viterbi_terminate_backtrace",
           "viterbi_fill_plain", "viterbi_terminate_backtrace_plain",
           "FILL_LAUNCHES", "BACKTRACE_LAUNCHES", "FILL_MAX_STATES"]

FILL_LAUNCHES = cuda_lib.LaunchCounter()
# kernel C gives each window at most 32 lanes of 3 states each (the path's
# state buckets are 48 and 72)
FILL_MAX_STATES = 96
BACKTRACE_LAUNCHES = cuda_lib.LaunchCounter()
# kernel C writes its codes at a window stride padded to a multiple of this,
# which kernel D's TMA copies need
CODES_ALIGN = 16


def viterbi_fill_codes(obs_T, mu, inv_sigma, lp_const, n_obs, n_states,
                       iM2M, eM2M, eOrIM2M, hmm_logs):
    """Viterbi fill (kernel C).  ``obs_T`` (T, W) f32; ``mu``,
    ``inv_sigma``, ``lp_const`` (N, W) f32; ``n_obs``, ``n_states`` (W,)
    i32; ``iM2M``, ``eM2M``, ``eOrIM2M`` (W,) f32; ``hmm_logs`` the six
    fixed log-probs (eD2D, eD2M, eI2M, eM2D, iM2I, iI2I).  Returns (codes
    (T, N, W) u8, I_fin, M_fin, D_fin (N, W) f32), every cell bitwise equal
    to ``viterbi_fill_plain``'s.  The kernel takes N <= FILL_MAX_STATES;
    its codes are a view whose window stride is W rounded up to
    CODES_ALIGN."""
    dev = obs_T.device
    T, W = obs_T.shape
    N = mu.shape[0]
    f32, i32 = torch.float32, torch.int32
    cuda_lib.check_tensor(obs_T, "obs_T", f32, (T, W), dev)
    for name, t in (("mu", mu), ("inv_sigma", inv_sigma),
                    ("lp_const", lp_const)):
        cuda_lib.check_tensor(t, name, f32, (N, W), dev)
    cuda_lib.check_tensor(n_obs, "n_obs", i32, (W,), dev)
    cuda_lib.check_tensor(n_states, "n_states", i32, (W,), dev)
    for name, t in (("iM2M", iM2M), ("eM2M", eM2M), ("eOrIM2M", eOrIM2M)):
        cuda_lib.check_tensor(t, name, f32, (W,), dev)
    if not cuda_lib.use_kernel(dev):
        return viterbi_fill_plain(obs_T, mu, inv_sigma, lp_const, n_obs,
                                  n_states, iM2M, eM2M, eOrIM2M, hmm_logs)
    if N > FILL_MAX_STATES:
        raise ValueError(f"{N} states exceed the kernel's {FILL_MAX_STATES}"
                         " (32 lanes of 3 states a window)")
    Wc = -(-W // CODES_ALIGN) * CODES_ALIGN
    codes = torch.empty((T, N, Wc), dtype=torch.uint8, device=dev)
    finals = torch.empty((3, N, W), dtype=f32, device=dev)
    with cuda_lib.on_device(dev):
        err = cuda_lib.lib().dt_viterbi_fill(
            obs_T.data_ptr(), mu.data_ptr(), inv_sigma.data_ptr(),
            lp_const.data_ptr(), n_obs.data_ptr(), n_states.data_ptr(),
            iM2M.data_ptr(), eM2M.data_ptr(), eOrIM2M.data_ptr(), T, N, W, Wc,
            *[float(v) for v in hmm_logs], codes.data_ptr(),
            finals[0].data_ptr(), finals[1].data_ptr(), finals[2].data_ptr(),
            cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "viterbi_fill_codes")
    FILL_LAUNCHES.add()
    return codes[:, :, :W], finals[0], finals[1], finals[2]


def codes_window_stride(codes) -> int:
    """The window stride of a (T, N, W) codes tensor laid out as kernel C
    writes it (windows dense, rows at a stride Wc); raises unless Wc and
    the base address are multiples of CODES_ALIGN, as kernel D takes."""
    T, N, W = codes.shape
    Wc = codes.stride(1)
    if (codes.stride(2) != 1 or (T > 1 and codes.stride(0) != N * Wc)
            or Wc < W or Wc % CODES_ALIGN or codes.data_ptr() % CODES_ALIGN):
        raise ValueError(
            f"codes with strides {codes.stride()}: kernel D takes a window "
            f"stride and base that are multiples of {CODES_ALIGN} (the "
            "layout viterbi_fill_codes returns)")
    return Wc


def viterbi_terminate_backtrace(codes, I_fin, M_fin, D_fin, n_obs, n_states,
                                eM2MorD, eI2M: float, s_rows: int):
    """Viterbi termination and backtrace (kernel D).  ``codes`` (T, N, W)
    u8 (on the card, in the layout ``viterbi_fill_codes`` returns) and the
    finals (N, W) f32 from kernel C; ``n_obs``, ``n_states``
    (W,) i32; ``eM2MorD`` (W,) f32; ``eI2M`` the fixed log-prob.  Returns
    (path (W, s_pad) u8, each row's codes in forward order, left-aligned,
    PAD only as a tail; path_len (W,) i32), bitwise equal to
    ``viterbi_terminate_backtrace_plain``.  ``s_rows`` bounds
    max(n_obs + n_states) (a window beyond it gets no path) and is rounded
    up to a multiple of 8."""
    dev = codes.device
    T, N, W = codes.shape
    f32, i32 = torch.float32, torch.int32
    if codes.dtype != torch.uint8:
        raise TypeError(f"codes has dtype {codes.dtype}, expected uint8")
    for name, t in (("I_fin", I_fin), ("M_fin", M_fin), ("D_fin", D_fin)):
        cuda_lib.check_tensor(t, name, f32, (N, W), dev)
    cuda_lib.check_tensor(n_obs, "n_obs", i32, (W,), dev)
    cuda_lib.check_tensor(n_states, "n_states", i32, (W,), dev)
    cuda_lib.check_tensor(eM2MorD, "eM2MorD", f32, (W,), dev)
    if s_rows < 1:
        raise ValueError(f"s_rows must be positive, got {s_rows}")
    if not cuda_lib.use_kernel(dev):
        return viterbi_terminate_backtrace_plain(
            codes, I_fin, M_fin, D_fin, n_obs, n_states, eM2MorD, eI2M,
            s_rows)
    Wc = codes_window_stride(codes)
    s_pad = -(-s_rows // 8) * 8
    path = torch.empty((W, s_pad), dtype=torch.uint8, device=dev)
    path_len = torch.empty(W, dtype=i32, device=dev)
    with cuda_lib.on_device(dev):
        err = cuda_lib.lib().dt_viterbi_terminate_backtrace(
            codes.data_ptr(), I_fin.data_ptr(), M_fin.data_ptr(),
            D_fin.data_ptr(), n_obs.data_ptr(), n_states.data_ptr(),
            eM2MorD.data_ptr(), float(eI2M), T, N, W, Wc, s_pad,
            path.data_ptr(), path_len.data_ptr(),
            cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "viterbi_terminate_backtrace")
    BACKTRACE_LAUNCHES.add()
    return path, path_len
