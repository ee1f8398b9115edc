"""Wrappers for kernels C (Viterbi fill) and D (Viterbi backtrace), port of
``dnascent_tpu/ops/viterbi_pallas.py``.

A wrapper runs the kernel for a CUDA tensor and its plain twin (imported
here from ``ops/viterbi.py``) for a CPU tensor; any other device, dtype,
shape or layout raises.  There is no fallback from the kernel to the twin.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .viterbi import viterbi_backtrace_plain, viterbi_fill_plain

__all__ = ["viterbi_fill_codes", "viterbi_backtrace", "viterbi_fill_plain",
           "viterbi_backtrace_plain", "FILL_LAUNCHES", "BACKTRACE_LAUNCHES",
           "FILL_MAX_STATES"]

FILL_LAUNCHES = cuda_lib.LaunchCounter()
# kernel C gives each window at most 32 lanes of 3 states each (the path's
# state buckets are 48 and 72)
FILL_MAX_STATES = 96
BACKTRACE_LAUNCHES = cuda_lib.LaunchCounter()


def viterbi_fill_codes(obs_T, mu, inv_sigma, lp_const, n_obs, n_states,
                       iM2M, eM2M, eOrIM2M, hmm_logs):
    """Viterbi fill (kernel C).  ``obs_T`` (T, W) f32; ``mu``,
    ``inv_sigma``, ``lp_const`` (N, W) f32; ``n_obs``, ``n_states`` (W,)
    i32; ``iM2M``, ``eM2M``, ``eOrIM2M`` (W,) f32; ``hmm_logs`` the six
    fixed log-probs (eD2D, eD2M, eI2M, eM2D, iM2I, iI2I).  Returns (codes
    (T, N, W) u8, I_fin, M_fin, D_fin (N, W) f32), every cell bitwise equal
    to ``viterbi_fill_plain``'s.  The kernel takes N <= FILL_MAX_STATES."""
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
    codes = torch.empty((T, N, W), dtype=torch.uint8, device=dev)
    finals = torch.empty((3, N, W), dtype=f32, device=dev)
    err = cuda_lib.lib().dt_viterbi_fill(
        obs_T.data_ptr(), mu.data_ptr(), inv_sigma.data_ptr(),
        lp_const.data_ptr(), n_obs.data_ptr(), n_states.data_ptr(),
        iM2M.data_ptr(), eM2M.data_ptr(), eOrIM2M.data_ptr(), T, N, W,
        *[float(v) for v in hmm_logs], codes.data_ptr(),
        finals[0].data_ptr(), finals[1].data_ptr(), finals[2].data_ptr(),
        cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "viterbi_fill_codes")
    FILL_LAUNCHES.add()
    return codes, finals[0], finals[1], finals[2]


def viterbi_backtrace(codes, kind0, n_obs, n_states, s_rows: int):
    """Viterbi backtrace (kernel D) -> (path_code (W, s_pad) u8 forward
    order with PAD gaps, path_len (W,) i32); ``s_rows`` bounds
    max(n_obs + n_states) and is rounded up to a multiple of 8."""
    dev = codes.device
    T, N, W = codes.shape
    i32 = torch.int32
    cuda_lib.check_tensor(codes, "codes", torch.uint8, (T, N, W), dev)
    for name, t in (("kind0", kind0), ("n_obs", n_obs),
                    ("n_states", n_states)):
        cuda_lib.check_tensor(t, name, i32, (W,), dev)
    if not cuda_lib.use_kernel(dev):
        return viterbi_backtrace_plain(codes, kind0, n_obs, n_states, s_rows)
    s_pad = -(-s_rows // 8) * 8
    path = torch.empty((W, s_pad), dtype=torch.uint8, device=dev)
    path_len = torch.empty(W, dtype=i32, device=dev)
    err = cuda_lib.lib().dt_viterbi_backtrace(
        codes.data_ptr(), kind0.data_ptr(), n_obs.data_ptr(),
        n_states.data_ptr(), T, N, W, s_pad, path.data_ptr(),
        path_len.data_ptr(), cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "viterbi_backtrace")
    BACKTRACE_LAUNCHES.add()
    return path, path_len
