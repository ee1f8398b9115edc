"""Build and load the port's CUDA kernels (``dnascent_tpu_torch/csrc``).

The kernels are compiled by ``nvcc`` for ``sm_90a``, one compiler process
per source, all started together, and linked into one shared library with a
plain C interface that is loaded with ctypes.  The build runs at first use,
from the sources in the checkout, into ``build/torch_kernels/`` at the
repository root; the library's file name carries a hash of the sources and
flags, so an edited source rebuilds and concurrent processes never load a
half-written file.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
SOURCES = ("banded_fill.cu", "banded_chase.cu", "viterbi_fill.cu",
           "viterbi_backtrace.cu", "gru_encoder.cu", "trunk_epilogue.cu")
# -fmad=false: the fills compare scores for equality, so every multiply and
# add must round like the plain PyTorch twin's separate ops (see common.cuh)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false")

_lock = threading.Lock()
_lib = None
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # events, mu, n_events, n_kmers, lp_stay, lp_step, B, E, K, W, n_steps,
    # lp_skip, lp_trim, h_c, trace, rights, best_event, best_score, stream
    "dt_banded_fill_lean": [_P] * 6 + [_I] * 5 + [_F] * 3 + [_P] * 5,
    # events, cA, cB, cC, n_events, n_kmers, lp_stay, lp_step, B, E, K, W,
    # n_steps, lp_skip, lp_trim, trace, rights, best_event, best_score, stream
    "dt_banded_fill_general": [_P] * 8 + [_I] * 5 + [_F] * 2 + [_P] * 5,
    # trace, rights, best_event, n_kmers, S, Sp, B, W, out, stream
    "dt_banded_chase": [_P] * 4 + [_I] * 4 + [_P] * 2,
    # obs, mu, inv_sigma, lp_const, n_obs, n_states, iM2M, eM2M, eOrIM2M,
    # T, N, W, Wc (the codes' window stride), six log-probs, codes, I_fin,
    # M_fin, D_fin, stream
    "dt_viterbi_fill": [_P] * 9 + [_I] * 4 + [_F] * 6 + [_P] * 5,
    # codes, I_fin, M_fin, D_fin, n_obs, n_states, eM2MorD, eI2M, T, N, W,
    # Wc, s_pad, path_code, path_len, stream
    "dt_viterbi_terminate_backtrace": [_P] * 7 + [_F] + [_I] * 5 + [_P] * 3,
    # xq, w, N, T, scale, lo, out, stream
    "dt_gru_encoder": [_P] * 2 + [_I] * 2 + [_F] * 2 + [_P] * 2,
    # y0, t0, y1, t1, B, C, L, has_bn, in_bf16, out_bf16, out, stream
    "dt_trunk_epilogue": [_P] * 4 + [_I] * 6 + [_P] * 2,
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash(extra: tuple) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as fh:
                h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the kernels (if this source set is not built yet) and return
    the library path.  ``verbose`` adds ``-Xptxas -v`` and keeps the
    compiler's report in ``build_log``."""
    global build_log
    extra = ("-Xptxas", "-v") if verbose else ()
    lib_path = os.path.join(BUILD_DIR,
                            f"libdnascent_kernels_{_source_hash(extra)}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
    nvcc = nvcc_path()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *extra, "-I", CSRC, "-c", "-o", obj,
         os.path.join(CSRC, src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode})")
    if not failed:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode})")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{build_log}")
    os.replace(tmp, lib_path)
    return lib_path


def lib(verbose: bool = False):
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build(verbose))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def on_device(device):
    """The context a wrapper launches its kernel in: the CUDA runtime
    launches (and sets kernel attributes) on the calling thread's current
    device, which need not be the tensors' device (a pipeline worker
    thread starts on cuda:0), so the launch runs with ``device`` made
    current."""
    import torch
    return torch.cuda.device(device)


def use_kernel(device) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain twin); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` has the device, dtype, shape and contiguous layout
    a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class LaunchCounter:
    """Per-kernel launch count: a plain integer, incremented (under a lock,
    since pipeline threads launch concurrently) where the wrapper launches
    its kernel and nowhere else."""

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def launch_counters() -> dict:
    """Every kernel wrapper's ``LaunchCounter`` by kernel name: A
    ``banded_fill``, B ``banded_chase``, C ``viterbi_fill``, D
    ``viterbi_backtrace``, E ``banded_fill_general``, F ``gru_encoder``,
    and the reference trunk's ``trunk_epilogue``."""
    from . import banded_cuda, gru_cuda, trunk_epilogue_cuda, viterbi_cuda
    return {"banded_fill": banded_cuda.FILL_LAUNCHES,
            "banded_chase": banded_cuda.CHASE_LAUNCHES,
            "viterbi_fill": viterbi_cuda.FILL_LAUNCHES,
            "viterbi_backtrace": viterbi_cuda.BACKTRACE_LAUNCHES,
            "banded_fill_general": banded_cuda.GENERAL_FILL_LAUNCHES,
            "gru_encoder": gru_cuda.LAUNCHES,
            "trunk_epilogue": trunk_epilogue_cuda.EPILOGUE_LAUNCHES}
