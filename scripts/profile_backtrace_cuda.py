#!/usr/bin/env python3
"""Where kernel D's time goes inside a block, by clock64 probes.

    python3 scripts/profile_backtrace_cuda.py

Copies ``dnascent_tpu_torch/csrc/viterbi_backtrace.cu`` into
``build/profile_backtrace/`` with probes added around its chunk loop (the
kernel's own source is not touched), builds it with the port's nvcc flags,
and runs it on ``chip_smoke.py``'s phase-1 inputs (2048 windows, T=192,
N=48, s_rows = T + N).  It prints one JSON line: whether path and path_len
equal the plain twin's, the kernel's time (``chip_smoke.cuda_ms``, 20
launches), and per block (means, in SM clock cycles): cycles in the walk,
cycles waiting for a chunk's copy, the critical steps (the slowest lane's
steps, summed over chunks), the whole chunk loop, and walk cycles per
critical step.  The probes cost a few cycles per chunk.  Needs a CUDA
device; prints the card's name and power limit first.

The probes go in at exact lines of the kernel's source (``PROBES``), so
they track its text: where a line has changed, the script says which
anchor is gone, and prints the time and the check without the probes.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "profile_backtrace")
MAX_BLOCKS = 8192
GROUP = 16  # windows a block walks (kGroup in the kernel)

# (anchor in the kernel source, text put after it)
PROBES = [
    ("namespace {\n\nconstexpr int KIND_D",
     None),  # the probe buffer goes before this anchor
    ("  for (int c = top; c >= 0; --c) {\n",
     None),  # the counters go before this anchor
    ("    mbar_wait(bar0 + 8 * (c % kBufs), ((top - c) / kBufs) & 1);\n",
     "    { const long long now = clock64();\n"
     "      p_wait += now - p_t; p_t = now; }\n"
     "    const int p_n0 = n;\n"),
    ("    __syncwarp();  // every lane is done with buffer c % kBufs\n",
     "    { const long long now = clock64();\n"
     "      p_walk += now - p_t; p_t = now;\n"
     "      p_crit += __reduce_max_sync(kFull, n - p_n0); }\n"),
]
BEFORE = {
    0: "__device__ long long dt_bt_probe[%d * 4];\n" % MAX_BLOCKS,
    1: "  long long p_walk = 0, p_wait = 0, p_crit = 0;\n"
       "  long long p_t = clock64();\n"
       "  const long long p_start = p_t;\n",
}
STORE_ANCHOR = "  if (walker) {\n    for (int b = 0; b < (n & 3)"
STORE = ("  if (lane == 0 && blockIdx.x < %d) {\n"
         "    long long* q = dt_bt_probe + blockIdx.x * 4;\n"
         "    q[0] = p_walk; q[1] = p_wait; q[2] = p_crit;\n"
         "    q[3] = clock64() - p_start;\n"
         "  }\n" % MAX_BLOCKS)
EXPORT = ("\nDT_EXPORT int dt_bt_probe_get(void* dst, int nbytes) {\n"
          "  return (int)cudaMemcpyFromSymbol(dst, dt_bt_probe, nbytes);\n}\n")


def probed_source() -> tuple[str, bool]:
    """The kernel's source with the probes in, and True; or, where an
    anchor is not found exactly once, the source as it is and False."""
    path = os.path.join(ROOT, "dnascent_tpu_torch", "csrc",
                        "viterbi_backtrace.cu")
    with open(path) as fh:
        src = orig = fh.read()
    for i, (anchor, after) in enumerate(PROBES + [(STORE_ANCHOR, None)]):
        if src.count(anchor) != 1:
            print(f"profile_backtrace_cuda: probe anchor {i} is not found "
                  f"once in {path}; timing the kernel without probes",
                  file=sys.stderr)
            return orig, False
        if i == len(PROBES):
            src = src.replace(anchor, STORE + anchor)
        if i in BEFORE:
            src = src.replace(anchor, BEFORE[i] + anchor)
        if after:
            src = src.replace(anchor, anchor + after)
    return src + EXPORT, True


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_backtrace_cuda: needs a CUDA device")
    import chip_smoke as smoke
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.poremodel import synthetic_model_set
    from dnascent_tpu_torch.ops import cuda_lib, viterbi_cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    os.makedirs(OUT, exist_ok=True)
    src_path = os.path.join(OUT, "viterbi_backtrace_probed.cu")
    src, probed = probed_source()
    with open(src_path, "w") as fh:
        fh.write(src)
    lib_path = os.path.join(OUT, "libprobed.so")
    res = subprocess.run(
        [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", cuda_lib.CSRC,
         "-shared", "-o", lib_path, src_path], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(lib_path)
    fn = lib.dt_viterbi_terminate_backtrace
    fn.argtypes = cuda_lib._SIGNATURES["dt_viterbi_terminate_backtrace"]
    fn.restype = ctypes.c_int

    dev = torch.device("cuda")
    vargs, eM2MorD = smoke.viterbi_inputs(
        torch, np, synthetic_model_set(DNA_R10), dev)
    codes, I_f, M_f, D_f = viterbi_cuda.viterbi_fill_codes(*vargs)
    T, W = vargs[0].shape
    N = vargs[1].shape[0]
    s_pad = T + N
    dargs = (codes, I_f, M_f, D_f, vargs[4], vargs[5], eM2MorD, vargs[9][2])
    want = viterbi_cuda.viterbi_terminate_backtrace_plain(*dargs, s_pad)
    stream = torch.cuda.current_stream().cuda_stream
    path = torch.empty((W, s_pad), dtype=torch.uint8, device=dev)
    plen = torch.empty(W, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in dargs[:7]]

    def call():
        return fn(*ptrs, float(dargs[7]), T, N, W,
                  viterbi_cuda.codes_window_stride(codes), s_pad,
                  path.data_ptr(), plen.data_ptr(), stream)

    if call() != 0:
        raise SystemExit("launch failed")
    torch.cuda.synchronize()
    out = {"shape": [W, T, N, s_pad], "probed": probed,
           "equal_to_plain": torch.equal(path, want[0])
           and torch.equal(plen, want[1]),
           "ms": smoke.cuda_ms(torch, call, 20)}
    if probed:
        lib.dt_bt_probe_get.argtypes = [ctypes.c_void_p, ctypes.c_int]
        probe = np.zeros(MAX_BLOCKS * 4, np.int64)
        if lib.dt_bt_probe_get(probe.ctypes.data, probe.nbytes) != 0:
            raise SystemExit("reading the probes failed")
        p = probe.reshape(-1, 4)[:-(-W // GROUP)]
        out.update(
            blocks=int(p.shape[0]), walk_cycles=float(p[:, 0].mean()),
            wait_cycles=float(p[:, 1].mean()),
            critical_steps=float(p[:, 2].mean()),
            loop_cycles=float(p[:, 3].mean()),
            loop_cycles_max=int(p[:, 3].max()),
            walk_cycles_per_critical_step=float(
                p[:, 0].sum() / max(p[:, 2].sum(), 1)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
