#!/usr/bin/env python3
"""Time the port's Viterbi fill (kernel C) and GRU encoder (kernel F) from
several source trees side by side on one CUDA card.

    python3 scripts/bench_viterbi_gru_cuda.py [TREE ...]

Each TREE is a checkout of the repository (default: this one); its
``dnascent_tpu_torch/csrc/viterbi_fill.cu`` and ``gru_encoder.cu`` are
built with the port's nvcc flags into ``build/bench_viterbi_gru/<i>/``.
The inputs are ``chip_smoke.py``'s phase-1 shapes (C at 2048 windows,
T=192, N=48; F at 2^19 rows x 20 samples) and one captured detect batch:
32 simulated 10 kb reads at batch 32 through ``detect_reads`` on CUDA with
the reference topology (``chip_smoke.py``'s phase-4 configuration; phase
3 aligns the same reads the same way, so its C launches are these), each
C launch's inputs and F's input recorded by wrapping the wrappers.  Every
tree's kernels run on the same device tensors, in turns (tree 0, 1, ...,
1, 0), each timed with CUDA events over ``--reps`` launches after a warm
launch; C's outputs (codes and finals, every cell) must be bitwise equal to
tree 0's, F's within 2e-5.  Prints the card's name and power limit, then
one JSON line.  Compare two commits by unpacking the older with ``git
archive`` into a directory that .gitignore lists and passing both.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRU_ATOL = 2e-5


def build(tree: str, out_dir: str, cuda_lib) -> ctypes.CDLL:
    csrc = os.path.join(tree, "dnascent_tpu_torch", "csrc")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libviterbi_gru.so")
    res = subprocess.run(
        [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", csrc, "-shared",
         "-o", lib_path, os.path.join(csrc, "viterbi_fill.cu"),
         os.path.join(csrc, "gru_encoder.cu")],
        capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {tree}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(lib_path)
    for name in ("dt_viterbi_fill", "dt_gru_encoder"):
        fn = getattr(lib, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def capture(torch, smoke, dev):
    """Run one detect batch (phase 4's configuration) and record the inputs
    of every kernel C and F launch."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.poremodel import synthetic_model_set
    from dnascent_tpu_torch.models import reference_cnn
    from dnascent_tpu_torch.ops import viterbi_cuda
    from dnascent_tpu_torch.pipeline.detect import detect_reads
    from dnascent_tpu_torch.pipeline.source import SimulatedSource

    models = synthetic_model_set(DNA_R10)
    model = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(), smoke.reference_tensors()).to(dev)
    fills, encodes = [], []
    fill, encode = viterbi_cuda.viterbi_fill_codes, reference_cnn.gru_encoder

    def fill_recorded(*args):
        fills.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return fill(*args)

    def encode_recorded(xq, w):
        encodes.append((xq.clone(), w.clone()))
        return encode(xq, w)

    viterbi_cuda.viterbi_fill_codes = fill_recorded
    reference_cnn.gru_encoder = encode_recorded
    try:
        records = list(SimulatedSource(models, DNA_R10, n_reads=32,
                                       length=10000, seed=smoke.SEED + 300))
        for _ in detect_reads(iter(records), models, model, DNA_R10,
                              device=dev, batch_size=32):
            pass
    finally:
        viterbi_cuda.viterbi_fill_codes = fill
        reference_cnn.gru_encoder = encode
    torch.cuda.synchronize()
    return fills, encodes


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", default=[ROOT])
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_viterbi_gru_cuda: needs a CUDA device")
    import chip_smoke as smoke
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.poremodel import synthetic_model_set
    from dnascent_tpu_torch.models.cnn import SIG_QUANT_LO, SIG_QUANT_SCALE
    from dnascent_tpu_torch.ops import cuda_lib

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stream = torch.cuda.current_stream().cuda_stream
    libs = [build(t, os.path.join(ROOT, "build", "bench_viterbi_gru", str(i)),
                  cuda_lib) for i, t in enumerate(a.trees)]
    models = synthetic_model_set(DNA_R10)
    fills, encodes = capture(torch, smoke, dev)
    fills.insert(0, smoke.viterbi_inputs(torch, np, models, dev)[0])
    encodes.insert(0, smoke.gru_inputs(torch, np, dev))

    def c_call(lib, args):
        obs, mu = args[0], args[1]
        T, W = obs.shape
        N = mu.shape[0]
        codes = torch.empty((T, N, W), dtype=torch.uint8, device=dev)
        fin = torch.empty((3, N, W), dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in args[:9]]
        logs = [float(v) for v in args[9]]
        return (lambda: lib.dt_viterbi_fill(
            *ptrs, T, N, W, *logs, codes.data_ptr(), fin[0].data_ptr(),
            fin[1].data_ptr(), fin[2].data_ptr(), stream)), (codes, fin)

    def f_call(lib, args):
        xq, w = args
        out = torch.empty((xq.shape[0], 16), dtype=torch.float32, device=dev)
        return (lambda: lib.dt_gru_encoder(
            xq.data_ptr(), w.data_ptr(), xq.shape[0], xq.shape[1],
            SIG_QUANT_SCALE, SIG_QUANT_LO, out.data_ptr(), stream)), (out,)

    def ms(fn):
        if fn() != 0:
            raise SystemExit("launch failed")
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(a.reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / a.reps

    order = list(range(len(libs))) + list(range(len(libs)))[::-1]
    result = {"device": torch.cuda.get_device_name(0), "trees": a.trees,
              "reps": a.reps}
    for kernel, cases, make in (("C", fills, c_call), ("F", encodes, f_call)):
        rows = []
        for ci, args in enumerate(cases):
            runs = [make(lib, args) for lib in libs]
            times = [[] for _ in libs]
            for i in order:
                times[i].append(ms(runs[i][0]))
            ref = runs[0][1]
            if kernel == "C":
                agree = [all(torch.equal(x, y) for x, y in zip(r[1], ref))
                         for r in runs]
            else:
                agree = [float((r[1][0] - ref[0]).abs().max()) <= GRU_ATOL
                         for r in runs]
            shape = (list(args[0].shape[::-1]) + [args[1].shape[0]]
                     if kernel == "C" else list(args[0].shape))
            if not all(agree):
                raise SystemExit(f"kernel {kernel} case {ci} {shape}: trees "
                                 f"disagree: {agree}")
            rows.append({"case": "phase1" if ci == 0 else "captured",
                         "shape": shape, "ms": times})
        captured = [r for r in rows if r["case"] == "captured"]
        result[kernel] = {
            "shape_key": "W, T, N" if kernel == "C" else "rows, T",
            "cases": rows,
            "captured_sum_ms": [sum(min(r["ms"][i]) for r in captured)
                                for i in range(len(libs))]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
