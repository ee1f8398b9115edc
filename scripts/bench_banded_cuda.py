#!/usr/bin/env python3
"""Time the port's banded fills (kernels A and E) and chase (kernel B) from
several source trees side by side on one CUDA card.

    python3 scripts/bench_banded_cuda.py [TREE ...]

Each TREE is a checkout of the repository (default: this one); its
``dnascent_tpu_torch/csrc/banded_fill.cu`` and ``banded_chase.cu`` are
built with the port's nvcc flags into ``build/bench_banded/<i>/``.  The
inputs are the main path's: 32 simulated reads of 10 kb through the port's
quantile scaling (A and B), and the same reads with a pore model whose
stdv varies per k-mer (E).  Every tree's kernels run on the same device
tensors, in turns (tree 0, 1, ..., 1, 0), each timed with CUDA events over
10 launches after a warm launch; every tree's outputs must be bitwise equal
to tree 0's.  Prints the card's name and power limit, then one JSON line.
Compare two commits by unpacking the older with ``git archive`` into a
directory that .gitignore lists and passing both.
"""

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0


def build(tree: str, out_dir: str, cuda_lib) -> ctypes.CDLL:
    csrc = os.path.join(tree, "dnascent_tpu_torch", "csrc")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libbanded.so")
    res = subprocess.run(
        [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", csrc, "-shared",
         "-o", lib_path, os.path.join(csrc, "banded_fill.cu"),
         os.path.join(csrc, "banded_chase.cu")],
        capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {tree}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(lib_path)
    for name in ("dt_banded_fill_lean", "dt_banded_fill_general",
                 "dt_banded_chase"):
        fn = getattr(lib, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", default=[ROOT])
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_banded_cuda: needs a CUDA device")
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.poremodel import (synthetic_model_set,
                                                 synthetic_model_table)
    from dnascent_tpu_torch.ops import banded, cuda_lib
    from dnascent_tpu_torch.pipeline import prep
    from dnascent_tpu_torch.pipeline.source import SimulatedSource

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    libs = [build(t, os.path.join(ROOT, "build", "bench_banded", str(i)),
                  cuda_lib) for i, t in enumerate(a.trees)]
    models = synthetic_model_set(DNA_R10)
    fit = dataclasses.replace(models, pore_model=synthetic_model_table(9, 1))

    def group(ms):
        recs = list(SimulatedSource(ms, DNA_R10, n_reads=32, length=10000,
                                    seed=SEED + 100))
        return [p for p in prep.quantile_scaled_reads(recs, ms, DNA_R10)
                if p.passed]

    def put(arrays):
        return [torch.from_numpy(x).to(dev) for x in arrays]

    lean = put(prep.fill_inputs(group(models), models))
    gen = put(prep.general_fill_inputs(group(fit), fit))
    inv_sigma, lp_const = prep.static_stdv_scalars(models.pore_model)
    W = DNA_R10.banded.bandwidth
    kw = dict(epsilon_skip=DNA_R10.banded.epsilon_skip,
              p_trim=DNA_R10.banded.p_trim)

    def outputs(B, E, K):
        S = banded.n_fill_steps(E, K)
        return (torch.empty((S, B, W), dtype=torch.uint8, device=dev),
                torch.empty((S, B), dtype=torch.uint8, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.float32, device=dev))

    ev, mu, n_ev, n_km = lean
    B, E = ev.shape
    K = mu.shape[1]
    S = banded.n_fill_steps(E, K)
    ls, lt, lk, lr, h_c = banded.lean_scalars(
        n_ev, n_km, inv_sigma=inv_sigma, lp_const=lp_const, **kw)
    gev, gmu, ginv, glpc, gn_ev, gn_km = gen
    gE, gK = gev.shape[1], gmu.shape[1]
    gS = banded.n_fill_steps(gE, gK)
    cA, cB, cC = banded.emission_coefficients(gmu, ginv, glpc)
    gls, glt, glk, glr = banded.transition_scalars(gn_ev, gn_km, **kw)

    runs = {"A": [], "E": [], "B": []}
    for lib in libs:
        o = outputs(B, E, K)
        runs["A"].append((lambda lib=lib, o=o: lib.dt_banded_fill_lean(
            ev.data_ptr(), mu.data_ptr(), n_ev.data_ptr(), n_km.data_ptr(),
            ls.data_ptr(), lt.data_ptr(), B, E, K, W, S, lk, lr, h_c,
            *(t.data_ptr() for t in o), stream), o))
        g = outputs(B, gE, gK)
        runs["E"].append((lambda lib=lib, g=g: lib.dt_banded_fill_general(
            gev.data_ptr(), cA.data_ptr(), cB.data_ptr(), cC.data_ptr(),
            gn_ev.data_ptr(), gn_km.data_ptr(), gls.data_ptr(),
            glt.data_ptr(), B, gE, gK, W, gS, glk, glr,
            *(t.data_ptr() for t in g), stream), g))
    # every tree's chase walks tree 0's fill (checked equal below)
    Sp = banded.chase_rows(S)
    for lib in libs:
        mv = torch.empty((Sp, B), dtype=torch.uint8, device=dev)
        runs["B"].append((lambda lib=lib, mv=mv: lib.dt_banded_chase(
            runs["A"][0][1][0].data_ptr(), runs["A"][0][1][1].data_ptr(),
            runs["A"][0][1][2].data_ptr(), n_km.data_ptr(), S, Sp, B, W,
            mv.data_ptr(), stream), (mv,)))

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

    result = {"device": torch.cuda.get_device_name(0), "trees": a.trees,
              "shape": [B, E, K, W], "reps": a.reps}
    order = list(range(len(libs))) + list(range(len(libs)))[::-1]
    for name in ("A", "E", "B"):
        times = [[] for _ in libs]
        for i in order:
            times[i].append(ms(runs[name][i][0]))
        equal = [all(torch.equal(x, y) for x, y in
                     zip(runs[name][i][1], runs[name][0][1]))
                 for i in range(len(libs))]
        if not all(equal):
            raise SystemExit(f"kernel {name}: trees disagree: {equal}")
        result[name] = {"ms": times, "equal_to_tree0": equal}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
