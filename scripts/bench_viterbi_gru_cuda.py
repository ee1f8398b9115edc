#!/usr/bin/env python3
"""Time the port's Viterbi fill (kernel C), Viterbi termination and
backtrace (kernel D) and GRU encoder (kernel F) from several source trees
side by side on one CUDA card, and D's host consumer before and after its
rows were left-aligned.

    python3 scripts/bench_viterbi_gru_cuda.py [TREE ...]

Each TREE is a checkout of the repository (default: this one); its
``dnascent_tpu_torch/csrc/viterbi_fill.cu``, ``viterbi_backtrace.cu`` and
``gru_encoder.cu`` are built with the port's nvcc flags into
``build/bench_viterbi_gru/<i>/``.  The inputs are
``chip_smoke.py``'s phase-1 shapes (C and D at 2048 windows, T=192, N=48;
F at 2^19 rows x 20 samples) and one captured detect batch: 32 simulated
10 kb reads at batch 32 through ``detect_reads`` on CUDA with the reference
topology (``chip_smoke.py``'s phase-4 configuration; phase 3 aligns the
same reads the same way, so its C and D launches are these), each C and D
launch's inputs, F's input and D's host consumer's input recorded by
wrapping the wrappers.  Every tree's kernels run on the same device
tensors, in turns (tree 0, 1, ..., 1, 0), each timed with CUDA events over
``--reps`` launches after a warm launch (``chip_smoke.cuda_ms``: the card
first spins so that the host has queued every launch, so this is device
time back to back, the host's issue time hidden).  C's
outputs (codes and finals, every cell) must be bitwise equal to tree 0's,
F's within 2e-5, D's path and path_len bitwise after left-aligning.  A
tree whose D is the backtrace alone (symbol ``dt_viterbi_backtrace``, rows
with PAD gaps, and C and D without the codes' padded window stride) gets
its termination kinds from ``ops/viterbi.terminate``, timed apart as
``terminate_ms``, and contiguous codes.  With such a tree given, D's host
consumer (device rows to each read's codes and step counts) is timed in
turns with the host clock: the per-window PAD filter that went with that
tree's rows against ``eventalign._read_paths`` on this tree's rows; their
outputs must be equal.  For D the host's own time a call is also read on
the host clock, with no spin (``host_us``, the mean of ``--reps`` calls in
each of five turns): each tree's bare library entry, this tree's wrapper
``viterbi_cuda.viterbi_terminate_backtrace`` and ``ops/viterbi.terminate``,
the PyTorch launches the old path ran before D.  Prints the card's name and power limit, then one JSON line.
Compare two commits by unpacking the older with ``git archive`` into a
directory that .gitignore lists and passing both.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRU_ATOL = 2e-5
SOURCES = ("viterbi_fill.cu", "viterbi_backtrace.cu", "gru_encoder.cu")
# a tree whose kernel D is the backtrace alone has kernels C and D without
# the codes' window stride: C's obs, mu, inv_sigma, lp_const, n_obs,
# n_states, iM2M, eM2M, eOrIM2M, T, N, W, six log-probs, codes, finals,
# stream; D's codes, kind0, n_obs, n_states, T, N, W, s_pad, path_code,
# path_len, stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
UNSTRIDED_FILL = [_P] * 9 + [_I] * 3 + [_F] * 6 + [_P] * 5
GAPPED_BT = [_P] * 4 + [_I] * 4 + [_P] * 3


def build(tree: str, out_dir: str, cuda_lib) -> ctypes.CDLL:
    csrc = os.path.join(tree, "dnascent_tpu_torch", "csrc")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libviterbi_gru.so")
    res = subprocess.run(
        [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", csrc,
         "-shared", "-o", lib_path, *(os.path.join(csrc, s) for s in SOURCES)],
        capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {tree}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(lib_path)
    sigs = {n: cuda_lib._SIGNATURES[n] for n in
            ("dt_viterbi_fill", "dt_gru_encoder",
             "dt_viterbi_terminate_backtrace")}
    if not hasattr(lib, "dt_viterbi_terminate_backtrace"):
        sigs.update(dt_viterbi_fill=UNSTRIDED_FILL,
                    dt_viterbi_backtrace=GAPPED_BT)
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def capture(torch, smoke, dev):
    """Run one detect batch (phase 4's configuration) and record the inputs
    of every kernel C, D and F launch and of D's host consumer."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.poremodel import synthetic_model_set
    from dnascent_tpu_torch.models import reference_cnn
    from dnascent_tpu_torch.ops import viterbi_cuda
    from dnascent_tpu_torch.pipeline import eventalign
    from dnascent_tpu_torch.pipeline.detect import detect_reads
    from dnascent_tpu_torch.pipeline.source import SimulatedSource

    models = synthetic_model_set(DNA_R10)
    model = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(), smoke.reference_tensors()).to(dev)
    got = {"C": [], "D": [], "F": [], "consumer": []}
    patches = [(viterbi_cuda, "viterbi_fill_codes", "C"),
               (viterbi_cuda, "viterbi_terminate_backtrace", "D"),
               (reference_cnn, "gru_encoder", "F"),
               (eventalign, "_read_paths", "consumer")]
    orig = [getattr(m, n) for m, n, _ in patches]

    def recorder(fn, key):
        def recorded(*args):
            got[key].append(tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args))
            return fn(*args)
        return recorded

    for (m, n, key), fn in zip(patches, orig):
        setattr(m, n, recorder(fn, key))
    try:
        records = list(SimulatedSource(models, DNA_R10, n_reads=32,
                                       length=10000, seed=smoke.SEED + 300))
        for _ in detect_reads(iter(records), models, model, DNA_R10,
                              device=dev, batch_size=32):
            pass
    finally:
        for (m, n, _), fn in zip(patches, orig):
            setattr(m, n, fn)
    torch.cuda.synchronize()
    return got


def gapped_read_paths(np, chunks, n_win, counts):
    """D's host consumer for rows with PAD gaps: PAD-filter every window's
    row in a Python loop, then concatenate each read's rows."""
    path_of = [None] * n_win
    for cid, path in chunks:
        path = path.cpu().numpy()
        keep = (path & 3) != 3
        for row, wid in enumerate(cid):
            path_of[wid] = path[row][keep[row]]
    out = []
    w0 = 0
    for c in counts:
        paths = path_of[w0:w0 + c]
        w0 += c
        steps = np.fromiter((p.shape[0] for p in paths), np.int64, len(paths))
        out.append((np.concatenate(paths), steps))
    return out


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
    from dnascent_tpu_torch.ops import cuda_lib, viterbi as tvit, viterbi_cuda
    from dnascent_tpu_torch.pipeline import eventalign

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
    got = capture(torch, smoke, dev)
    fills, encodes, bts = got["C"], got["F"], got["D"]
    vargs, eM2MorD = smoke.viterbi_inputs(torch, np, models, dev)
    fills.insert(0, vargs)
    encodes.insert(0, smoke.gru_inputs(torch, np, dev))
    T, W = vargs[0].shape
    N = vargs[1].shape[0]
    bts.insert(0, (*viterbi_cuda.viterbi_fill_codes(*vargs), vargs[4],
                   vargs[5], eM2MorD, vargs[9][2], T + N))

    def strided(lib):
        """Whether a tree's C and D take the codes' window stride."""
        return hasattr(lib, "dt_viterbi_terminate_backtrace")

    def padded(codes):
        """codes in kernel C's padded layout (a view of window stride Wc)."""
        T, N, W = codes.shape
        Wc = -(-W // viterbi_cuda.CODES_ALIGN) * viterbi_cuda.CODES_ALIGN
        buf = torch.zeros((T, N, Wc), dtype=torch.uint8, device=dev)
        buf[:, :, :W] = codes
        return buf[:, :, :W]

    def c_call(lib, args):
        obs, mu = args[0], args[1]
        T, W = obs.shape
        N = mu.shape[0]
        Wc = -(-W // viterbi_cuda.CODES_ALIGN) * viterbi_cuda.CODES_ALIGN
        wc = [Wc] if strided(lib) else []
        codes = torch.empty((T, N, Wc if wc else W), dtype=torch.uint8,
                            device=dev)
        fin = torch.empty((3, N, W), dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in args[:9]]
        logs = [float(v) for v in args[9]]
        return (lambda: lib.dt_viterbi_fill(
            *ptrs, T, N, W, *wc, *logs, codes.data_ptr(), fin[0].data_ptr(),
            fin[1].data_ptr(), fin[2].data_ptr(), stream)), (
                codes[:, :, :W], fin)

    def d_call(lib, args):
        codes, I_f, M_f, D_f, n_obs, n_st, eMD, eI2M, s_rows = args
        T, N, W = codes.shape
        s_pad = -(-s_rows // 8) * 8
        path = torch.empty((W, s_pad), dtype=torch.uint8, device=dev)
        plen = torch.empty(W, dtype=torch.int32, device=dev)
        if strided(lib):
            codes = padded(codes)
            Wc = viterbi_cuda.codes_window_stride(codes)
            return (lambda: lib.dt_viterbi_terminate_backtrace(
                codes.data_ptr(), I_f.data_ptr(), M_f.data_ptr(),
                D_f.data_ptr(), n_obs.data_ptr(), n_st.data_ptr(),
                eMD.data_ptr(), float(eI2M), T, N, W, Wc, s_pad,
                path.data_ptr(), plen.data_ptr(), stream)), (path, plen)
        codes = codes.contiguous()
        kind0 = tvit.terminate(I_f, M_f, D_f, n_st, eMD, eI2M)[1]
        return (lambda: lib.dt_viterbi_backtrace(
            codes.data_ptr(), kind0.data_ptr(), n_obs.data_ptr(),
            n_st.data_ptr(), T, N, W, s_pad, path.data_ptr(),
            plen.data_ptr(), stream)), (path, plen)

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
        return smoke.cuda_ms(torch, fn, a.reps)

    def host_us(fn, turns=5):
        """The host's time a call (µs), no spin: ``a.reps`` calls a turn,
        queued behind nothing but each other."""
        out = []
        for _ in range(turns):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(a.reps):
                fn()
            out.append((time.perf_counter() - t0) * 1e6 / a.reps)
            torch.cuda.synchronize()
        return out

    def d_rows(lib, outs):
        """A tree's D output as left-aligned rows and lengths."""
        if strided(lib):
            return outs
        return tvit.left_align_paths(outs[0])

    order = list(range(len(libs))) + list(range(len(libs)))[::-1]
    result = {"device": torch.cuda.get_device_name(0), "trees": a.trees,
              "reps": a.reps}
    d_outs = [[] for _ in libs]  # per tree, each captured D launch's rows
    for kernel, cases, make in (("C", fills, c_call), ("D", bts, d_call),
                                ("F", encodes, f_call)):
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
            elif kernel == "D":
                ref = d_rows(libs[0], ref)
                agree = [all(torch.equal(x, y) for x, y in
                             zip(d_rows(lib, r[1]), ref))
                         for lib, r in zip(libs, runs)]
            else:
                agree = [float((r[1][0] - ref[0]).abs().max()) <= GRU_ATOL
                         for r in runs]
            if kernel == "C":
                shape = list(args[0].shape[::-1]) + [args[1].shape[0]]
            elif kernel == "D":
                shape = [args[0].shape[2], args[0].shape[0],
                         args[0].shape[1], args[8]]
            else:
                shape = list(args[0].shape)
            if not all(agree):
                raise SystemExit(f"kernel {kernel} case {ci} {shape}: trees "
                                 f"disagree: {agree}")
            row = {"case": "phase1" if ci == 0 else "captured",
                   "shape": shape, "ms": times}
            if kernel == "D":
                row["terminate_ms"] = smoke.cuda_ms(
                    torch, lambda: tvit.terminate(*args[1:4], args[5],
                                                  args[6], args[7]), a.reps)
                row["steps"] = int(ref[1].sum())
                wargs = (padded(args[0]), *args[1:])
                row["host_us"] = {
                    "entry": [host_us(r[0]) for r in runs],
                    "wrapper": host_us(
                        lambda: viterbi_cuda.viterbi_terminate_backtrace(
                            *wargs)),
                    "terminate": host_us(
                        lambda: tvit.terminate(*args[1:4], args[5],
                                               args[6], args[7]))}
                if ci > 0:
                    for i, r in enumerate(runs):
                        d_outs[i].append(r[1])
            rows.append(row)
        captured = [r for r in rows if r["case"] == "captured"]
        result[kernel] = {
            "shape_key": {"C": "W, T, N", "D": "W, T, N, s_rows",
                          "F": "rows, T"}[kernel],
            "cases": rows,
            "captured_sum_ms": [sum(min(r["ms"][i]) for r in captured)
                                for i in range(len(libs))]}
        if kernel == "D":
            result[kernel]["captured_terminate_sum_ms"] = sum(
                r["terminate_ms"] for r in captured)

    gapped = [i for i, lib in enumerate(libs) if not strided(lib)]
    if gapped:
        result["consumer"] = consumer_times(
            np, torch, eventalign, got["consumer"], d_outs[gapped[0]])
    print(json.dumps(result))
    return 0


def consumer_times(np, torch, eventalign, calls, gapped_rows, turns=3):
    """D's host consumer on the captured batch, host clock (its device to
    host copies included): the PAD filter on the gapped tree's rows against
    ``eventalign._read_paths`` on this tree's, in turns; equal outputs."""
    (chunks, n_win, counts), = calls
    gapped_chunks = [(c[0], r[0]) for c, r in zip(chunks, gapped_rows)]
    runs = {"pad_filter_loop": lambda: gapped_read_paths(
                np, gapped_chunks, n_win, counts),
            "read_paths": lambda: eventalign._read_paths(chunks, n_win,
                                                         counts)}
    outs = {k: fn() for k, fn in runs.items()}
    for (ca, sa), (cb, sb) in zip(*outs.values()):
        if not (np.array_equal(ca, cb) and np.array_equal(sa, sb)):
            raise SystemExit("D's consumers disagree on a read")
    times = {k: [] for k in runs}
    for _ in range(turns):
        for k in list(runs) + list(runs)[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[k]()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {"windows": int(n_win), "reads": len(counts), "ms": times}


if __name__ == "__main__":
    sys.exit(main())
