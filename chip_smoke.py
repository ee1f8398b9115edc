#!/usr/bin/env python3
"""Drive the PyTorch port's detect main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each:
  0. set-up: card name and power limit, torch/CUDA/nvcc/triton versions,
     build of the six CUDA kernels (five sources, one nvcc each, in
     parallel) from ``dnascent_tpu_torch/csrc``, with ptxas's register
     and spill counts;
  1. each kernel against its plain PyTorch twin on the card, with both
     times: the static and the per-k-mer-stdv fills and the chase at the
     main path's 32 reads of 10 kb; Viterbi fill and backtrace at 2048
     windows, T=192, N=48; the GRU encoder at 2^19 rows of 20 samples
     (padded tails, rows of the code q=128);
  2. four 2 kb reads through ``detect_reads`` on CUDA and on the CPU with
     the same DetectCNN weights: positions equal, probabilities within
     tolerance;
  3. the main path: 64 reads of 10 kb at batch 32 through ``detect_reads``
     on CUDA with the default-width DetectCNN (untrained, seeded weights),
     written as ``.detect``; kernels A-D must have launched;
  4. the ``--model`` path: the reference CNN topology, its seeded
     synthetic weights (non-zero biases and BatchNorm statistics, as
     trained weights have) written as a SavedModel directory and read back by
     the port's loader; CPU against CUDA on four 2 kb reads, then 64 reads
     of 10 kb at batch 32 on CUDA; kernels A-D and F must have launched;
  5. the fit-stdv path: a pore model whose stdv varies per k-mer; CPU
     against CUDA on four 2 kb reads, then 32 reads of 10 kb on CUDA;
     kernel E must have launched and kernel A must not.
Each path's launch counts are set to 0 just before it and read just after.
The line before the last is the kernel table as JSON: per kernel its launches
on the path that runs it (and on each path), its time and its plain twin's,
its bound (``bound_ms``/``bound_us``: this run's bytes over the card's
memory rate or its operations over the f32 rate, whichever is larger, named
by ``bound_by``), ``share_of_bound`` = bound / time, and ``library_ms``
(null: no PyTorch call computes these functions).  The last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the script
exits non-zero without that line, as it does without CUDA.  The script
imports nothing of jax or of the JAX package ``dnascent_tpu``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

# the port never uses jax or the JAX package; make any accidental import
# fail loudly
for _mod in ("jax", "flax", "optax", "dnascent_tpu"):
    sys.modules[_mod] = None

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# tolerances (see PERF.md): the fills, chase and Viterbi kernels are built
# with -fmad=false and follow their plain twins op for op, so their outputs
# must be bitwise equal; the GRU encoder's dot products and expf/tanhf
# differ from torch's by a few ulp, so it is held to the JAX contract's
# 2e-5, with its masked steps (the code q=128) exactly as the twin's; the
# CUDA-vs-CPU detect runs differ only in the bf16 CNN (cuDNN vs oneDNN),
# and the reference topology's 40 bf16 conv layers spread further than the
# DetectCNN's 17
PROB_ATOL_CPU = 0.02
REF_PROB_ATOL_CPU = 0.05
GRU_ATOL = 2e-5
# published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): memory
# rate and float32 rate outside the tensor cores (every kernel here is f32
# or integer work); a fused multiply-add counts as two operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# operations a cell of each kernel does on its inputs, counted from the
# sources: A x-mu, t*t, h_c*, four adds, the skip add, two maxes; E the
# emission's two multiplies and two adds plus the same six; C the emission
# (5), insertion (4), match (8), deletion chain (7) and pointer (2) updates;
# F one multiply-add per weight of the two GRU cells (816 + 1536) a live step
OPS_PER_CELL = {"banded_fill": 10, "banded_fill_general": 12,
                "viterbi_fill": 26, "gru_encoder": 2 * 2352}
# no single PyTorch call computes any of these functions (library_ms null):
# A, B, C, D and E are dynamic programs and walks that emit trace codes; for
# F, cuDNN's GRU drops only a padded tail, while F masks steps of the code
# q=128 anywhere in the sequence
LIBRARY_MS = None


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cmd_line(args) -> str:
    res = subprocess.run(args, capture_output=True, text=True, timeout=60)
    return res.stdout.strip()


def ptxas_report(log: str) -> dict:
    """Each kernel's ptxas register/shared-memory line and spill line, by
    (mangled) entry-function name, from an ``-Xptxas -v`` build log."""
    out, name = {}, None
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = []
        elif name and ("spill stores" in line or "Used" in line):
            out[name].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes that must move (each input
    read once, each output written once) over the memory rate, or
    operations over the f32 rate, whichever is larger."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return dict(bytes=int(nbytes), ops=int(ops),
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def compare(torch, name, kernel, plain, reps, shape, atol=0.0):
    """Launch ``kernel`` once, time it over ``reps`` more launches, run its
    plain twin once (host clock: a Python loop of many small launches) and
    require every output to be bitwise equal (``atol`` 0) or within
    ``atol``.  Returns (kernel outputs, table row)."""
    got = kernel()
    torch.cuda.synchronize()
    ms = cuda_ms(torch, kernel, reps)
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got_t = got if isinstance(got, (tuple, list)) else (got,)
    want_t = want if isinstance(want, (tuple, list)) else (want,)
    err = max(float((g.double() - w.double()).abs().max()) if g.numel()
              else 0.0 for g, w in zip(got_t, want_t))
    if atol == 0.0:
        if not all(torch.equal(g, w) for g, w in zip(got_t, want_t)):
            fail(f"{name} disagrees with its plain twin")
    elif not err <= atol:
        fail(f"{name} differs from its plain twin by {err} > {atol}")
    return got, dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, tol=atol,
                     shape=shape)


def fit_stdv_models(models):
    """The model set with a fit-stdv pore model: the static model's means,
    stdvs 0.10 to 0.18 varying per k-mer."""
    from dnascent_tpu_torch.io.poremodel import synthetic_model_table
    return dataclasses.replace(
        models, pore_model=synthetic_model_table(models.kmer_len, seed=1))


def reference_tensors():
    """The reference topology's seeded weights, every bias and BatchNorm
    statistic non-zero."""
    from dnascent_tpu_torch.models import reference_cnn
    return reference_cnn.seed_affine(reference_cnn.synthetic_tensors(SEED),
                                     SEED + 1)


def reference_model(dev):
    """The reference topology with seeded synthetic weights, written as a
    SavedModel directory and read back through the port's loader (the one
    ``detect --model`` uses)."""
    from dnascent_tpu_torch.testing.tf_bundle_writer import write_savedmodel_dir
    from dnascent_tpu_torch.models import reference_cnn
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "detect_model")
        write_savedmodel_dir(model_dir, reference_tensors())
        return reference_cnn.load_savedmodel(model_dir).to(dev)


def phase1_kernels(torch, np, models, dev):
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    from dnascent_tpu_torch.ops import (banded_cuda, viterbi as tvit,
                                        viterbi_cuda)
    from dnascent_tpu_torch.pipeline import prep
    from dnascent_tpu_torch.pipeline.eventalign import HMM_KEY

    rows = {}
    recs = list(SimulatedSource(models, DNA_R10, n_reads=32, length=10000,
                                seed=SEED + 100))
    group = [p for p in prep.quantile_scaled_reads(recs, models, DNA_R10)
             if p.passed]
    arrays = prep.fill_inputs(group, models)
    inv_sigma, lp_const = prep.static_stdv_scalars(models.pore_model)
    fill_args = [torch.from_numpy(a).to(dev) for a in arrays]
    kw = dict(inv_sigma=inv_sigma, lp_const=lp_const)
    got, rows["banded_fill"] = compare(
        torch, "banded fill",
        lambda: banded_cuda.banded_fill_lean(*fill_args, **kw),
        lambda: banded_cuda.banded_fill_plain(*fill_args, **kw), 10,
        list(fill_args[0].shape) + [fill_args[1].shape[1]])
    rows["banded_fill"].update(fill_bound(fill_args, got, "banded_fill"))

    chase = (got[0], got[1], got[2], fill_args[3])
    moves, rows["banded_chase"] = compare(
        torch, "backtrace chase", lambda: banded_cuda.backtrace_moves(*chase),
        lambda: banded_cuda.backtrace_moves_plain(*chase), 10,
        list(got[0].shape))
    # the walk reads one trace byte a move (a non-PAD code of its output)
    codes = torch.stack([(moves >> (2 * j)) & 3 for j in range(4)])
    n_moves = int((codes != 3).sum())
    rows["banded_chase"].update(bound(
        tensor_bytes(got[1], got[2], fill_args[3], moves) + n_moves, 0))

    rng = np.random.default_rng(SEED + 7)
    W, T, N = 2048, 192, 48
    n_states = rng.integers(30, 43, W).astype(np.int32)
    ranks = rng.integers(0, models.pore_model.shape[0], (N, W))
    ranks[np.arange(N)[:, None] >= n_states[None, :]] = -1
    table = torch.from_numpy(models.pore_model.astype(np.float32)).to(dev)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    mu, inv, lpc = tvit.emission_planes(t(ranks), table)
    obs = mu[rng.integers(0, 42, T)] + torch.from_numpy(
        rng.normal(0, 0.2, (T, W)).astype(np.float32)).to(dev)
    obs = obs.contiguous()
    n_obs = t(rng.integers(100, T + 1, W).astype(np.int32))
    n_st = t(n_states)
    hmm = tuple(getattr(DNA_R10.hmm, k) for k in HMM_KEY)
    iM2M, eM2M, eOrIM2M, eM2MorD, logs = tvit.transition_scores(
        t(rng.uniform(1.8, 2.6, W).astype(np.float32)), hmm)
    vargs = (obs, mu, inv, lpc, n_obs, n_st, iM2M, eM2M, eOrIM2M, logs)
    got, rows["viterbi_fill"] = compare(
        torch, "Viterbi fill", lambda: viterbi_cuda.viterbi_fill_codes(*vargs),
        lambda: viterbi_cuda.viterbi_fill_plain(*vargs), 10, [T, N, W])
    # live cells: observations before each window's count, states inside it
    live = float((n_obs.double() * n_st.double()).sum())
    rows["viterbi_fill"].update(bound(
        tensor_bytes(*vargs[:9], *got),
        live * OPS_PER_CELL["viterbi_fill"]))

    _, kind0 = tvit.terminate(*got[1:], n_st, eM2MorD, logs[2])
    bargs = (got[0], kind0, n_obs, n_st, T + N)
    path, rows["viterbi_backtrace"] = compare(
        torch, "Viterbi backtrace",
        lambda: viterbi_cuda.viterbi_backtrace(*bargs),
        lambda: viterbi_cuda.viterbi_backtrace_plain(*bargs), 10, [T, N, W])
    # the walk reads one code byte a step of each window's path
    rows["viterbi_backtrace"].update(bound(
        tensor_bytes(kind0, n_obs, n_st, *path) + int(path[1].sum()), 0))

    rows["banded_fill_general"] = phase1_general_fill(torch, models, dev)
    rows["gru_encoder"] = phase1_gru(torch, np, dev)
    return rows


def phase1_general_fill(torch, models, dev):
    """Kernel E on a fit-stdv model, bitwise against its twin at A's shape,
    32 reads of 10 kb."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    from dnascent_tpu_torch.ops import banded_cuda
    from dnascent_tpu_torch.pipeline import prep

    fit = fit_stdv_models(models)
    recs = list(SimulatedSource(fit, DNA_R10, n_reads=32, length=10000,
                                seed=SEED + 100))
    group = [p for p in prep.quantile_scaled_reads(recs, fit, DNA_R10)
             if p.passed]
    args = [torch.from_numpy(a).to(dev)
            for a in prep.general_fill_inputs(group, fit)]
    got, row = compare(
        torch, "per-k-mer-stdv fill",
        lambda: banded_cuda.banded_fill_general(*args),
        lambda: banded_cuda.banded_fill_general_plain(*args), 10,
        list(args[0].shape) + [args[1].shape[1]])
    row.update(fill_bound(args, got, "banded_fill_general"))
    return row


def fill_bound(args, outs, name):
    """Kernel A's or E's bound: its input planes and outputs once, and the
    band cells of each read's own E+K bands (the kernel fills a shorter
    read's tail too; that is not counted)."""
    n_ev, n_km = args[-2], args[-1]
    W = outs[0].shape[2]
    cells = float((n_ev.double() + n_km.double()).sum()) * W
    return bound(tensor_bytes(*args, *outs), cells * OPS_PER_CELL[name])


def phase1_gru(torch, np, dev):
    """Kernel F at 2^19 rows x 20 samples: seeded codes with padded tails
    (0 to 20 live samples a row), code 128 sprinkled in, and 1024 rows made
    only of q=128, whose dequantised value is 0.0 under IEEE division, so
    every step of them is masked and their state stays exactly 0."""
    from dnascent_tpu_torch.models import cnn, reference_cnn
    from dnascent_tpu_torch.ops import gru_cuda

    rng = np.random.default_rng(SEED + 9)
    n, t = 1 << 19, cnn.RAWDEPTH
    xq = np.clip(rng.normal(128, 30, (n, t)), 1, 255).astype(np.uint8)
    counts = rng.integers(0, t + 1, n)
    xq[np.arange(t)[None, :] >= counts[:, None]] = 0
    xq[rng.random((n, t)) < 0.01] = 128
    xq[:1024] = 128
    xq = torch.from_numpy(xq).to(dev)
    w = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(),
        reference_tensors()).gru.packed().detach().to(dev)
    got, row = compare(
        torch, "GRU encoder", lambda: gru_cuda.gru_encoder(xq, w),
        lambda: gru_cuda.gru_encoder_plain(xq, w), 10, [n, t],
        atol=GRU_ATOL)
    if bool((got[:1024] != 0).any()):
        fail("GRU encoder: a step of the code q=128 was not masked")
    live = float(((xq != 0) & (xq != 128)).sum())
    row.update(bound(tensor_bytes(xq, w, got),
                     live * OPS_PER_CELL["gru_encoder"]))
    return row


def cpu_agreement(torch, np, models, model, dev, tol):
    """Four 2 kb reads through ``detect_reads`` on the CPU and on CUDA with
    the same weights: read sets and positions equal, probabilities within
    ``tol``."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    from dnascent_tpu_torch.pipeline.detect import detect_reads

    runs = []
    for d in ("cpu", dev):
        src = SimulatedSource(models, DNA_R10, n_reads=4, length=2000,
                              seed=SEED + 200)
        runs.append(dict(detect_reads(src, models, model.to(d), device=d)))
    model.to(dev)
    cpu, gpu = runs
    if cpu.keys() != gpu.keys() or not cpu:
        fail(f"CPU/CUDA read sets differ: {sorted(cpu)} vs {sorted(gpu)}")
    err = 0.0
    n_pos = 0
    for rid in cpu:
        a, b = cpu[rid], gpu[rid]
        if not (np.array_equal(a.ref_coords, b.ref_coords)
                and np.array_equal(a.kmer_starts, b.kmer_starts)):
            fail(f"{rid}: CPU and CUDA positions differ")
        n_pos += a.ref_coords.shape[0]
        err = max(err, float(np.abs(a.brdu_prob - b.brdu_prob).max()),
                  float(np.abs(a.edu_prob - b.edu_prob).max()))
    if err > tol:
        fail(f"CPU/CUDA probabilities differ by {err} > {tol}")
    return dict(reads=len(cpu), t_positions=n_pos, max_prob_diff=err,
                tol=tol)


def drive(torch, np, models, model, dev, counters, required, n_reads=64,
          length=10000, absent=()):
    """One path: ``n_reads`` reads of ``length`` at batch 32 through
    ``detect_reads`` on CUDA, written as ``.detect``; every kernel named in
    ``required`` must have launched in this run, none in ``absent``."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    from dnascent_tpu_torch.io.writers import DetectHRWriter, detect_header
    from dnascent_tpu_torch.pipeline.detect import DetectStats, detect_reads

    records = list(SimulatedSource(models, DNA_R10, n_reads=n_reads,
                                   length=length, seed=SEED + 300))
    stats = DetectStats()
    n_sites = 0
    n_written = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "smoke.detect")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        with DetectHRWriter(out) as w:
            w.write_header(detect_header("simulated", "simulated", "none", 1,
                                         20, 1000, compute="GPU"))
            for _rid, d in detect_reads(iter(records), models, model, DNA_R10,
                                        device=dev, batch_size=32,
                                        stats=stats):
                probs = np.concatenate([d.brdu_prob, d.edu_prob])
                if not (np.isfinite(probs).all() and (probs >= 0).all()
                        and (probs <= 1).all()):
                    fail(f"{d.record.read_id}: probabilities out of [0, 1]")
                if d.kmer_starts.shape != d.ref_coords.shape:
                    fail(f"{d.record.read_id}: call table shapes differ")
                w.write(d)
                n_sites += d.ref_coords.shape[0]
                n_written += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.count for k, c in counters.items()}
        with open(out) as fh:
            headers = sum(1 for line in fh if line.startswith(">"))
    peak = torch.cuda.max_memory_allocated()
    if headers != n_written or n_written == 0:
        fail(f"wrote {headers} read records, expected {n_written} > 0")
    if n_sites == 0:
        fail("no called sites")
    if stats.processed != n_reads:
        fail(f"processed {stats.processed} of {n_reads} reads")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on this path: {missing}")
    wrong = [k for k in absent if launches[k] != 0]
    if wrong:
        fail(f"kernels launched off this path: {wrong}")
    return dict(reads=n_reads, passed=n_written, failed_qc=stats.failed,
                called_sites=n_sites, wall_s=wall,
                reads_per_s=n_reads / wall, peak_mem_bytes=peak,
                launches=launches)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import numpy as np
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.poremodel import synthetic_model_set
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.ops import (banded_cuda, cuda_lib, gru_cuda,
                                        viterbi_cuda)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cmd_line(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    print(smi)
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    nvcc_v = cmd_line([cuda_lib.nvcc_path(), "--version"]).splitlines()
    t0 = time.perf_counter()
    cuda_lib.lib(verbose=True)
    regs = ptxas_report(cuda_lib.build_log)
    print("phase 0 setup: " + json.dumps(dict(
        torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc_v[-1] if nvcc_v else "absent", triton=triton_v,
        device=torch.cuda.get_device_name(0),
        build_s=round(time.perf_counter() - t0, 3), ptxas=regs,
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        tf32_cudnn=torch.backends.cudnn.allow_tf32)), flush=True)

    models = synthetic_model_set(DNA_R10)
    rows = phase1_kernels(torch, np, models, dev)
    print("phase 1 kernels vs plain: " + json.dumps(rows), flush=True)

    model = cnn.init_untrained(cnn.DetectCNN(), seed=SEED).to(dev)
    p2 = cpu_agreement(torch, np, models, model, dev, PROB_ATOL_CPU)
    print("phase 2 cuda vs cpu detect: " + json.dumps(p2), flush=True)

    counters = {"banded_fill": banded_cuda.FILL_LAUNCHES,
                "banded_chase": banded_cuda.CHASE_LAUNCHES,
                "viterbi_fill": viterbi_cuda.FILL_LAUNCHES,
                "viterbi_backtrace": viterbi_cuda.BACKTRACE_LAUNCHES,
                "banded_fill_general": banded_cuda.GENERAL_FILL_LAUNCHES,
                "gru_encoder": gru_cuda.LAUNCHES}
    a_to_d = ("banded_fill", "banded_chase", "viterbi_fill",
              "viterbi_backtrace")
    p3 = drive(torch, np, models, model, dev, counters, a_to_d)
    print("phase 3 main path: " + json.dumps(p3), flush=True)

    ref = reference_model(dev)
    p4 = dict(cuda_vs_cpu=cpu_agreement(torch, np, models, ref, dev,
                                        REF_PROB_ATOL_CPU))
    p4.update(drive(torch, np, models, ref, dev, counters,
                    a_to_d + ("gru_encoder",)))
    print("phase 4 --model path: " + json.dumps(p4), flush=True)

    fit = fit_stdv_models(models)
    p5 = dict(cuda_vs_cpu=cpu_agreement(torch, np, fit, model, dev,
                                        PROB_ATOL_CPU))
    p5.update(drive(torch, np, fit, model, dev, counters,
                    ("banded_fill_general", "banded_chase", "viterbi_fill",
                     "viterbi_backtrace"), n_reads=32,
                    absent=("banded_fill",)))
    print("phase 5 fit-stdv path: " + json.dumps(p5), flush=True)

    # (source, TPU kernel, the path whose launch count the table shows)
    meta = {
        "banded_fill": ("dnascent_tpu_torch/csrc/banded_fill.cu",
                        "dnascent_tpu/ops/banded_pallas.py:345", p3),
        "banded_chase": ("dnascent_tpu_torch/csrc/banded_chase.cu",
                         "dnascent_tpu/ops/banded_pallas.py:875", p3),
        "viterbi_fill": ("dnascent_tpu_torch/csrc/viterbi_fill.cu",
                         "dnascent_tpu/ops/viterbi_pallas.py:38", p3),
        "viterbi_backtrace": ("dnascent_tpu_torch/csrc/viterbi_backtrace.cu",
                              "dnascent_tpu/ops/viterbi_pallas.py:225", p3),
        "banded_fill_general": ("dnascent_tpu_torch/csrc/banded_fill.cu",
                                "dnascent_tpu/ops/banded_pallas.py:41", p5),
        "gru_encoder": ("dnascent_tpu_torch/csrc/gru_encoder.cu",
                        "dnascent_tpu/models/reference_cnn.py:171", p4),
    }
    paths = {"phase3": p3, "phase4": p4, "phase5": p5}
    kernels = []
    for name, (src, rep, path) in meta.items():
        row = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=path["launches"][name],
            launches_by_path={k: v["launches"][name]
                              for k, v in paths.items()},
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_us=row["bound_ms"] * 1e3, bound_by=row["bound_by"],
            share_of_bound=row["bound_ms"] / row["ms"],
            library_ms=LIBRARY_MS, bytes=row["bytes"], ops=row["ops"],
            shape=row["shape"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
