#!/usr/bin/env python3
"""Drive the PyTorch port's detect main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each:
  0. set-up: card name and power limit, torch/CUDA/nvcc/triton versions,
     build of the four CUDA kernels from ``dnascent_tpu_torch/csrc``;
  1. each kernel against its plain PyTorch twin on the card, at the main
     path's shapes (banded fill and chase: 32 reads of 10 kb; Viterbi fill
     and backtrace: 2048 windows, T=192, N=48), with both times;
  2. four 2 kb reads through ``detect_reads`` on CUDA and on the CPU with
     the same weights: positions equal, probabilities within tolerance;
  3. the main path: 64 reads of 10 kb at batch 32 through ``detect_reads``
     on CUDA with the default-width DetectCNN (untrained, seeded weights),
     written as ``.detect``; every kernel must have launched.
The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the script
exits non-zero without that line, as it does without CUDA.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

# the port never uses jax; make any accidental import fail loudly
for _mod in ("jax", "flax", "optax"):
    sys.modules[_mod] = None

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# tolerances (see PERF.md): kernels are built with -fmad=false and follow
# their plain twins op for op, so every output must be bitwise equal; the
# CUDA-vs-CPU detect run differs only in the bf16 CNN (cuDNN vs oneDNN)
PROB_ATOL_CPU = 0.02


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cmd_line(args) -> str:
    res = subprocess.run(args, capture_output=True, text=True, timeout=60)
    return res.stdout.strip()


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


def compare(torch, name, kernel, plain, reps, shape):
    """Launch ``kernel`` once, time it over ``reps`` more launches, run its
    plain twin once (host clock: a Python loop of many small launches) and
    require every output to be bitwise equal.  Returns (kernel outputs,
    table row)."""
    got = kernel()
    torch.cuda.synchronize()
    ms = cuda_ms(torch, kernel, reps)
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    if not all(torch.equal(g, w) for g, w in zip(got_t, want_t)):
        fail(f"{name} disagrees with its plain twin")
    err = max(float((g.double() - w.double()).abs().max()) if g.numel()
              else 0.0 for g, w in zip(got_t, want_t))
    return got, dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, shape=shape)


def phase1_kernels(torch, np, models, dev):
    from dnascent_tpu.config import DNA_R10
    from dnascent_tpu.pipeline.source import SimulatedSource
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
        lambda: banded_cuda.banded_fill_plain(*fill_args, **kw), 3,
        list(fill_args[0].shape) + [fill_args[1].shape[1]])

    chase = (got[0], got[1], got[2], fill_args[3])
    _, rows["banded_chase"] = compare(
        torch, "backtrace chase", lambda: banded_cuda.backtrace_moves(*chase),
        lambda: banded_cuda.backtrace_moves_plain(*chase), 10,
        list(got[0].shape))

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

    _, kind0 = tvit.terminate(*got[1:], n_st, eM2MorD, logs[2])
    bargs = (got[0], kind0, n_obs, n_st, T + N)
    _, rows["viterbi_backtrace"] = compare(
        torch, "Viterbi backtrace",
        lambda: viterbi_cuda.viterbi_backtrace(*bargs),
        lambda: viterbi_cuda.viterbi_backtrace_plain(*bargs), 10, [T, N, W])
    return rows


def phase2_cpu_agreement(torch, np, models, model, dev):
    from dnascent_tpu.config import DNA_R10
    from dnascent_tpu.pipeline.source import SimulatedSource
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
    if err > PROB_ATOL_CPU:
        fail(f"CPU/CUDA probabilities differ by {err} > {PROB_ATOL_CPU}")
    return dict(reads=len(cpu), t_positions=n_pos, max_prob_diff=err,
                tol=PROB_ATOL_CPU)


def phase3_main_path(torch, np, models, model, dev, counters, n_reads=64,
                     length=10000):
    from dnascent_tpu.config import DNA_R10
    from dnascent_tpu.pipeline.source import SimulatedSource
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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
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
    import dnascent_tpu_torch  # noqa: F401  (sets DNASCENT_TPU_NO_CACHE)
    from dnascent_tpu.config import DNA_R10
    from dnascent_tpu.io.poremodel import synthetic_model_set
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.ops import banded_cuda, cuda_lib, viterbi_cuda

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
    regs = [line.split(":", 1)[1].strip() for line in
            cuda_lib.build_log.splitlines() if "Used" in line]
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
    p2 = phase2_cpu_agreement(torch, np, models, model, dev)
    print("phase 2 cuda vs cpu detect: " + json.dumps(p2), flush=True)

    counters = {"banded_fill": banded_cuda.FILL_LAUNCHES,
                "banded_chase": banded_cuda.CHASE_LAUNCHES,
                "viterbi_fill": viterbi_cuda.FILL_LAUNCHES,
                "viterbi_backtrace": viterbi_cuda.BACKTRACE_LAUNCHES}
    p3 = phase3_main_path(torch, np, models, model, dev, counters)
    print("phase 3 main path: " + json.dumps(p3), flush=True)

    meta = {
        "banded_fill": ("dnascent_tpu_torch/csrc/banded_fill.cu",
                        "dnascent_tpu/ops/banded_pallas.py:345"),
        "banded_chase": ("dnascent_tpu_torch/csrc/banded_chase.cu",
                         "dnascent_tpu/ops/banded_pallas.py:875"),
        "viterbi_fill": ("dnascent_tpu_torch/csrc/viterbi_fill.cu",
                         "dnascent_tpu/ops/viterbi_pallas.py:38"),
        "viterbi_backtrace": ("dnascent_tpu_torch/csrc/viterbi_backtrace.cu",
                              "dnascent_tpu/ops/viterbi_pallas.py:225"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=p3["launches"][name],
                    max_abs_err=rows[name]["max_abs_err"],
                    ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"])
               for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
