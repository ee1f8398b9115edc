#!/usr/bin/env python3
"""Drive the PyTorch port's detect main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each:
  0. set-up: card name and power limit, torch/CUDA/nvcc/triton versions,
     build of the seven CUDA kernels (six sources, one nvcc each, in
     parallel) from ``dnascent_tpu_torch/csrc``, with ptxas's register
     and spill counts;
  1. each kernel against its plain PyTorch twin on the card, with both
     times: the static and the per-k-mer-stdv fills and the chase at the
     main path's 32 reads of 10 kb; the Viterbi fill and the Viterbi
     termination and backtrace at 2048 windows, T=192, N=48 (the latter
     also at s_rows 192, a 64-bucket below T+N); the GRU encoder at 2^19
     rows of 20 samples (padded tails, rows of the code q=128), beside its
     library yardstick
     (``gru.gru_encoder_library``: ``torch.nn.GRU`` over each row's live
     steps, TF32 off), timed whole and as the bare ``nn.GRU`` call; the
     reference trunk's epilogue (``ops/trunk_epilogue_cuda.py``) on the 34
     conv results of one forward of the reference topology at the path's
     32 x 10,240 positions, each launch bitwise against its twin (the
     module chain's ops), timed alone (the largest) and over the 34, beside
     their byte bound and the twin's time over the same 34, and the trunk's
     two routes on one input (fused: cached weights and the epilogue; the
     module chain), device and host time a pass;
  2. four 2 kb reads through ``detect_reads`` on CUDA and on the CPU with
     the same DetectCNN weights: positions equal, probabilities within
     tolerance;
  3. the main path: 64 reads of 10 kb at batch 32 through ``detect_reads``
     on CUDA with the default-width DetectCNN (untrained, seeded weights),
     written as ``.detect``; kernels A-D must have launched; prints the
     (W, T, N) of each Viterbi fill launch;
  4. the ``--model`` path: the reference CNN topology, its seeded
     synthetic weights (non-zero biases and BatchNorm statistics, as
     trained weights have) written as a SavedModel directory and read back by
     the port's loader; CPU against CUDA on four 2 kb reads, then 64 reads
     of 10 kb at batch 32 on CUDA; kernels A-D and F must have launched;
     prints the histogram of live steps per row fed to F; the trunk
     epilogue must have launched 34 times a forward;
  5. the fit-stdv path: a pore model whose stdv varies per k-mer; CPU
     against CUDA on four 2 kb reads, then 32 reads of 10 kb on CUDA;
     kernel E must have launched and kernel A must not;
  6. the flow after detect: (a) 64 reads of 10 kb, half of them reverse,
     each with a BAM record (all-M CIGAR, SEQ in SAM orientation), at
     batch 32 through ``detect_reads`` on CUDA with phase 3's DetectCNN,
     written as modbam ``.bam`` and as ``.detect``; kernels A-D must have
     launched; the ``.bam`` read back with ``iter_modbam_detected_reads``
     must give the ``.detect`` coordinates (reverse reads one higher: the
     modbam reader's convention, coord = refEnd - index) and
     probabilities within 1/255; (b) ``forksense_run`` over 1024 synthetic
     12-20 kb fork reads of varied span (half right, half left forks; in a
     quarter the BrdU track reaches the read end) on the host, at least
     90 % of them yielding their fork; (c) the ``seeBreaks`` CLI on (b)'s
     beds in parity mode (native RNG; expected and observed read-end
     fractions must be non-zero) and with ``--fast`` on CUDA, the
     device bootstrap alone at 5000 iterations x 20,000 forks x the six end
     tolerances, and at 5000 x 4000 against the numpy bootstrap in
     distribution;
  7. align and the training tables, on simulated in-memory reads: (a) 32
     reads of 10 kb, half of them reverse, at batch 32 through
     ``align_reads`` on CUDA in strict mode (the reference's window
     coupling: kernels C and D once a wavefront round), written as
     ``.align``; kernels A-D must have launched, C and D as often as each
     other; prints the rounds, the (W, T, N) and host time of each round,
     rows, wall, reads/s and peak memory; (b) the same reads in fast mode
     (``--fast-windows``), the two modes run in turns (strict, fast, fast,
     strict), and the strict/fast wall ratio; (c) four 2 kb reads, strict
     and fast, on CUDA and on the CPU: the same rows in the same order,
     coordinate and k-mer columns equal, numeric columns within 1e-5, the
     texts byte-equal; (d) trainCNN's tables of 8 of (a)'s reads with phase 3's
     DetectCNN: with the two call columns removed, (b)'s text for those
     reads byte for byte; exactly the rows of centre-T k-mers carry calls,
     in [0, 1]; (e) trainGMM's EM (``em_prior_batch``) on CUDA over two
     chunks of 2048 k-mers x 10,000 events of seeded two-component
     mixtures, its time and peak memory, and against the CPU on a 256-k-mer
     slice within 1e-5; ``train_gmm`` end to end over 512 k-mers, its table
     written and read back with ``import_traingmm_model``;
  8. ``detect --HMM`` and CNN fitting, on simulated in-memory reads: (a) 32
     reads of 10 kb, half of them reverse, as one batch through
     ``hmm_detect_reads`` on CUDA (kernels A and B in prep; C, D and F must
     not launch): windows, T, the forward's device time a batch (CUDA
     events, both passes) against its bound, its device operations a pass
     (``torch.profiler``), reads/s and peak memory; every line must parse
     and every LLR be finite; (b) four 2 kb reads on CUDA and on the CPU:
     equal lines, LLRs within 1e-4; (c) ``batches_from_labelled_reads`` of
     8 of (a)'s reads (label BrdU, seq_len 1024, batch 8) on CUDA, then 10
     steps of each architecture at full width on CUDA (the DetectCNN at 128
     x 8 blocks, the reference topology from its seeded weights): ms a step
     and peak memory; losses finite, the reference topology's BatchNorm
     moving statistics unchanged, kernel F not launched (float windows take
     the plain scan), and the npz written and read back into equal weights;
     (d) one step of each architecture on CUDA and on the CPU from equal
     weights on 2 x 1024 positions of (c)'s first batch: losses within
     1e-2;
  9. multi-device and multi-process runs (``dnascent_tpu_torch/parallel``):
     (a) phase 3's 64 reads through ``detect_reads`` on the device set
     [cuda:0], then [cuda:0, cuda:0] (two replicas whose batches
     alternate): both ``.detect`` bodies byte-equal to phase 3's, A-D's
     launches and reads/s of each run; (b) two worker processes on the
     card, each running its shard ``records[k::2]`` through
     ``detect_reads`` into ``<out>.host<k>``, then joining a gloo group at a
     free localhost port: the per-read call counts gathered by ordinal
     equal (a)'s vector, and process 0's merge of the shards equals (a)'s
     text through the same merge; (c) in the same workers, the forkSense
     and seeBreaks CLIs with ``--coordinator localhost:<port> --nprocs 2
     --procid k`` on phase 6's 1024 fork reads, against single runs here:
     the same ``#EstimatedRegion`` lines, sorted blocks and beds, and
     seeBreaks output; (d) ``data_parallel_train_step`` with two full-width
     DetectCNN replicas on cuda:0 against one, one step at 8 x 1024
     positions: the loss gap and the largest parameter gap; (e)
     ``sequence_sharded_apply`` with two shards along 8 x 4096 positions
     against the unsharded forward: the largest gap;
 10. stage telemetry, the CPU baseline and the writers: (a) phase 3's 64
     reads through ``detect_reads`` on CUDA with a ``StageTimer``: the
     three stage totals and call counts, the ``.detect`` body byte-equal
     to phase 3's (SHA-256) and the launches phase 3's (A 2, B 2, C 6, D
     6, E and F none); (b) ``native.baseline_detect_read``, the scalar C++
     detect hot path, on 8 of those reads pinned to one core: seconds and
     checksum a read (NaN a QC failure), the host's CPU model and cores,
     and how many reads' QC outcome agrees with (a)'s (printed, not gated:
     the baseline windows its Viterbi as ``bench.py`` does); (c) the
     port's FASTA, BAM and pore-model writers read back through its
     readers; ``testing.dataset.build_dataset``'s files in pod5 (VBZ
     through pyarrow's zstd codec: the phase fails without it) and, where
     h5py is present, in fast5, through ``cli.main(["detect", ...])``
     with ``--device cuda`` and ``cpu``: the same reads and positions,
     probabilities within phase 2's tolerance; a missing h5py is printed
     on a line of its own;
 11. the port's benchmark, ``bench_torch.py``, run as a subprocess at a
     reduced size (64 reads of 10 kb, 2 passes at pipeline depths 1 and
     10, no 50 kb point, a mixed point of 8 reads, ``BENCH_BASELINE`` set
     so that the CPU baseline is not measured: its ``vs_baseline`` is no
     reading): its last line must parse, its gate pass, its value and peak
     device memory be positive, and its launch counts show A-D and F (E
     none); then ``graft_entry.entry()`` and ``dryrun_multichip(n)`` at
     their default device, the card (n the visible cards);
 12. the users' command lines on pod5 files: 128 simulated 10 kb reads
     (seeded) written by ``testing.dataset.build_dataset`` as FASTA, one
     pod5 file and BAM, and the reference topology's seeded weights as a
     SavedModel directory; then, each as ``python -m dnascent_tpu_torch``
     in a fresh interpreter on the default device, exit code 0: ``index``
     (its map equal to the dataset's index), ``detect --model`` to
     ``.detect`` and to ``.bam``, ``align`` and ``forkSense`` on each
     detect output (line counts of every file it writes, each with its
     header); the same detect in this process through ``cli.main``
     (kernels A-D and F must launch, E not; the ``.detect`` body byte-equal
     to the subprocess's) and through ``detect_reads`` over
     ``BamSignalSource``'s records at the CLI's batch size and depth (byte-
     equal too); the ``.bam`` against the ``.detect`` as in phase 6, every
     ``.align`` table checked as in phase 7, every read's decoded pod5
     samples equal to the int16 samples the writer stored; prints each
     command's wall time and reads/s, seconds a read of the read source and
     of ``pod5_get_signal``, VBZ decode MB/s, the pod5 bytes, the detect's
     peak device memory and the per-read fetch at 128 and 4096 reads a file
     (``scripts/bench_pod5_lookup.py``);
 13. the BrdU/EdU fork workflow of ``tests/test_workflow_e2e.py`` at a
     user's size (``testing/painted.py``): (a) 96 painted 10 kb reads (one
     BrdU and one EdU track of 1.5-3.5 kb each, seeded lengths, order and
     places) through ``batches_from_labelled_reads`` on CUDA (kernels A-D
     must launch), then the full-width DetectCNN fitted from its seeded
     weights with AdamW (steps, ms a step, peak memory; its last loss below
     0.6 x its first), written as the npz ``--cnn-weights`` reads; (b) 256
     painted 20 kb reads (96 right forks, 96 left forks, 64 origins, tracks
     of 2-4 kb; in about a quarter of the fork reads the BrdU track runs
     to the read end) written as FASTA, one pod5 file, BAM, index and
     truth; ``detect --cnn-weights`` as ``python -m dnascent_tpu_torch`` in
     a fresh interpreter on the default device, and ``detect_reads`` over
     ``BamSignalSource``'s records in this process (A-D launched, E and F
     not; body byte-equal to the subprocess's); (c) CUDA against the CPU
     with the fitted weights on four painted 3 kb reads, within phase 2's
     tolerance; (d) each analogue's mean probability inside its tracks
     over its mean outside every track above 2 in at least 90 % of the
     QC-passing reads; (e) the forkSense CLI (host): at least 70 % of the
     right-fork reads with a ``rightForks`` call across their EdU->BrdU
     boundary, the same for left forks, at most 5 % of the fork reads with
     a fork of the wrong direction, origin recall printed; (f) the
     seeBreaks CLI on forkSense's beds as in phase 6c.
Each path's launch counts are set to 0 just before it and read just after.
The shapes of phases 3-5 (each path's C launches and F's live-step
histogram, recorded by observers around the wrappers) show whether phase
1's shapes stand for the path.
The line before the last is the kernel table as JSON: per kernel its launches
on the path that runs it (and on each path), its time and its plain twin's,
its bound (``bound_ms``/``bound_us``: this run's bytes over the card's
memory rate or its operations over their type's rate, f32 or, for F's
tensor-core products, TF32, whichever is larger, named by ``bound_by``),
``share_of_bound`` = bound / time, and ``library_ms``: the time of one
PyTorch call computing the same function where there is one (F), else
null, with ``library_note`` saying why.  The last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the script
exits non-zero without that line, as it does without CUDA.  The script
imports nothing of jax or of the JAX package ``dnascent_tpu``.
"""

import contextlib
import dataclasses
import io
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
# must be bitwise equal; the GRU encoder's 3xTF32 tensor-core products and
# __expf-based sigmoid/tanh differ from torch's by a few 1e-7, so it is held
# to the JAX contract's 2e-5, with its masked steps (the code q=128) exactly
# as the twin's; the CUDA-vs-CPU detect runs differ only in the bf16 CNN
# (cuDNN vs oneDNN), and the reference topology's 40 bf16 conv layers
# spread further than the DetectCNN's 17
PROB_ATOL_CPU = 0.02
REF_PROB_ATOL_CPU = 0.05
GRU_ATOL = 2e-5
# --HMM: the forward's CUDA and CPU log-likelihoods differ by f32 rounding
# of their log-sum-exp chains (the CPU test against the JAX package holds
# 1e-4 on the printed LLR); a training step's loss, CUDA against CPU, by
# the bf16 layers' rounding in cuDNN and oneDNN
LLR_ATOL_CPU = 1e-4
LOSS_ATOL_CPU = 1e-2
# published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): memory
# rate, float32 rate outside the tensor cores (A-E are f32 or integer work)
# and the dense TF32 tensor-core rate (F's products); a fused multiply-add
# counts as two operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 495e12
# operations a cell of each kernel does on its inputs, counted from the
# sources: A x-mu, t*t, h_c*, four adds, the skip add, two maxes; E the
# emission's two multiplies and two adds plus the same six; C the emission
# (5), insertion (4), match (8), deletion chain (7) and pointer (2) updates;
# F three TF32 multiply-adds (3xTF32) per weight of the two GRU cells' three
# matrices (768 + 768 + 768) a live step, at the TF32 rate (its input row
# and gate math run on the f32 pipes and are not counted)
OPS_PER_CELL = {"banded_fill": 10, "banded_fill_general": 12,
                "viterbi_fill": 26, "gru_encoder": 3 * 2 * 2304}
# the --HMM forward (ops/hmm.py), a (window, state) cell a step, counting a
# log-add-exp as 6 (max, subtract, abs, exp, log1p, add) and not the
# selects: emission 5, insertion 8, match 21 + first state 12 + 1, the
# deletion chain's prefix and update 16
OPS_PER_HMM_CELL = 64
# the kernels no single PyTorch call computes (library_ms null), and why;
# F's library_ms is measured in phase 1
LIBRARY_NOTES = {
    "banded_fill": "no PyTorch call: an adaptive banded DP emitting trace "
                   "codes and band moves",
    "banded_chase": "no PyTorch call: a data-dependent walk of trace codes",
    "viterbi_fill": "no PyTorch call: a max-product DP emitting argmax "
                    "pointer codes",
    "viterbi_backtrace": "no PyTorch call: termination and a data-dependent "
                         "walk of pointer codes",
    "banded_fill_general": "no PyTorch call: kernel A's DP with per-k-mer "
                           "emissions",
    "gru_encoder": "torch.nn.GRU(1, 16, num_layers=2) over each row's live "
                   "steps packed (a masked step carries the state, the same "
                   "as deleting it): whole gru_encoder_library, TF32 off",
    "trunk_epilogue": "no single PyTorch call: bias, BatchNorm, residual add, "
                      "ReLU and cast are the module chain's separate ops, "
                      "timed as plain_ms",
}


# the kernels every detect path runs: fill, chase, Viterbi fill, backtrace
A_TO_D = ("banded_fill", "banded_chase", "viterbi_fill", "viterbi_backtrace")


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


def cuda_ms(torch, fn, reps: int, spin: int = 200_000) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events).  The
    card first spins for ``spin`` cycles (~0.1 ms by default) a call, so the
    host has queued every call before the first runs: a kernel shorter than
    its wrapper's host work is timed back to back, not at the host's issue
    rate."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes: float, ops: float, ops_rate=PEAK_F32_OPS_PER_S) -> dict:
    """The least time the card could take: bytes that must move (each input
    read once, each output written once) over the memory rate, or
    operations over their type's rate, whichever is larger."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / ops_rate * 1e3
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
    from dnascent_tpu_torch.ops import banded_cuda, viterbi_cuda
    from dnascent_tpu_torch.pipeline import prep

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

    vargs, eM2MorD = viterbi_inputs(torch, np, models, dev)
    T, W = vargs[0].shape
    N = vargs[1].shape[0]
    n_obs, n_st, logs = vargs[4], vargs[5], vargs[9]
    got, rows["viterbi_fill"] = compare(
        torch, "Viterbi fill", lambda: viterbi_cuda.viterbi_fill_codes(*vargs),
        lambda: viterbi_cuda.viterbi_fill_plain(*vargs), 10, [T, N, W])
    # live cells: observations before each window's count, states inside it
    live = float((n_obs.double() * n_st.double()).sum())
    rows["viterbi_fill"].update(bound(
        tensor_bytes(*vargs[:9], *got),
        live * OPS_PER_CELL["viterbi_fill"]))

    dargs = (*got, n_obs, n_st, eM2MorD, logs[2])
    for s_rows in (T + N, 192):
        path, row = compare(
            torch, f"Viterbi termination and backtrace, s_rows {s_rows}",
            lambda: viterbi_cuda.viterbi_terminate_backtrace(*dargs, s_rows),
            lambda: viterbi_cuda.viterbi_terminate_backtrace_plain(
                *dargs, s_rows), 10, [T, N, W, s_rows])
        # it reads the three finals at n_states-1, eM2MorD, the two counts
        # and one code byte a step of each window's path
        row.update(bound(tensor_bytes(n_obs, n_st, eM2MorD, *path)
                         + 3 * 4 * W + int(path[1].sum()), 0))
        if s_rows == T + N:
            rows["viterbi_backtrace"] = row
        else:
            rows["viterbi_backtrace"]["s_rows_192"] = row

    rows["banded_fill_general"] = phase1_general_fill(torch, models, dev)
    rows["gru_encoder"] = phase1_gru(torch, np, dev)
    rows["trunk_epilogue"] = phase1_epilogue(torch, np, dev)
    return rows


def viterbi_inputs(torch, np, models, dev):
    """Kernel C's phase-1 inputs: 2048 seeded windows, T=192, N=48, 30 to
    42 states and 100 to 192 observations a window.  Returns (the fill's
    arguments, eM2MorD for termination)."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.ops import viterbi as tvit
    from dnascent_tpu_torch.pipeline.eventalign import HMM_KEY

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
    hmm = tuple(getattr(DNA_R10.hmm, k) for k in HMM_KEY)
    iM2M, eM2M, eOrIM2M, eM2MorD, logs = tvit.transition_scores(
        t(rng.uniform(1.8, 2.6, W).astype(np.float32)), hmm)
    return ((obs, mu, inv, lpc, n_obs, t(n_states), iM2M, eM2M, eOrIM2M,
             logs), eM2MorD)


def gru_inputs(torch, np, dev):
    """Kernel F's phase-1 inputs: 2^19 rows x 20 seeded codes with padded
    tails (0 to 20 live samples a row), code 128 sprinkled in, and 1024
    rows made only of q=128; the reference topology's seeded weights."""
    from dnascent_tpu_torch.models import cnn, reference_cnn

    rng = np.random.default_rng(SEED + 9)
    n, t = 1 << 19, cnn.RAWDEPTH
    xq = np.clip(rng.normal(128, 30, (n, t)), 1, 255).astype(np.uint8)
    counts = rng.integers(0, t + 1, n)
    xq[np.arange(t)[None, :] >= counts[:, None]] = 0
    xq[rng.random((n, t)) < 0.01] = 128
    xq[:1024] = 128
    w = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(),
        reference_tensors()).gru.packed().detach().to(dev)
    return torch.from_numpy(xq).to(dev), w


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
    """Kernel F at 2^19 rows x 20 samples (``gru_inputs``); the 1024 rows
    made only of q=128 dequantise to 0.0 under IEEE division, so every step
    of them is masked and their state stays exactly 0."""
    from dnascent_tpu_torch.ops import gru, gru_cuda

    xq, w = gru_inputs(torch, np, dev)
    n, t = xq.shape
    got, row = compare(
        torch, "GRU encoder", lambda: gru_cuda.gru_encoder(xq, w),
        lambda: gru_cuda.gru_encoder_plain(xq, w), 10, [n, t],
        atol=GRU_ATOL)
    if bool((got[:1024] != 0).any()):
        fail("GRU encoder: a step of the code q=128 was not masked")
    live = float(((xq != 0) & (xq != 128)).sum())
    row.update(bound(tensor_bytes(xq, w, got),
                     live * OPS_PER_CELL["gru_encoder"], PEAK_TF32_OPS_PER_S))
    # the yardstick: the same function as one library call, whole (live-step
    # compaction, packing, nn.GRU) and as the bare nn.GRU call
    lib_out = gru.gru_encoder_library(xq, w)
    lib_err = float((lib_out - got).abs().max())
    if not lib_err <= 2 * GRU_ATOL:  # each within GRU_ATOL of the twin
        fail(f"GRU yardstick differs from kernel F by {lib_err}")
    packed, _rows = gru.pack_live(xq)
    module = gru.library_gru(w)
    with torch.no_grad():
        module(packed)
        torch.cuda.synchronize()
        row["library_ms"] = cuda_ms(
            torch, lambda: gru.gru_encoder_library(xq, w), 10)
        row["library_gru_ms"] = cuda_ms(torch, lambda: module(packed), 10)
    row["library_max_abs_err_vs_kernel"] = lib_err
    return row


def phase1_epilogue(torch, np, dev):
    """The trunk epilogue at the path's shapes: one no-grad forward of the
    reference topology (seeded weights) at 32 x 10,240 positions with u8
    windows, its 34 epilogue calls' arguments recorded; each launch bitwise
    against the twin; the largest alone and the 34 together timed, beside
    the bytes they must move (conv results read once, outputs written
    once, tables) and the twin's time over the same 34.  Then the trunk on
    one lifted input both ways: the fused route (``_Inference.trunk``) and
    the module chain (``_trunk``), device time by CUDA events and host
    time a pass (the Python issuing the ops, no synchronise)."""
    from dnascent_tpu_torch.models import reference_cnn
    from dnascent_tpu_torch.ops import trunk_epilogue_cuda as ep

    B, L = 32, 10240
    model = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(), reference_tensors()).to(dev)
    rng = np.random.default_rng(SEED + 11)
    core = torch.from_numpy(rng.integers(1, 1025, (B, L))).to(dev)
    resid = torch.from_numpy(rng.integers(1, 257, (B, L))).to(dev)
    sig = np.clip(rng.normal(128, 30, (B, L, 20)), 1, 255).astype(np.uint8)
    sig[np.arange(20)[None, None, :] >= rng.integers(0, 21, (B, L))[
        ..., None]] = 0
    sig = torch.from_numpy(sig).to(dev)
    calls = []
    orig = reference_cnn.trunk_epilogue

    def recorded(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    reference_cnn.trunk_epilogue = recorded
    try:
        with torch.no_grad():
            model(core, resid, sig)
    finally:
        reference_cnn.trunk_epilogue = orig
    torch.cuda.synchronize()
    if len(calls) != 34:
        fail(f"trunk epilogue: {len(calls)} calls a forward, expected 34")

    def operands(args):
        return [t for t in args if t is not None]

    nbytes = 0
    for args, kw in calls:
        got = ep.trunk_epilogue(*args, **kw)
        want = ep.trunk_epilogue_plain(*args, **kw)
        if not torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8)):
            fail(f"trunk epilogue disagrees with its twin at "
                 f"{tuple(args[0].shape)}")
        nbytes += tensor_bytes(*operands(args), got)
    args, kw = max(calls, key=lambda c: sum(t.numel() for t in operands(
        c[0])))
    out, row = compare(torch, "trunk epilogue",
                       lambda: ep.trunk_epilogue(*args, **kw),
                       lambda: ep.trunk_epilogue_plain(*args, **kw), 10,
                       list(args[0].shape))
    row["form"] = "join" if len(args) > 2 and args[2] is not None else "bn"
    row.update(bound(tensor_bytes(*operands(args), out), 0))

    def all34(fn):
        for a, k in calls:
            fn(*a, **k)

    with torch.no_grad():
        row["forward_34"] = dict(
            launches=len(calls), bytes=nbytes,
            ms=cuda_ms(torch, lambda: all34(ep.trunk_epilogue), 5,
                       spin=2_000_000),
            plain_ms=cuda_ms(torch, lambda: all34(ep.trunk_epilogue_plain),
                             5, spin=20_000_000),
            bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
        del calls, args, out
        cache = model.inference_cache()
        feats = torch.zeros((B, L, 64), device=dev)
        feats[..., :18] = torch.randn((B, L, 18), device=dev)
        x = feats.transpose(1, 2)
        if not torch.equal(cache.trunk(x), model._trunk(x)):
            fail("the fused trunk differs from the module chain")
        trunk = {}
        for name, fn in (("fused", lambda: cache.trunk(x)),
                         ("module_chain", lambda: model._trunk(x))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            host_ms = (time.perf_counter() - t0) / 3 * 1e3
            torch.cuda.synchronize()
            trunk[name] = dict(device_ms=cuda_ms(torch, fn, 5,
                                                 spin=40_000_000),
                               host_ms=host_ms)
    row["trunk_pass"] = trunk
    return row


def cpu_agreement(torch, np, models, model, dev, tol, records=None):
    """Four reads (``records``, or simulated 2 kb reads) through
    ``detect_reads`` on the CPU and on CUDA with the same weights: read sets
    and positions equal, probabilities within ``tol``."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    from dnascent_tpu_torch.pipeline.detect import detect_reads

    runs = []
    for d in ("cpu", dev):
        src = records or SimulatedSource(models, DNA_R10, n_reads=4,
                                         length=2000, seed=SEED + 200)
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


class PathShapes:
    """Records, while a path runs, the (W, T, N) of each Viterbi fill
    launch and the histogram of live steps per row fed to the GRU encoder,
    by wrapping the wrappers (their launch counts are untouched)."""

    def __init__(self, torch):
        from dnascent_tpu_torch.models import reference_cnn
        from dnascent_tpu_torch.ops import gru, viterbi_cuda
        from dnascent_tpu_torch.pipeline import eventalign
        self.fill_shapes = []
        self.live_hist = None
        self.gru_calls = 0
        self.round_windows = []
        self.round_s = []
        self._patches = [(viterbi_cuda, "viterbi_fill_codes"),
                         (reference_cnn, "gru_encoder"),
                         (eventalign, "_strict_round")]
        self._orig = [getattr(m, n) for m, n in self._patches]
        fill, encoder, strict_round = self._orig

        def fill_observed(obs_T, mu, *args):
            self.fill_shapes.append([obs_T.shape[1], obs_T.shape[0],
                                     mu.shape[0]])
            return fill(obs_T, mu, *args)

        def encoder_observed(xq, w):
            self.gru_calls += 1
            counts = gru.dequantise(xq)[1].sum(dim=1)
            hist = torch.bincount(counts, minlength=xq.shape[1] + 1)
            self.live_hist = (hist if self.live_hist is None
                              else self.live_hist + hist)
            return encoder(xq, w)

        def round_observed(windows, *args):
            t0 = time.perf_counter()
            out = strict_round(windows, *args)
            self.round_s.append(time.perf_counter() - t0)
            self.round_windows.append(len(windows))
            return out

        self._wrapped = [fill_observed, encoder_observed, round_observed]

    def __enter__(self):
        for (m, n), fn in zip(self._patches, self._wrapped):
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self._patches, self._orig):
            setattr(m, n, fn)

    def report(self) -> dict:
        hist = (None if self.live_hist is None
                else self.live_hist.cpu().tolist())
        out = dict(viterbi_fill_WTN=self.fill_shapes,
                   gru_live_steps_hist=hist, gru_calls=self.gru_calls)
        if self.round_windows:
            out["strict_round_windows"] = self.round_windows
            out["strict_round_s"] = self.round_s
        return out


def with_bam_records(records):
    """The records with every second one on the reverse strand (sequence and
    signal stay in sequencing orientation, only the genome mapping flips, as
    the BAM source delivers reverse reads) and each given a BAM record: an
    all-M CIGAR at its start, SEQ in reference-forward orientation as SAM
    stores it.  Returns (records, BAM header text, ref names, ref lengths)."""
    from dnascent_tpu_torch.io import bam
    from dnascent_tpu_torch.utils.seqtools import reverse_complement
    out = []
    for i, r in enumerate(records):
        rev = i % 2 == 1
        seq = reverse_complement(r.reference_seq) if rev else r.reference_seq
        out.append(dataclasses.replace(
            r, is_reverse=rev, bam_record=bam.build_record(
                r.read_id, 0, r.ref_start, 60, [(bam.BAM_CMATCH, len(seq))],
                seq, flag=bam.FLAG_REVERSE if rev else 0)))
    contig, contig_len = out[0].contig, max(r.ref_end for r in out) + 1000
    header = f"@HD\tVN:1.6\tSO:unknown\n@SQ\tSN:{contig}\tLN:{contig_len}\n"
    return out, header, [contig], [contig_len]


def modbam_agreement(np, bam_path, detect_path):
    """The ``.bam`` read back against the ``.detect`` of the same run: per
    read, after sorting both by coordinate, equal coordinates (a reverse
    read's one higher, the modbam reader's convention) and probabilities
    within 1/255 (ML is p x 255 truncated)."""
    from dnascent_tpu_torch.io.modbam import iter_modbam_detected_reads
    from dnascent_tpu_torch.pipeline.forksense import parse_detect_file
    got = {r.read_id: r for r in iter_modbam_detected_reads(bam_path)}
    want = {r.read_id: r for r in parse_detect_file(detect_path)}
    if got.keys() != want.keys() or not got:
        fail(f"modbam reads {len(got)} differ from .detect reads {len(want)}")
    err, n_sites, n_rev = 0.0, 0, 0
    for rid, b in got.items():
        d = want[rid]
        ob = np.argsort(b.coords, kind="stable")
        od = np.argsort(d.coords, kind="stable")
        shift = 1 if b.strand == "rev" else 0
        n_rev += shift
        if b.strand != d.strand or not np.array_equal(b.coords[ob],
                                                      d.coords[od] + shift):
            fail(f"{rid}: modbam coordinates differ from .detect")
        err = max(err, float(np.abs(b.brdu[ob] - d.brdu[od]).max()),
                  float(np.abs(b.edu[ob] - d.edu[od]).max()))
        n_sites += b.coords.shape[0]
    if not err <= 1 / 255 + 1e-6:
        fail(f"modbam probabilities differ from .detect by {err}")
    return dict(reads=len(got), reverse_reads=n_rev, sites=n_sites,
                max_prob_diff=err, tol=1 / 255 + 1e-6)


def detect_body(path):
    """(read records, SHA-256 of the lines that are not header lines) of a
    ``.detect`` file: its bytes but the run's start time."""
    import hashlib
    h, n = hashlib.sha256(), 0
    with open(path, "rb") as fh:
        for line in fh:
            if not line.startswith(b"#"):
                h.update(line)
                n += line.startswith(b">")
    return n, h.hexdigest()


def drive(torch, np, models, model, dev, counters, required, n_reads=64,
          length=10000, absent=(), modbam=False):
    """One path: ``n_reads`` reads of ``length`` at batch 32 through
    ``detect_reads`` on CUDA, written as ``.detect`` (and with ``modbam`` as
    ``.bam`` too, half the reads reverse, then read back); every kernel
    named in ``required`` must have launched in this run, none in
    ``absent``."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    from dnascent_tpu_torch.io.modbam import ModBamWriter
    from dnascent_tpu_torch.io.writers import DetectHRWriter, detect_header
    from dnascent_tpu_torch.pipeline.detect import DetectStats, detect_reads

    records = list(SimulatedSource(models, DNA_R10, n_reads=n_reads,
                                   length=length, seed=SEED + 300))
    if modbam:
        records, *bam_header = with_bam_records(records)
    stats = DetectStats()
    n_sites = 0
    n_written = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "smoke.detect")
        bam_out = os.path.join(tmp, "smoke.bam")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            shapes = stack.enter_context(PathShapes(torch))
            w = stack.enter_context(DetectHRWriter(out))
            bw = (stack.enter_context(ModBamWriter(bam_out, *bam_header))
                  if modbam else None)
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
                if bw is not None:
                    bw.write(d)
                n_sites += d.ref_coords.shape[0]
                n_written += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.count for k, c in counters.items()}
        headers, body = detect_body(out)
        readback = modbam_agreement(np, bam_out, out) if modbam else None
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
    res = dict(reads=n_reads, passed=n_written, failed_qc=stats.failed,
               called_sites=n_sites, wall_s=wall,
               reads_per_s=n_reads / wall, peak_mem_bytes=peak,
               launches=launches, shapes=shapes.report(),
               body_sha256=body)
    if readback is not None:
        res["modbam_readback"] = readback
    return res


def phase6_forksense(np, tmp):
    """forkSense over 1024 synthetic 12-20 kb fork reads of varied span
    (512 right, 512 left; in about a quarter the BrdU track ends at the read
    end the fork moves towards) on the host; at least 90 % must yield their
    fork.  Writes the fork and BrdU beds and the reads as ``.detect`` into
    ``tmp`` for seeBreaks."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.forksense import forksense_run
    from dnascent_tpu_torch.testing.forks import (varied_fork_reads,
                                                  write_detect_file)

    reads = varied_fork_reads(512, 512, seed=SEED)
    t0 = time.perf_counter()
    inc, outputs = forksense_run(reads, "EdU,BrdU", DNA_R10)
    wall = time.perf_counter() - t0
    beds = {"left": ("left_forks", "lf-"), "right": ("right_forks", "rf-"),
            "brdu": ("brdu_beds", None)}
    paths, found = {}, set()
    for key, (attr, prefix) in beds.items():
        paths[key] = os.path.join(tmp, f"{key}.bed")
        with open(paths[key], "w") as fh:
            fh.write("#Software dnascent_tpu_torch\n")
            for o in outputs:
                for line in getattr(o, attr):
                    fh.write(line)
                    rid = line.split()[3]
                    if prefix and rid.startswith(prefix):
                        found.add(rid)
    yield_frac = len(found) / len(reads)
    if yield_frac < 0.9:
        fail(f"forkSense found the fork of {yield_frac:.3f} of the reads")
    paths["detect"] = os.path.join(tmp, "forks.detect")
    write_detect_file(reads, paths["detect"])
    return paths, dict(reads=len(reads), wall_s=wall,
                       reads_per_s=len(reads) / wall,
                       distinct_spans=len({(r.ref_start, r.ref_end)
                                           for r in reads}),
                       fork_yield=yield_frac, brdu_p=inc.centroid_1,
                       edu_p=inc.centroid_2)


def read_seebreaks(np, path):
    """(header values by key, expected fractions, observed fractions) of a
    ``.seeBreaks`` file; fails unless every value is finite."""
    head, vals, cur = {}, {}, None
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                k, _, v = line[1:].rstrip("\n").partition(" ")
                head[k] = v
            elif line.startswith(">"):
                cur = vals.setdefault(line[1:].strip(), [])
            else:
                cur.append(float(line))
    sim = np.asarray(vals.get("ExpectedReadEndFractions:", []))
    obs = np.asarray(vals.get("ObservedReadEndFractions:", []))
    stats = [float(head[k]) for k in ("ExpectedReadEndFraction",
                                      "ObservedReadEndFraction", "Difference")]
    if not (sim.size and obs.size and np.isfinite(sim).all()
            and np.isfinite(obs).all() and np.isfinite(stats).all()):
        fail(f"{path}: a malformed .seeBreaks file")
    return head, sim, obs


def within_distribution(np, got, want, what):
    """The asserts of the JAX package's device-bootstrap test: means within
    5 standard errors + 1e-3, spreads within 15 %."""
    se = want.std(ddof=1) / np.sqrt(want.shape[0])
    d_mean = abs(float(got.mean()) - float(want.mean()))
    d_std = abs(float(got.std()) - float(want.std()))
    if not (d_mean < 5 * se + 1e-3
            and d_std < 0.15 * max(float(want.std()), 1e-3)):
        fail(f"{what}: mean off by {d_mean} (5 se {5 * se}), spread by "
             f"{d_std} (sd {want.std()})")
    return dict(mean=float(got.mean()), ref_mean=float(want.mean()),
                mean_diff=d_mean, five_se=5 * se, std=float(got.std()),
                ref_std=float(want.std()))


def seebreaks_modes(np, paths, what):
    """The seeBreaks CLI on fork and BrdU beds and their ``.detect``
    (``paths``: left, right, brdu, detect), parity mode (host) then
    ``--fast`` on the card; both fractions of parity mode must be non-zero
    (so the comparison can fail) and ``--fast``'s must lie within parity
    mode's distribution."""
    from dnascent_tpu_torch import cli

    out, fractions = {}, {}
    for mode, extra in (("parity", []), ("fast_cuda", ["--fast"])):
        path = paths["detect"][: -len(".detect")] + f".{mode}.seeBreaks"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["seeBreaks", "-l", paths["left"], "-r",
                           paths["right"], "-a", paths["brdu"], "-d",
                           paths["detect"], "-o", path, *extra])
        if rc != 0:
            fail(f"{what}: seeBreaks {mode} returned {rc}")
        head, *fractions[mode] = read_seebreaks(np, path)
        out[mode] = dict(wall_s=time.perf_counter() - t0,
                         n_forks=int(head["nForks"]),
                         expected=float(head["ExpectedReadEndFraction"]),
                         observed=float(head["ObservedReadEndFraction"]),
                         difference=float(head["Difference"]),
                         iterations=int(fractions[mode][0].shape[0]))
    (sim_p, obs_p), (sim_f, obs_f) = fractions["parity"], fractions["fast_cuda"]
    if not (sim_p.mean() > 0 and obs_p.mean() > 0):
        fail(f"{what}: seeBreaks parity: expected {sim_p.mean()}, observed "
             f"{obs_p.mean()}; both must be non-zero")
    out["fast_vs_parity"] = dict(
        expected=within_distribution(np, sim_f, sim_p,
                                     f"{what}: fast vs parity sim"),
        observed=within_distribution(np, obs_f, obs_p,
                                     f"{what}: fast vs parity obs"))
    return out


def phase6_seebreaks(torch, np, dev, paths):
    """The seeBreaks CLI on phase 6's beds, parity mode then ``--fast`` on
    the card (the reads' varied spans and end-reaching tracks make both
    fractions non-zero); the device bootstrap alone at full width; and at
    5000 x 4000 against the numpy bootstrap."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline import seebreaks as sb

    out = seebreaks_modes(np, paths, "6c")

    p = DNA_R10.seebreaks
    tols = list(range(p.end_tolerance_r10, p.end_tolerance_r10
                      + p.end_tolerance_sweep + 1, p.end_tolerance_step))
    rng = np.random.default_rng(SEED + 600)

    def inputs(n_forks):
        v5 = rng.integers(0, 100_000_000, n_forks).astype(np.int64)
        v3 = v5 + rng.integers(20_000, 80_000, n_forks)
        lens = rng.integers(2000, 9000, n_forks).astype(np.int64)
        return v5, v3, lens, rng.random(n_forks) < 0.3

    # full width: 5000 iterations x 20,000 forks x the six tolerances
    v5, v3, lens, runoffs = inputs(20_000)
    sb.bootstrap_fast_device(v5, v3, lens, runoffs, 10, p.rng_seed,
                             p.forksense_boundary, tols[0], dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for tol in tols:
        sim, obs = sb.bootstrap_fast_device(
            v5, v3, lens, runoffs, p.bootstrap_iterations, p.rng_seed,
            p.forksense_boundary, tol, dev)
        if not (np.isfinite(sim).all() and np.isfinite(obs).all()):
            fail("device bootstrap: non-finite fractions")
    out["device_bootstrap_full"] = dict(
        iterations=p.bootstrap_iterations, forks=20_000, tolerances=tols,
        wall_s=time.perf_counter() - t0,
        peak_mem_bytes=torch.cuda.max_memory_allocated())

    # 5000 x 4000 at one tolerance: the device grid against numpy's
    v5, v3, lens, runoffs = inputs(4000)
    args = (p.bootstrap_iterations, p.rng_seed, p.forksense_boundary,
            tols[0])
    t0 = time.perf_counter()
    sim_np = sb.simulation_fast(v5, v3, lens, 4000, *args)
    obs_np = sb.observation_fast(runoffs, p.bootstrap_iterations, p.rng_seed)
    numpy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim_dv, obs_dv = sb.bootstrap_fast_device(v5, v3, lens, runoffs, *args,
                                              dev)
    device_s = time.perf_counter() - t0
    out["device_vs_numpy_5000x4000"] = dict(
        numpy_s=numpy_s, device_s=device_s,
        sim=within_distribution(np, sim_dv, sim_np, "device vs numpy sim"),
        obs=within_distribution(np, obs_dv, obs_np, "device vs numpy obs"))
    return out


def align_records(models, n_reads, length, seed):
    """Simulated reads, every second one on the reverse strand (sequence
    and signal stay in sequencing orientation; only the genome mapping
    flips, as the BAM source delivers reverse reads)."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    return [dataclasses.replace(r, is_reverse=i % 2 == 1)
            for i, r in enumerate(SimulatedSource(
                models, DNA_R10, n_reads=n_reads, length=length, seed=seed))]


def check_table(np, rid, text, call_columns=False):
    """A read's eventalign table: its header, then rows of five columns
    (seven on call rows with ``call_columns``), finite values.  Returns
    the row count."""
    lines = text.split("\n")
    if not (lines[0].startswith(f">{rid} ") and lines[-1] == ""):
        fail(f"{rid}: malformed eventalign table head or tail")
    rows = lines[1:-1]
    widths = {line.count("\t") + 1 for line in rows}
    if not rows or not widths <= ({5, 7} if call_columns else {5}):
        fail(f"{rid}: eventalign rows of {sorted(widths)} columns")
    vals = np.array([line.split("\t", 3)[2] for line in rows]).astype(
        np.float64)
    if not np.isfinite(vals).all():
        fail(f"{rid}: non-finite scaled samples")
    return len(rows)


def align_drive(torch, np, models, dev, counters, records, strict, out_path,
                keep=()):
    """``records`` through ``align_reads`` on CUDA at batch 32, strict or
    fast, written as ``.align``; every read must pass.  Returns (the texts
    of the read ids in ``keep``, the run's record)."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.writers import AlignHRWriter
    from dnascent_tpu_torch.pipeline.align import align_reads
    from dnascent_tpu_torch.pipeline.detect import DetectStats

    stats = DetectStats()
    kept, n_rows = {}, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    with PathShapes(torch) as shapes, AlignHRWriter(out_path) as w:
        for rid, text in align_reads(iter(records), models, DNA_R10,
                                     device=dev, strict=strict,
                                     batch_size=32, stats=stats):
            if text is None:
                fail(f"{rid}: failed QC in align")
            w.write_text(text)
            n_rows += text.count("\n") - 1
            if rid in keep:
                kept[rid] = text
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    for rid, text in kept.items():
        check_table(np, rid, text)
    if stats.processed != len(records) or stats.failed:
        fail(f"align processed {stats.processed}, failed {stats.failed}")
    return kept, dict(
        mode="strict" if strict else "fast", reads=len(records),
        rows=n_rows, file_bytes=os.path.getsize(out_path), wall_s=wall,
        reads_per_s=len(records) / wall,
        peak_mem_bytes=torch.cuda.max_memory_allocated(), launches=launches,
        shapes=shapes.report())


def phase7_align(torch, np, models, dev, counters, tmp):
    """7a strict align and 7b fast align of 32 reads of 10 kb (half
    reverse) on CUDA, in turns (strict, fast, fast, strict; each record is
    its mode's first run, with both runs' walls).  Returns (7b's texts of
    the first 8 reads, 7a's record, 7b's record)."""
    records = align_records(models, 32, 10000, SEED + 700)
    keep = {r.read_id for r in records[:8]}
    runs, kept = {True: [], False: []}, {}
    for strict in (True, False, False, True):
        kept[strict], run = align_drive(
            torch, np, models, dev, counters, records, strict,
            os.path.join(tmp, f"strict{int(strict)}.align"), keep)
        runs[strict].append(run)
        missing = [k for k in A_TO_D if run["launches"][k] == 0]
        if missing:
            fail(f"kernels never launched on align: {missing}")
    p7a, p7b = runs[True][0], runs[False][0]
    for rec, mode in ((p7a, True), (p7b, False)):
        rec["wall_s_runs"] = [r["wall_s"] for r in runs[mode]]
        rec["launches_runs"] = [r["launches"] for r in runs[mode]]
    rounds = p7a["shapes"].get("strict_round_windows", [])
    if not rounds or (p7a["launches"]["viterbi_fill"]
                      != p7a["launches"]["viterbi_backtrace"]):
        fail(f"strict align: {len(rounds)} rounds, C/D launches "
             f"{p7a['launches']['viterbi_fill']}/"
             f"{p7a['launches']['viterbi_backtrace']}")
    p7a["rounds"] = len(rounds)
    p7a["windows"] = sum(rounds)
    p7a["rounds_s"] = sum(p7a["shapes"]["strict_round_s"])
    p7a["cd_launches_per_round"] = p7a["launches"]["viterbi_fill"] / len(
        rounds)
    hist = {}
    for W, T, N in p7a["shapes"]["viterbi_fill_WTN"]:
        hist.setdefault(f"T{T},N{N}", []).append(W)
    p7a["round_TN_hist"] = {k: dict(rounds=len(v), windows=sum(v))
                            for k, v in hist.items()}
    p7b["strict_fast_wall_ratio"] = (sum(p7a["wall_s_runs"])
                                     / sum(p7b["wall_s_runs"]))
    return kept[False], records[:8], p7a, p7b


def phase7_cpu_agreement(torch, np, models, dev):
    """7c: four 2 kb reads (two reverse) through ``align_reads``, strict and
    fast, on the CPU and on CUDA: the same rows in the same order,
    coordinate and k-mer columns equal, the two numeric columns within
    1e-5, and the texts byte-equal (as they first came out on the card:
    kernels C and D follow their plain twins bitwise, and the values
    printed to six decimals did not move)."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.align import align_reads
    records = align_records(models, 4, 2000, SEED + 750)
    out = {}
    for strict in (True, False):
        texts = [list(align_reads(iter(records), models, DNA_R10, device=d,
                                  strict=strict)) for d in ("cpu", dev)]
        cpu, gpu = texts
        if [r for r, _ in cpu] != [r for r, _ in gpu] or any(
                t is None for _, t in cpu + gpu):
            fail("align CPU/CUDA read sets differ or a read failed")
        gap, rows = 0.0, 0
        for (rid, a), (_, b) in zip(cpu, gpu):
            la, lb = a.split("\n"), b.split("\n")
            if len(la) != len(lb) or la[0] != lb[0]:
                fail(f"{rid}: CPU/CUDA eventalign rows differ")
            for x, y in zip(la[1:-1], lb[1:-1]):
                x, y = x.split("\t"), y.split("\t")
                if x[0] != y[0] or x[1] != y[1] or x[3] != y[3]:
                    fail(f"{rid}: CPU/CUDA rows differ: {x} vs {y}")
                gap = max(gap, abs(float(x[2]) - float(y[2])),
                          abs(float(x[4]) - float(y[4])))
            rows += len(la) - 2
        if not gap <= 1e-5:
            fail(f"align CPU/CUDA values differ by {gap}")
        if [t for _, t in cpu] != [t for _, t in gpu]:
            fail("align CPU/CUDA texts are not byte-equal")
        out["strict" if strict else "fast"] = dict(
            reads=len(cpu), rows=rows, max_abs_gap=gap, byte_equal=True)
    return out


def phase7_traincnn(torch, np, models, model, dev, counters, records,
                    fast_texts):
    """7d: trainCNN's tables of ``records`` on CUDA with ``model``: with the
    two call columns removed each equals its read's fast-align text byte for
    byte, and exactly the rows of centre-T k-mers carry calls, in [0, 1]."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.traincnn import generate_training_tables
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    tables = list(generate_training_tables(records, models, model, DNA_R10,
                                           device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    if len(tables) != len(records):
        fail(f"trainCNN wrote {len(tables)} of {len(records)} reads")
    n_calls, n_rows = 0, 0
    for rec, text in zip(records, tables):
        n_rows += check_table(np, rec.read_id, text, call_columns=True)
        lines = text.split("\n")
        stripped = [lines[0]]
        for line in lines[1:-1]:
            cols = line.split("\t")
            centre_t = cols[3][4] == "T" and cols[3] != "N" * 9
            if (len(cols) == 7) != centre_t:
                fail(f"{rec.read_id}: call columns off the centre-T rows")
            if len(cols) == 7:
                p = np.array([float(cols[5]), float(cols[6])])
                if not (np.isfinite(p).all() and (p >= 0).all()
                        and (p <= 1).all()):
                    fail(f"{rec.read_id}: call probabilities out of [0, 1]")
                n_calls += 1
            stripped.append("\t".join(cols[:5]))
        if "\n".join(stripped) + "\n" != fast_texts[rec.read_id]:
            fail(f"{rec.read_id}: trainCNN table without calls differs "
                 "from the fast align table")
    missing = [k for k in A_TO_D if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on trainCNN: {missing}")
    return dict(reads=len(tables), rows=n_rows, call_rows=n_calls,
                wall_s=wall, launches=launches)


def em_inputs(np, models, rng, K, M):
    """K k-mers x M events of seeded two-component mixtures: component 1
    at the synthetic model's mean and stdv, component 2 offset by
    -0.6..0.6 with spread 0.08..0.3, weights 0.1..0.9.  Returns (the
    k-mers, em_prior_batch's arguments: data, mask, mu1, s1, mu1, 2 * s1)."""
    idx = rng.choice(models.pore_model.shape[0], K, replace=False)
    mu1 = models.pore_model[idx, 0].astype(np.float32)
    s1 = models.pore_model[idx, 1].astype(np.float32)
    z = rng.random((K, M), dtype=np.float32) < rng.uniform(0.1, 0.9, K)[:, None]
    c2 = rng.standard_normal((K, M), dtype=np.float32) * rng.uniform(
        0.08, 0.3, K).astype(np.float32)[:, None] + (
        mu1 + rng.uniform(-0.6, 0.6, K).astype(np.float32))[:, None]
    c1 = rng.standard_normal((K, M), dtype=np.float32) * s1[:, None] + mu1[:, None]
    data = np.where(z, c2, c1).astype(np.float32)
    return idx, (data, np.ones((K, M), bool), mu1, s1, mu1, 2 * s1)


def phase7_traingmm(torch, np, models, dev, tmp):
    """7e: the EM on CUDA over two chunks of 2048 k-mers x 10,000 events
    (the ``-e`` cap), timed, and against the CPU on a 256-k-mer slice;
    ``train_gmm`` over 512 k-mers, its table written and read back."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.poremodel import import_traingmm_model
    from dnascent_tpu_torch.pipeline import traingmm as tg
    p = DNA_R10.traingmm
    rng = np.random.default_rng(SEED + 800)
    chunks = [em_inputs(np, models, rng, 2048, p.max_events_per_kmer)[1]
              for _ in range(2)]
    t = lambda a, d: torch.from_numpy(np.ascontiguousarray(a)).to(d)
    em = lambda args: tg.em_prior_batch(*args, p.default_pi,
                                        p.em_tolerance, p.em_max_iterations)
    em([t(a[:8], dev) for a in chunks[0]])         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, fits = [], []
    t_all = time.perf_counter()
    for chunk in chunks:
        args = [t(a, dev) for a in chunk]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits.append([f.cpu() for f in em(args)])
        times.append(time.perf_counter() - t0)
    total = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated()
    for f in fits:
        if not all(bool(torch.isfinite(x).all()) for x in f):
            fail("EM: non-finite fits")
    t0 = time.perf_counter()
    cpu = em([t(a[:256], "cpu") for a in chunks[0]])
    cpu_s = time.perf_counter() - t0
    gap = max(float((a - b[:256]).abs().max()) for a, b in zip(cpu, fits[0]))
    if not gap <= 1e-5:
        fail(f"EM CUDA/CPU fits differ by {gap}")

    # end to end: host DBSCAN + device EM over 512 k-mers, table round trip
    idx, (data, *_) = em_inputs(np, models, rng, 512, 3000)
    pools = {int(i): row.astype(np.float64) for i, row in zip(idx, data)}
    t0 = time.perf_counter()
    gmm = tg.train_gmm(pools, models, DNA_R10, device=dev)
    e2e_s = time.perf_counter() - t0
    path = os.path.join(tmp, "fit.model")
    tg.write_gmm_table(gmm, path)
    table = import_traingmm_model(path, DNA_R10.kmer_len)
    back = float(max(max(abs(table[f.kmer_index, 0] - f.mu2),
                         abs(table[f.kmer_index, 1] - f.sigma2))
                     for f in gmm))
    if len(gmm) != len(pools) or not back <= 1e-5:
        fail(f"trainGMM: {len(gmm)} of {len(pools)} k-mers fitted, table "
             f"read back within {back}")
    return dict(
        em_full=dict(chunks=len(chunks), kmers_per_chunk=2048,
                     events=p.max_events_per_kmer, iterations=
                     p.em_max_iterations, chunk_s=times, wall_s=total,
                     peak_mem_bytes=peak, pi2_mean=float(fits[0][1].mean())),
        em_cuda_vs_cpu=dict(kmers=256, max_abs_gap=gap, tol=1e-5,
                            cpu_s=cpu_s),
        train_gmm=dict(kmers=len(gmm), wall_s=e2e_s, table_readback=back))


class ForwardObserver:
    """Records, while the ``--HMM`` path runs, each forward pass's (W, T),
    its steps (the longest window's observations) and its device time
    (CUDA events), and keeps the last pass's arguments."""

    def __init__(self, torch):
        from dnascent_tpu_torch.pipeline import hmm_detect
        self.mod, self.orig = hmm_detect, hmm_detect.forward_batch
        self.passes, self.args = [], None

        def observed(obs, n_obs, *rest):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.orig(obs, n_obs, *rest)
            end.record()
            self.passes.append((list(obs.shape), int(n_obs.max()), start,
                                end))
            self.args = (obs, n_obs, *rest)
            return out

        self.wrapped = observed

    def __enter__(self):
        self.mod.forward_batch = self.wrapped
        return self

    def __exit__(self, *exc):
        self.mod.forward_batch = self.orig

    def report(self, torch) -> dict:
        torch.cuda.synchronize()
        return dict(WT=[p[0] for p in self.passes],
                    steps=[p[1] for p in self.passes],
                    pass_ms=[s.elapsed_time(e) for *_, s, e in self.passes])


def device_ops(torch, fn):
    """(device operations, their summed device ms) of one call of ``fn``,
    from ``torch.profiler``; (None, None) when it traces no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except Exception as e:  # a profiler that cannot trace the card
        print(f"chip_smoke: torch.profiler: {e!r}", file=sys.stderr)
        return None, None
    if not evs:
        return None, None
    us = sum(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
             for e in evs)
    return len(evs), us / 1e3


def check_hmm_text(np, rid, text):
    """A read's ``--HMM`` block: its header, then rows of coordinate,
    finite LLR and two 9-mers.  Returns (rows, LLRs)."""
    lines = text.split("\n")
    head = lines[0].split()
    if not (head[0] == f">{rid}" and len(head) == 5 and lines[-1] == ""
            and head[4] in ("fwd", "rev")):
        fail(f"{rid}: malformed --HMM header or tail")
    llr = []
    for line in lines[1:-1]:
        cols = line.split("\t")
        if not (len(cols) == 4 and cols[0].isdigit() and len(cols[2]) == 9
                and len(cols[3]) == 9 and set(cols[2] + cols[3]) <= set(
                    "ACGT")):
            fail(f"{rid}: malformed --HMM row {line!r}")
        llr.append(float(cols[1]))
    llr = np.array(llr)
    if not np.isfinite(llr).all():
        fail(f"{rid}: non-finite LLR")
    return len(llr), llr


def phase8_hmm(torch, np, models, dev, counters):
    """8a: 32 reads of 10 kb (half reverse) as one batch through
    ``hmm_detect_reads`` on CUDA; the forward's passes timed and its bound
    counted from this run's windows."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.detect import DetectStats
    from dnascent_tpu_torch.pipeline.hmm_detect import hmm_detect_reads
    from dnascent_tpu_torch.ops.hmm import forward_batch

    records = align_records(models, 32, 10000, SEED + 850)
    stats = DetectStats()
    n_rows, texts = 0, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    with ForwardObserver(torch) as obs:
        for rid, text in hmm_detect_reads(iter(records), models, DNA_R10,
                                          device=dev, stats=stats,
                                          batch_size=32):
            if text is None:
                fail(f"{rid}: failed QC in --HMM detect")
            texts[rid] = text
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: c.count for k, c in counters.items()}
    llr_all = []
    for rid, text in texts.items():
        rows, llr = check_hmm_text(np, rid, text)
        n_rows += rows
        llr_all.append(llr)
    llr_all = np.concatenate(llr_all)
    if stats.processed != len(records) or n_rows == 0:
        fail(f"--HMM processed {stats.processed} reads, {n_rows} rows")
    missing = [k for k in ("banded_fill", "banded_chase") if launches[k] == 0]
    wrong = [k for k in ("viterbi_fill", "viterbi_backtrace", "gru_encoder",
                         "banded_fill_general") if launches[k] != 0]
    if missing or wrong:
        fail(f"--HMM kernels: never launched {missing}, launched {wrong}")
    rep = obs.report(torch)
    if len(rep["WT"]) != 2:
        fail(f"--HMM ran {len(rep['WT'])} forward passes, expected 2")
    # the forward's bound: the live windows' observations once, each
    # pass's means and stdvs, the counts, events per base and outputs; the
    # operations of the live (window, state) cells of each step
    fwd_args = obs.args
    n_obs = fwd_args[1]
    N = fwd_args[2].shape[1]
    live_obs = float(n_obs.double().sum())
    nbytes = 4 * (live_obs + 2 * 2 * n_rows * N + 2 * n_rows + 2 * n_rows)
    ops = live_obs * N * OPS_PER_HMM_CELL * 2
    fwd = dict(ms_per_batch=sum(rep["pass_ms"]), pass_ms=rep["pass_ms"],
               WT=rep["WT"][0], steps=rep["steps"][0], windows=n_rows,
               states=N)
    fwd.update(bound(nbytes, ops))
    fwd["share_of_bound"] = fwd["bound_ms"] / fwd["ms_per_batch"]
    n_ops, ops_ms = device_ops(torch, lambda: forward_batch(*fwd_args))
    fwd["device_ops_per_pass"] = n_ops
    fwd["device_ops_ms_per_pass"] = ops_ms
    return records, dict(
        reads=len(records), rows=n_rows, wall_s=wall,
        reads_per_s=len(records) / wall, peak_mem_bytes=peak,
        launches=launches, llr_min=float(llr_all.min()),
        llr_max=float(llr_all.max()), llr_mean=float(llr_all.mean()),
        forward=fwd)


def phase8_hmm_cpu_agreement(torch, np, models, dev):
    """8b: four 2 kb reads (two reverse) through ``hmm_detect_reads`` on the
    CPU and on CUDA: equal lines but the LLR, within LLR_ATOL_CPU."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.hmm_detect import hmm_detect_reads
    records = align_records(models, 4, 2000, SEED + 870)
    cpu, gpu = (list(hmm_detect_reads(iter(records), models, DNA_R10,
                                      device=d)) for d in ("cpu", dev))
    if [r for r, _ in cpu] != [r for r, _ in gpu] or any(
            t is None for _, t in cpu + gpu):
        fail("--HMM CPU/CUDA read sets differ or a read failed")
    gap, rows = 0.0, 0
    for (rid, a), (_, b) in zip(cpu, gpu):
        la, lb = a.split("\n"), b.split("\n")
        if len(la) != len(lb) or la[0] != lb[0]:
            fail(f"{rid}: --HMM CPU/CUDA lines differ")
        for x, y in zip(la[1:-1], lb[1:-1]):
            x, y = x.split("\t"), y.split("\t")
            if x[0] != y[0] or x[2:] != y[2:]:
                fail(f"{rid}: --HMM CPU/CUDA rows differ: {x} vs {y}")
            gap = max(gap, abs(float(x[1]) - float(y[1])))
            rows += 1
    if not gap <= LLR_ATOL_CPU:
        fail(f"--HMM CPU/CUDA LLRs differ by {gap} > {LLR_ATOL_CPU}")
    return dict(reads=len(cpu), rows=rows, max_llr_gap=gap,
                tol=LLR_ATOL_CPU)


def fit_model(torch, arch, dev):
    """(model, optimizer) of ``trainCNN --fit-arch arch`` on ``dev``."""
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.pipeline import traincnn as tc
    if arch == "reference":
        return tc.reference_arch_trainer(seed=SEED, device=dev)
    model = cnn.init_untrained(cnn.DetectCNN(), seed=SEED).to(dev)
    return model, tc.make_optimizer(list(model.parameters()))


def phase8_fit(torch, np, models, dev, counters, records, tmp):
    """8c: the training batches of ``records`` on CUDA, then 10 steps of
    each architecture at full width; 8d: one step of each on CUDA and on
    the CPU from equal weights."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.models import cnn, reference_cnn
    from dnascent_tpu_torch.pipeline import traincnn as tc

    pairs = [(r, np.full(len(r.reference_seq), tc.LABEL_IDS["BrdU"],
                         np.int32)) for r in records]
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    batches = list(tc.batches_from_labelled_reads(pairs, models, DNA_R10,
                                                  device=dev))
    torch.cuda.synchronize()
    out = dict(batches=dict(
        reads=len(records), batches=len(batches),
        shape=list(batches[0].signal.shape) if batches else None,
        labelled=int(sum(b.mask.sum() for b in batches)),
        wall_s=time.perf_counter() - t0,
        launches={k: c.count for k, c in counters.items()}))
    if not batches or out["batches"]["labelled"] == 0:
        fail("no training batches")
    missing = [k for k in A_TO_D if out["batches"]["launches"][k] == 0]
    if missing:
        fail(f"kernels never launched on the training batches: {missing}")
    steps = (batches * (-(-10 // len(batches))))[:10]
    for arch in ("tpu", "reference"):
        model, opt = fit_model(torch, arch, dev)
        frozen = [p.detach().clone()
                  for p in reference_cnn.frozen_parameters(model)] \
            if arch == "reference" else []
        tc.train_detect_cnn(steps[:1], model=model, optimizer=opt,
                            device=dev)                   # warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters["gru_encoder"].reset()
        t0 = time.perf_counter()
        _, losses = tc.train_detect_cnn(steps, model=model, optimizer=opt,
                                        device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not np.isfinite(losses).all():
            fail(f"fit [{arch}]: non-finite losses {losses}")
        if counters["gru_encoder"].count:
            fail(f"fit [{arch}]: kernel F launched on float windows")
        if arch == "reference" and not all(torch.equal(a, b) for a, b in zip(
                frozen, reference_cnn.frozen_parameters(model))):
            fail("fit [reference]: BatchNorm moving statistics changed")
        path = os.path.join(tmp, f"fit_{arch}.npz")
        tc.save_model(model, path)
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        back = (reference_cnn.params_from_tree(
            reference_cnn.ReferenceDetectCNN(), flat) if arch == "reference"
            else cnn.params_from_flax(cnn.DetectCNN(), flat))
        if not all(torch.equal(a.detach().cpu(), b) for a, b in zip(
                model.parameters(), back.parameters())):
            fail(f"fit [{arch}]: the npz does not read back")
        out[arch] = dict(steps=len(losses),
                         ms_per_step=wall / len(losses) * 1e3,
                         peak_mem_bytes=torch.cuda.max_memory_allocated(),
                         loss_first=losses[0], loss_last=losses[-1],
                         npz_keys=len(flat),
                         params=sum(p.numel() for p in model.parameters()))
    # 8d: one step on CUDA and on the CPU from equal weights
    b0 = batches[0]
    small = tc.TrainBatch(*(getattr(b0, f)[:2] for f in (
        "core_idx", "residual_idx", "signal", "labels", "mask")))
    for arch in ("tpu", "reference"):
        losses = []
        for d in ("cpu", dev):
            model, opt = fit_model(torch, arch, d)
            losses.append(tc.train_detect_cnn([small], model=model,
                                              optimizer=opt, device=d)[1][0])
        gap = abs(losses[0] - losses[1])
        if not gap <= LOSS_ATOL_CPU:
            fail(f"fit [{arch}]: CUDA/CPU losses {losses} differ by {gap}")
        out[arch]["cuda_vs_cpu"] = dict(positions=int(small.mask.sum()),
                                        losses=losses, gap=gap,
                                        tol=LOSS_ATOL_CPU)
    return out


# one of phase 9's two worker processes on the card: 9b (its shard of the
# main path's reads through detect_reads, a gloo group at a free localhost
# port, the gather of the per-read call counts, a barrier, process 0's
# merge), then 9c (the forkSense and seeBreaks CLIs with --coordinator);
# it imports nothing of jax or the JAX package
PHASE9_WORKER = r"""
import json, os, sys, time
for _mod in ("jax", "flax", "optax", "dnascent_tpu"):
    sys.modules[_mod] = None
k, tmp, root, port_b, port_fs, port_sb = sys.argv[1:7]
k = int(k)
sys.path.insert(0, root)
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from dnascent_tpu_torch import cli
from dnascent_tpu_torch.config import DNA_R10
from dnascent_tpu_torch.io.poremodel import synthetic_model_set
from dnascent_tpu_torch.io.writers import DetectHRWriter, detect_header
from dnascent_tpu_torch.models import cnn
from dnascent_tpu_torch.ops import banded_cuda, cuda_lib, viterbi_cuda
from dnascent_tpu_torch.parallel import collectives, merge, mesh
from dnascent_tpu_torch.pipeline.detect import detect_reads
from dnascent_tpu_torch.pipeline.source import SimulatedSource

seed = int(os.environ["SMOKE_SEED"])
cuda_lib.lib(verbose=True)          # the library phase 0 built
t0 = time.perf_counter()
models = synthetic_model_set(DNA_R10)
records = list(SimulatedSource(models, DNA_R10, n_reads=64, length=10000,
                               seed=seed + 300))[k::2]
model = cnn.init_untrained(cnn.DetectCNN(), seed=seed).to("cuda")
out = os.path.join(tmp, "phase9.detect")
shard = merge.host_shard_path(out, k)
counts = []
with DetectHRWriter(shard) as w:
    w.write_header(detect_header("simulated", "simulated", "none", 1, 20,
                                 1000, compute="GPU"))
    for _rid, d in detect_reads(records, models, model, DNA_R10,
                                device="cuda", batch_size=32,
                                collect_failures=True):
        if d is not None:
            w.write(d)
        counts.append(0 if d is None else d.ref_coords.shape[0])
torch.cuda.synchronize()
res = dict(detect_s=time.perf_counter() - t0,
           launches=dict(A=banded_cuda.FILL_LAUNCHES.count,
                         B=banded_cuda.CHASE_LAUNCHES.count,
                         C=viterbi_cuda.FILL_LAUNCHES.count,
                         D=viterbi_cuda.BACKTRACE_LAUNCHES.count))
t0 = time.perf_counter()
mesh.init_distributed(f"localhost:{port_b}", 2, k)
ordinals = np.arange(k, 64, 2)
gathered = collectives.gather_ordered(np.asarray(counts, np.int64), ordinals)
collectives.barrier("phase9_detect_done")
if k == 0:
    res["merged_reads"] = merge.merge_host_outputs(
        [merge.host_shard_path(out, i) for i in range(2)], out)
    res["gathered_counts"] = gathered.tolist()
mesh.shutdown_distributed()
res["group_s"] = time.perf_counter() - t0

def group(port):
    return ["--coordinator", f"localhost:{port}", "--nprocs", "2",
            "--procid", str(k)]

t0 = time.perf_counter()
os.chdir(os.path.join(tmp, "sharded"))
rc = cli.main(["forkSense", "-d", os.path.join(tmp, "forks.detect"),
               "-o", "sharded.forkSense", "--order", "EdU,BrdU",
               "--markForks", "--markAnalogues", *group(port_fs)])
res["forksense_s"] = time.perf_counter() - t0
if rc == 0:
    # seeBreaks reads the single run's beds, which the parent writes
    ready = os.path.join(tmp, "single", "ready")
    deadline = time.time() + 300
    while not os.path.exists(ready) and time.time() < deadline:
        time.sleep(0.2)
    t0 = time.perf_counter()
    single = os.path.join(tmp, "single")
    rc = cli.main(["seeBreaks", "-l",
                   os.path.join(single, "leftForks_DNAscent_forkSense.bed"),
                   "-r",
                   os.path.join(single, "rightForks_DNAscent_forkSense.bed"),
                   "-a", os.path.join(single, "BrdU_DNAscent_forkSense.bed"),
                   "-d", os.path.join(tmp, "forks.detect"),
                   "-o", "sharded.seeBreaks", *group(port_sb)])
    res["seebreaks_s"] = time.perf_counter() - t0
with open(os.path.join(tmp, f"worker{k}.json"), "w") as fh:
    json.dump(res, fh)
sys.exit(rc)
"""


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase9a(torch, np, models, model, counters, records, tmp, p3):
    """9a: the main path's 64 reads through ``detect_reads`` on the device
    set [cuda:0], then [cuda:0, cuda:0] (two replicas whose batches
    alternate): both ``.detect`` bodies byte-equal to phase 3's; the second
    run is phase 9's path for the launch counts.  Returns the results, the
    per-read call counts in read order and the two-replica file."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.writers import DetectHRWriter, detect_header
    from dnascent_tpu_torch.pipeline.detect import detect_reads

    out = {}
    for name, devices in (("one", ["cuda:0"]), ("two", ["cuda:0"] * 2)):
        path = os.path.join(tmp, f"phase9a_{name}.detect")
        counts = []
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        with DetectHRWriter(path) as w:
            w.write_header(detect_header("simulated", "simulated", "none", 1,
                                         20, 1000, compute="GPU"))
            for _rid, d in detect_reads(iter(records), models, model,
                                        DNA_R10, device=devices,
                                        batch_size=32,
                                        collect_failures=True):
                if d is not None:
                    w.write(d)
                counts.append(0 if d is None else d.ref_coords.shape[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.count for k, c in counters.items()}
        n, body = detect_body(path)
        if body != p3["body_sha256"] or n != p3["passed"]:
            fail(f"9a on {devices}: .detect body differs from phase 3's")
        out[name] = dict(devices=devices, reads=len(records), wall_s=wall,
                         reads_per_s=len(records) / wall, launches=launches,
                         byte_equal_to_phase3=True)
    missing = [k for k in A_TO_D if out["two"]["launches"][k] == 0]
    wrong = [k for k in ("banded_fill_general", "gru_encoder")
             if out["two"]["launches"][k]]
    if missing or wrong:
        fail(f"9a two replicas: never launched {missing}, launched {wrong}")
    out["launches"] = out["two"]["launches"]
    return out, counts, path


def phase9_processes(torch, np, tmp, counts, single_path):
    """9b and 9c: two worker processes on the card (``PHASE9_WORKER``);
    meanwhile the single runs of forkSense and seeBreaks here, on phase 6's
    fork reads.  9b: the gathered call counts equal 9a's vector and the
    merged body equals 9a's text put through the same merge; 9c: the merged
    forkSense output carries the single run's ``#EstimatedRegion`` lines,
    blocks and beds, seeBreaks the single run's output."""
    from dnascent_tpu_torch import cli
    from dnascent_tpu_torch.parallel.merge import merge_host_outputs
    from dnascent_tpu_torch.testing.forks import (varied_fork_reads,
                                                  write_detect_file)

    forks = os.path.join(tmp, "forks.detect")
    fork_reads = varied_fork_reads(512, 512, seed=SEED)
    write_detect_file(fork_reads, forks)
    single, sharded = os.path.join(tmp, "single"), os.path.join(tmp, "sharded")
    os.makedirs(single)
    os.makedirs(sharded)
    env = dict(os.environ, PYTHONPATH=ROOT, SMOKE_SEED=str(SEED))
    env.pop("RANK", None)
    ports = [str(free_port()) for _ in range(3)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", PHASE9_WORKER, str(k), tmp, ROOT, *ports],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(2)]
    try:
        t1 = time.perf_counter()
        cwd = os.getcwd()
        os.chdir(single)
        try:
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = cli.main(["forkSense", "-d", forks, "-o",
                               "single.forkSense", "--order", "EdU,BrdU",
                               "--markForks", "--markAnalogues"])
                # the bed paths as the workers give them: seeBreaks writes
                # them into its header
                bed = lambda name: os.path.join(  # noqa: E731
                    single, f"{name}_DNAscent_forkSense.bed")
                rc = rc or cli.main([
                    "seeBreaks", "-l", bed("leftForks"), "-r",
                    bed("rightForks"), "-a", bed("BrdU"), "-d", forks,
                    "-o", "single.seeBreaks"])
        finally:
            os.chdir(cwd)
        if rc != 0:
            fail(f"9c single forkSense/seeBreaks returned {rc}")
        open(os.path.join(single, "ready"), "w").close()
        single_s = time.perf_counter() - t1
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for k, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"phase 9 worker {k} exited {p.returncode}:\n{log[-3000:]}")
    workers = []
    for k in range(2):
        with open(os.path.join(tmp, f"worker{k}.json")) as fh:
            workers.append(json.load(fh))
    # 9b
    if workers[0]["gathered_counts"] != counts:
        fail("9b: the gathered per-read call counts differ from 9a's")
    canon = os.path.join(tmp, "phase9a.canon.detect")
    merge_host_outputs([single_path], canon)
    merged = os.path.join(tmp, "phase9.detect")
    if detect_body(merged) != detect_body(canon):
        fail("9b: the merged shards differ from 9a's text through the merge")
    for k, w in enumerate(workers):
        if min(w["launches"].values()) == 0:
            fail(f"9b worker {k}: a kernel of A-D never launched")

    # 9c
    def lines(path, keep=lambda l: not l.startswith("#")):
        with open(path) as fh:
            return [l for l in fh if keep(l)]

    est = lambda l: l.startswith("#EstimatedRegion")  # noqa: E731
    fs_s, fs_m = (os.path.join(single, "single.forkSense"),
                  os.path.join(sharded, "sharded.forkSense"))
    if lines(fs_s, est) != lines(fs_m, est) or len(lines(fs_s, est)) != 2:
        fail("9c: #EstimatedRegion lines differ")
    if sorted(lines(fs_s)) != sorted(lines(fs_m)):
        fail("9c: forkSense blocks differ")
    beds = {}
    for bed in ("leftForks", "rightForks", "BrdU", "EdU"):
        name = f"{bed}_DNAscent_forkSense.bed"
        a, b = (sorted(lines(os.path.join(d, name))) for d in (single,
                                                              sharded))
        if a != b:
            fail(f"9c: {name} differs")
        beds[bed] = len(a)
    no_time = lambda l: not l.startswith("#SystemStartTime")  # noqa: E731
    if (lines(os.path.join(single, "single.seeBreaks"), no_time)
            != lines(os.path.join(sharded, "sharded.seeBreaks"), no_time)):
        fail("9c: seeBreaks output differs")
    return dict(
        b=dict(reads=len(counts), merged_reads=workers[0]["merged_reads"],
               gathered_equal=True, merged_equal=True,
               worker_detect_s=[w["detect_s"] for w in workers],
               worker_group_s=[w["group_s"] for w in workers],
               worker_launches=[w["launches"] for w in workers]),
        c=dict(fork_reads=len(fork_reads), bed_rows=beds,
               estimated_equal=True, body_lines=len(lines(fs_s)),
               seebreaks_equal=True,
               single_s=single_s,
               worker_forksense_s=[w["forksense_s"] for w in workers],
               worker_seebreaks_s=[w["seebreaks_s"] for w in workers]),
        bc_wall_s=time.perf_counter() - t0)


def phase9d(torch, np, dev):
    """9d: ``data_parallel_train_step`` with two full-width DetectCNN
    replicas on cuda:0 against one replica, one step at 8 x 1024 positions
    from equal weights: the loss gap and the largest parameter gap."""
    import copy
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.parallel.mesh import data_parallel_train_step
    from dnascent_tpu_torch.pipeline.traincnn import make_optimizer

    rng = np.random.default_rng(SEED + 900)
    B, L = 8, 1024
    batch = dict(
        core=rng.integers(1, cnn.CORE_VOCAB, (B, L)).astype(np.int64),
        residual=rng.integers(1, cnn.RESIDUAL_VOCAB, (B, L)).astype(np.int64),
        signal=rng.normal(0, 1, (B, L, cnn.RAWDEPTH)).astype(np.float32),
        labels=rng.integers(0, 3, (B, L)).astype(np.int64),
        mask=rng.random((B, L)) < 0.9)
    base = cnn.init_untrained(cnn.DetectCNN(), seed=SEED).to(dev)
    lr = 3e-4
    got = {}
    for n in (1, 2):
        model = copy.deepcopy(base)
        step = data_parallel_train_step(
            model, make_optimizer(list(model.parameters()), lr), [dev] * n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(batch))
        torch.cuda.synchronize()
        got[n] = (loss, (time.perf_counter() - t0) * 1e3,
                  dict(model.named_parameters()))
    loss_gap = abs(got[2][0] - got[1][0])
    param_gap = max(float((got[2][2][k] - got[1][2][k]).detach().abs()
                          .max()) for k in got[1][2])
    # a first AdamW step moves each weight by at most lr (and its decay),
    # so two steps whose bf16 gradients differ in sign differ by < 2 lr
    if not (np.isfinite(got[2][0]) and loss_gap <= LOSS_ATOL_CPU
            and param_gap <= 2 * lr * 1.01):
        fail(f"9d: loss gap {loss_gap}, parameter gap {param_gap}")
    return dict(positions=B * L, losses=[got[1][0], got[2][0]],
                loss_gap=loss_gap, max_param_gap=param_gap,
                step_ms=[got[1][1], got[2][1]], lr=lr,
                tol=dict(loss=LOSS_ATOL_CPU, param=2 * lr * 1.01))


def phase9e(torch, np, model, dev):
    """9e: ``sequence_sharded_apply`` with two shards (cuda:0 twice) along
    8 x 4096 positions against the unsharded forward of the same model:
    the largest probability gap."""
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.parallel.mesh import sequence_sharded_apply

    rng = np.random.default_rng(SEED + 901)
    B, L = 8, 4096
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(1, cnn.CORE_VOCAB, (B, L)),
        rng.integers(1, cnn.RESIDUAL_VOCAB, (B, L)),
        rng.normal(0, 1, (B, L, cnn.RAWDEPTH)).astype(np.float32))]
    apply = sequence_sharded_apply(model, [dev, dev])
    with torch.no_grad():
        whole = model(*args)
        sharded = apply(*args)
    torch.cuda.synchronize()
    gap = float((whole - sharded).abs().max())
    if sharded.shape != whole.shape or not gap <= PROB_ATOL_CPU:
        fail(f"9e: sharded apply differs from the whole forward by {gap}")
    return dict(shape=list(whole.shape), halo=model.receptive_field() // 2,
                max_gap=gap, tol=PROB_ATOL_CPU)


def phase10a(torch, np, models, model, dev, counters, records, p3):
    """10a: phase 3's reads through ``detect_reads`` on CUDA with a
    ``StageTimer``: its three stage totals and call counts; the ``.detect``
    body byte-equal to phase 3's (run without the timer) and the launches
    phase 3's.  Returns the result and the ids of the reads that passed."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.writers import DetectHRWriter, detect_header
    from dnascent_tpu_torch.pipeline.detect import detect_reads
    from dnascent_tpu_torch.utils.progress import StageTimer

    timer = StageTimer()
    passed = set()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "phase10a.detect")
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        with DetectHRWriter(path) as w:
            w.write_header(detect_header("simulated", "simulated", "none", 1,
                                         20, 1000, compute="GPU"))
            for rid, d in detect_reads(iter(records), models, model, DNA_R10,
                                       device=dev, batch_size=32,
                                       collect_failures=True, timer=timer):
                if d is not None:
                    w.write(d)
                    passed.add(rid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.count for k, c in counters.items()}
        n, body = detect_body(path)
    if body != p3["body_sha256"] or n != p3["passed"]:
        fail("10a: the .detect body with the stage timer differs from "
             "phase 3's")
    want = dict(banded_fill=2, banded_chase=2, viterbi_fill=6,
                viterbi_backtrace=6, banded_fill_general=0, gru_encoder=0,
                trunk_epilogue=0)
    if launches != p3["launches"] or launches != want:
        fail(f"10a launches {launches}, phase 3 {p3['launches']}, "
             f"expected {want}")
    stages = {name: dict(total_s=timer.totals[name],
                         calls=timer.counts[name])
              for name in ("prep(events+scaling+banded)",
                           "eventalign(viterbi)", "cnn_forward")}
    if any(v["calls"] != 2 for v in stages.values()):
        fail(f"10a: each stage should run once a batch: {stages}")
    return dict(reads=len(records), passed=n, wall_s=wall,
                reads_per_s=len(records) / wall, stages=stages,
                stage_sum_s=sum(v["total_s"] for v in stages.values()),
                launches=launches, body_sha256=body,
                byte_equal_to_phase3=True), passed


def cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo, else its vendor and
    family fields there, else the machine type."""
    import platform
    fields = {}
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    if fields.get("model name"):
        return fields["model name"]
    parts = [f"{k} {fields[k]}" for k in ("vendor_id", "cpu family",
                                           "model", "CPU implementer",
                                           "CPU part") if fields.get(k)]
    return ", ".join(parts) or platform.machine()


def phase10b(np, models, records, passed):
    """10b: ``native.baseline_detect_read`` (the scalar C++ detect hot path)
    on 8 of 10a's reads, pinned to one core: seconds and checksum a read
    (NaN is a QC failure) and how many reads' QC outcome agrees with the
    port's in 10a.  The baseline windows its Viterbi as ``bench.py`` does,
    not as detect does, so the agreement is printed, not gated."""
    from dnascent_tpu_torch import native
    from dnascent_tpu_torch.config import DNA_R10

    core, seconds, checksums = native.time_baseline_reads(
        records[:8], models.pore_model.astype(np.float64), DNA_R10)
    agree = sum(bool(np.isfinite(cs)) == (rec.read_id in passed)
                for rec, cs in zip(records, checksums))
    if not any(np.isfinite(c) for c in checksums):
        fail("10b: the CPU baseline failed QC on every read")
    return dict(reads=len(seconds), read_length=10000, pinned_core=core,
                cpu_model=cpu_model(), host_cores=os.cpu_count(),
                s_per_read=seconds, mean_s_per_read=float(np.mean(seconds)),
                checksums=[c if np.isfinite(c) else "NaN"
                           for c in checksums],
                qc_agrees_with_port=agree)


def detect_rows(path):
    """(read headers, [(coord, k-mer)], (n, 2) probabilities) of a
    ``.detect`` file's body."""
    import numpy as np
    heads, keys, probs = [], [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            if line.startswith(">"):
                heads.append(line)
                continue
            cols = line.rstrip("\n").split("\t")
            keys.append((cols[0], cols[3]))
            probs.append((float(cols[1]), float(cols[2])))
    return heads, keys, np.asarray(probs).reshape(-1, 2)


def phase10c(np, models, tmp):
    """10c: the port's FASTA, BAM and pore-model writers on this host, read
    back through the port's readers; then the whole dataset of
    ``testing.dataset.build_dataset`` in pod5 (pyarrow's zstd codec; it
    fails without it) and, where h5py is present, in fast5, and
    ``cli.main(["detect", ...])`` on it with ``--device cuda`` and
    ``--device cpu``: the same reads, coordinates and k-mers, probabilities
    within phase 2's tolerance.  A missing h5py is printed on a line of its
    own."""
    import importlib.util

    from dnascent_tpu_torch import cli
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io import bam as bam_io, pod5_io
    from dnascent_tpu_torch.io.fasta import import_reference, write_fasta
    from dnascent_tpu_torch.io.poremodel import (import_pore_model_fit_stdv,
                                                 write_model_tsv)
    from dnascent_tpu_torch.testing.dataset import build_dataset
    from dnascent_tpu_torch.testing.simulate import random_sequence

    rng = np.random.default_rng(SEED + 1000)
    ref = {f"chr{i}": random_sequence(rng, n)
           for i, n in enumerate((50000, 81, 1))}
    fa = os.path.join(tmp, "w.fa")
    write_fasta(ref, fa)
    if import_reference(fa) != ref:
        fail("10c: FASTA read back differs")
    names, lengths = list(ref), [len(v) for v in ref.values()]
    header = "@HD\tVN:1.6\tSO:unknown\n" + "".join(
        f"@SQ\tSN:{k}\tLN:{n}\n" for k, n in zip(names, lengths))
    written = []
    for i in range(200):
        start = int(rng.integers(0, 40000))
        n = int(rng.integers(100, 9000))
        written.append(bam_io.build_record(
            f"read{i}", 0, start, 60, [(bam_io.BAM_CMATCH, n)],
            ref["chr0"][start : start + n],
            flag=bam_io.FLAG_REVERSE if i % 2 else 0))
    bam_path = os.path.join(tmp, "w.bam")
    w = bam_io.BamWriter(bam_path, header, names, lengths)
    for r in written:
        w.write_record(r)
    w.close()
    rd = bam_io.BamReader(bam_path)
    back = list(rd)
    rd.close()
    if (rd.header_text != header or rd.ref_names != names
            or rd.ref_lengths != lengths
            or [r.raw for r in back] != [r.raw for r in written]):
        fail("10c: BAM read back differs")
    tsv = os.path.join(tmp, "w.model")
    write_model_tsv(models.unlabelled_model, tsv, DNA_R10.kmer_len)
    table = import_pore_model_fit_stdv(tsv, DNA_R10.kmer_len)
    # the writer prints six decimals; the reader parses them into f32
    want = np.array([float(f"{v:.6f}") for v in
                     models.unlabelled_model.ravel()],
                    np.float32).reshape(table.shape)
    if not np.array_equal(table, want):
        fail("10c: pore-model TSV read back differs")
    out = dict(fasta_contigs=len(ref), bam_records=len(back),
               bam_bytes=os.path.getsize(bam_path), model_rows=len(table),
               model_max_abs_err=float(
                   np.abs(table - models.unlabelled_model).max()))

    # pod5's codec is pyarrow's zstd; fast5 needs h5py, which the card's
    # host lacks: only fast5 may be skipped
    if not pod5_io.HAVE_ZSTD:
        fail("10c: pod5 needs pyarrow with its zstd codec")
    have_h5py = importlib.util.find_spec("h5py") is not None
    out["libraries"] = dict(pyarrow=pod5_io.pa.__version__,
                            pyarrow_zstd=pod5_io.HAVE_ZSTD, h5py=have_h5py)
    formats = ["pod5"]
    if have_h5py:
        formats.append("fast5")
    else:
        print("h5py", flush=True)
    for fmt in formats:
        ds = build_dataset(os.path.join(tmp, fmt), models, n_reads=4,
                           read_length=2000, signal_format=fmt,
                           seed=SEED + 200)
        runs = []
        for device in ("cuda", "cpu"):
            path = os.path.join(tmp, f"{fmt}_{device}.detect")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["detect", "-b", ds.bam, "-r", ds.reference_fa,
                               "-i", ds.index, "-o", path, "--device",
                               device, "--allow-untrained-cnn"])
            if rc != 0:
                fail(f"10c: detect --device {device} on {fmt} gave {rc}")
            runs.append(detect_rows(path))
        (hg, kg, pg), (hc, kc, pc) = runs
        if hg != hc or kg != kc or not kg:
            fail(f"10c: {fmt} detect on CUDA and CPU: reads or positions "
                 "differ")
        err = float(np.abs(pg - pc).max())
        if err > PROB_ATOL_CPU:
            fail(f"10c: {fmt} CUDA/CPU probabilities differ by {err}")
        out[fmt] = dict(reads=len(hg), rows=len(kg), max_prob_diff=err,
                        tol=PROB_ATOL_CPU)
    return out


# phase 11: bench_torch.py as __main__ in a fresh interpreter, with any
# import of jax or the JAX package failing
PHASE11_RUNNER = r"""
import runpy, sys
for _mod in ("jax", "flax", "optax", "dnascent_tpu"):
    sys.modules[_mod] = None
sys.argv = [sys.argv[1]]
runpy.run_path(sys.argv[0], run_name="__main__")
"""
# phase 11's reduced size; BENCH_BASELINE stands in for the CPU baseline
PHASE11_ENV = dict(BENCH_READS="64", BENCH_REPS="2", BENCH_DEPTHS="1,10",
                   BENCH_DEPTH="10", BENCH_LONG_READS="0",
                   BENCH_MIXED_READS="8", BENCH_BASELINE="1")


def phase11_bench():
    """11: ``bench_torch.py`` at phase 11's size in a subprocess on the
    card; its record must parse, pass its gate and show A-D and F launched
    (E not)."""
    env = dict(os.environ, **PHASE11_ENV)
    env.pop("BENCH_BUDGET_S", None)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", PHASE11_RUNNER,
                          os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=400)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"11: bench_torch.py exited {res.returncode}:\n"
             f"{res.stderr[-3000:]}")
    try:
        out = json.loads(res.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        fail(f"11: no JSON record in bench_torch.py's output:\n"
             f"{res.stdout[-2000:]}")
    launches = out.get("launches") or {}
    missing = [k for k in A_TO_D + ("gru_encoder",)
               if launches.get(k, 0) <= 0]
    if not out.get("gate", {}).get("passed"):
        fail(f"11: the bench's gate failed: {out.get('gate')}")
    if not out.get("value", 0) > 0 or not out.get("peak_device_mb", 0) > 0:
        fail(f"11: value {out.get('value')}, peak device MB "
             f"{out.get('peak_device_mb')}")
    if missing or launches.get("banded_fill_general") != 0:
        fail(f"11: launches {launches}: missing {missing} or E launched")
    if not (out.get("stage_breakdown_unpipelined") or {}).get("host_steps"):
        fail("11: no host steps in the stage breakdown")
    return dict(wall_s=wall, env=PHASE11_ENV,
                vs_baseline_note="BENCH_BASELINE=1 stands in for the CPU "
                "baseline: vs_baseline is no reading", bench=out)


def phase11_graft(torch):
    """11, after the bench: ``graft_entry.entry()`` and
    ``graft_entry.dryrun_multichip(n)`` at their default device (the card),
    n the visible cards: the forward's inputs on the card, its output
    finite, of the JAX entry's shape (4, 512, 3), its rows summing to 1;
    both multi-device checks pass (the function raises otherwise)."""
    from dnascent_tpu_torch import graft_entry
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    out = fn(*args)
    sums = out.float().sum(-1)
    if not (all(a.is_cuda for a in args) and out.is_cuda
            and tuple(out.shape) == (4, 512, 3)
            and bool(torch.isfinite(out).all())
            and float((sums - 1).abs().max()) < 1e-4):
        fail(f"11: graft_entry.entry(): inputs on {args[0].device}, output "
             f"{tuple(out.shape)} on {out.device}, row sums "
             f"{float(sums.min())}..{float(sums.max())}")
    entry_s = time.perf_counter() - t0
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(n)
    return dict(entry_shape=list(out.shape), entry_device=str(out.device),
                entry_s=entry_s, dryrun_devices=n,
                dryrun_s=time.perf_counter() - t0)


# phase 12's dataset: the 10 kb workload's reads, written as a user's files
P12_READS, P12_LENGTH = 128, 10_000


def run_cli(args, cwd, what, timeout=600) -> float:
    """``python -m dnascent_tpu_torch <args>`` in a fresh interpreter at
    ``cwd`` (the repository on its path), on the default device; it must
    exit 0.  Returns its wall seconds."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "dnascent_tpu_torch", *args],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"{what} exited {res.returncode}:\n{res.stderr[-3000:]}")
    return wall


def line_counts(paths):
    """{file name: lines} of each file, each of which must start with a
    ``#`` header line."""
    out = {}
    for path in paths:
        with open(path) as fh:
            lines = fh.readlines()
        if not lines or not lines[0].startswith("#"):
            fail(f"12: {path} has no header")
        out[os.path.basename(path)] = len(lines)
    return out


def align_texts(path):
    """{read id: its table text} of an ``.align`` file."""
    lines, rid = {}, None
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                rid = line[1:].split()[0]
                lines[rid] = []
            lines[rid].append(line)
    return {k: "".join(v) for k, v in lines.items()}


def phase12_dataset(np, models, tmp):
    """12's files: 128 simulated 10 kb reads (seeded) as FASTA, one pod5
    file and BAM by ``testing.dataset.build_dataset``, with the int16
    samples the writer hands the VBZ encoder, row by row."""
    from dnascent_tpu_torch.io import pod5_io
    from dnascent_tpu_torch.testing.dataset import build_dataset
    stored = []
    encode = pod5_io.vbz_compress

    def recording(samples):
        stored.append(np.array(samples, np.int16))
        return encode(samples)

    pod5_io.vbz_compress = recording
    t0 = time.perf_counter()
    try:
        ds = build_dataset(os.path.join(tmp, "ds"), models,
                           n_reads=P12_READS, read_length=P12_LENGTH,
                           signal_format="pod5", contig_length=1_000_000,
                           seed=SEED + 1200)
    finally:
        pod5_io.vbz_compress = encode
    return ds, stored, time.perf_counter() - t0


def phase12_signal(np, ds, stored, records):
    """12's signal input: every read's samples decoded from the pod5 file
    equal the int16 samples the writer stored, and ``pod5_get_signal``
    gives the read source's signal; the first fetch (the file's parse), the
    fetch of every read and the VBZ decode alone, timed."""
    from dnascent_tpu_torch.io import pod5_io
    pod5 = os.path.join(ds.signal_dir, "batch0.pod5")
    by_id = {r.read_id: r for r in records}
    pod5_io._TABLE_CACHE.clear()
    t0 = time.perf_counter()
    pod5_io.pod5_get_signal(pod5, ds.read_ids[0])
    open_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    signals = [pod5_io.pod5_get_signal(pod5, rid) for rid in ds.read_ids]
    fetch_s = time.perf_counter() - t0
    tables = pod5_io._open_tables_cached(pod5)
    blobs = tables.signal.column("signal").to_pylist()
    counts = tables.signal.column("samples").to_pylist()
    if len(blobs) != len(stored):
        fail(f"12: {len(blobs)} signal rows, the writer stored {len(stored)}")
    t0 = time.perf_counter()
    decoded = [pod5_io.vbz_decompress(b, n) for b, n in zip(blobs, counts)]
    decode_s = time.perf_counter() - t0
    row_lists = tables.reads.column("signal").to_pylist()
    for rid, sig in zip(ds.read_ids, signals):
        rows = row_lists[tables.rows[rid]]
        got = np.concatenate([decoded[j] for j in rows])
        if not np.array_equal(got, np.concatenate([stored[j] for j in rows])):
            fail(f"12: {rid}: decoded pod5 samples differ from the stored")
        if not np.array_equal(sig, by_id[rid].raw):
            fail(f"12: {rid}: pod5_get_signal differs from the read source")
    samples = sum(counts)
    return dict(pod5_bytes=os.path.getsize(pod5), signal_rows=len(blobs),
                samples=samples, open_and_first_fetch_s=open_s,
                pod5_get_signal_s_per_read=fetch_s / len(signals),
                vbz_decode_s=decode_s,
                vbz_decode_mb_per_s_out=2 * samples / decode_s / 1e6,
                vbz_decode_mb_per_s_in=sum(map(len, blobs)) / decode_s / 1e6)


def phase12(torch, np, models, counters, tmp):
    """12: the users' command lines on pod5 files, each as ``python -m
    dnascent_tpu_torch`` on the default device (the card): ``index`` (its
    map equal to the dataset's index), ``detect --model`` to ``.detect``
    and to ``.bam``, ``align`` and ``forkSense`` on both detect outputs;
    then the same detect in this process through ``cli.main`` under the
    launch counters (A-D and F launch, E not; body byte-equal to the
    subprocess's) and through ``detect_reads`` over the read source's
    records at the CLI's batch size and depth (body byte-equal too); the
    ``.bam`` against the ``.detect``, the ``.align`` tables, the decoded
    samples against the stored ones; and the per-read fetch at 128 and 4096
    reads a file (``scripts/bench_pod5_lookup.py``)."""
    from dnascent_tpu_torch import cli
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.fasta import import_reference
    from dnascent_tpu_torch.io.index_io import parse_index
    from dnascent_tpu_torch.io.poremodel import load_model_set
    from dnascent_tpu_torch.io.writers import DetectHRWriter, detect_header
    from dnascent_tpu_torch.models import reference_cnn
    from dnascent_tpu_torch.parallel.compute import device_set
    from dnascent_tpu_torch.pipeline.detect import DetectStats, detect_reads
    from dnascent_tpu_torch.pipeline.source import BamSignalSource
    from dnascent_tpu_torch.testing.tf_bundle_writer import write_savedmodel_dir

    ds, stored, build_s = phase12_dataset(np, models, tmp)
    model_dir = os.path.join(tmp, "detect_model")
    write_savedmodel_dir(model_dir, reference_tensors())

    def path(name):
        return os.path.join(tmp, name)

    io_args = ["-b", ds.bam, "-r", ds.reference_fa, "-i", path("idx")]
    n = len(ds.read_ids)
    walls = dict(index=run_cli(["index", "-f", ds.signal_dir, "-o",
                                path("idx")], tmp, "12: index"))
    if parse_index(path("idx")) != parse_index(ds.index):
        fail("12: index's read -> file map differs from the dataset's")
    for ext in ("detect", "bam"):
        walls[f"detect_{ext}"] = run_cli(
            ["detect", *io_args, "-o", path(f"out.{ext}"), "--model",
             model_dir], tmp, f"12: detect -o out.{ext}")
    walls["align"] = run_cli(["align", *io_args, "-o", path("out.align")],
                             tmp, "12: align")
    forksense = {}
    for ext in ("detect", "bam"):
        cwd = path(f"fs_{ext}")
        os.makedirs(cwd)
        walls[f"forksense_{ext}"] = run_cli(
            ["forkSense", "-d", path(f"out.{ext}"), "-o", "out.forkSense",
             "--order", "BrdU,EdU", "--markForks", "--markAnalogues",
             "--markOrigins", "--markTerminations"], cwd,
            f"12: forkSense -d out.{ext}")
        forksense[ext] = line_counts(
            [os.path.join(cwd, f) for f in sorted(os.listdir(cwd))])
    print("phase 12 forkSense line counts: " + json.dumps(forksense),
          flush=True)

    # the same detect in this process, under the launch counters
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    with PathShapes(torch) as shapes, \
            contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["detect", *io_args, "-o", path("inproc.detect"),
                       "--model", model_dir])
    torch.cuda.synchronize()
    inproc_s = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"12: in-process detect gave {rc}")
    missing = [k for k in A_TO_D + ("gru_encoder",) if launches[k] == 0]
    if missing or launches["banded_fill_general"]:
        fail(f"12: in-process detect launches {launches}")
    reads_out, body = detect_body(path("out.detect"))
    if detect_body(path("inproc.detect")) != (reads_out, body):
        fail("12: in-process detect body differs from the subprocess's")

    # the read source alone, then detect_reads over its records
    t0 = time.perf_counter()
    records = list(BamSignalSource(ds.bam, import_reference(ds.reference_fa),
                                   parse_index(path("idx"))))
    source_s = time.perf_counter() - t0
    if len(records) != n:
        fail(f"12: the read source gave {len(records)} of {n} reads")
    model = reference_cnn.load_savedmodel(model_dir).to("cuda")
    stats = DetectStats()
    with DetectHRWriter(path("lib.detect")) as w:
        w.write_header(detect_header(ds.bam, ds.reference_fa, path("idx"), 1,
                                     20, 1000, compute="GPU"))
        for _rid, d in detect_reads(iter(records), load_model_set(DNA_R10),
                                    model, DNA_R10,
                                    device=device_set(None, "cuda"),
                                    stats=stats, collect_failures=True):
            if d is not None:
                w.write(d)
    if detect_body(path("lib.detect")) != (reads_out, body):
        fail("12: detect_reads' body differs from the CLI's")

    texts = align_texts(path("out.align"))
    if len(texts) != reads_out:
        fail(f"12: .align has {len(texts)} reads, .detect {reads_out}")
    align_rows = sum(check_table(np, rid, t) for rid, t in texts.items())
    signal = phase12_signal(np, ds, stored, records)

    res = subprocess.run([sys.executable, os.path.join(
        ROOT, "scripts", "bench_pod5_lookup.py")], capture_output=True,
        text=True, timeout=300)
    if res.returncode != 0:
        fail(f"12: bench_pod5_lookup.py exited {res.returncode}:\n"
             f"{res.stderr[-3000:]}")
    lookup = {r["reads_a_file"]: r for r in
              json.loads(res.stdout.strip().splitlines()[-1])["rows"]}
    return dict(
        reads=n, read_length=P12_LENGTH, dataset_build_s=build_s,
        reads_out=reads_out, failed_qc=stats.failed,
        wall_s=walls, reads_per_s={k: n / v for k, v in walls.items()},
        inproc_detect_s=inproc_s, inproc_reads_per_s=n / inproc_s,
        peak_mem_bytes=peak, launches=launches, shapes=shapes.report(),
        body_sha256=body, modbam=modbam_agreement(np, path("out.bam"),
                                                  path("out.detect")),
        align_rows=align_rows, forksense_lines=forksense,
        bam_signal_source_s_per_read=source_s / n, **signal, lookup=lookup)


# phase 13, the fork workflow: sizes and gates fixed before its first run.
# Training: 96 painted 10 kb reads, one BrdU and one EdU track each of
# 1.5-3.5 kb; the full-width DetectCNN fitted with AdamW; its last loss
# below 0.6 x its first (tests/test_workflow_e2e.py's gate).  Forks: 256
# painted 20 kb reads (96 right forks, 96 left, 64 origins; tracks 2-4 kb).
P13_TRAIN = dict(n_reads=96, length=10_000, track_len=(1500, 3501))
P13_FIT = dict(seq_len=1024, batch_size=16, epochs=6, learning_rate=1e-3)
P13_FORKS = dict(n_right=96, n_left=96, n_origin=64, read_length=20_000,
                 track_len=(2000, 4001))
P13_LOSS_RATIO = 0.6
# separation: a track's mean probability of its analogue above 2x the mean
# outside every track, in at least 90 % of the QC-passing reads
P13_SEPARATION, P13_SEPARATED_SHARE = 2.0, 0.9
# forks: at least 70 % of each direction's reads called across their
# boundary; at most 5 % of the fork reads called in the wrong direction
P13_FORK_RECALL, P13_WRONG_SHARE = 0.7, 0.05
def phase13_fit(torch, np, models, edu, dev, counters, npz):
    """13's fit: the training batches of the painted reads through
    ``batches_from_labelled_reads`` on the card (kernels A-D), then the
    full-width DetectCNN from its seeded weights with AdamW; its loss must
    fall below ``P13_LOSS_RATIO`` x the first; written to ``npz``."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.pipeline import traincnn as tc
    from dnascent_tpu_torch.testing.painted import training_pairs

    t0 = time.perf_counter()
    pairs = training_pairs(models, edu, seed=SEED + 1300, **P13_TRAIN)
    paint_s = time.perf_counter() - t0
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    batches = list(tc.batches_from_labelled_reads(
        pairs, models, DNA_R10, seq_len=P13_FIT["seq_len"],
        batch_size=P13_FIT["batch_size"], device=dev))
    batches_s = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    missing = [k for k in A_TO_D if launches[k] == 0]
    if missing:
        fail(f"13: kernels never launched on the training batches: {missing}")
    model = cnn.init_untrained(cnn.DetectCNN(), seed=SEED).to(dev)
    opt = tc.make_optimizer(list(model.parameters()),
                            P13_FIT["learning_rate"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, losses = tc.train_detect_cnn(batches, model=model, optimizer=opt,
                                    epochs=P13_FIT["epochs"], device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    if not (np.isfinite(losses).all()
            and losses[-1] < P13_LOSS_RATIO * losses[0]):
        fail(f"13: the fit's loss went {losses[0]} -> {losses[-1]}, not "
             f"below {P13_LOSS_RATIO} x the first")
    tc.save_model(model, npz)
    per_epoch = np.asarray(losses).reshape(P13_FIT["epochs"], -1)
    return dict(
        reads=len(pairs), read_length=P13_TRAIN["length"],
        paint_s=paint_s, batches=len(batches), batches_s=batches_s,
        labelled=int(sum(b.mask.sum() for b in batches)),
        launches=launches, steps=len(losses), epochs=P13_FIT["epochs"],
        batch=[P13_FIT["batch_size"], P13_FIT["seq_len"]], fit_s=fit_s,
        ms_per_step=fit_s / len(losses) * 1e3,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        loss_first=losses[0], loss_last=losses[-1],
        loss_epoch_means=per_epoch.mean(axis=1).tolist())


def separation(np, truth, detected):
    """Per QC-passing read, each analogue's mean probability inside its
    painted tracks over its mean outside every track; the share of reads
    above ``P13_SEPARATION`` must reach ``P13_SEPARATED_SHARE``."""
    from dnascent_tpu_torch.pipeline.traincnn import LABEL_IDS
    ratios = {"BrdU": [], "EdU": []}
    for f in truth:
        d = detected.get(f.read_id)
        if d is None:
            continue
        lab = f.labels[d.ref_coords - f.ref_start]
        out = lab == LABEL_IDS["Thym"]
        for kind, p in (("BrdU", d.brdu_prob), ("EdU", d.edu_prob)):
            inside, outside = p[lab == LABEL_IDS[kind]].mean(), p[out].mean()
            ratios[kind].append(inside / outside if outside > 0
                                else float("inf"))
    res = {}
    for kind, r in ratios.items():
        r = np.asarray(r)
        share = float((r > P13_SEPARATION).mean()) if r.size else 0.0
        if share < P13_SEPARATED_SHARE:
            fail(f"13: {kind} separates in {share:.3f} of the reads, not "
                 f"{P13_SEPARATED_SHARE}")
        res[kind] = dict(reads=int(r.size), share_above=share,
                         ratio_median=float(np.median(r)),
                         ratio_min=float(r.min()))
    return res


def read_bed(path):
    """{read id: [(left, right), ...]} of a forkSense bed."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if not line.startswith("#"):
                c = line.split()
                out.setdefault(c[3], []).append((int(c[1]), int(c[2])))
    return out


def fork_recall(truth, beds):
    """Each fork read called across its boundary in its own direction, each
    fork read called in the other, each origin read with an origin on its
    EdU track; the recall and wrong-direction gates."""
    hit = {"right": 0, "left": 0, "origin": 0}
    n = {"right": 0, "left": 0, "origin": 0}
    wrong = 0
    other = {"right": "left", "left": "right"}
    for f in truth:
        n[f.pattern] += 1
        if f.pattern == "origin":
            e0, e1 = f.tracks[1][1:]
            hit["origin"] += any(lb <= e1 and ub >= e0 for lb, ub in
                                 beds["origins"].get(f.read_id, []))
            continue
        first_end, second_start = f.boundary()
        hit[f.pattern] += any(lb < first_end and ub > second_start
                              for lb, ub in beds[f.pattern].get(f.read_id,
                                                                []))
        wrong += f.read_id in beds[other[f.pattern]]
    recall = {k: hit[k] / max(n[k], 1) for k in hit}
    n_forks = n["right"] + n["left"]
    res = dict(reads=n, recall=recall, wrong_direction=wrong,
               wrong_share=wrong / max(n_forks, 1),
               calls={k: sum(map(len, v.values())) for k, v in beds.items()},
               termination_recall=None,
               termination_note="no read is painted as a termination: every "
                                "termination call is a false one")
    for k in ("right", "left"):
        if recall[k] < P13_FORK_RECALL:
            fail(f"13: {k}-fork recall {recall[k]:.3f} < {P13_FORK_RECALL}")
    if res["wrong_share"] > P13_WRONG_SHARE:
        fail(f"13: {wrong} of {n_forks} fork reads called in the wrong "
             f"direction")
    return res


def phase13(torch, np, models, counters, tmp, dev):
    """13: the BrdU/EdU fork workflow at a user's size on the card.  The
    full-width DetectCNN fitted on painted reads; painted fork reads
    written as FASTA, pod5, BAM and index; ``detect --cnn-weights`` on them
    as ``python -m dnascent_tpu_torch`` in a fresh interpreter (default
    device) and in this process through ``detect_reads`` over
    ``BamSignalSource``'s records, bodies byte-equal, A-D launched and E, F
    not; CUDA against the CPU with the fitted weights on four painted 3 kb
    reads; the calls' separation of the painted tracks; the forkSense CLI
    (host) and its forks against the truth; seeBreaks in both modes."""
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.fasta import import_reference
    from dnascent_tpu_torch.io.index_io import parse_index
    from dnascent_tpu_torch.io.writers import DetectHRWriter, detect_header
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.parallel.compute import device_set
    from dnascent_tpu_torch.pipeline.detect import DetectStats, detect_reads
    from dnascent_tpu_torch.pipeline.source import BamSignalSource
    from dnascent_tpu_torch.testing import painted

    def path(name):
        return os.path.join(tmp, name)

    edu = painted.edu_model(models)
    npz = path("fit.npz")
    out = dict(fit=phase13_fit(torch, np, models, edu, dev, counters, npz))

    t0 = time.perf_counter()
    ds = painted.painted_fork_dataset(path("forks"), models, seed=SEED + 1310,
                                      **P13_FORKS)
    out["dataset_s"] = time.perf_counter() - t0
    truth = painted.read_truth(ds.truth)
    n = len(truth)
    det = path("forks.detect")
    io_args = ["-b", ds.bam, "-r", ds.reference_fa, "-i", ds.index]
    walls = dict(detect=run_cli(["detect", *io_args, "-o", det,
                                 "--cnn-weights", npz], tmp, "13: detect"))

    # the same detect in this process, under the launch counters
    model = cnn.load_npz(cnn.DetectCNN(), npz).to(dev)
    records = list(BamSignalSource(ds.bam, import_reference(ds.reference_fa),
                                   parse_index(ds.index)))
    stats = DetectStats()
    detected = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    with DetectHRWriter(path("lib.detect")) as w:
        w.write_header(detect_header(ds.bam, ds.reference_fa, ds.index, 1,
                                     20, 1000, compute="GPU"))
        for rid, d in detect_reads(iter(records), models, model, DNA_R10,
                                   device=device_set(None, dev.type),
                                   stats=stats, collect_failures=True):
            if d is not None:
                w.write(d)
                detected[rid] = d
    torch.cuda.synchronize()
    inproc_s = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    missing = [k for k in A_TO_D if launches[k] == 0]
    if missing or launches["banded_fill_general"] or launches["gru_encoder"]:
        fail(f"13: in-process detect launches {launches}")
    reads_out, body = detect_body(det)
    if detect_body(path("lib.detect")) != (reads_out, body):
        fail("13: detect_reads' body differs from the CLI's")
    out.update(reads=n, read_length=P13_FORKS["read_length"],
               reads_out=reads_out, failed_qc=stats.failed,
               called_sites=int(sum(d.ref_coords.shape[0]
                                    for d in detected.values())),
               inproc_detect_s=inproc_s, inproc_reads_per_s=n / inproc_s,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches, body_sha256=body)

    # CUDA against the CPU with the fitted weights on painted 3 kb reads
    labels = painted.labels_from_tracks(3000, [("EdU", 600, 1350),
                                               ("BrdU", 1410, 2160)])
    short = [painted.painted_read(models, edu, 3000, labels,
                                  SEED + 1320 + i, f"cmp-{i}")
             for i in range(4)]
    out["cuda_vs_cpu"] = cpu_agreement(torch, np, models, model, dev,
                                       PROB_ATOL_CPU, records=short)
    out["separation"] = separation(np, truth, detected)

    fs_dir = path("fs")
    os.makedirs(fs_dir)
    walls["forksense"] = run_cli(
        ["forkSense", "-d", det, "-o", "forks.forkSense", "--order",
         "EdU,BrdU", "--markForks", "--markOrigins", "--markTerminations",
         "--markAnalogues"], fs_dir, "13: forkSense")
    bed = {k: os.path.join(fs_dir, f"{name}_DNAscent_forkSense.bed")
           for k, name in (("left", "leftForks"), ("right", "rightForks"),
                           ("origins", "origins"),
                           ("terminations", "terminations"),
                           ("brdu", "BrdU"))}
    out["forks"] = fork_recall(truth, {k: read_bed(v) for k, v in
                                       bed.items() if k != "brdu"})
    t0 = time.perf_counter()
    out["seebreaks"] = seebreaks_modes(np, dict(
        left=bed["left"], right=bed["right"], brdu=bed["brdu"], detect=det),
        "13")
    walls["seebreaks"] = time.perf_counter() - t0
    out["wall_s"] = walls
    out["detect_cli_reads_per_s"] = n / walls["detect"]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import numpy as np
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.poremodel import synthetic_model_set
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
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

    counters = cuda_lib.launch_counters()
    p3 = drive(torch, np, models, model, dev, counters, A_TO_D)
    print("phase 3 main path: " + json.dumps(p3), flush=True)

    ref = reference_model(dev)
    p4 = dict(cuda_vs_cpu=cpu_agreement(torch, np, models, ref, dev,
                                        REF_PROB_ATOL_CPU))
    p4.update(drive(torch, np, models, ref, dev, counters,
                    A_TO_D + ("gru_encoder", "trunk_epilogue")))
    # one GRU call a forward: the epilogue's launches are 34 a forward
    if p4["launches"]["trunk_epilogue"] != 34 * p4["shapes"]["gru_calls"]:
        fail(f"trunk epilogue: {p4['launches']['trunk_epilogue']} launches "
             f"over {p4['shapes']['gru_calls']} forwards")
    print("phase 4 --model path: " + json.dumps(p4), flush=True)

    fit = fit_stdv_models(models)
    p5 = dict(cuda_vs_cpu=cpu_agreement(torch, np, fit, model, dev,
                                        PROB_ATOL_CPU))
    p5.update(drive(torch, np, fit, model, dev, counters,
                    ("banded_fill_general", "banded_chase", "viterbi_fill",
                     "viterbi_backtrace"), n_reads=32,
                    absent=("banded_fill",)))
    print("phase 5 fit-stdv path: " + json.dumps(p5), flush=True)

    p6 = dict(modbam=drive(torch, np, models, model, dev, counters, A_TO_D,
                           modbam=True))
    with tempfile.TemporaryDirectory() as tmp:
        paths, p6["forksense"] = phase6_forksense(np, tmp)
        p6["seebreaks"] = phase6_seebreaks(torch, np, dev, paths)
    print("phase 6 analysis flow: " + json.dumps(p6), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        p7 = dict(cuda_vs_cpu=phase7_cpu_agreement(torch, np, models, dev))
        fast_texts, records, p7["strict"], p7["fast"] = phase7_align(
            torch, np, models, dev, counters, tmp)
        p7["traincnn"] = phase7_traincnn(torch, np, models, model, dev,
                                         counters, records, fast_texts)
        p7["traingmm"] = phase7_traingmm(torch, np, models, dev, tmp)
    print("phase 7 align and training tables: " + json.dumps(p7), flush=True)

    t8 = time.perf_counter()
    records8, p8a = phase8_hmm(torch, np, models, dev, counters)
    p8 = dict(hmm=p8a, hmm_cuda_vs_cpu=phase8_hmm_cpu_agreement(
        torch, np, models, dev))
    with tempfile.TemporaryDirectory() as tmp:
        p8["fit"] = phase8_fit(torch, np, models, dev, counters,
                               records8[:8], tmp)
    p8["wall_s"] = time.perf_counter() - t8
    print(f"phase 8 --HMM detect and CNN fitting ({smi}): "
          + json.dumps(p8), flush=True)

    t9 = time.perf_counter()
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    records9 = list(SimulatedSource(models, DNA_R10, n_reads=64,
                                    length=10000, seed=SEED + 300))
    with tempfile.TemporaryDirectory() as tmp:
        p9a, counts9, single9 = phase9a(torch, np, models, model, counters,
                                        records9, tmp, p3)
        p9 = dict(a=p9a, a_wall_s=time.perf_counter() - t9)
        p9.update(phase9_processes(torch, np, tmp, counts9, single9))
    t = time.perf_counter()
    p9["d"] = phase9d(torch, np, dev)
    p9["d_wall_s"] = time.perf_counter() - t
    t = time.perf_counter()
    p9["e"] = phase9e(torch, np, model, dev)
    p9["e_wall_s"] = time.perf_counter() - t
    p9["wall_s"] = time.perf_counter() - t9
    print(f"phase 9 multi-device and multi-process runs ({smi}): "
          + json.dumps(p9), flush=True)

    t10 = time.perf_counter()
    p10 = {}
    p10["a"], passed10 = phase10a(torch, np, models, model, dev, counters,
                                  records9, p3)
    t = time.perf_counter()
    p10["b"] = phase10b(np, models, records9, passed10)
    p10["b_wall_s"] = time.perf_counter() - t
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        p10["c"] = phase10c(np, models, tmp)
    p10["c_wall_s"] = time.perf_counter() - t
    p10["wall_s"] = time.perf_counter() - t10
    print(f"phase 10 stage telemetry, CPU baseline and writers ({smi}): "
          + json.dumps(p10), flush=True)

    p11 = dict(card=smi, **phase11_bench())
    p11["graft_entry"] = phase11_graft(torch)
    print("phase 11 bench: " + json.dumps(p11), flush=True)

    t12 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        p12 = phase12(torch, np, models, counters, tmp)
    p12["phase_wall_s"] = time.perf_counter() - t12
    print(f"phase 12 the CLI on pod5 files ({smi}): " + json.dumps(p12),
          flush=True)

    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        p13 = phase13(torch, np, models, counters, tmp, dev)
    p13["phase_wall_s"] = time.perf_counter() - t13
    print(f"phase 13 the fork workflow ({smi}): " + json.dumps(p13),
          flush=True)

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
        "trunk_epilogue": ("dnascent_tpu_torch/csrc/trunk_epilogue.cu",
                           "none (XLA fuses this glue in the JAX package)",
                           p4),
    }
    paths = {"phase3": p3, "phase4": p4, "phase5": p5,
             "phase6": p6["modbam"], "phase7": p7["strict"],
             "phase8_hmm": p8["hmm"], "phase8_fit": p8["fit"]["batches"],
             "phase9": p9["a"], "phase10": p10["a"], "phase12": p12,
             "phase13": p13}
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
            library_ms=row.get("library_ms"),
            library_note=LIBRARY_NOTES[name], bytes=row["bytes"],
            library_gru_ms=row.get("library_gru_ms"), ops=row["ops"],
            shape=row["shape"], forward_34=row.get("forward_34"),
            trunk_pass=row.get("trunk_pass")))
    print(f"total wall: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
