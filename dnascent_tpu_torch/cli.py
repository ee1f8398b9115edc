"""Command-line interface of the port: ``index``, ``detect`` (``.detect`` or
modbam ``.bam`` output; ``--HMM`` for the forward-HMM log-likelihood
ratios), ``align``, ``forkSense``, ``seeBreaks``, ``trainCNN`` (the
training tables; ``--fit`` also fits a detect CNN) and ``trainGMM``.

Run as ``python -m dnascent_tpu_torch <subprogram> ...`` or through the
``dnascent-tpu-torch`` entry point.  The flags are the JAX package's
(``dnascent_tpu/cli.py``) plus ``--device`` (default ``cuda``) on
``detect``, ``align``, ``trainCNN``, ``trainGMM`` (its EM) and
``seeBreaks``, where only ``--fast`` uses it.  ``--devices`` sends whole
batches to several devices in turn; ``--nprocs``/``--procid`` shard the
reads over processes, each writing ``<out>.host<k>``, merged by the last
shard run or, with ``--coordinator host:port`` (a gloo process group), by
process 0 after a barrier.  The CNN is the default
DetectCNN (``--cnn-weights``) or the reference's trained topology (``--model
<SavedModel dir>``, or ``--cnn-weights`` with an npz that ``trainCNN
--fit-arch reference`` wrote).  ``index``, ``forkSense`` and ``seeBreaks``
without ``--fast`` run on the host, as in the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import __version__

GENERAL_HELP = f"""dnascent_tpu_torch v{__version__} — PyTorch/CUDA DNAscent
Usage: dnascent-tpu-torch [subprogram] [arguments]
The subprograms are:

  index      generate an index file for fast5/pod5 files,
  detect     detect base analogues in Oxford Nanopore reads,
  align      align nanopore signals to reference k-mers,
  forkSense  call replication origins, fork movement, and fork stalling,
  seeBreaks  detect an elevated frequency of DNA breaks at forks,
  trainCNN   build training data for neural network training,
  trainGMM   estimate the mean and standard deviation of a base analogue's current.
"""


def _add_distributed_flags(p):
    p.add_argument("--devices", default=None,
                   help="run on N devices ('all' = every visible CUDA "
                   "device; with --device cpu, N CPU replicas), batch i on "
                   "device i mod N")
    p.add_argument("--nprocs", type=int, default=1,
                   help="number of cooperating processes (each takes every "
                   "nprocs-th read; shard outputs are merged "
                   "deterministically)")
    p.add_argument("--procid", type=int, default=None,
                   help="this process's index in [0, nprocs); with "
                   "--coordinator it defaults to RANK from the environment")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0's gloo rendezvous "
                   "(processes that run together)")


def _setup_parallel(a):
    """Join the process group of ``--coordinator`` (if given); returns
    (process index, process count).  A single process is process 0, as the
    JAX CLI ignores ``--procid`` without ``--nprocs``."""
    from .parallel.mesh import init_distributed
    nprocs = max(1, a.nprocs)
    try:
        procid = init_distributed(a.coordinator, nprocs, a.procid)
    except ValueError as e:
        raise SystemExit(f"Exiting with error.  {e}") from None
    if nprocs == 1:
        return 0, 1
    if not 0 <= procid < nprocs:
        raise SystemExit(f"Exiting with error.  --procid {procid} outside "
                         f"[0, {nprocs}).")
    return procid, nprocs


def _merge_shards(a, procid: int, nprocs: int, what: str,
                  beds=()) -> None:
    """After a shard run: with a coordinator every process reaches a
    barrier and process 0 merges; without one, whichever run completes
    the set of ``<out>.host<k>`` files merges them (and each bed's)."""
    from .parallel.collectives import barrier
    from .parallel.merge import (all_shards_present, host_shard_path,
                                 merge_bed_outputs, merge_host_outputs)
    if a.coordinator:
        barrier(f"{what}_shards_done")
    if (procid == 0 or not a.coordinator) and all_shards_present(a.output,
                                                                  nprocs):
        n = merge_host_outputs(
            [host_shard_path(a.output, i) for i in range(nprocs)], a.output)
        for name in beds:
            if all_shards_present(name, nprocs):
                merge_bed_outputs(
                    [host_shard_path(name, i) for i in range(nprocs)], name)
        print(f"merged {nprocs} shards -> {a.output} ({n} reads)")
    elif not a.coordinator:
        print(f"shard {procid}/{nprocs} written to "
              f"{host_shard_path(a.output, procid)}; the final shard run "
              "merges all shards", file=sys.stderr)


# ---------------------------------------------------------------------------
# index
# ---------------------------------------------------------------------------

def main_index(argv) -> int:
    p = argparse.ArgumentParser(prog="dnascent-tpu-torch index")
    p.add_argument("-f", "--files", required=True,
                   help="full path to fast5 or pod5 files")
    p.add_argument("-s", "--sequencing-summary", default=None)
    p.add_argument("-o", "--output", default="index.dnascent")
    a = p.parse_args(argv)
    from .io.index_io import build_index
    n = build_index(a.files.rstrip("/"), a.output, a.sequencing_summary)
    print(f"Indexed {n} reads -> {a.output}")
    return 0


# ---------------------------------------------------------------------------
# detect / align / trainCNN shared front end
# ---------------------------------------------------------------------------

def _detect_parser(prog: str, min_l_default: int):
    p = argparse.ArgumentParser(prog=f"dnascent-tpu-torch {prog}")
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-q", "--quality", type=int, default=20)
    p.add_argument("-l", "--length", type=int, default=min_l_default)
    p.add_argument("-m", "--maxReads", type=int, default=None)
    p.add_argument("--GPU", default=None, help="accepted for compatibility; "
                   "use --device")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                   "kernels' plain PyTorch versions)")
    p.add_argument("--HMM", action="store_true",
                   help="detect: forward-HMM log-likelihood ratios instead "
                   "of CNN calls (.detect output only); align and trainCNN "
                   "accept it and ignore it, as the JAX CLI does")
    p.add_argument("--cnn-weights", default=None,
                   help="npz weights in the key layout "
                   "dnascent_tpu.models.cnn.save_params writes: the default "
                   "detect CNN's, or the reference topology's (trainCNN "
                   "--fit-arch reference)")
    p.add_argument("--model", default=None,
                   help="reference SavedModel directory (with its "
                   "variables.data-* shards): run the reference's trained "
                   "CNN topology")
    p.add_argument("--allow-untrained-cnn", action="store_true",
                   help="run with untrained weights from a seeded torch "
                   "generator (pipeline testing only; probabilities are "
                   "noise and differ from the JAX package's untrained noise)")
    _add_distributed_flags(p)
    p.add_argument("--resume", action="store_true",
                   help="skip reads already present in the .detect output "
                   "file")
    p.add_argument("--strict-windows", action="store_true",
                   help="reproduce the reference's sequential window "
                   "coupling (strict eventalign)")
    return p


def _open_source(a, shard=None):
    """(read source over the BAM, the list its missing read ids go to);
    ``shard`` = (k, n) keeps every n-th passing record from the k-th."""
    from .io.fasta import import_reference
    from .io.index_io import parse_index
    from .pipeline.source import BamSignalSource
    missing: list[str] = []
    src = BamSignalSource(a.bam, import_reference(a.reference),
                          parse_index(a.index), min_mapq=a.quality,
                          min_length=a.length, max_reads=a.maxReads,
                          on_missing=missing.append, shard=shard)
    return src, missing


def _write_missing_log(out_path: str, suffix: str, missing) -> None:
    with open(os.path.splitext(out_path)[0] + suffix, "w") as fh:
        for rid in missing:
            fh.write(f"ReadID {rid} missing from index. Skipping.\n")


def _resolve_devices(devices, device: str):
    """The run's device set (``--devices`` on ``--device``); on CUDA,
    cuBLAS/cuDNN in full f32 where the model runs f32 (the head); the bf16
    layers are unaffected."""
    import torch

    from .parallel.compute import device_set
    try:
        devices = device_set(devices, device)
    except ValueError as e:
        raise SystemExit(f"Exiting with error.  {e}") from None
    if devices[0].type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return devices


def _load_cnn(a, device):
    from .models import cnn as cnn_mod
    from .models import reference_cnn
    if a.model:
        if not os.path.isdir(a.model):
            raise SystemExit(f"Exiting with error.  SavedModel directory "
                             f"{a.model} not found.")
        return reference_cnn.load_savedmodel(a.model).to(device)
    model = cnn_mod.DetectCNN()
    if a.cnn_weights:
        if not os.path.exists(a.cnn_weights):
            raise SystemExit(f"Exiting with error.  CNN weights "
                             f"{a.cnn_weights} not found.")
        import numpy as np
        with np.load(a.cnn_weights) as data:
            flat = {k: data[k] for k in data.files}
        if "gru0/kernel" in flat:
            # npz written by `trainCNN --fit --fit-arch reference`: the
            # reference topology fitted in-framework
            model = reference_cnn.params_from_tree(
                reference_cnn.ReferenceDetectCNN(), flat)
        else:
            cnn_mod.params_from_flax(model, flat)
    elif a.allow_untrained_cnn:
        cnn_mod.init_untrained(model)
        print("Warning: --allow-untrained-cnn — analogue probabilities "
              "will be noise (no trained CNN weights supplied).",
              file=sys.stderr)
    else:
        # the reference refuses to run without its trained SavedModel
        # (src/tensor.cpp:48); the JAX CLI's message
        raise SystemExit(
            "Exiting with error.  No trained CNN weights: pass "
            "--cnn-weights <npz> (or --allow-untrained-cnn to force "
            "untrained weights for pipeline testing).")
    return model.to(device)


def main_detect(argv) -> int:
    a = _detect_parser("detect", 1000).parse_args(argv)
    ext = a.output.rsplit(".", 1)[-1]
    if ext not in ("detect", "bam"):
        print(f"Exiting with error.  Invalid output extension: {ext}",
              file=sys.stderr)
        return 1
    human_readable = ext == "detect"
    procid, nprocs = _setup_parallel(a)
    shard = (procid, nprocs) if nprocs > 1 else None
    if shard and not human_readable:
        print("--nprocs > 1 supports human-readable .detect output only "
              "(shards are merged as text)", file=sys.stderr)
        return 1
    if a.HMM and not human_readable:
        print("--HMM supports human-readable output only (as in the "
              "reference's legacy path)", file=sys.stderr)
        return 1
    from .parallel.merge import host_shard_path
    out_path = host_shard_path(a.output, procid) if shard else a.output

    from .config import DNA_R10
    from .io.poremodel import load_model_set
    from .io.writers import DetectHRWriter, detect_header
    from .pipeline.detect import DetectStats, detect_reads
    from .utils.progress import ProgressBar, StageTimer

    devices = _resolve_devices(a.devices, a.device)
    # the HMM path scores with the pore models alone: no CNN is loaded
    model = None if a.HMM else _load_cnn(a, devices[0])
    cfg = DNA_R10
    models = load_model_set(cfg)
    src, missing = _open_source(a, shard)
    total = src.count_records()
    done_ids = set()
    if a.resume and human_readable and os.path.exists(out_path):
        with open(out_path) as fh:
            done_ids = {line[1:].split()[0] for line in fh
                        if line.startswith(">")}
        print(f"resume: skipping {len(done_ids)} completed reads",
              file=sys.stderr)
        src = (r for r in src if r.read_id not in done_ids)
    compute = "GPU" if devices[0].type == "cuda" else "CPU"
    stats = DetectStats()
    bar = ProgressBar(max(1, total - len(done_ids)))
    # per-stage wall-clock totals on stderr, the JAX CLI's switch (with
    # --HMM it prints the heading alone, as the JAX CLI does), then the
    # tree of the run's spans
    timer = (StageTimer()
             if os.environ.get("DNASCENT_STAGE_TIMES") == "1" else None)
    if a.HMM:
        from .pipeline.hmm_detect import hmm_detect_reads
        # the file is reopened for writing even after --resume skipped the
        # completed reads, so they are lost: the JAX CLI's behaviour,
        # mirrored (ROADMAP section 3, reference quirks)
        writer = DetectHRWriter(out_path)
        writer.write_header(detect_header(
            a.bam, a.reference, a.index, a.threads, a.quality, a.length,
            compute=compute, mode="HMM"))
        results = hmm_detect_reads(src, models, cfg, device=devices,
                                   stats=stats)
        write = writer.write_text
    else:
        if human_readable:
            mode = "a" if done_ids else "w"
            writer = DetectHRWriter(out_path, mode=mode)
            if mode == "w":
                writer.write_header(detect_header(
                    a.bam, a.reference, a.index, a.threads, a.quality,
                    a.length, compute=compute))
        else:
            from .io.bam import BamReader
            from .io.modbam import ModBamWriter
            hdr = BamReader(a.bam)
            hdr.close()
            writer = ModBamWriter(a.output, hdr.header_text, hdr.ref_names,
                                  hdr.ref_lengths)
        results = detect_reads(src, models, model, cfg, device=devices,
                               stats=stats, collect_failures=True,
                               strict_windows=a.strict_windows, timer=timer)
        write = writer.write
    with writer:
        # a read that failed QC comes as None
        for _rid, out in results:
            if out is not None:
                write(out)
            bar.display(stats.processed, stats.failed)
    bar.display(stats.processed, stats.failed)
    bar.finish()
    if timer is not None:
        print("stage wall-clock totals:", file=sys.stderr)
        timer.report()
        print("spans (wall ms, thread-CPU ms, calls):", file=sys.stderr)
        timer.tree()
    _write_missing_log(out_path, ".detect.log", missing)
    print(f"\ndetect: {stats.processed} reads, {stats.failed} failed QC")
    if shard:
        _merge_shards(a, procid, nprocs, "detect")
    return 0


# ---------------------------------------------------------------------------
# align / trainCNN / trainGMM
# ---------------------------------------------------------------------------

def main_align(argv) -> int:
    p = _detect_parser("align", 100)
    p.add_argument("--fast-windows", action="store_true",
                   help="use the batched independent-window geometry "
                   "instead of the reference's sequential window coupling "
                   "(faster; rows differ where the couplings diverge)")
    a = p.parse_args(argv)
    # shards as detect's (reference: the same OpenMP read loop drives
    # align, src/alignment.cpp:826)
    procid, nprocs = _setup_parallel(a)
    shard = (procid, nprocs) if nprocs > 1 else None
    from .config import DNA_R10
    from .io.poremodel import load_model_set
    from .io.writers import AlignHRWriter
    from .parallel.merge import host_shard_path
    from .pipeline.align import align_reads
    from .pipeline.detect import DetectStats
    from .utils.progress import ProgressBar

    out_path = host_shard_path(a.output, procid) if shard else a.output
    devices = _resolve_devices(a.devices, a.device)
    models = load_model_set(DNA_R10)
    src, missing = _open_source(a, shard)
    bar = ProgressBar(max(1, src.count_records()))
    stats = DetectStats()
    # align's product is the reference's eventalign table, so the
    # reference's window coupling (strict mode) is the default here
    strict = a.strict_windows or not a.fast_windows
    with AlignHRWriter(out_path) as w:
        for _rid, text in align_reads(src, models, DNA_R10, device=devices,
                                      strict=strict, stats=stats):
            if text is not None:
                w.write_text(text)
            bar.display(stats.processed, stats.failed)
    bar.finish()
    _write_missing_log(out_path, ".align.log", missing)
    print(f"\nalign: {stats.processed - stats.failed} reads, "
          f"{stats.failed} failed QC")
    if shard:
        _merge_shards(a, procid, nprocs, "align")
    return 0


def main_traincnn(argv) -> int:
    p = _detect_parser("trainCNN", 100)
    p.add_argument("--fit", default=None, metavar="OUT_NPZ",
                   help="also fit a detect CNN on these reads and save its "
                   "weights as the JAX package's npz (requires "
                   "--fit-label); the reference only emits tables")
    p.add_argument("--fit-label", choices=sorted({"Thym", "BrdU", "EdU"}),
                   default=None,
                   help="sample-wide ground-truth class of this run: every "
                   "T position carries it")
    p.add_argument("--fit-arch", choices=["tpu", "reference"], default="tpu",
                   help="architecture to fit: the default DetectCNN (from "
                   "the port's seeded untrained weights) or the reference's "
                   "GRU+separable-conv topology (from its seeded synthetic "
                   "weights, BatchNorm statistics frozen)")
    p.add_argument("--fit-epochs", type=int, default=1)
    p.add_argument("--fit-lr", type=float, default=3e-4)
    a = p.parse_args(argv)
    if a.fit and a.fit_label is None:
        print("Exiting with error.  --fit requires --fit-label.",
              file=sys.stderr)
        return 1
    # the JAX CLI shards no trainCNN reads (dnascent_tpu/cli.py:625): the
    # process flags only join the group, and each flush of 32 reads goes
    # to the next device of the set
    _setup_parallel(a)
    import numpy as np

    from .config import DNA_R10
    from .io.poremodel import load_model_set
    from .parallel.compute import replicate_module
    from .pipeline import traincnn as tc

    devices = _resolve_devices(a.devices, a.device)
    dev = devices[0]
    cnns = replicate_module(_load_cnn(a, dev), devices)
    models = load_model_set(DNA_R10)
    src, _missing = _open_source(a)
    n = 0
    n_flushed = 0
    train_batches = []
    with open(a.output, "w") as fh:
        def flush(batch):
            nonlocal n, n_flushed
            d = devices[n_flushed % len(devices)]
            n_flushed += 1
            for text in tc.generate_training_tables(batch, models, cnns[d],
                                                    DNA_R10, device=d):
                fh.write(text)
                n += 1
            if a.fit:
                lab = tc.LABEL_IDS[a.fit_label]
                pairs = [(r, np.full(len(r.reference_seq), lab, np.int32))
                         for r in batch]
                train_batches.extend(tc.batches_from_labelled_reads(
                    pairs, models, DNA_R10, device=d))

        batch = []
        for rec in src:
            batch.append(rec)
            if len(batch) >= 32:
                flush(batch)
                batch = []
        if batch:
            flush(batch)
    print(f"\ntrainCNN: {n} reads written")
    if a.fit:
        from .models import cnn as cnn_mod
        if a.fit_arch == "reference":
            fmodel, opt = tc.reference_arch_trainer(learning_rate=a.fit_lr,
                                                    device=dev)
        else:
            # the JAX package starts from PRNGKey(0) weights, which torch
            # cannot draw: the port starts from its own seeded weights
            fmodel, opt = cnn_mod.init_untrained(cnn_mod.DetectCNN()), None
        _fitted, losses = tc.train_detect_cnn(
            train_batches, model=fmodel, learning_rate=a.fit_lr,
            epochs=a.fit_epochs, optimizer=opt, checkpoint_path=a.fit,
            device=dev)
        if losses:
            print(f"trainCNN fit [{a.fit_arch}]: {len(losses)} steps, "
                  f"loss {losses[0]:.4f} -> {losses[-1]:.4f} -> {a.fit}")
    return 0


def main_traingmm(argv) -> int:
    p = argparse.ArgumentParser(prog="dnascent-tpu-torch trainGMM")
    p.add_argument("-d", "--trainingData", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-pi", dest="pi", type=float, default=0.5)
    p.add_argument("-m", "--max-reads", type=int, default=100000)
    p.add_argument("-e", "--max-events", type=int, default=10000)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device of the EM (default cuda; cpu runs it "
                   "on the host)")
    a = p.parse_args(argv)
    import dataclasses

    from .config import DNA_R10
    from .io.poremodel import load_model_set
    from .pipeline.traingmm import (parse_align_events, train_gmm,
                                    write_gmm_table)

    dev = _resolve_devices(None, a.device)[0]
    cfg = DNA_R10
    if a.pi != cfg.traingmm.default_pi:
        cfg = cfg.replace(traingmm=dataclasses.replace(cfg.traingmm,
                                                       default_pi=a.pi))
    models = load_model_set(cfg)
    pools = parse_align_events(a.trainingData, cfg.kmer_len, a.max_events,
                               a.max_reads)
    fits = train_gmm(pools, models, cfg, device=dev)
    write_gmm_table(fits, a.output, cfg.kmer_len)
    print(f"Done. {len(fits)} k-mers fitted -> {a.output}")
    return 0


# ---------------------------------------------------------------------------
# forkSense / seeBreaks (host numpy; seeBreaks --fast on --device)
# ---------------------------------------------------------------------------

def main_forksense(argv) -> int:
    p = argparse.ArgumentParser(prog="dnascent-tpu-torch forkSense")
    p.add_argument("-d", "--detect", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--order", required=True,
                   choices=["EdU,BrdU", "BrdU,EdU"])
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--markAnalogues", action="store_true")
    p.add_argument("--markOrigins", action="store_true")
    p.add_argument("--markTerminations", action="store_true")
    p.add_argument("--markForks", action="store_true")
    p.add_argument("--makeSignatures", action="store_true")
    _add_distributed_flags(p)
    a = p.parse_args(argv)
    # forkSense runs on the host: --devices is accepted and has nothing to
    # place, as in the JAX CLI
    procid, nprocs = _setup_parallel(a)
    from .config import DNA_R10
    from .parallel.merge import host_shard_path
    from .pipeline import forksense as fsm

    ext = a.detect.rsplit(".", 1)[-1]
    if ext == "detect":
        reads = list(fsm.parse_detect_file(a.detect))
        human_readable = True
    elif ext == "bam":
        from .io.modbam import iter_modbam_detected_reads
        reads = list(iter_modbam_detected_reads(a.detect))
        human_readable = False
    else:
        print(f"Exiting with error.  Invalid detect extension: {ext}",
              file=sys.stderr)
        return 1

    ordinals = None
    if nprocs > 1:
        # shard the reads over the processes; pass 1's statistics are
        # gathered inside forksense_run, so every process's 2-means is the
        # single run's
        ordinals = list(range(procid, len(reads), nprocs))
        reads = [reads[i] for i in ordinals]
    from .utils.progress import ProgressBar
    bar = ProgressBar(max(1, len(reads)), show_failures=False)
    inc, outputs = fsm.forksense_run(
        reads, a.order, DNA_R10, read_ordinals=ordinals,
        progress_cb=bar.display,
        mark_origins=a.markOrigins, mark_terms=a.markTerminations,
        mark_forks=a.markForks, mark_analogues=a.markAnalogues,
        make_signatures=a.makeSignatures, human_readable=human_readable)
    bar.finish()

    print(f"Estimated fraction of BrdU substitution in BrdU-positive "
          f"regions: {inc.centroid_1}", file=sys.stderr)
    print(f"Estimated fraction of EdU substitution in EdU-positive "
          f"regions: {inc.centroid_2}", file=sys.stderr)

    import datetime
    now = datetime.datetime.now().strftime("%d/%m/%Y %H:%M:%S")

    def hdr(extra=""):
        return (f"#DetectFile {a.detect}\n#Threads {a.threads}\n"
                f"#Compute CPU\n#SystemStartTime {now}\n"
                f"#Software dnascent_tpu_torch\n#Version {__version__}\n"
                f"#Commit none\n{extra}")

    shard = nprocs > 1
    with open(host_shard_path(a.output, procid) if shard else a.output,
              "w") as fh:
        fh.write(hdr(f"#EstimatedRegionBrdU {inc.centroid_1:.6f}\n"
                     f"#EstimatedRegionEdU {inc.centroid_2:.6f}\n"))
        for o in outputs:
            for block in o.main:
                fh.write(block)

    # the bed files go to the working directory, as the reference's do
    bed_names = []

    def write_bed(name, lines_attr):
        bed_names.append(name)
        with open(host_shard_path(name, procid) if shard else name,
                  "w") as fh:
            fh.write(hdr())
            for o in outputs:
                for line in getattr(o, lines_attr):
                    fh.write(line)

    if a.markTerminations:
        write_bed("terminations_DNAscent_forkSense.bed", "terminations")
    if a.markOrigins:
        write_bed("origins_DNAscent_forkSense.bed", "origins")
    if a.markForks:
        write_bed("leftForks_DNAscent_forkSense.bed", "left_forks")
        write_bed("rightForks_DNAscent_forkSense.bed", "right_forks")
    if a.makeSignatures:
        write_bed("leftForks_DNAscent_forkSense_stressSignatures.bed",
                  "left_signatures")
        write_bed("rightForks_DNAscent_forkSense_stressSignatures.bed",
                  "right_signatures")
    if a.markAnalogues:
        write_bed("BrdU_DNAscent_forkSense.bed", "brdu_beds")
        write_bed("EdU_DNAscent_forkSense.bed", "edu_beds")
    if shard:
        _merge_shards(a, procid, nprocs, "forksense", beds=bed_names)
    return 0


def main_seebreaks(argv) -> int:
    p = argparse.ArgumentParser(prog="dnascent-tpu-torch seeBreaks")
    p.add_argument("-l", "--left", default=None)
    p.add_argument("-r", "--right", default=None)
    p.add_argument("-a", "--analogue", required=True)
    p.add_argument("-d", "--detect", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--fast", action="store_true",
                   help="vectorised bootstrap instead of reference-exact RNG")
    p.add_argument("--device", default="cuda",
                   help="torch device of the --fast bootstrap (default cuda; "
                   "cpu runs the numpy bootstrap)")
    _add_distributed_flags(p)
    a = p.parse_args(argv)
    if not (a.left or a.right):
        print("Exiting with error.  Insufficient arguments passed to "
              "DNAscent seeBreaks.", file=sys.stderr)
        return 1
    procid, nprocs = _setup_parallel(a)
    import numpy as np

    from .config import DNA_R10
    from .parallel.collectives import gather_ordered
    from .pipeline.seebreaks import run_seebreaks, write_seebreaks_output

    # parity mode never touches the device; --fast fails here, before any
    # input is read, when its device is absent; its bootstrap runs on the
    # first device of the set
    dev = _resolve_devices(a.devices, a.device)[0] if a.fast else None
    # the read spans of the detect output (src/seeBreaks.cpp:288-350): the
    # scan is sharded over the processes, then the spans are gathered in
    # read order, so every process computes the same statistics
    spans, ordinals = [], []
    n_seen = 0

    def take(span):
        nonlocal n_seen
        if n_seen % nprocs == procid:
            spans.append(span)
            ordinals.append(n_seen)
        n_seen += 1

    if a.detect.rsplit(".", 1)[-1] == "detect":
        with open(a.detect) as fh:
            for line in fh:
                if line.startswith(">"):
                    cols = line.split()
                    take((int(cols[2]), int(cols[3])))
    else:
        from .io.bam import BamReader, get_ref_span
        rd = BamReader(a.detect)
        for rec in rd:
            take(get_ref_span(rec.cigar(), rec.pos))
        rd.close()
    spans = gather_ordered(np.asarray(spans, dtype=np.int64).reshape(-1, 2),
                           np.asarray(ordinals, dtype=np.int64))

    def by_minlen(minlen):
        keep = (spans[:, 1] - spans[:, 0]) >= minlen
        return spans[keep, 0], spans[keep, 1]

    res = run_seebreaks(a.left, a.right, a.analogue, spans[:, 0], by_minlen,
                        DNA_R10.seebreaks, parity=not a.fast, device=dev)
    if procid == 0:
        # every process computed the same result from the gathered spans;
        # one writes it
        write_seebreaks_output(res, a.output, a.detect, a.left or "",
                               a.right or "")
    print(f"\nNumber of forks: {res.n_forks}")
    print("Expected number of analogue tracks at read ends")
    print(f"   Estimate: {res.sim_mean:.6g}")
    print(f"   StandardError: {res.sim_std:.6g}")
    print("Observed number of analogue tracks at read ends")
    print(f"   Estimate: {res.obs_mean:.6g}")
    print(f"   StandardError: {res.obs_std:.6g}")
    print("Difference between observed and expected")
    print(f"   Estimate: {res.diff_mean:.6g}")
    print(f"   StandardError: {res.diff_std:.6g}")
    print(f"   95% Confidence Interval: [{res.ci_low:.6g}, {res.ci_high:.6g}]")
    return 0


SUBCOMMANDS = {
    "index": main_index,
    "detect": main_detect,
    "align": main_align,
    "forkSense": main_forksense,
    "seeBreaks": main_seebreaks,
    "trainCNN": main_traincnn,
    "trainGMM": main_traingmm,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(GENERAL_HELP)
        return 0
    if argv[0] in ("-v", "--version"):
        print(__version__)
        return 0
    fn = SUBCOMMANDS.get(argv[0])
    if fn is None:
        print(GENERAL_HELP)
        print(f"Unknown subprogram: {argv[0]}", file=sys.stderr)
        return 1
    try:
        return fn(argv[1:])
    finally:
        if "torch.distributed" in sys.modules:
            from .parallel.mesh import shutdown_distributed
            shutdown_distributed()
