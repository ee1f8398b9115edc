"""Command-line interface of the port: ``detect`` with ``.detect`` output.

Run as ``python -m dnascent_tpu_torch detect ...`` or through the
``dnascent-tpu-torch`` entry point.  The flags are the JAX package's
(``dnascent_tpu/cli.py``) plus ``--device`` (default ``cuda``).  The CNN is
the default DetectCNN (``--cnn-weights``) or the reference's trained
topology (``--model <SavedModel dir>``, or ``--cnn-weights`` with an npz
that ``trainCNN --fit-arch reference`` wrote).  Options whose code paths
are not ported yet (modbam ``.bam`` output, ``--HMM``, ``--strict-windows``,
multi-device and multi-process runs) are refused with an error rather than
ignored.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import __version__

GENERAL_HELP = f"""dnascent_tpu_torch v{__version__} — PyTorch/CUDA DNAscent
Usage: dnascent-tpu-torch detect [arguments]
The subprograms are:

  detect     detect base analogues in Oxford Nanopore reads.
"""


def _detect_parser():
    p = argparse.ArgumentParser(prog="dnascent-tpu-torch detect")
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-q", "--quality", type=int, default=20)
    p.add_argument("-l", "--length", type=int, default=1000)
    p.add_argument("-m", "--maxReads", type=int, default=None)
    p.add_argument("--GPU", default=None, help="accepted for compatibility; "
                   "use --device")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                   "kernels' plain PyTorch versions)")
    p.add_argument("--HMM", action="store_true", help="not ported yet")
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
    p.add_argument("--devices", default=None, help="not ported yet")
    p.add_argument("--nprocs", type=int, default=1, help="not ported yet")
    p.add_argument("--procid", type=int, default=None, help="not ported yet")
    p.add_argument("--coordinator", default=None, help="not ported yet")
    p.add_argument("--resume", action="store_true",
                   help="skip reads already present in the output file")
    p.add_argument("--strict-windows", action="store_true",
                   help="not ported yet")
    return p


def _unported(a) -> list[str]:
    out = []
    if a.output.rsplit(".", 1)[-1] == "bam":
        out.append("modbam (.bam) output")
    for flag, on in (("--HMM", a.HMM), ("--strict-windows", a.strict_windows),
                     ("--devices", a.devices), ("--nprocs", a.nprocs > 1),
                     ("--procid", a.procid is not None),
                     ("--coordinator", a.coordinator)):
        if on:
            out.append(flag)
    return out


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
        # (src/tensor.cpp:48)
        raise SystemExit(
            "Exiting with error.  No trained CNN weights: pass "
            "--model <SavedModel dir> or --cnn-weights <npz> (or "
            "--allow-untrained-cnn to force untrained weights for pipeline "
            "testing).")
    return model.to(device)


def main_detect(argv) -> int:
    a = _detect_parser().parse_args(argv)
    ext = a.output.rsplit(".", 1)[-1]
    if ext not in ("detect", "bam"):
        print(f"Exiting with error.  Invalid output extension: {ext}",
              file=sys.stderr)
        return 1
    missing_features = _unported(a)
    if missing_features:
        print("Exiting with error.  Not ported to dnascent_tpu_torch yet: "
              + ", ".join(missing_features), file=sys.stderr)
        return 1

    import torch
    from dnascent_tpu.config import DNA_R10
    from dnascent_tpu.io.fasta import import_reference
    from dnascent_tpu.io.index_io import parse_index
    from dnascent_tpu.io.poremodel import load_model_set
    from dnascent_tpu.pipeline.source import BamSignalSource
    from dnascent_tpu.utils.progress import ProgressBar

    from . import device as devmod
    from .io.writers import DetectHRWriter, detect_header
    from .pipeline.detect import DetectStats, detect_reads

    dev = devmod.resolve(a.device)
    if dev.type == "cuda":
        # cuBLAS/cuDNN in full f32 where the model runs f32 (the head); the
        # bf16 layers are unaffected
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = _load_cnn(a, dev)
    cfg = DNA_R10
    models = load_model_set(cfg)
    missing = []
    src = BamSignalSource(a.bam, import_reference(a.reference),
                          parse_index(a.index), min_mapq=a.quality,
                          min_length=a.length, max_reads=a.maxReads,
                          on_missing=missing.append)
    total = src.count_records()
    done_ids = set()
    if a.resume and os.path.exists(a.output):
        with open(a.output) as fh:
            done_ids = {line[1:].split()[0] for line in fh
                        if line.startswith(">")}
        print(f"resume: skipping {len(done_ids)} completed reads",
              file=sys.stderr)
        src = (r for r in src if r.read_id not in done_ids)
    stats = DetectStats()
    bar = ProgressBar(max(1, total - len(done_ids)))
    mode = "a" if done_ids else "w"
    with DetectHRWriter(a.output, mode=mode) as w:
        if mode == "w":
            w.write_header(detect_header(
                a.bam, a.reference, a.index, a.threads, a.quality, a.length,
                compute="GPU" if dev.type == "cuda" else "CPU"))
        for _rid, d in detect_reads(src, models, model, cfg, device=dev,
                                    stats=stats, collect_failures=True):
            if d is not None:
                w.write(d)
            bar.display(stats.processed, stats.failed)
    bar.display(stats.processed, stats.failed)
    bar.finish()
    log = os.path.splitext(a.output)[0] + ".detect.log"
    with open(log, "w") as fh:
        for rid in missing:
            fh.write(f"ReadID {rid} missing from index. Skipping.\n")
    print(f"\ndetect: {stats.processed} reads, {stats.failed} failed QC")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(GENERAL_HELP)
        return 0 if argv else 1
    if argv[0] in ("-v", "--version"):
        print(f"dnascent_tpu_torch v{__version__}")
        return 0
    if argv[0] != "detect":
        print(f"Exiting with error.  Subprogram {argv[0]} is not ported to "
              "dnascent_tpu_torch yet.", file=sys.stderr)
        return 1
    return main_detect(argv[1:])
