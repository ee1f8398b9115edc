"""Command-line interface of the port: ``index``, ``detect`` (``.detect`` or
modbam ``.bam`` output), ``forkSense`` and ``seeBreaks``.

Run as ``python -m dnascent_tpu_torch <subprogram> ...`` or through the
``dnascent-tpu-torch`` entry point.  The flags are the JAX package's
(``dnascent_tpu/cli.py``) plus ``--device`` (default ``cuda``) on ``detect``
and on ``seeBreaks``, where only ``--fast`` uses it.  The CNN is the default
DetectCNN (``--cnn-weights``) or the reference's trained topology (``--model
<SavedModel dir>``, or ``--cnn-weights`` with an npz that ``trainCNN
--fit-arch reference`` wrote).  ``index``, ``forkSense`` and ``seeBreaks``
without ``--fast`` run on the host, as in the JAX package.  What is not
ported yet (the subprograms ``align``, ``trainCNN`` and ``trainGMM``,
``--HMM``, ``--strict-windows``, multi-device and multi-process runs) is
refused with an error rather than ignored.
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
  forkSense  call replication origins, fork movement, and fork stalling,
  seeBreaks  detect an elevated frequency of DNA breaks at forks.

Not ported yet: align, trainCNN, trainGMM.
"""

UNPORTED_SUBPROGRAMS = ("align", "trainCNN", "trainGMM")


def _refused(features: list[str]) -> bool:
    """Print the refusal of ``features`` (if any); True when refused."""
    if features:
        print("Exiting with error.  Not ported to dnascent_tpu_torch yet: "
              + ", ".join(features), file=sys.stderr)
    return bool(features)


def _add_distributed_flags(p):
    p.add_argument("--devices", default=None, help="not ported yet")
    p.add_argument("--nprocs", type=int, default=1, help="not ported yet")
    p.add_argument("--procid", type=int, default=None, help="not ported yet")
    p.add_argument("--coordinator", default=None, help="not ported yet")


def _distributed_flags(a) -> list[str]:
    return [flag for flag, on in (("--devices", a.devices),
                                  ("--nprocs", a.nprocs > 1),
                                  ("--procid", a.procid is not None),
                                  ("--coordinator", a.coordinator)) if on]


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
# detect
# ---------------------------------------------------------------------------

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
    _add_distributed_flags(p)
    p.add_argument("--resume", action="store_true",
                   help="skip reads already present in the .detect output "
                   "file")
    p.add_argument("--strict-windows", action="store_true",
                   help="not ported yet")
    return p


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
    if _refused([flag for flag, on in (("--HMM", a.HMM),
                                       ("--strict-windows", a.strict_windows))
                 if on] + _distributed_flags(a)):
        return 1
    human_readable = ext == "detect"

    import torch

    from . import device as devmod
    from .config import DNA_R10
    from .io.fasta import import_reference
    from .io.index_io import parse_index
    from .io.poremodel import load_model_set
    from .pipeline.detect import DetectStats, detect_reads
    from .pipeline.source import BamSignalSource
    from .utils.progress import ProgressBar

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
    if a.resume and human_readable and os.path.exists(a.output):
        with open(a.output) as fh:
            done_ids = {line[1:].split()[0] for line in fh
                        if line.startswith(">")}
        print(f"resume: skipping {len(done_ids)} completed reads",
              file=sys.stderr)
        src = (r for r in src if r.read_id not in done_ids)
    if human_readable:
        from .io.writers import DetectHRWriter, detect_header
        mode = "a" if done_ids else "w"
        writer = DetectHRWriter(a.output, mode=mode)
        if mode == "w":
            writer.write_header(detect_header(
                a.bam, a.reference, a.index, a.threads, a.quality, a.length,
                compute="GPU" if dev.type == "cuda" else "CPU"))
    else:
        from .io.bam import BamReader
        from .io.modbam import ModBamWriter
        hdr = BamReader(a.bam)
        hdr.close()
        writer = ModBamWriter(a.output, hdr.header_text, hdr.ref_names,
                              hdr.ref_lengths)
    stats = DetectStats()
    bar = ProgressBar(max(1, total - len(done_ids)))
    with writer as w:
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
    if _refused(_distributed_flags(a)):
        return 1
    from .config import DNA_R10
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

    from .utils.progress import ProgressBar
    bar = ProgressBar(max(1, len(reads)), show_failures=False)
    inc, outputs = fsm.forksense_run(
        reads, a.order, DNA_R10, progress_cb=bar.display,
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

    with open(a.output, "w") as fh:
        fh.write(hdr(f"#EstimatedRegionBrdU {inc.centroid_1:.6f}\n"
                     f"#EstimatedRegionEdU {inc.centroid_2:.6f}\n"))
        for o in outputs:
            for block in o.main:
                fh.write(block)

    # the bed files go to the working directory, as the reference's do
    def write_bed(name, lines_attr):
        with open(name, "w") as fh:
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
    if _refused(_distributed_flags(a)):
        return 1
    if not (a.left or a.right):
        print("Exiting with error.  Insufficient arguments passed to "
              "DNAscent seeBreaks.", file=sys.stderr)
        return 1
    import numpy as np

    from . import device as devmod
    from .config import DNA_R10
    from .pipeline.seebreaks import run_seebreaks, write_seebreaks_output

    # parity mode never touches the device; --fast fails here, before any
    # input is read, when its device is absent
    dev = devmod.resolve(a.device) if a.fast else None
    # the read spans of the detect output (src/seeBreaks.cpp:288-350)
    spans = []
    if a.detect.rsplit(".", 1)[-1] == "detect":
        with open(a.detect) as fh:
            for line in fh:
                if line.startswith(">"):
                    cols = line.split()
                    spans.append((int(cols[2]), int(cols[3])))
    else:
        from .io.bam import BamReader, get_ref_span
        rd = BamReader(a.detect)
        for rec in rd:
            spans.append(get_ref_span(rec.cigar(), rec.pos))
        rd.close()
    spans = np.asarray(spans, dtype=np.int64).reshape(-1, 2)

    def by_minlen(minlen):
        keep = (spans[:, 1] - spans[:, 0]) >= minlen
        return spans[keep, 0], spans[keep, 1]

    res = run_seebreaks(a.left, a.right, a.analogue, spans[:, 0], by_minlen,
                        DNA_R10.seebreaks, parity=not a.fast, device=dev)
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
    "forkSense": main_forksense,
    "seeBreaks": main_seebreaks,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(GENERAL_HELP)
        return 0 if argv else 1
    if argv[0] in ("-v", "--version"):
        print(f"dnascent_tpu_torch v{__version__}")
        return 0
    if argv[0] in UNPORTED_SUBPROGRAMS:
        _refused([f"subprogram {argv[0]}"])
        return 1
    fn = SUBCOMMANDS.get(argv[0])
    if fn is None:
        print(GENERAL_HELP)
        print(f"Unknown subprogram: {argv[0]}", file=sys.stderr)
        return 1
    return fn(argv[1:])
