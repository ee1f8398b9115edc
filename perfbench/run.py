#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port's ``detect``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout on a machine with the cell's CUDA cards.
The cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``perfbench/configs/<config>.json``: the CNN's widths, the check's
limits) and a traffic mix (``perfbench/traffic/<traffic>.json``: read
lengths, pool, source, writer, batching); each metric has a reader
``perfbench/metrics/<metric>.py``.  All three are found by name.

Set-up makes the pool of reads, the pore table and the CNN's weights from
``--seed`` (the weights on the card), loads the weights through the
program's own loader, and warms the cell's shapes.  The window then feeds
one endless stream of the pool's reads (a closed loop, as a batch tool
reading a file) to ``dnascent_tpu_torch.pipeline.detect.detect_reads`` for
``--seconds`` seconds and counts the reads whose calls were drained inside
it.  Afterwards a seeded sample of those reads is run through the plain
reference (``perfbench/reference``) and compared with what the timed path
produced (``perfbench/check.py``).  The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of that object.

``--trace 1`` runs the same window with the per-layer instrumentation and
``torch.profiler`` on, and reports the per-layer metrics instead of the
end-to-end ones.  ``--control 1`` (not used by the benchmark's own runs)
puts the reference, computed one precision step below what the
configuration states, in the program's place for the comparison: the
control that the limits must fail.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from contextlib import contextmanager, nullcontext  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# what the port must not load (compared by whole top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dnascent_tpu")
# fixed cache directories inside the checkout
CACHE_DIRS = ("build/torch_kernels", "build/torch_native")
TRITON_CACHE = os.path.join(HERE, ".cache", "triton")


def _since_process_start() -> float:
    """Seconds from this process's start to now, from /proc."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_BOOT_S = _since_process_start()


def _log(msg: str) -> None:
    print(f"[perfbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def cold_build(root: str) -> bool:
    """Whether this run has to build the program's kernel libraries (the
    checkout's first run): either build directory lacks its library."""
    import glob
    kernels = glob.glob(os.path.join(root, CACHE_DIRS[0],
                                     "libdnascent_kernels_*.so"))
    native = os.path.join(root, CACHE_DIRS[1], "libdnascent_native.so")
    return not (kernels and os.path.exists(native))


def _host_sample() -> tuple:
    """(wall, this process's CPU seconds, /proc/stat's busy and steal and
    total jiffies over all cores) now."""
    busy = steal = total = 0
    try:
        with open("/proc/stat") as fh:
            f = [int(x) for x in fh.readline().split()[1:]]
        # user nice system idle iowait irq softirq steal ...
        busy, steal, total = f[0] + f[1] + f[2] + f[5] + f[6], f[7], sum(f[:8])
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter(), time.process_time(), busy, steal, total


def _host_load(a: tuple, b: tuple) -> dict:
    """What else the host ran between two samples: the cores busy outside
    this process, the share of time the hypervisor stole, the load average
    and the cores' mean clock at the end."""
    hz = os.sysconf("SC_CLK_TCK")
    wall = max(b[0] - a[0], 1e-9)
    out = {"own_cores": round((b[1] - a[1]) / wall, 3),
           "other_cores": round(max(0.0, (b[2] - a[2]) / hz - (b[1] - a[1]))
                                / wall, 3),
           "steal_share": round((b[3] - a[3]) / max(b[4] - a[4], 1), 4)}
    try:
        out["loadavg_1m"] = float(open("/proc/loadavg").read().split()[0])
        with open("/proc/cpuinfo") as fh:
            mhz = [float(ln.split(":")[1]) for ln in fh
                   if ln.startswith("cpu MHz")]
        if mhz:
            out["cpu_mhz_mean"] = round(sum(mhz) / len(mhz), 1)
    except (OSError, ValueError, IndexError):
        pass
    return out


# ---------------------------------------------------------------------------
# The registry: cells, configurations, traffic and metric readers by name
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: str


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    try:
        w = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"perfbench: no workload {name!r} in "
                         "BENCHMARK.json") from None
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "perfbench", "traffic",
                           w["traffic"] + ".json")) as fh:
        traffic = json.load(fh)

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]

    return Cell(name, int(w["chips"]), config, traffic,
                mine(bench["end_to_end"]), mine(bench["per_layer"]), root)


def reader(root: str, metric: str):
    """The ``read(run)`` function of ``perfbench/metrics/<metric>.py``."""
    path = os.path.join(root, "perfbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

@dataclass
class Run:
    """What the metric readers see."""

    cell: Cell
    seconds: float = 0.0
    setup_s: float = 0.0
    attempted: int = 0
    qc_failed: int = 0
    kbp: float = 0.0                 # QC-passed kbp drained in the window
    rate_s: float = 0.0              # window opening to its last drain
    trace: object = None
    extra: dict = field(default_factory=dict)


def _record(read):
    """The program's in-memory record of a pool read (all-M, error-free)."""
    from dnascent_tpu_torch.pipeline.source import ReadRecord
    import numpy as np
    L = read.length
    idx = np.arange(L, dtype=np.int64)
    seq = read.seq
    return ReadRecord(read_id=read.read_id, contig="chrSim",
                      ref_start=read.ref_start, ref_end=read.ref_start + L,
                      is_reverse=read.is_reverse, basecall=seq,
                      reference_seq=seq, ref_to_query=idx.copy(),
                      query_to_ref=idx.copy(),
                      ref_to_del=np.zeros(L, dtype=bool), raw=read.raw)


def _bucket(n: int) -> int:
    return 256 if n <= 256 else ((n + 2047) // 2048) * 2048


def _warm_ids(pool, traffic, chunk: int) -> list:
    """The first batches, then one read of each CNN length bucket (and one
    read long enough to be chunked) that they miss."""
    n = int(traffic["warm_batches"]) * int(traffic["batch"])
    ids = [r.read_id for r in pool[:n]]
    seen = {_bucket(r.length) for r in pool[:n]}
    chunked = any(r.length > chunk for r in pool[:n])
    for r in pool[n:]:
        b = _bucket(r.length)
        if b not in seen or (r.length > chunk and not chunked):
            ids.append(r.read_id)
            seen.add(b)
            chunked |= r.length > chunk
    return ids


class _Light:
    """What the check keeps of a drained read's calls."""

    __slots__ = ("ref_coords", "kmer_starts", "brdu_prob", "edu_prob")

    def __init__(self, d):
        self.ref_coords = d.ref_coords
        self.kmer_starts = d.kmer_starts
        self.brdu_prob = d.brdu_prob
        self.edu_prob = d.edu_prob


@contextmanager
def _broken(faults):
    """``faults`` ({module attribute path: replacement factory}) in place
    for the block, for the harness's own tests of the check."""
    restore = []
    try:
        for path, make in (faults or {}).items():
            mod_name, attr = path.rsplit(".", 1)
            mod = sys.modules[mod_name]
            restore.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, make(getattr(mod, attr)))
        yield
    finally:
        for mod, attr, orig in reversed(restore):
            setattr(mod, attr, orig)


@dataclass
class _Feed:
    """The cell's reads as the program takes them, and its writer."""

    make_iter: object        # () -> iterator of ReadRecord, one pool cycle
    header: tuple = None     # BAM header for the writer, where it writes

    def open_writer(self, path):
        if self.header is None:
            return None
        from dnascent_tpu_torch.io.modbam import ModBamWriter
        return ModBamWriter(path, *self.header)


def _feed(traffic, pool, contig, tmp) -> _Feed:
    """Memory mixes hand the program ReadRecords; pod5 mixes write the
    user's files and open a ``BamSignalSource`` on them each cycle."""
    from perfbench import inputs
    if traffic["source"] != "pod5":
        records = [_record(r) for r in pool]
        return _Feed(lambda: iter(records))
    from dnascent_tpu_torch.io.bam import BamReader
    from dnascent_tpu_torch.io.fasta import import_reference
    from dnascent_tpu_torch.io.index_io import parse_index
    from dnascent_tpu_torch.pipeline.source import BamSignalSource
    files = inputs.write_files(tmp, traffic, pool, contig)
    reference = import_reference(files.fasta)
    index = parse_index(files.index)

    def make_iter():
        return iter(BamSignalSource(
            files.bam, reference, index, min_mapq=int(traffic["min_mapq"]),
            min_length=int(traffic["min_read_length"])))
    header = None
    if traffic.get("writer") == "modbam":
        hdr = BamReader(files.bam)
        hdr.close()
        header = (hdr.header_text, hdr.ref_names, hdr.ref_lengths)
    return _Feed(make_iter, header)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False, boot_s: float = 0.0, t0: float = None,
             faults: dict = None) -> dict:
    """Set-up, the window and the check; returns the result object."""
    import torch

    from perfbench import inputs, models

    t0 = _T0 if t0 is None else t0
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.zeros(1, device=dev)   # the CUDA context, for the counters
        torch.cuda.reset_peak_memory_stats(dev)
    from dnascent_tpu_torch.io.poremodel import PoreModelSet

    conf = cell.config
    phases = {"imports": time.perf_counter() - t0}
    pore_seed = int(conf["pore_model"]["seed"])
    tables = inputs.pore_tables(pore_seed)
    models_set = PoreModelSet(
        pore_model=tables.pore,
        unlabelled_model=inputs.synthetic_table(pore_seed),
        analogue_model=tables.analogue, kmer_len=inputs.KMER)
    pool, contig = inputs.make_pool(cell.traffic, tables, seed)
    phases["reads"] = time.perf_counter() - t0
    tensors = models.make_tensors(conf, seed, dev)
    model = models.program_model(conf, tensors, dev)
    phases["weights"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp, \
            _broken(faults):
        feed = _feed(cell.traffic, pool, contig, tmp)
        phases["files"] = time.perf_counter() - t0
        _warm_up(cell, feed, pool, model, models_set, dev, tmp)
        phases["warm-up"] = time.perf_counter() - t0
        run = Run(cell, seconds=float(seconds))
        drained, peak = _window(run, feed, pool, model, models_set, dev,
                                trace, tmp, boot_s, t0)
        run.extra["setup_phases_s"] = {k: round(v + boot_s, 3)
                                       for k, v in phases.items()}
        # the check: after the window, with the program's state freed
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ok, shown = _check(run, drained, pool, tables, tensors, dev, seed,
                           control, os.path.join(tmp, "calls.bam"))
    return _result(run, ok, shown, peak, dev, trace)


def _warm_up(cell, feed, pool, model, models_set, dev, tmp) -> None:
    """The cell's shapes once: the first batches and one read of each CNN
    length bucket they miss, through the writer where the cell writes."""
    import torch
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline.detect import detect_reads
    traffic = cell.traffic
    warm = set(_warm_ids(pool, traffic,
                         int(cell.config["cnn_chunk_positions"])))
    recs = [r for r in feed.make_iter() if r.read_id in warm]
    w = feed.open_writer(os.path.join(tmp, "warm.bam"))
    for _rid, d in detect_reads(
            recs, models_set, model, DNA_R10, device=dev,
            batch_size=int(traffic["batch"]), collect_failures=True,
            pipeline_depth=int(traffic["pipeline_depth"])):
        if w is not None and d is not None:
            w.write(d)
    if w is not None:
        w.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window(run, feed, pool, model, models_set, dev, trace, tmp, boot_s,
            t0) -> tuple:
    """The measured window: the pool cycled into ``detect_reads`` until
    ``run.seconds`` have passed since it opened, the reads drained inside
    it counted (and written), the rest drained uncounted.  Returns (the
    first calls of each pool read drained inside it, the device memory
    peak)."""
    import torch
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.pipeline import detect as detect_mod
    from perfbench import counts, tracing

    traffic = run.cell.traffic
    index_of = {r.read_id: i for i, r in enumerate(pool)}
    tr = tracing.Trace() if trace else None
    timer = None
    if tr is not None:
        from dnascent_tpu_torch.utils.progress import StageTimer
        timer = StageTimer()
        tr.cnn_flops_per_position = counts.cnn_flops_per_position(
            run.cell.config)
    close_at = [float("inf")]

    def stream():
        while True:
            it = feed.make_iter()
            while True:
                a = time.perf_counter_ns()
                try:
                    rec = next(it)
                except StopIteration:
                    break
                if tr is not None:
                    tr.add_span("source", a, time.perf_counter_ns())
                if time.perf_counter() >= close_at[0]:
                    return
                yield rec

    def stop_profile():
        tr.counting = False
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        return time.perf_counter_ns()

    writer = feed.open_writer(os.path.join(tmp, "calls.bam"))
    drained: dict = {}
    paced: dict = {}           # kbp drained in each 5 s of the window
    prof = None
    processed_kbp = 0.0
    with (tracing.instrument(tr) if tr is not None else nullcontext()):
        gen = detect_mod.detect_reads(
            stream(), models_set, model, DNA_R10, device=dev,
            batch_size=int(traffic["batch"]), collect_failures=True,
            pipeline_depth=int(traffic["pipeline_depth"]), timer=timer)
        if tr is not None:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA
                                       if dev.type == "cuda"
                                       else ProfilerActivity.CPU])
            prof.start()
            tr.counting = True
        t_open = time.perf_counter()
        t_open_ns = time.perf_counter_ns()
        if tr is not None:
            tr.epoch_minus_perf_ns = time.time_ns() - time.perf_counter_ns()
        run.setup_s = boot_s + (t_open - t0)
        close_at[0] = t_open + run.seconds
        host_open, host_close = _host_sample(), None
        t_stop_ns = None
        for rid, d in gen:
            now = time.perf_counter()
            i = index_of[rid]
            processed_kbp += pool[i].length / 1e3
            if now > close_at[0]:
                if host_close is None:
                    host_close = _host_sample()
                if prof is not None and t_stop_ns is None:
                    t_stop_ns = stop_profile()
                continue
            run.attempted += 1
            run.rate_s = now - t_open
            slot = int((now - t_open) // 5)
            paced[slot] = paced.get(slot, 0.0) + (
                0.0 if d is None else pool[i].length / 1e3)
            if d is None:
                run.qc_failed += 1
            else:
                run.kbp += pool[i].length / 1e3
                if writer is not None:
                    a = time.perf_counter_ns()
                    writer.write(d)
                    if tr is not None:
                        tr.add_span("writer", a, time.perf_counter_ns())
            if i not in drained:
                drained[i] = None if d is None else _Light(d)
        if host_close is None:
            host_close = _host_sample()
        if prof is not None and t_stop_ns is None:
            t_stop_ns = stop_profile()
    if writer is not None:
        writer.close()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if tr is not None:
        tr.kbp = processed_kbp
        tr.stage_s = dict(timer.totals)
        tr.peak_mib = peak / 2**20
        tracing.digest_profile(prof, tr, t_open_ns, t_stop_ns)
        run.trace = tr
    run.extra["kbp_per_5s"] = [round(paced.get(k, 0.0), 1)
                               for k in range(int(run.seconds // 5) + 1)]
    run.extra["rate_window_s"] = run.rate_s
    run.extra["host"] = _host_load(host_open, host_close)
    run.extra["forbidden"] = sorted(
        {m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    return drained, peak


def _check(run, drained, pool, tables, tensors, dev, seed, control,
           bam_path) -> tuple:
    """The sample's reference calls against the program's (or, with
    ``control``, the control's): (correct, the numbers beside their
    limits)."""
    import numpy as np
    from perfbench import check

    traffic, conf = run.cell.traffic, run.cell.config
    t_ref = time.perf_counter()
    sample = check.sample_reads(drained, pool, int(traffic["check_reads"]),
                                seed)
    reads = [pool[i] for i in sample]
    ref = check.reference_calls(reads, conf, tables.pore, tensors, dev)
    if control:
        ctl = check.reference_calls(reads, conf, tables.pore, tensors, dev,
                                    control=True)
        prog = [None if c is None else SimpleNamespace(
            ref_coords=c[0], kmer_starts=c[1], brdu_prob=c[3][:, 0],
            edu_prob=c[3][:, 1]) for c in ctl]
    else:
        prog = [drained[i] for i in sample]
    numbers = check.compare_memory(prog, ref)
    if traffic.get("writer") == "modbam":
        ids = [r.read_id for r in reads]
        if control:
            recs = {r.read_id: (c[2], (c[3][:, 0] * 255.0).astype(np.uint8),
                                (c[3][:, 1] * 255.0).astype(np.uint8))
                    for r, c in zip(reads, ctl) if c is not None}
        else:
            recs = check.read_modbam(bam_path, set(ids))
        numbers.update(check.compare_bam(recs, ids, ref))
    run.extra["reference_s"] = time.perf_counter() - t_ref
    run.extra["checked_reads"] = len(sample)
    run.extra["checked_sites"] = numbers["sites"]
    printed = conf.get("printed", [])
    run.extra["shown"] = {k: v for k, v in numbers.items()
                          if k.endswith(("sites_off", "prob_gap"))
                          or k in printed}
    ok, shown = check.verdict(numbers, conf["limits"], printed)
    return ok and len(sample) > 0, shown


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _result(run: Run, ok: bool, shown: dict, peak: int, dev, trace: bool):
    import torch

    cell = run.cell
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(cell.root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(ok), "attempted": run.attempted,
           "failed": run.qc_failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        tr = run.trace
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        top = sorted(tr.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n[:160], s] for n, s in top],
                            "idle_gaps": [[n, s] for n, s in tr.gaps[:10]]}
    out["checks"] = shown
    out["_extra"] = run.extra
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 3
    os.environ["TRITON_CACHE_DIR"] = TRITON_CACHE
    cold = cold_build(ROOT)
    for d in CACHE_DIRS:
        stale = os.path.join(ROOT, d, "lock")
        if os.path.exists(stale):
            os.remove(stale)

    out = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda:0",
                   control=bool(a.control), boot_s=_BOOT_S)
    extra = out.pop("_extra")
    # the first run in a checkout builds the kernel libraries inside its
    # set-up: marked, so its setup_s is told apart from a warm one's
    out = {**{k: v for k, v in out.items() if k != "checks"},
           "cold_build": cold, "host": extra["host"],
           "checks": out["checks"]}
    if extra["forbidden"]:
        print(f"perfbench: the run loaded {', '.join(extra['forbidden'])}; "
              "the port must not", file=sys.stderr)
        return 4
    limit = _power_limit()
    _log(f"card: {limit}; cold build: {cold}; reference check of "
         f"{extra['checked_reads']} reads, {extra['checked_sites']} sites, "
         f"{extra['reference_s']:.1f} s; not compared: {extra['shown']}; "
         f"kbp drained in each 5 s: {extra['kbp_per_5s']}; rate closed at "
         f"the last drain, {extra['rate_window_s']:.3f} s after the "
         f"opening; host in the window: {extra['host']}; set-up phases "
         f"ended at (s from process start): {extra['setup_phases_s']}")
    for name, m in out["metrics"].items():
        if "roofline" in name or "mfu" in name:
            _log(f"{name} = {m['value']} % of the H100 SXM data-sheet peak "
                 f"(card: {limit})")
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
