#!/usr/bin/env python3
"""The program's own spans in a traced run of one cell: the recorder's
spans (``StageTimer.spans()``, ``dnascent_tpu_torch/utils/progress.py``)
on the device trace's clock, the device's idle gaps labelled by the step
each thread was in, device seconds by the step that launched them, and
four per-layer readings of the spans.

    python3 perfbench/spans.py --workload <cell> --seed <n> \\
        --seconds <s> [--profile 0|1]

runs the cell as ``perfbench/run.py --trace 1`` does and prints its result
line with a ``spans`` object added.  ``run.py`` does not hand the
recorder's spans or the profiler to its ``Trace`` (a change of ``run.py``
and ``tracing.py``, which belongs to a benchmark change), so this script
takes them through two hooks: the ``StageTimer`` that ``run.py`` creates,
and ``tracing.digest_profile``, which it wraps.  ``--profile 0`` runs the
window untraced (no profiler, no wrapper spans) with the recorder on: the
cost of the recorder, against a ``--trace 0`` run of ``run.py``.

The functions below take spans (``progress.Span``) and the window's
bounds on ``time.perf_counter_ns()``; device operations and runtime
launches come as ``Op`` and ``Launch`` on the profiler's clock.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import threading
import time
from collections import defaultdict
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

class Op(NamedTuple):
    """A device operation: name, start and end (ns, profiler clock), the
    correlation id of the runtime call that launched it (-1: none)."""

    name: str
    t0: int
    t1: int
    corr: int


class Launch(NamedTuple):
    """A runtime call on the host: its OS thread, start (ns, profiler
    clock) and correlation id."""

    tid: int
    t0: int
    corr: int


# ---------------------------------------------------------------------------
# Span arithmetic
# ---------------------------------------------------------------------------

def _clip(t0, t1, lo, hi) -> int:
    return max(0, min(t1, hi) - max(t0, lo))


def _ancestor(by_id, s, name):
    """The span or its nearest ancestor called ``name``; None."""
    while s is not None and s.name != name:
        s = by_id.get(s.parent)
    return s


def steps(spans) -> dict:
    """{(role, name): {calls, wall_s, self_s, cpu_s, self_cpu_s}}: self
    time and self thread-CPU leave out the span's children (a child runs
    on its parent's thread, inside it)."""
    child_wall, child_cpu = defaultdict(int), defaultdict(int)
    for s in spans:
        if s.parent >= 0:
            child_wall[s.parent] += s.t1 - s.t0
            child_cpu[s.parent] += s.cpu1 - s.cpu0
    out: dict = {}
    for s in spans:
        a = out.setdefault((s.role, s.name), [0, 0, 0, 0, 0])
        a[0] += 1
        a[1] += s.t1 - s.t0
        a[2] += s.t1 - s.t0 - child_wall[s.sid]
        a[3] += s.cpu1 - s.cpu0
        a[4] += s.cpu1 - s.cpu0 - child_cpu[s.sid]
    return {k: dict(calls=a[0], wall_s=a[1] / 1e9, self_s=a[2] / 1e9,
                    cpu_s=a[3] / 1e9, self_cpu_s=a[4] / 1e9)
            for k, a in out.items()}


def worker_idle_share(spans, t_open, t_stop, workers):
    """Per cent of the window's worker time (``workers`` threads) that no
    worker ``batch`` span covers."""
    window = t_stop - t_open
    if window <= 0 or workers <= 0:
        return None
    busy = sum(_clip(s.t0, s.t1, t_open, t_stop) for s in spans
               if s.role == "worker" and s.name == "batch")
    return 100.0 * (1.0 - busy / (workers * window))


def worker_offcpu_share(spans, t_open, t_stop):
    """Over the worker ``batch`` spans that start in the window, with their
    device-wait descendants left out: per cent of the wall on which the
    thread ran on no core."""
    by_id = {s.sid: s for s in spans}
    batches = {s.sid for s in spans if s.role == "worker"
               and s.name == "batch" and t_open <= s.t0 < t_stop}
    wall = sum(by_id[i].t1 - by_id[i].t0 for i in batches)
    cpu = sum(by_id[i].cpu1 - by_id[i].cpu0 for i in batches)
    for s in spans:
        if s.wait:
            b = _ancestor(by_id, by_id.get(s.parent), "batch")
            if b is not None and b.sid in batches:
                wall -= s.t1 - s.t0
                cpu -= s.cpu1 - s.cpu0
    if wall <= 0:
        return None
    return 100.0 * (wall - cpu) / wall


def device_wait_ms_per_kbp(spans, kbp):
    """Worker milliseconds in device-wait spans per kbp processed."""
    if kbp <= 0:
        return None
    ns = sum(s.t1 - s.t0 for s in spans if s.role == "worker" and s.wait)
    return ns / 1e6 / kbp


def cnn_launch_ms_per_kbp(spans, kbp):
    """Worker milliseconds of ``cnn.forward`` self time per kbp processed:
    the trunk's host-side launch cost, its device waits left out."""
    if kbp <= 0:
        return None
    s = steps([x for x in spans if x.role == "worker"]).get(
        ("worker", "cnn.forward"))
    return None if s is None else 1000.0 * s["self_s"] / kbp


class Threads:
    """The innermost span open on a thread at a time (spans on one thread
    nest, so it is the last one started before the time, or the nearest of
    its ancestors still open)."""

    def __init__(self, spans):
        self.by_id = {s.sid: s for s in spans}
        self.on: dict = defaultdict(list)
        for s in sorted(spans, key=lambda s: s.t0):
            self.on[s.tid].append(s)
        self.starts = {t: [s.t0 for s in v] for t, v in self.on.items()}

    def innermost(self, tid, t):
        i = bisect.bisect_right(self.starts.get(tid, ()), t) - 1
        if i < 0:
            return None
        s = self.on[tid][i]
        while s is not None and not s.t0 <= t <= s.t1:
            s = self.by_id.get(s.parent)
        return s

    def roles(self, role) -> list:
        return sorted(t for t, v in self.on.items() if v[0].role == role)


# ---------------------------------------------------------------------------
# The profiler's clock against the spans'
# ---------------------------------------------------------------------------

def clock(spans, ops, launches, t_open, t_stop, epoch_minus_perf):
    """The shift that puts the profiler's times on ``perf_counter_ns``
    (``host = profiler - shift``): 0 where the profiler keeps the monotonic
    clock, ``epoch_minus_perf`` where it keeps the epoch; the one under
    which more device operations start inside the window.  Checked: with
    runtime launches, the share of the launches made by worker threads
    that lie inside a ``batch`` span of the same thread (at least 99 %);
    without, the share of device operations inside the window (all)."""
    def inside(shift):
        return sum(t_open <= o.t0 - shift <= t_stop for o in ops)
    base = max((("perf_counter", 0), ("epoch", epoch_minus_perf)),
               key=lambda c: inside(c[1]))
    shift = base[1]
    out = {"base": base[0], "shift_ns": shift}
    th = Threads(spans)
    workers = set(th.roles("worker"))
    mine = [la for la in launches if la.tid in workers]
    if mine:
        hit = 0
        for la in mine:
            s = th.innermost(la.tid, la.t0 - shift)
            hit += _ancestor(th.by_id, s, "batch") is not None
        share = hit / len(mine)
        out["check"] = {"kind": "worker launches inside a batch span",
                        "launches": len(mine), "share": share,
                        "holds": share >= 0.99}
    else:
        share = inside(shift) / len(ops) if ops else 0.0
        out["check"] = {"kind": "device operations inside the window",
                        "operations": len(ops), "share": share,
                        "holds": bool(ops) and share == 1.0}
    return out


def idle_gaps(ops):
    """The device's idle gaps, between the union's intervals of the
    operations, as (ns, start, end), longest first (the selection of
    ``tracing.digest_profile``)."""
    if not ops:
        return []
    iv = sorted((o.t0, o.t1) for o in ops)
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s > merged[-1][1]:
            merged.append([s, e])
        else:
            merged[-1][1] = max(merged[-1][1], e)
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    return gaps


def gap_labels(spans, gaps, shift, n=10):
    """The ``n`` longest gaps as [label, seconds]: the label is the
    innermost span open on each worker and on the main thread at the gap's
    midpoint, sorted and joined with ``+`` (``no_span`` where none is)."""
    th = Threads(spans)
    tids = th.roles("worker") + th.roles("main")
    out = []
    for dur, s, e in gaps[:n]:
        mid = (s + e) // 2 - shift
        names = sorted(x.name for x in (th.innermost(t, mid) for t in tids)
                       if x is not None)
        out.append(["+".join(names) or "no_span", dur / 1e9])
    return out


def device_s_by_step(spans, ops, launches, shift):
    """Device seconds by the innermost span open on the launching thread
    when the operation was launched (``no_span`` outside every span,
    ``unlinked`` without a launch)."""
    th = Threads(spans)
    by_corr = {la.corr: la for la in launches}
    out: dict = defaultdict(float)
    for o in ops:
        la = by_corr.get(o.corr)
        if la is None:
            key = "unlinked"
        else:
            s = th.innermost(la.tid, la.t0 - shift)
            key = "no_span" if s is None else s.name
        out[key] += (o.t1 - o.t0) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------------------
# From the profiler, and the run
# ---------------------------------------------------------------------------

def profile_events(prof, device: str = "CUDA"):
    """(the operations on ``device`` as ``Op``, the runtime calls that
    launched them as ``Launch``) of a ``torch.profiler`` run, on the
    profiler's clock; ``device`` "CPU" takes the CPU operators, with no
    launches.  A runtime call's thread is its resource id, which CUPTI
    gives as the low 32 bits of the thread's pthread id."""
    from torch.autograd import DeviceType
    want = getattr(DeviceType, device)
    ops, calls = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == want:
            ops.append(Op(e.name(), e.start_ns(), e.end_ns(),
                          e.correlation_id()))
        elif device != "CPU" and e.device_type() == DeviceType.CPU \
                and e.name().startswith(("cuda", "cu")):
            calls.append(Launch(e.device_resource_id(), e.start_ns(),
                                e.correlation_id()))
    linked = {o.corr for o in ops}
    return ops, [c for c in calls if c.corr in linked]


def site_ns(on: bool = False, n: int = 200_000) -> float:
    """Nanoseconds a span site costs (the loop's own cost taken off), the
    median of five timings: with no recorder, or ``on``, recording into
    one."""
    from dnascent_tpu_torch.utils.progress import NULL, StageTimer, span
    runs = []
    for _ in range(5):
        rec = StageTimer()
        with rec.scope("worker") if on else NULL:
            t0 = time.perf_counter_ns()
            for _ in range(n):
                pass
            t1 = time.perf_counter_ns()
            for _ in range(n):
                with span("h2d", wait=True):
                    pass
            t2 = time.perf_counter_ns()
        runs.append(((t2 - t1) - (t1 - t0)) / n)
    return sorted(runs)[2]


def tracing_cost(spans) -> dict:
    """The span sites' cost off and on: a site's nanoseconds times the
    sites a batch passes (the spans a batch records on its worker), as a
    share of a batch's worker wall."""
    batches = [s for s in spans if s.name == "batch"]
    if not batches:
        return {}
    per_batch = sum(s.role == "worker" for s in spans) / len(batches)
    wall = sum(s.t1 - s.t0 for s in batches) / len(batches)
    out = {"spans_per_batch": per_batch, "batch_wall_s": wall / 1e9}
    for key, on in (("off", False), ("on", True)):
        ns = site_ns(on)
        out[key] = {"site_ns": ns, "share_pct": 100.0 * ns * per_batch / wall}
    return out


STAGES = ("prep(events+scaling+banded)", "eventalign(viterbi)",
          "cnn_forward")
# the benchmark's wrapper spans (perfbench/tracing.py) and the program's
# spans around the same calls
AGREE = {"event_detection": "prep.event_detection",
         "postprocess": "eventalign.postprocess"}


def readings(cell, rec, tr, prof, t_open, t_stop, device="CUDA") -> dict:
    """What the spans of one traced window show (see the module's
    docstring)."""
    sp = rec.spans()
    ops, launches = profile_events(prof, device)
    # a launch named by the thread's pthread id takes its OS id
    launches = [la._replace(tid=rec.idents.get(la.tid, la.tid))
                for la in launches]
    c = clock(sp, ops, launches, t_open, t_stop, tr.epoch_minus_perf_ns)
    gaps = idle_gaps(ops)
    workers = int(cell.traffic["pipeline_depth"]) * cell.chips
    st = steps(sp)
    agree = {}
    for wrapper, mine in AGREE.items():
        w = tr.spans.get(wrapper, (0.0, 0))[0]
        p = st.get(("worker", mine), {}).get("wall_s", 0.0)
        agree[mine] = {"program_s": p, "wrapper_s": w,
                       "ratio": p / w if w else None}
    return {
        "metrics": {
            "worker_idle_share": worker_idle_share(sp, t_open, t_stop,
                                                   workers),
            "worker_offcpu_share": worker_offcpu_share(sp, t_open, t_stop),
            "device_wait_ms_per_kbp": device_wait_ms_per_kbp(sp, tr.kbp),
            "cnn_launch_ms_per_kbp": cnn_launch_ms_per_kbp(sp, tr.kbp)},
        "clock": c,
        "idle_gaps": gap_labels(sp, gaps, c["shift_ns"]),
        "device_s_by_step": (device_s_by_step(sp, ops, launches,
                                              c["shift_ns"])
                             if launches else "not measured"),
        "stage_totals_exact": all(
            tr.stage_s.get(n) == sum(s.t1 - s.t0 for s in sp
                                     if s.name == n) / 1e9 for n in STAGES),
        "agreement": agree,
        "kbp": tr.kbp,
        "n_spans": len(sp),
        "tracing_cost": tracing_cost(sp),
        "profile": {"ops": len(ops), "launches": len(launches),
                    "launch_threads": len({la.tid for la in launches})},
        "steps": {f"{r}/{n}": v for (r, n), v in sorted(
            st.items(), key=lambda kv: -kv[1]["self_s"])},
    }


def traced_run(cell, seed, seconds, profile, device="cuda:0", **kw):
    """``perfbench.run.run_cell`` with the recorder's spans kept: with
    ``profile``, a ``--trace 1`` run and its readings under ``spans``;
    without, an untraced run with the recorder on."""
    from dnascent_tpu_torch.pipeline import detect as detect_mod
    from dnascent_tpu_torch.utils import progress
    from perfbench import run as bench, tracing

    made: list = []
    seen: dict = {}

    class Kept(progress.StageTimer):
        """Kept for the readings, with each thread's pthread id (whole,
        and its low 32 bits, by which the profiler names a launching
        thread) mapped to its OS id."""

        def __init__(self):
            super().__init__()
            self.idents = {}
            made.append(self)

        def scope(self, role):
            ident, low = threading.get_ident(), threading.get_ident() % 2**32
            for key in (ident, low, low - 2**32 * (low >= 2**31)):
                self.idents[key] = threading.get_native_id()
            return super().scope(role)

    def digest(prof, tr, t_open, t_stop):
        seen.update(prof=prof, tr=tr, t_open=t_open, t_stop=t_stop)
        return orig_digest(prof, tr, t_open, t_stop)

    def detect_reads(*a, timer=None, **k):
        return orig_detect(*a, timer=Kept() if timer is None else timer, **k)

    orig_timer, orig_digest = progress.StageTimer, tracing.digest_profile
    orig_detect = detect_mod.detect_reads
    progress.StageTimer, tracing.digest_profile = Kept, digest
    if not profile:
        detect_mod.detect_reads = detect_reads
    try:
        out = bench.run_cell(cell, seed, seconds, profile, device, **kw)
    finally:
        progress.StageTimer, tracing.digest_profile = orig_timer, orig_digest
        detect_mod.detect_reads = orig_detect
    if profile:
        out["spans"] = readings(cell, made[-1], seen["tr"], seen["prof"],
                                seen["t_open"], seen["t_stop"],
                                "CUDA" if device.startswith("cuda")
                                else "CPU")
    else:
        out["spans"] = {"n_spans": len(made[-1].spans())}
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    a = ap.parse_args(argv)
    from perfbench import run as bench

    import torch
    if not torch.cuda.is_available():
        print("perfbench/spans.py: needs a CUDA device", file=sys.stderr)
        return 3
    os.environ["TRITON_CACHE_DIR"] = bench.TRITON_CACHE
    out = traced_run(bench.load_cell(a.workload), a.seed, a.seconds,
                     bool(a.profile), boot_s=bench._BOOT_S)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
