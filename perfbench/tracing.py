"""What a ``--trace 1`` run records, from the benchmark's own files: spans
around the calls into each layer, counts of the live work handed to each
kernel, the program's ``StageTimer`` totals, and the device trace of the
window from ``torch.profiler``.

The spans and counts come from wrapping module attributes that the
program looks up at call time, for the traced window only (every
attribute is restored on exit).  A trace-0 run installs none of them.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from . import counts

# (span name, module, attribute): host spans labelling the device's idle
# gaps, and the two host steps that per-layer metrics read
SPANS = (
    ("prep", "detect", "prepare_reads"),
    ("eventalign", "detect", "run_eventalign"),
    ("cnn", "detect", "run_cnn_batched"),
    ("event_detection", "prep", "detect_events"),
    ("postprocess", "native", "process_read_windows"),
)


@dataclass
class Trace:
    """Everything the per-layer readers see of one traced window."""

    spans: dict = field(default_factory=dict)    # name -> [seconds, calls]
    intervals: list = field(default_factory=list)  # (name, t0_ns, t1_ns)
    work: dict = field(default_factory=dict)     # kernel -> [ops, bytes]
    positions: int = 0          # CNN positions of the reads run
    gru_steps: int = 0          # live GRU steps (samples fed to the CNN)
    kbp: float = 0.0            # their reference kilobases
    stage_s: dict = field(default_factory=dict)  # StageTimer totals
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: dict = field(default_factory=dict)  # device op name -> s
    gaps: list = field(default_factory=list)      # (seconds, label)
    peak_mib: float = 0.0
    cnn_flops_per_position: float = 0.0
    counting: bool = False
    epoch_minus_perf_ns: int = 0   # time.time_ns() - perf_counter_ns()
    lock: threading.Lock = field(default_factory=threading.Lock)

    def add_span(self, name, t0, t1):
        with self.lock:
            acc = self.spans.setdefault(name, [0.0, 0])
            acc[0] += (t1 - t0) / 1e9
            acc[1] += 1
            self.intervals.append((name, t0, t1))

    def add_work(self, kernel, ops, nbytes):
        if not self.counting:
            return
        with self.lock:
            acc = self.work.setdefault(kernel, [0.0, 0.0])
            acc[0] += ops
            acc[1] += nbytes


def _modules():
    from dnascent_tpu_torch import native
    from dnascent_tpu_torch.pipeline import detect, eventalign, prep
    return dict(detect=detect, prep=prep, native=native,
                eventalign=eventalign)


@contextmanager
def instrument(tr: Trace):
    """Within the block: spans around SPANS, and the live work of kernels
    A-D (from the host arrays the fills and windows are built from) and
    of the CNN and kernel F (from the positions each CNN call runs)."""
    mods = _modules()
    patched = []

    def patch(mod, attr, make):
        orig = getattr(mod, attr)
        patched.append((mod, attr, orig))
        setattr(mod, attr, make(orig))

    def spanned(name):
        def make(orig):
            def wrapped(*a, **k):
                t0 = time.perf_counter_ns()
                try:
                    return orig(*a, **k)
                finally:
                    tr.add_span(name, t0, time.perf_counter_ns())
            return wrapped
        return make

    def fill_inputs(orig):
        def wrapped(group, models):
            arrays = orig(group, models)
            n_ev, n_km = arrays[-2], arrays[-1]
            for e, k in zip(n_ev.tolist(), n_km.tolist()):
                tr.add_work("A", *counts.banded_fill(e, k))
                tr.add_work("B", *counts.banded_chase(e, k))
            return arrays
        return wrapped

    def viterbi_windows(orig):
        def wrapped(obs_flat, ranks_flat, model_table, lens, ostarts,
                    rstarts, ns, *rest, **kw):
            for t, n in zip(lens.tolist(), ns.tolist()):
                tr.add_work("C", *counts.viterbi_fill(t, n))
                tr.add_work("D", *counts.viterbi_backtrace(t, n))
            return orig(obs_flat, ranks_flat, model_table, lens, ostarts,
                        rstarts, ns, *rest, **kw)
        return wrapped

    def run_cnn(orig):
        inner = spanned("cnn")(orig)

        def wrapped(model, results, prepped, device, *a, **k):
            if tr.counting:
                pos = steps = 0
                for p in prepped:
                    res = results.get(p.record.read_id)
                    if res is not None and res.qc_passed \
                            and res.positions is not None:
                        pos += int(res.positions.coord.shape[0])
                        steps += int(res.positions.signal_counts.sum())
                with tr.lock:
                    tr.positions += pos
                    tr.gru_steps += steps
            return inner(model, results, prepped, device, *a, **k)
        return wrapped

    try:
        for name, mod, attr in SPANS:
            if name == "cnn":
                patch(mods[mod], attr, run_cnn)
            else:
                patch(mods[mod], attr, spanned(name))
        patch(mods["prep"], "fill_inputs", fill_inputs)
        patch(mods["eventalign"], "viterbi_windows", viterbi_windows)
        yield tr
    finally:
        for mod, attr, orig in reversed(patched):
            setattr(mod, attr, orig)


def digest_profile(prof, tr: Trace, t_start_ns: int, t_stop_ns: int) -> None:
    """Device busy seconds (the union of the device operations' intervals),
    seconds by operation name, and the idle gaps labelled by the host spans
    open at their midpoints, from the profiler of the window."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    tr.window_s = (t_stop_ns - t_start_ns) / 1e9
    if not evs:
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    merged = [list(spans[0])]
    for s, e in spans[1:]:
        if s > merged[-1][1]:
            merged.append([s, e])
        else:
            merged[-1][1] = max(merged[-1][1], e)
    tr.busy_s = sum(e - s for s, e in merged) / 1e6
    for e in evs:
        name = e.name
        tr.kernel_s[name] = tr.kernel_s.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    # the profiler's time base against the host clock of the spans: its
    # start as perf_counter or as epoch nanoseconds, whichever puts the
    # first device operation inside the window
    base_ns = None
    try:
        start = prof.profiler.kineto_results.trace_start_ns()
        first = start + spans[0][0] * 1000.0
        for shift in (0, tr.epoch_minus_perf_ns):
            if t_start_ns - 1e9 <= first - shift <= t_stop_ns + 1e9:
                base_ns = start - shift
                break
    except AttributeError:
        pass
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    for dur, s, e in gaps[:10]:
        label = "unaligned"
        if base_ns is not None:
            mid = base_ns + (s + e) * 500.0   # us -> ns, midpoint
            open_ = sorted({n for n, a, b in tr.intervals if a <= mid <= b})
            label = "+".join(open_) if open_ else "no_span"
        tr.gaps.append((label, dur / 1e6))
