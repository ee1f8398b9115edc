"""Progress bar with ETA and failure counter (reference: src/common.h:30-88),
plus the pipeline's telemetry: stage wall-clock totals (the JAX package's
``dnascent_tpu/utils/progress.py``) and, on the same recorder, every span of
the run with its thread, batch, parent, clocks and thread CPU time."""

from __future__ import annotations

import itertools
import sys
import threading
import time
from array import array
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import NamedTuple


class ProgressBar:
    def __init__(self, total: int, show_failures: bool = True,
                 stream=sys.stderr, width: int = 30):
        self.total = max(total, 1)
        self.show_failures = show_failures
        self.stream = stream
        self.width = width
        self.start = time.monotonic()
        self._last = 0.0

    def display(self, progress: int, failed: int = 0) -> None:
        now = time.monotonic()
        if now - self._last < 0.25 and progress < self.total:
            return
        self._last = now
        frac = min(progress / self.total, 1.0)
        fill = int(self.width * frac)
        bar = "=" * fill + " " * (self.width - fill)
        elapsed = now - self.start
        eta = elapsed / frac - elapsed if frac > 0 else 0.0
        msg = (f"\r[{bar}] {100*frac:5.1f}%  {progress}/{self.total}  "
               f"ETA {eta:6.0f}s")
        if self.show_failures:
            msg += f"  failed: {failed}"
        self.stream.write(msg)
        self.stream.flush()

    def finish(self) -> None:
        self.stream.write("\n")
        self.stream.flush()


ROLES = ("main", "producer", "worker")


class Span(NamedTuple):
    """One recorded span.  ``parent`` is the ``sid`` of the span that was
    innermost open on the same thread when it started (-1: none);
    ``batch`` the sequence number of the batch it worked for (-1: none);
    ``t0``/``t1`` ``time.perf_counter_ns()``; ``cpu0``/``cpu1``
    ``time.thread_time_ns()``; ``wait`` marks a span that blocks on the
    device."""

    sid: int
    parent: int
    name: str
    tid: int
    role: str
    batch: int
    t0: int
    t1: int
    cpu0: int
    cpu1: int
    wait: bool


class _Context(threading.local):
    """A thread's recorder and role (``StageTimer.scope``) and its open
    spans, innermost last, as (sid, batch)."""

    def __init__(self):
        self.recorder = None
        self.role = "main"
        self.open = []


_ctx = _Context()
# the shared null context of every span site with no recorder
NULL = nullcontext()


def span(name: str, wait: bool = False):
    """A span of the recorder the calling thread runs under (set by
    ``StageTimer.scope``); without one, a shared null context: one check,
    no clock read, no allocation."""
    rec = _ctx.recorder
    return NULL if rec is None else _Open(rec, name, wait, None, False)


class _Open:
    """A span while it is open: it takes its parent, and its batch unless
    given one, from the innermost span open on its thread."""

    __slots__ = ("rec", "name", "wait", "batch", "stage", "sid", "parent",
                 "t0", "cpu0")

    def __init__(self, rec, name, wait, batch, stage):
        self.rec, self.name, self.wait = rec, name, wait
        self.batch, self.stage = batch, stage

    def __enter__(self):
        opened = _ctx.open
        parent, batch = opened[-1] if opened else (-1, -1)
        if self.batch is None:
            self.batch = batch
        self.parent = parent
        self.sid = next(self.rec._ids)
        opened.append((self.sid, self.batch))
        self.cpu0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        cpu1 = time.thread_time_ns()
        _ctx.open.pop()
        self.rec._add(self, t1, cpu1)
        return False


class StageTimer:
    """Accumulating wall-clock telemetry; the framework's replacement for the
    reference's commented-out chrono probes (event_handling.cpp:150-151).
    Pipeline worker threads share one timer, so the totals are updated
    under a lock.

    It is also the pipeline's span recorder: ``time`` (a stage, added to
    ``totals``), ``span`` and the module's ``span`` (on a thread that runs
    under ``scope``) record each span in memory, and ``spans()`` returns
    them once the run is over.  A stage's total is the sum of its spans'
    durations: their nanoseconds added up, over 1e9."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._stage_ns = defaultdict(int)
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._names: dict[str, int] = {}
        # 11 integers a span, in Span's field order (names and roles as
        # indices): a long run keeps millions of spans
        self._cols = array("q")

    def time(self, name: str):
        """A stage: a span whose duration is added to ``totals[name]``."""
        return _Open(self, name, False, None, True)

    def span(self, name: str, wait: bool = False, batch: int | None = None):
        """A span on the calling thread, whether or not it runs under this
        recorder's ``scope``."""
        return _Open(self, name, wait, batch, False)

    @contextmanager
    def scope(self, role: str):
        """Within the block the calling thread records the module's
        ``span`` sites into this recorder, under ``role`` (one of
        ``ROLES``)."""
        ctx = _ctx
        prev = ctx.recorder, ctx.role
        ctx.recorder, ctx.role = self, role
        try:
            yield self
        finally:
            ctx.recorder, ctx.role = prev

    def _add(self, s: _Open, t1: int, cpu1: int) -> None:
        tid = threading.get_native_id()
        role = ROLES.index(_ctx.role)
        with self._lock:
            name = self._names.setdefault(s.name, len(self._names))
            self._cols.extend((s.sid, s.parent, name, tid, role, s.batch,
                               s.t0, t1, s.cpu0, cpu1, int(s.wait)))
            if s.stage:
                self._stage_ns[s.name] += t1 - s.t0
                self.totals[s.name] = self._stage_ns[s.name] / 1e9
                self.counts[s.name] += 1

    def spans(self) -> list[Span]:
        """Every span recorded so far, in the order they ended."""
        with self._lock:
            cols = self._cols.tolist()
            names = list(self._names)
        return [Span(c[0], c[1], names[c[2]], c[3], ROLES[c[4]], *c[5:10],
                     bool(c[10])) for c in zip(*[iter(cols)] * 11)]

    def report(self, stream=sys.stderr) -> None:
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            stream.write(f"  {name:32s} {self.totals[name]*1000:10.1f} ms "
                         f"({self.counts[name]} calls)\n")

    def tree(self, stream=sys.stderr) -> None:
        """Every span name under its parents, by thread role: wall and
        thread-CPU milliseconds summed over the calls, and the calls.
        Siblings come in the order they first started."""
        spans = self.spans()
        by_id = {s.sid: s for s in spans}
        paths: dict[int, tuple] = {}

        def path(s: Span) -> tuple:
            p = paths.get(s.sid)
            if p is None:
                up = by_id.get(s.parent)
                p = paths[s.sid] = (path(up) if up else (s.role,)) + (s.name,)
            return p

        acc: dict[tuple, list] = {}
        for s in sorted(spans, key=lambda s: s.t0):
            a = acc.setdefault(path(s), [0, 0, 0])
            a[0] += s.t1 - s.t0
            a[1] += s.cpu1 - s.cpu0
            a[2] += 1
        first = {k: i for i, k in enumerate(acc)}
        for role in ROLES:
            keys = [k for k in acc if k[0] == role]
            if keys:
                stream.write(f"{role}\n")
            keys.sort(key=lambda k: [first[k[:i]]
                                     for i in range(2, len(k) + 1)])
            for k in keys:
                wall, cpu, calls = acc[k]
                label = "  " * (len(k) - 1) + k[-1]
                stream.write(f"{label:44s} {wall/1e6:10.1f} {cpu/1e6:10.1f} "
                             f"{calls:8d}\n")
