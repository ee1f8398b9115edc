"""Progress bar with ETA and failure counter (reference: src/common.h:30-88),
plus simple wall-clock telemetry for pipeline stages; a copy of
``dnascent_tpu/utils/progress.py``."""

from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager


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


class StageTimer:
    """Accumulating wall-clock telemetry; the framework's replacement for the
    reference's commented-out chrono probes (event_handling.cpp:150-151).
    Pipeline worker threads share one timer, so the totals are updated
    under a lock."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def report(self, stream=sys.stderr) -> None:
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            stream.write(f"  {name:32s} {self.totals[name]*1000:10.1f} ms "
                         f"({self.counts[name]} calls)\n")
