"""Progress bar with ETA and failure counter (reference: src/common.h:30-88);
a copy of ``dnascent_tpu/utils/progress.py``'s ``ProgressBar``."""

from __future__ import annotations

import sys
import time


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
