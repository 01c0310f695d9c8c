"""Progress lines (copy of the JAX package's utils/progress.ProgressMeter).

The reference prints elapsed seconds + sec/file every PROGRESS_INTERVAL files
(tagging.py:342-351, gen_cfeatures.py:428-437); this keeps that surface.
"""

from __future__ import annotations

import time


class ProgressMeter:
    def __init__(self, interval: int, label: str = "files") -> None:
        self.interval = interval
        self.label = label
        self.start = time.perf_counter()
        self.count = 0
        self._last_reported = 0

    def add(self, n: int = 1) -> None:
        self.count += n
        if self.count - self._last_reported >= self.interval:
            self.report()
            self._last_reported = self.count

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def report(self) -> None:
        diff = self.elapsed()
        print(f"{self.count} {self.label} processed")
        print("{:.2f} seconds elapsed".format(diff))
        if self.count > 0:
            print("{:.4f} seconds per file".format(diff / self.count))
        print("", flush=True)
