"""Progress reporting (counterpart of raytracingthenextweekcuda_tpu/utils/progress.py).

Replaces the kernel-side atomicAdd pixel counter that printed every 10%
(main.cu:197-203). Host-side: progress ticks per completed pass, printed to
stderr at every 10% step.
"""

from __future__ import annotations

import sys
import time

STEP_PERCENT = 10


class Progress:
    def __init__(self, total: int):
        self.total = max(total, 1)
        self.done = 0
        self._next = STEP_PERCENT
        self._t0 = time.perf_counter()

    def update(self, n: int = 1) -> None:
        self.done += n
        pct = self.done * 100.0 / self.total
        if pct >= self._next:
            elapsed = time.perf_counter() - self._t0
            sys.stderr.write(f"Complete: {min(pct, 100.0):.2f}%  ({elapsed:.1f}s)\n")
            sys.stderr.flush()
            while self._next <= pct:
                self._next += STEP_PERCENT

    def finish(self) -> None:
        """Count what is left, printing the 100% line if not yet printed."""
        if self.done < self.total:
            self.update(self.total - self.done)
