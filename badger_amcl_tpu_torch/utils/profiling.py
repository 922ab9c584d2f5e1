"""Per-phase host timing (a copy of badger_amcl_tpu.utils.profiling's
`PhaseTimer`).

`PhaseTimer`: named wall-clock accumulators around host-side phases (scan
prep, sensor update, resample). On a CUDA device a phase times what the
host spends in it, dispatch and host syncs included, not the device's work
behind it; `report()` gives per-phase mean/max/total.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class PhaseTimer:
    def __init__(self):
        self._sums: Dict[str, float] = defaultdict(float)
        self._maxs: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._sums[name] += dt
            self._counts[name] += 1
            if dt > self._maxs[name]:
                self._maxs[name] = dt

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "count": self._counts[name],
                "total_s": self._sums[name],
                "mean_ms": 1e3 * self._sums[name] / max(self._counts[name], 1),
                "max_ms": 1e3 * self._maxs[name],
            }
            for name in self._sums
        }

    def reset(self) -> None:
        self._sums.clear()
        self._maxs.clear()
        self._counts.clear()
