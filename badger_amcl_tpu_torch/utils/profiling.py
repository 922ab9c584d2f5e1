"""Per-phase host timing and device traces (counterpart of
badger_amcl_tpu.utils.profiling).

- `PhaseTimer` (a copy of the JAX package's): named wall-clock
  accumulators around host-side phases (scan prep, sensor update,
  resample). On a CUDA device a phase times what the host spends in it,
  dispatch and host syncs included, not the device's work behind it;
  `report()` gives per-phase mean/max/total.
- `trace(logdir)`: a `torch.profiler` window around a block, written into
  `logdir` as a Chrome trace (Perfetto, chrome://tracing), in place of
  the JAX package's `jax.profiler` TensorBoard trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


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


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block's host ops, and its CUDA kernels where a card is
    present, with torch.profiler (profiling.py:56-65); on exit the trace is
    written to `logdir`/trace_<pid>_<ns>.json. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
