"""The 95th percentile of the latency of every scan of the window, gated
ones included (nearest rank): whether a robot's localizer keeps up with
its sensor."""

import math

UNIT = "ms"


def p95(values) -> float:
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def read(run):
    return p95(run.latencies) * 1e3 if run.latencies else None
