"""Device: the share of the traced window, in percent, in which no
activity ran on the card while the host was inside one of the program's
graph_jit calls (its `graph.call` spans, clipped to the window): the idle
device time that the compiled entry's host work (key, copy-in, launch,
clone) leaves.

The program's spans stand on `time.time_ns()`, which the profiler's host
clock shares. The reader checks that: every program `scan` span in the
window has to lie inside one of the benchmark's `scan_received` spans to
0.5 ms at both ends; where one does not, or the program kept no span, or
no device activity ran in the window, it reads nothing."""

import bisect

from perfbench import program
from perfbench.trace import merged

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "scans_per_s"
SLACK_S = 5e-4


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _overlap(a, b) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def on_one_clock(scans, received) -> bool:
    """Whether each (start, end) of scans lies inside one of received's,
    to SLACK_S at both ends."""
    received = sorted(received)
    starts = [s for s, _ in received]
    for s, e in scans:
        i = bisect.bisect_right(starts, s + SLACK_S) - 1
        if i < 0 or s < received[i][0] - SLACK_S or e > received[i][1] + SLACK_S:
            return False
    return True


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    kept = program.spans()
    if not kept:
        return None
    w0, w1 = run.trace.window
    inside = [(s.name, 1e-9 * s.start_ns, 1e-9 * s.end_ns) for s in kept]
    inside = [(n, s, e) for n, s, e in inside if e > w0 and s < w1]
    scans = [(s, e) for n, s, e in inside if n == "scan"]
    received = [(s, e) for n, s, e in run.trace.spans if n == "scan_received"]
    if not scans or not on_one_clock(scans, received):
        return None
    calls = merged([(max(s, w0), min(e, w1)) for n, s, e in inside if n == "graph.call"])
    if not calls:
        return None
    busy = merged([(max(s, w0), min(e, w1)) for _, s, e, _ in run.trace.device
                   if e > w0 and s < w1])
    if not busy:  # no device ran in the window
        return None
    return 100.0 * (_length(calls) - _overlap(calls, busy)) / run.trace.window_s
