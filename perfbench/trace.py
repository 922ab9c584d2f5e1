"""The traced stretch of a `--trace 1` run: `torch.profiler` over the first
steps of the window, with spans named `perfbench.<part>` that the driver
opens around each part of a step and each call into the node's compiled
helpers, and its reduction to what the per-layer readers read.

`Trace` holds, in seconds on one clock: the traced window (the span
`perfbench.window`), every span, and every device activity (kernel, copy,
set) with the span it was launched from: the innermost span around the
host event that launched it (its linked correlation), or around its own
start where the profiler links none.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses

PREFIX = "perfbench."


@dataclasses.dataclass
class Trace:
    window: tuple  # (start, end) s
    spans: list  # (name, start, end) s, name without the prefix
    device: list  # (name, start, end, span or None) s

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran."""
        return sum(b - a for a, b in merged(
            [(max(s, self.window[0]), min(e, self.window[1])) for _, s, e, _ in self.device
             if e > self.window[0] and s < self.window[1]]))

    def device_s(self, spans) -> float:
        """Device seconds of the activities launched from the named spans."""
        return sum(e - s for _, s, e, sp in self.device if sp in spans)

    def top_ops(self, k: int = 10) -> list:
        tot = collections.Counter()
        for name, s, e, _ in self.device:
            tot[name[:160]] += e - s
        return [[n, t] for n, t in tot.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device seconds of the window by the innermost span the host
        was in at each gap's middle ("between spans" outside every one)."""
        busy = merged([(s, e) for _, s, e, _ in self.device])
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        find = span_finder(self.spans)
        tot = collections.Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, self.window[0]), min(b, self.window[1])
            if b > a:
                tot[find((a + b) / 2) or "between spans"] += b - a
        return [[n, t] for n, t in tot.most_common(k)]


def merged(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def span_finder(spans):
    """A function of a time returning the innermost span around it."""
    order = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in order]

    def find(t):
        best = None
        i = bisect.bisect_right(starts, t)
        for name, s, e in reversed(order[max(0, i - 64):i]):
            if s <= t <= e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else None

    return find


def reduce(events) -> Trace:
    """A Trace from the profiler's events (objects with name(),
    device_type(), start_ns(), duration_ns(), correlation_id(),
    linked_correlation_id())."""
    spans, host, device = [], {}, []
    for ev in events:
        name = ev.name()
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        if "cuda" in str(ev.device_type()).lower():
            if name.startswith(PREFIX):  # the device-side copy of a span
                continue
            device.append((name, start, end, ev.linked_correlation_id()))
            continue
        if name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], start, end))
        if ev.linked_correlation_id() == 0:
            host[ev.correlation_id()] = start
    window = next(((s, e) for n, s, e in spans if n == "window"), None)
    spans = [s for s in spans if s[0] != "window"]
    if window is None:
        raise RuntimeError("the trace holds no perfbench.window span")
    find = span_finder(spans)
    return Trace(window=window, spans=spans,
                 device=[(n, s, e, find(host.get(c, s))) for n, s, e, c in device])


class Tracer:
    """`torch.profiler` over a stretch of steps, the spans the driver opens
    inside it, and the reduction once it stops."""

    def __init__(self):
        self.prof = None
        self.trace = None
        self._window = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._window = torch.profiler.record_function(PREFIX + "window")
        self._window.__enter__()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name: str):
        import torch

        with torch.profiler.record_function(PREFIX + name):
            yield

    def reduce(self) -> Trace:
        self.trace = reduce(self.prof.profiler.kineto_results.events())
        self.prof = None
        return self.trace
