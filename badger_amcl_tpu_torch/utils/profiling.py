"""The port's tracing: process-wide counters, spans kept while a profiler
runs, a node's phase timers, and the Chrome-trace exporter (counterpart
of badger_amcl_tpu.utils.profiling).

Every timed block is a `_Region`: a span under a profiler, and its host
time on `perf_counter_ns`, when it closes, into an accumulator (`_Acc`:
count, total, longest) or into a tally of the open scan. A scan
(`scan()`, the nodes' `scan_received`) is the root region.

**Counters** (`counters()`) are always on. The tallies (TALLIES) count
over the timed scans: a scan keeps its own by name while it is open, and
its close adds them to one store. A scan is timed where no
`torch.profiler` was active around it and it captured no graph and
loaded nothing of the kernel library (set-up, counted below). A profiled
scan empties the store, so after a profiler stops the tallies cover the
scans since; so does `reset`. A new tally is a name in TALLIES and a
`tally(name)` at its site.

- `timed_scans`, `scan_ns`: the timed scans and their host time.
- `entry_ns`: the host time of the timed scans' outermost `graph_jit`
  calls (key, copy-in, launch, clone).
- `entry_leaves`, `entry_grouped`: the tensors the timed scans'
  `graph_jit` calls moved in and out of their graphs, and those of them
  moved in a transfer of their dtype group (`utils.graph`): every output,
  and every input but a non-contiguous one, which is copied alone.
- `sync_ns`: the host time of the timed scans' reads outside a
  `graph_jit` call (`numerics.host_values`, `host_arrays`): the host
  blocked on the device. So `scan_ns - entry_ns - sync_ns` is the node's
  own host time, and the three share `timed_scans` as their denominator;
  the profiler's host slowdown never enters them.
- `pool_tests`, `pool_stalls`: the timed scans' lagged reads
  (`numerics.LaggedFlags`, the uniform pool's stop test) and those of
  them whose copy had not landed when read, so that the host waited on
  the card.
- `pool_builds`, `pool_skips`: the timed scans' resamples that built the
  uniform pool, and those that passed a zero pool since no slot could
  take a pool pose (w_diff 0).
- `captures`, `capture_ns`: every `graph_jit` warm-up and capture.
- `library_ns`: loading the kernel library, its nvcc build included, and
  each entry point's first call (`ops/_build.lib`).
- `spans_dropped`: the spans past the cap.

**Spans** (`spans()`) are kept only while a `torch.profiler` is
active (`torch._C._autograd._profiler_enabled()`): `profiling.trace` or
the benchmark's traced stretch turns them on. Each keeps its name, its
start and end on `time.time_ns()` (the profiler's host clock,
Unix-epoch nanoseconds), the span around it on its thread, the number of
the scan it belongs to (0 outside a scan), its thread and a tag. At most
MAX_SPANS are kept after a `reset` or the start of a `trace`; later ones
are counted, not kept. With no profiler a span is one check that returns
the shared no-op `NOOP`. No span is a `torch.profiler.record_function`
range: such a range adds its events, and a device-side copy on a card, to
the profiler's own trace.

The spans: `scan` (the root: its number tags every span under it),
`scan_prep`, `motion_update`, `sensor_update`, `resample`, `publish` (a
node's phases), `pool_round`, `graph.call` (tagged with the helper) with
`graph.key`, `graph.copy_in`, `graph.replay` (the host launch),
`graph.copy_out` and `graph.capture`, `sync`, `library.load` with
`library.build`, and `map.receipt` with `map.field`, `map.free_cells`.

- `PhaseTimer`: a node's named phases, each a region adding to the
  node's own accumulator of that phase (`report()`).
- `trace(logdir)`: a `torch.profiler` run around a block, written
  into `logdir` as a Chrome trace (Perfetto, chrome://tracing) with the
  program's spans on a track of their own, in place of the JAX package's
  `jax.profiler` TensorBoard trace.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, NamedTuple, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns
_epoch_ns = time.time_ns
_thread_id = threading.get_ident

# the spans kept after a reset; a long traced stretch of a 2D node keeps
# ~30,000 (~5 MB)
MAX_SPANS = 200_000
# the pid of the spans' track in an exported Chrome trace
TRACK = "badger_amcl_tpu_torch spans"


class _Acc:
    """The count, total and longest host time (ns) of a region."""

    __slots__ = ("count", "ns", "max_ns")

    def __init__(self):
        self.count = self.ns = self.max_ns = 0

    def add(self, ns: int) -> None:
        self.count += 1
        self.ns += ns
        if ns > self.max_ns:
            self.max_ns = ns

    clear = __init__


# set-up
_CAPTURE, _LIBRARY = _Acc(), _Acc()
# the tallies of the timed scans (module docstring)
TALLIES = ("timed_scans", "scan_ns", "entry_ns", "sync_ns", "pool_tests", "pool_stalls",
           "pool_builds", "pool_skips", "entry_leaves", "entry_grouped")
_TALLIED = dict.fromkeys(TALLIES, 0)  # summed over the timed scans since the last profiled one


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int  # the id of the span around it, 0 at the top
    scan: int  # the number of its scan, 0 outside every scan
    thread: int
    tag: Optional[str]


_SPANS = []  # the fields of each Span, in the order they closed
_ids = itertools.count(1)
_scans = itertools.count(1)
_room = [MAX_SPANS]  # spans that may still be kept
_dropped = [0]


class _State:
    """One thread's open spans and scan."""

    __slots__ = ("stack", "scan", "depth", "pending")

    def __init__(self):
        self.stack = []  # ids of the open spans
        self.scan = 0  # the number of the open scan, 0 outside
        self.depth = 0  # open calls and syncs
        self.pending = None  # the open scan's tallies ({name: n}), None outside


_local = threading.local()


def _state() -> _State:
    try:
        return _local.state
    except AttributeError:
        _local.state = _State()
        return _local.state


class _Noop:
    # __exit__ takes its three arguments by name, which calls faster than
    # *args: a graph_jit call opens four of these blocks
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "tag", "id", "parent", "scan", "start", "state")

    def __init__(self, name: str, tag: Optional[str]):
        self.name, self.tag = name, tag

    def __enter__(self):
        if _room[0] <= 0:
            _dropped[0] += 1
            self.id = 0
            return self
        _room[0] -= 1
        i = self.id = next(_ids)
        t = self.state = _state()
        stack = t.stack
        self.parent = stack[-1] if stack else 0
        self.scan = t.scan
        stack.append(i)
        self.start = _epoch_ns()
        return self

    def __exit__(self, *exc):
        end = _epoch_ns()
        if self.id:
            self.state.stack.pop()
            _SPANS.append((self.id, self.name, self.start, end, self.parent, self.scan,
                           _thread_id(), self.tag))
        return False


def span(name: str, tag: Optional[str] = None):
    """A span around the block while a profiler runs, else `NOOP`."""
    return _Span(name, tag) if _profiling() else NOOP


class _Region:
    """A span under a profiler, and the block's host time into `acc` on
    exit; or, where `tally` names one, into that tally of the open scan,
    by the outermost call or sync only."""

    __slots__ = ("span", "acc", "tally", "state", "t0")

    def __init__(self, name: str, tag: Optional[str] = None, acc: Optional[_Acc] = None,
                 tally: Optional[str] = None):
        self.span = _Span(name, tag) if _profiling() else None
        self.acc, self.tally = acc, tally

    def __enter__(self):
        if self.span is not None:
            self.span.__enter__()
        if self.tally is not None:
            t = self.state = _state()
            t.depth += 1
        self.t0 = _clock()
        return self

    def __exit__(self, typ, value, tb):
        ns = _clock() - self.t0
        if self.tally is None:
            self.acc.add(ns)
        else:
            t = self.state
            t.depth -= 1
            if t.pending is not None and not t.depth:
                t.pending[self.tally] += ns
        if self.span is not None:
            self.span.__exit__()
        return False


class _Scan:
    """The root of one scan: its number, its span, and its tallies into the
    store where nothing profiled or set up inside it."""

    __slots__ = ("outer", "span", "setup", "profiled", "t0")

    def __enter__(self):
        t = _state()
        self.outer = (t.scan, t.pending)
        t.scan, t.pending = next(_scans), dict.fromkeys(TALLIES, 0)
        self.profiled = _profiling()
        self.span = _Span("scan", None).__enter__() if self.profiled else None
        self.setup = (_CAPTURE.count, _LIBRARY.count)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        ns = _clock() - self.t0
        t = _state()
        if self.profiled or _profiling():
            _TALLIED.update(dict.fromkeys(TALLIES, 0))
        elif self.setup == (_CAPTURE.count, _LIBRARY.count):
            pending = t.pending
            pending["timed_scans"], pending["scan_ns"] = 1, ns
            for name, n in pending.items():
                _TALLIED[name] += n
        if self.span is not None:
            self.span.__exit__()
        t.scan, t.pending = self.outer
        return False


def scan():
    """The root region of one scan (a node's scan_received)."""
    return _Scan()


def call(tag: str) -> _Region:
    """A graph_jit call of the helper `tag`."""
    return _Region("graph.call", tag, tally="entry_ns")


def sync() -> _Region:
    """One counted host read of device values."""
    return _Region("sync", tally="sync_ns")


def tally(name: str, n: int = 1) -> None:
    """n events into the open scan's tally `name` (one of TALLIES); none
    outside a scan."""
    pending = _state().pending
    if pending is not None:
        pending[name] += n


def capture(tag: str) -> _Region:
    """A graph_jit key's warm-up and capture."""
    return _Region("graph.capture", tag, _CAPTURE)


def library(tag: Optional[str] = None) -> _Region:
    """Loading the kernel library (its build included), or an entry
    point's (`tag`) first call."""
    return _Region("library.load", tag, _LIBRARY)


def counters() -> Dict[str, int]:
    """The counters (module docstring)."""
    return dict(_TALLIED, captures=_CAPTURE.count, capture_ns=_CAPTURE.ns,
                library_ns=_LIBRARY.ns, spans_dropped=_dropped[0])


def spans() -> list:
    """The kept spans (`Span`), in the order they closed."""
    return [Span._make(s) for s in _SPANS]


def _forget_spans(max_spans: Optional[int] = None) -> None:
    _SPANS.clear()
    _room[0] = MAX_SPANS if max_spans is None else max_spans


def reset(max_spans: Optional[int] = None) -> None:
    """Zero the counters, drop the kept spans, keep at most max_spans
    (MAX_SPANS) more."""
    _TALLIED.update(dict.fromkeys(TALLIES, 0))
    _CAPTURE.clear()
    _LIBRARY.clear()
    _dropped[0] = 0
    _forget_spans(max_spans)


class PhaseTimer:
    """A node's named host phases. Each `phase(name)` is a region: a span
    under a profiler, and always its host time into this timer's
    accumulator of the phase. On a CUDA device a phase times what the host
    spends in it, dispatch and host syncs included, not the device's work
    behind it; `report()` gives per-phase count, total, mean and longest."""

    def __init__(self):
        self._phases: Dict[str, _Acc] = {}

    def phase(self, name: str) -> _Region:
        acc = self._phases.get(name)
        if acc is None:
            acc = self._phases[name] = _Acc()
        return _Region(name, acc=acc)

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "count": acc.count,
                "total_s": acc.ns * 1e-9,
                "mean_ms": acc.ns * 1e-6 / max(acc.count, 1),
                "max_ms": acc.max_ns * 1e-6,
            }
            for name, acc in self._phases.items()
        }

    def reset(self) -> None:
        self._phases.clear()


def _add_spans(path: str, kept: list) -> None:
    """Append the spans `kept` to the Chrome trace at `path`, on its time
    base (microseconds from its `baseTimeNanoseconds`, or from the epoch
    where it has none), as a track of their own (pid TRACK, one row per
    thread)."""
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds", 0)
    events = data.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": TRACK, "tid": 0,
                   "args": {"name": "program spans"}})
    for s in kept:
        events.append({"ph": "X", "name": s.name, "cat": "program", "pid": TRACK,
                       "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent, "scan": s.scan,
                                "tag": s.tag}})
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block's host ops, and its CUDA kernels where a card is
    present, with torch.profiler (profiling.py:56-65); on exit the trace is
    written to `logdir`/trace_<pid>_<ns>.json with the program's spans of
    the block beside the profiler's events. The block starts with no span
    kept and room for MAX_SPANS; its spans leave the store once written.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    _forget_spans()
    start = time.time_ns()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        kept = [s for s in spans() if s.start_ns >= start]
        _forget_spans()
        _add_spans(path, kept)
