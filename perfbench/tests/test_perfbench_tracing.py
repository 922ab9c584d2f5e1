"""The readers of the program's own counters and spans, on a synthetic
trace and recorder: their values, nothing where nothing was recorded (or
the program has no recorder), nothing on the CPU for the host times or
where the timed scans are too few or reach past the window's untraced
rest, and nothing from `entry_idle_share` where the program's clock is
not the profiler's."""

import importlib

import pytest

from badger_amcl_tpu_torch.utils import profiling
from perfbench import core, program
from perfbench.trace import Trace

COUNTERS = dict(timed_scans=100, scan_ns=800_000_000, entry_ns=450_000_000,
                sync_ns=150_000_000, captures=12, capture_ns=2_500_000_000,
                library_ns=1_250_000_000, spans_dropped=0)
# the host-time readers' cells: 2D's untraced rest is too short
CELLS = {"node_host_ms": ["amcl_3d_store.track"], "sync_wait_ms": ["amcl_3d_store.track"],
         "entry_host_ms": ["amcl_3d_store.track"]}
HOST = {"node_host_ms": 2.0, "sync_wait_ms": 1.5, "entry_host_ms": 4.5, "capture_s": 2.5,
        "library_load_s": 1.25}
NEW = sorted(HOST) + ["entry_idle_share"]


def _metric(name):
    return importlib.import_module("perfbench.metrics." + name)


def _span(name, start_s, end_s, i=1):
    return profiling.Span(i, name, int(start_s * 1e9), int(end_s * 1e9), 0, 1, 0, None)


def _trace(shift_s=0.0):
    """A 1 s window from t = 100 s holding two scans (0.1-0.4 and
    0.5-0.9), each with one graph_jit call (0.2-0.3 and 0.6-0.8); the
    device is busy 0.25-0.35 and 0.6-0.65. The program's spans are
    shifted by shift_s."""
    t0 = 100.0
    trace = Trace(window=(t0, t0 + 1.0),
                  spans=[("scan_received", t0 + 0.1, t0 + 0.4),
                         ("scan_received", t0 + 0.5, t0 + 0.9)],
                  device=[("k", t0 + 0.25, t0 + 0.35, None), ("k", t0 + 0.6, t0 + 0.65, None)])
    s = t0 + shift_s
    spans = [_span("scan", s + 0.1001, s + 0.3999), _span("graph.call", s + 0.2, s + 0.3),
             _span("scan", s + 0.5001, s + 0.8999), _span("graph.call", s + 0.6, s + 0.8)]
    return trace, spans


def _run(device_type="cuda", trace=None, scans=400, traced=240):
    """A run of `scans` scans, the first `traced` of them traced."""
    return core.Run(latencies=[0.01] * scans, window_s=1.0, setup_s=10.0, counts={}, info={},
                    device_type=device_type, trace=trace, traced_scans=traced)


@pytest.fixture
def recorder(monkeypatch):
    """The program's recorder, its counters and spans set by the test."""
    held = {"counters": dict(COUNTERS), "spans": []}
    monkeypatch.setattr(profiling, "counters", lambda: dict(held["counters"]))
    monkeypatch.setattr(profiling, "spans", lambda: list(held["spans"]))
    return held


@pytest.mark.parametrize("name", sorted(HOST))
def test_host_time_readers(recorder, name):
    mod = _metric(name)
    assert mod.read(_run()) == pytest.approx(HOST[name])
    assert mod.read(_run("cpu")) is None
    recorder["counters"] = dict.fromkeys(COUNTERS, 0)
    assert mod.read(_run()) is None


@pytest.mark.parametrize("name", sorted(set(HOST) & set(CELLS)))
def test_host_times_read_only_the_window_s_untraced_rest(recorder, name):
    mod = _metric(name)
    # 100 timed scans, as many as the untraced rest: read
    assert mod.read(_run(scans=340)) == pytest.approx(HOST[name])
    # more timed scans than the untraced rest: the warm-up's among them
    assert mod.read(_run(scans=339)) is None
    # too few to read a mean over (the 2D cell: the rest is one scan)
    recorder["counters"]["timed_scans"] = program.MIN_SCANS - 1
    assert mod.read(_run()) is None


def test_host_times_partition_the_scan(recorder):
    total = sum(_metric(n).read(_run()) for n in ("node_host_ms", "sync_wait_ms",
                                                   "entry_host_ms"))
    assert total == pytest.approx(COUNTERS["scan_ns"] * 1e-6 / COUNTERS["timed_scans"])


def test_entry_idle_share(recorder):
    trace, spans = _trace()
    recorder["spans"] = spans
    mod = _metric("entry_idle_share")
    # calls 0.2-0.3 and 0.6-0.8 (0.3 s), busy inside them 0.25-0.3 and 0.6-0.65
    assert mod.read(_run(trace=trace)) == pytest.approx(100.0 * (0.3 - 0.1))
    assert mod.read(_run(trace=None)) is None
    recorder["spans"] = []
    assert mod.read(_run(trace=trace)) is None
    recorder["spans"] = [s for s in spans if s.name == "scan"]  # no call
    assert mod.read(_run(trace=trace)) is None


@pytest.mark.parametrize("shift_s", [-0.002, 0.002, 3600.0])
def test_entry_idle_share_reads_nothing_on_another_clock(recorder, shift_s):
    trace, spans = _trace(shift_s)
    recorder["spans"] = spans
    assert _metric("entry_idle_share").read(_run(trace=trace)) is None


def test_entry_idle_share_clips_spans_to_the_window(recorder):
    trace, spans = _trace()
    # a call and its scan from an earlier profiled stretch, outside the window
    recorder["spans"] = spans + [_span("scan", 50.0, 50.5), _span("graph.call", 50.1, 50.2)]
    assert _metric("entry_idle_share").read(_run(trace=trace)) == pytest.approx(20.0)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_a_recorder_reads_nothing(monkeypatch, name):
    monkeypatch.delattr(profiling, "counters")
    monkeypatch.delattr(profiling, "spans")
    trace, _ = _trace()
    assert _metric(name).read(_run(trace=trace)) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_is_listed_as_it_declares(name):
    bench = core.load_json(core.ROOT, "BENCHMARK.json")
    (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
    mod = _metric(name)
    assert (entry["layer"], entry["unit"], entry["source"], entry["moves"]) == (
        mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES)
    assert entry["workloads"] == CELLS.get(name, ["amcl_2d_store.track",
                                                  "amcl_3d_store.track"])
