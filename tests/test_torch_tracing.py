"""PyTorch port: the tracing module (`utils.profiling`) on the CPU.

Counters count with no profiler and keep no span; under a CPU
`torch.profiler` a 2D node scan nests `scan` > `sensor_update` >
`graph.call` under one scan number, every counted sync is a `sync` span,
and the spans stand on the profiler's clock without adding a single event
to its trace. A profiled scan restarts the timed-scan counters and a scan
that sets something up is left out of them; the kernel library's entry
points are timed at their first call only. `profiling.trace` writes the
spans into the Chrome trace it exports, each trace with room for the cap.
The tallies of what `graph_jit` calls move are counters; on a card (the
cases skip without one) a compiled node helper's returned state is its
own, unchanged by the next call, and bit for bit what a copy per tensor
in and a clone per tensor out of the same graph give.
"""

import collections
import inspect
import json
import os
import tempfile
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from badger_amcl_tpu_torch import config, scenario
from badger_amcl_tpu_torch.node import make_node, messages, transforms
from badger_amcl_tpu_torch.node import node as tnode
from badger_amcl_tpu_torch.ops import _build
from badger_amcl_tpu_torch.pf.filter import ResampleModel
from badger_amcl_tpu_torch.sensors.odom import OdomModel
from badger_amcl_tpu_torch.utils import graph, numerics, profiling, tree

TIMED = ("timed_scans", "scan_ns", "entry_ns", "sync_ns")
ANGLES = np.linspace(-2.35, 2.35, 32).astype(np.float32)


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _delta(before):
    after = profiling.counters()
    return {k: after[k] - before[k] for k in after}


class _Robot:
    """A CPU 2D node on the scenario's 96-cell map, resampling every
    update, moved 5 cm a scan so that each scan updates."""

    def __init__(self):
        self.tf = transforms.TransformBuffer()
        self.tf.set_static("base_link", "laser", transforms.Transform.identity())
        cfg = config.AMCLConfig(min_particles=64, max_particles=128, laser_max_beams=16,
                                update_min_d=0.01, resample_interval=1,
                                resample_model_type="systematic",
                                saved_pose_filepath="/nonexistent/saved_pose.yaml")
        self.node = make_node(cfg, tf_buffer=self.tf, device="cpu")
        self.node.init_pose = np.array([0.3, -0.3, 0.2])
        self.node.init_cov = np.array([0.01, 0.01, 0.005])
        self.node.map_msg_received(scenario.grid_msg(96))
        self.pose = self.node.init_pose.copy()
        self.k = 0

    def scan(self):
        self.k += 1
        self.pose = self.pose + np.array([0.05, 0.0, 0.0])
        t = 0.1 * self.k
        self.tf.set_transform("odom", "base_link", t, transforms.Transform.from_pose2d(self.pose))
        self.node.integrate_odom(messages.Odometry(t, self.pose.copy()))
        self.node.scan_received(scenario.laser_scan(self.node.map, self.pose, ANGLES, t))


@pytest.fixture(scope="module")
def robot():
    r = _Robot()
    r.scan()  # initOdom
    r.scan()  # the odometry integrator's first reading: no motion yet
    return r


def test_no_profiler_keeps_no_span_and_returns_the_shared_noop():
    assert profiling.span("a") is profiling.NOOP and profiling.span("b", "t") is profiling.NOOP
    with profiling.span("a"), profiling.scan():
        with profiling.call("helper"), profiling.span("graph.key"):
            pass
        numerics.host_values(torch.ones(()))
    assert profiling.spans() == []
    c = profiling.counters()
    assert c["timed_scans"] == 1 and c["entry_ns"] > 0 and c["sync_ns"] > 0
    assert c["scan_ns"] >= c["entry_ns"] + c["sync_ns"]


def test_counters_count_with_no_profiler():
    with profiling.library():
        pass
    for _ in range(3):
        with profiling.capture("helper"):
            pass
    c = profiling.counters()
    assert c["captures"] == 3 and c["capture_ns"] > 0 and c["library_ns"] > 0
    # outside a scan, calls and syncs add nothing to the timed counters
    with profiling.call("helper"):
        numerics.host_values(torch.ones(()))
    assert all(profiling.counters()[k] == 0 for k in TIMED)


def test_a_profiled_node_scan_nests_under_one_scan_number(robot):
    syncs = numerics.SYNCS.count
    with profile(activities=[ProfilerActivity.CPU]):
        robot.scan()
    syncs = numerics.SYNCS.count - syncs
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    scans = [s for s in spans if s.name == "scan"]
    assert len(scans) == 1 and scans[0].parent == 0
    number = scans[0].scan
    assert number > 0 and all(s.scan == number for s in spans)
    calls = [s for s in spans if s.name == "graph.call" and s.tag == "sensor_update_2d"]
    assert len(calls) == 1
    update = by_id[calls[0].parent]
    assert update.name == "sensor_update" and by_id[update.parent].name == "scan"
    assert {"scan_prep", "motion_update", "resample", "publish", "graph.key",
            "sync"} <= {s.name for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # every counted sync is a sync span
    assert syncs > 0 and sum(s.name == "sync" for s in spans) == syncs
    # and the phases, as before, in the node's timers
    rep = robot.node.timers.report()
    assert {"scan_prep", "sensor_update", "resample", "motion_update", "publish"} <= set(rep)
    for v in rep.values():
        assert set(v) == {"count", "total_s", "mean_ms", "max_ms"} and v["count"] >= 1


def test_an_unprofiled_node_scan_is_timed(robot):
    before = profiling.counters()
    robot.scan()
    d = _delta(before)
    assert d["timed_scans"] == 1 and d["entry_ns"] > 0 and d["sync_ns"] > 0
    assert d["scan_ns"] >= d["entry_ns"] + d["sync_ns"]
    assert profiling.spans() == []


def test_profiled_and_setting_up_scans_add_nothing_to_the_timed_counters(robot):
    robot.scan()
    assert profiling.counters()["timed_scans"] == 1
    # a profiled scan adds nothing, and restarts the count: the counters
    # cover the scans since the last profiled one
    with profile(activities=[ProfilerActivity.CPU]):
        robot.scan()
    assert all(profiling.counters()[k] == 0 for k in TIMED)
    robot.scan()
    c = profiling.counters()
    assert c["timed_scans"] == 1 and c["scan_ns"] >= c["entry_ns"] + c["sync_ns"] > 0
    for setup in (lambda: profiling.capture("helper"), profiling.library):
        before = profiling.counters()
        with profiling.scan():
            with profiling.call("helper"):
                with setup():
                    pass
            numerics.host_values(torch.ones(()))
        d = _delta(before)
        assert all(d[k] == 0 for k in TIMED)


def test_spans_stand_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(4):
            with record_function(f"block{i}"), profiling.span(f"block{i}"):
                torch.ones(1000).sum()
    mine = {s.name: s for s in profiling.spans()}
    theirs = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name() in mine}
    assert len(theirs) == 4
    for name, e in theirs.items():
        s = mine[name]
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        # inside the range opened around it, on one clock to 1 ms at both
        # ends (the profiler's first range of a process starts itself up
        # and opens late)
        assert start - 1_000_000 < s.start_ns and s.end_ns < end + 1_000_000
        if name != "block0":
            assert abs(start - s.start_ns) < 1_000_000 and abs(end - s.end_ns) < 1_000_000


def _regions(program):
    for _ in range(3):
        with (profiling.span("outer") if program else profiling.NOOP):
            with (profiling.call("helper") if program else profiling.NOOP):
                torch.ones(8).add_(1)
            if program:
                numerics.host_values(torch.ones(()))
            else:  # the same read, uncounted
                torch.ones(()).item()


def _shift(x, by):
    return x + by


_shift_jit = graph.graph_jit(_shift, static_argnames=("by",))


def _helper(program):
    """A graph_jit helper on CPU tensors (its step run eagerly), or the
    step it wraps."""
    for _ in range(3):
        (_shift_jit if program else _shift_jit.__wrapped__)(torch.ones(8), by=1.0)


@pytest.mark.parametrize("work,kept", [
    (_regions, {"outer": 3, "graph.call": 3, "sync": 3}),
    (_helper, {"graph.call": 3, "graph.key": 3}),
], ids=["regions", "graph_jit"])
def test_the_program_adds_no_event_to_the_profiler(work, kept):
    counts = []
    for program in (False, True, False, True):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            work(program)
        counts.append(len(list(prof.profiler.kineto_results.events())))
    assert counts[0] == counts[1] == counts[2] == counts[3]
    spans = profiling.spans()
    assert collections.Counter(s.name for s in spans) == {k: 2 * n for k, n in kept.items()}
    if work is _helper:  # each key span inside its call's, tagged with the step
        by_id = {s.id: s for s in spans}
        for s in spans:
            if s.name == "graph.key":
                assert by_id[s.parent].name == "graph.call"
            else:
                assert s.tag == "_shift" and s.parent == 0


def test_the_span_cap_drops_and_counts():
    profiling.reset(max_spans=5)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            for _ in range(7):
                with profiling.span("inner"):
                    pass
    spans = profiling.spans()
    assert len(spans) == 5 and profiling.counters()["spans_dropped"] == 3
    # the outer span opened first and is kept: every kept inner one names it
    (outer,) = [s for s in spans if s.name == "outer"]
    assert all(s.parent == outer.id for s in spans if s.name == "inner")


def test_trace_writes_the_spans_into_its_chrome_trace(robot):
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            robot.scan()
        (name,) = os.listdir(d)
        with open(os.path.join(d, name)) as f:
            data = json.load(f)
    events = data["traceEvents"]
    mine = [e for e in events if e.get("pid") == profiling.TRACK and e.get("ph") == "X"]
    calls = [e for e in mine if e["name"] == "graph.call"]
    scans = [e for e in mine if e["name"] == "scan"]
    assert calls and len(scans) == 1
    # on the file's time base: inside the profiler's own window of events
    theirs = [e for e in events if e.get("ph") == "X" and e.get("pid") != profiling.TRACK]
    first = min(e["ts"] for e in theirs)
    last = max(e["ts"] + e.get("dur", 0) for e in theirs)
    scan_id = scans[0]["args"]["id"]
    by_id = {e["args"]["id"]: e for e in mine}
    for e in calls:
        assert first <= e["ts"] and e["ts"] + e["dur"] <= last
        assert scans[0]["ts"] <= e["ts"] and e["ts"] + e["dur"] <= scans[0]["ts"] + scans[0][
            "dur"]
        assert e["args"]["scan"] == scans[0]["args"]["scan"]
        up = e
        while up["args"]["parent"]:  # its parents lead up to the scan
            up = by_id[up["args"]["parent"]]
        assert up["args"]["id"] == scan_id
    # written, the spans leave the store
    assert profiling.spans() == []


def test_each_trace_keeps_spans_past_the_cap_of_the_last(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    profiling.reset()
    with tempfile.TemporaryDirectory() as d:
        for i in range(3):
            with profiling.trace(os.path.join(d, str(i))):
                for _ in range(7):
                    with profiling.span("block"):
                        torch.ones(4).sum()
            (name,) = os.listdir(os.path.join(d, str(i)))
            with open(os.path.join(d, str(i), name)) as f:
                events = json.load(f)["traceEvents"]
            mine = [e for e in events if e.get("pid") == profiling.TRACK and e.get("ph") == "X"]
            assert len(mine) == 5
            assert profiling.counters()["spans_dropped"] == 2 * (i + 1)
    assert profiling.spans() == []


def _fake_library():
    """A loaded library whose entry points count their calls."""
    calls = {}

    def entry(name):
        def fn(*args):
            calls[name] = calls.get(name, 0) + 1
            return 0

        return fn

    handle = types.SimpleNamespace(**{n: entry(n) for n in _build._SIGNATURES})
    return _build._Library(handle), calls


def test_each_library_entry_points_first_call_is_timed():
    lib, calls = _fake_library()
    name = next(iter(_build._SIGNATURES))
    held = getattr(lib, name)
    assert held(1, 2) == 0
    c = profiling.counters()
    assert c["library_ns"] > 0
    with profiling.scan():  # a later call is no set-up: the scan is timed
        assert getattr(lib, name)(1, 2) == 0
        assert held(1, 2) == 0  # a reference held from before the first call
    after = profiling.counters()
    assert after["library_ns"] == c["library_ns"] and after["timed_scans"] == 1
    assert calls[name] == 3
    with profiling.scan():  # a first call inside a scan is set-up: not timed
        getattr(lib, list(_build._SIGNATURES)[1])()
    assert profiling.counters()["timed_scans"] == 1


def test_the_entry_tallies_are_counters():
    assert {"entry_leaves", "entry_grouped"} <= set(profiling.TALLIES)
    c = profiling.counters()
    assert c["entry_leaves"] == c["entry_grouped"] == 0
    with profiling.scan():
        profiling.tally("entry_leaves", 38)
        profiling.tally("entry_grouped", 37)
    c = profiling.counters()
    assert (c["entry_leaves"], c["entry_grouped"]) == (38, 37)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _helper_call(which, device, k):
    """(helper, args, kwargs) of the k-th call of a node helper on one key:
    the motion update (the state and four f32 tensors in) or the
    systematic resample (the state, the pool and the comb's start), each on
    a 2,000-particle cloud, with the variates drawn from seed k."""
    params, state, pool = scenario.build_filter(2000, device=device)
    g = torch.Generator(device=device).manual_seed(k)
    if which == "motion_update":
        def f32(*v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        normals = torch.randn((3, params.max_samples), generator=g, device=device)
        return tnode._motion_update_jit, (
            state, OdomModel.DIFF, tnode._alphas(config.AMCLConfig()), f32(0.1 * k, 0.0, 0.0),
            f32(0.1, 0.02, 0.01), normals, f32(0.1, 0.02, 0.01)), {}
    return tnode._resample_jit, (state, params, pool), dict(
        model=ResampleModel.SYSTEMATIC, log_averages=False,
        u_start=torch.rand((), generator=g, device=device))


@pytest.mark.parametrize("which", ["motion_update", "resample"])
def test_a_compiled_helpers_output_is_its_own(which, card):
    helper, args, kwargs = _helper_call(which, card, 1)
    first = helper(*args, **kwargs)
    kept = tree.map_tensors(torch.clone, first)
    helper, args, kwargs = _helper_call(which, card, 2)
    second = helper(*args, **kwargs)
    for a, b in zip(tree.leaves(first), tree.leaves(kept)):
        assert torch.equal(a, b)
    assert not torch.equal(first.poses, second.poses)


def _bytes(t):
    return t if t.dtype == torch.bool else t.reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("which", ["motion_update", "resample"])
def test_a_compiled_helper_moves_what_a_copy_per_tensor_moves(which, card):
    helper, args, kwargs = _helper_call(which, card, 3)
    out = helper(*args, **kwargs)
    entry = next(reversed(helper.entries.values()))  # the call's, the most recently used
    bound = inspect.signature(helper.__wrapped__).bind(*args, **kwargs)
    bound.apply_defaults()
    _, leaves = tree.flatten({k: v for k, v in bound.arguments.items()
                              if k not in entry.static and k not in entry.references})
    assert len(leaves) == len(entry.inputs)
    for buf, t in zip(entry.inputs, leaves):
        buf.copy_(t)
    entry.graph.replay()
    per_tensor = [None] * entry.outputs.n
    for index, flat, slots in entry.outputs.groups:
        for i, slot in zip(index, slots):
            per_tensor[i] = flat.as_strided(*slot).clone()
    for a, b in zip(tree.leaves(out), per_tensor, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bytes(a), _bytes(b))
