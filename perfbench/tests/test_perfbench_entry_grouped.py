"""The reader of the compiled entry's grouped share
(`metrics/entry_grouped_share.py`) on a stubbed recorder: the share on a
card run; nothing on the CPU, under MIN_SCANS or past the window's
untraced rest, where the rest held no graph_jit call, or where the
program has no such counters (a version that moves its tensors one by
one); and its BENCHMARK.json entry."""

import pytest

from badger_amcl_tpu_torch.utils import profiling
from perfbench import core, program
from perfbench.metrics import entry_grouped_share

COUNTERS = dict(timed_scans=100, scan_ns=800_000_000, entry_ns=450_000_000,
                sync_ns=150_000_000, captures=12, capture_ns=2_500_000_000,
                library_ns=1_250_000_000, spans_dropped=0, pool_tests=0, pool_stalls=0,
                pool_builds=0, pool_skips=9, entry_leaves=1_600, entry_grouped=1_560)


def _run(device_type="cuda", scans=400, traced=240):
    """A run of `scans` scans, the first `traced` of them traced."""
    return core.Run(latencies=[0.01] * scans, window_s=1.0, setup_s=10.0, counts={}, info={},
                    device_type=device_type, traced_scans=traced)


@pytest.fixture
def recorder(monkeypatch):
    """The program's counters, set by the test."""
    held = {"counters": dict(COUNTERS)}
    monkeypatch.setattr(profiling, "counters", lambda: dict(held["counters"]))
    return held


def test_the_share_of_tensors_moved_grouped(recorder):
    assert entry_grouped_share.read(_run()) == pytest.approx(97.5)
    recorder["counters"]["entry_grouped"] = 1_600
    assert entry_grouped_share.read(_run()) == pytest.approx(100.0)
    recorder["counters"]["entry_grouped"] = 0
    assert entry_grouped_share.read(_run()) == 0.0


def test_nothing_on_the_cpu_or_with_no_call(recorder):
    assert entry_grouped_share.read(_run("cpu")) is None
    recorder["counters"].update(entry_leaves=0, entry_grouped=0)
    assert entry_grouped_share.read(_run()) is None


def test_only_the_window_s_untraced_rest(recorder):
    # 100 timed scans, as many as the untraced rest: read
    assert entry_grouped_share.read(_run(scans=340)) == pytest.approx(97.5)
    # more timed scans than the untraced rest: the warm-up's among them
    assert entry_grouped_share.read(_run(scans=339)) is None
    # too few to read a share over
    recorder["counters"]["timed_scans"] = program.MIN_SCANS - 1
    assert entry_grouped_share.read(_run()) is None


def test_a_program_without_the_counters_reads_nothing(recorder, monkeypatch):
    for key in ("entry_leaves", "entry_grouped"):
        del recorder["counters"][key]
    assert entry_grouped_share.read(_run()) is None
    monkeypatch.delattr(profiling, "counters")
    assert entry_grouped_share.read(_run()) is None


def test_it_is_listed_as_it_declares():
    bench = core.load_json(core.ROOT, "BENCHMARK.json")
    (entry,) = [m for m in bench["per_layer"] if m["name"] == "entry_grouped_share"]
    mod = entry_grouped_share
    assert (entry["layer"], entry["unit"], entry["source"], entry["moves"]) == (
        mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES)
    assert entry["better"] == "higher"
    assert entry["workloads"] == ["amcl_2d_store.track", "amcl_3d_store.track"]
