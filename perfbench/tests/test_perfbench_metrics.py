"""The metric readers' arithmetic: the end-to-end metrics over every scan
and the whole window, the traced stretch's reduction, and the likelihood's
least time counted from shapes."""

import math

import pytest

from perfbench import core, peaks, trace
from perfbench.e2e import scan_ms_p95, scans_per_s, setup_s
from perfbench.metrics import (filter_dev_ms, graph_replays, host_syncs, idle_share,
                               likelihood_roofline, map_receipt_s, pool_rounds)


def _run(**kw):
    base = dict(latencies=[0.001] * 10, window_s=1.0, setup_s=7.5,
                counts=dict(scans=10, helper_calls=40, score_rounds=114, resamples=2, syncs=25),
                info=dict(map_receipt_s=0.25), device_type="cuda")
    base.update(kw)
    return core.Run(**base)


def test_p95_is_over_every_scan():
    # one slow scan among 20: the 95th percentile (nearest rank, the 19th) is
    # a fast one; among 10, the 10th, the slow one
    lat = [0.002] * 19 + [0.050]
    assert scan_ms_p95.read(_run(latencies=lat)) == pytest.approx(2.0)
    assert scan_ms_p95.read(_run(latencies=lat[10:])) == pytest.approx(50.0)
    assert scan_ms_p95.p95([3, 1, 2]) == 3


def test_rate_is_over_the_whole_window():
    run = _run(latencies=[0.01] * 120, window_s=1.5)
    assert scans_per_s.read(run) == pytest.approx(80.0)
    assert setup_s.read(run) == 7.5


def test_counters_per_scan_and_per_resample():
    run = _run()
    assert pool_rounds.read(run) == pytest.approx(57.0)
    assert host_syncs.read(run) == pytest.approx(2.5)
    assert graph_replays.read(run) == pytest.approx(4.0)
    assert graph_replays.read(_run(device_type="cpu")) is None
    assert pool_rounds.read(_run(counts=dict(score_rounds=0, resamples=0))) is None
    assert map_receipt_s.read(run) == 0.25


class _Ev:
    def __init__(self, name, dev, start_us, dur_us, corr, linked):
        self._v = (name, dev, start_us, dur_us, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return int(self._v[2] * 1000)

    def duration_ns(self):
        return int(self._v[3] * 1000)

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def _events():
    """A 1000 us window: a scoring span launching two kernels (one at 100 us
    for 50 us, one overlapping it), a resample span launching one, idle
    elsewhere."""
    return [
        _Ev("perfbench.window", 0, 0, 1000, 1, 0),
        _Ev("perfbench.score_poses", 0, 50, 200, 2, 0),
        _Ev("aten::copy_", 0, 60, 5, 3, 0),
        _Ev("kernel_a", 1, 100, 50, 901, 3),
        _Ev("kernel_b", 1, 120, 60, 902, 2),
        _Ev("perfbench.resample", 0, 400, 100, 4, 0),
        _Ev("kernel_c", 1, 450, 100, 903, 4),
        _Ev("perfbench.score_poses", 1, 50, 200, 905, 2),  # the span's device copy
    ]


def test_trace_reduction():
    t = trace.reduce(_events())
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(180e-6)  # [100, 180] and [450, 550]
    assert t.device_s(("score_poses",)) == pytest.approx(110e-6)
    assert t.device_s(("resample",)) == pytest.approx(100e-6)
    assert [n for n, _ in t.top_ops()] == ["kernel_c", "kernel_b", "kernel_a"]
    gaps = dict(t.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(1e-3 - 180e-6)
    # [0, 100] idles in score_poses, [180, 450] between spans at its middle, [550,
    # 1000] too
    assert gaps["score_poses"] == pytest.approx(100e-6)


def test_idle_share_and_filter_time():
    t = trace.reduce(_events())
    run = _run(trace=t, traced_scans=4)
    assert idle_share.read(run) == pytest.approx(82.0)
    assert filter_dev_ms.read(run) == pytest.approx(0.1 / 4)


def test_likelihood_roofline_counts_at_a_tiny_shape():
    t = trace.reduce(_events())
    # 8 poses x 5 beams on the 2D field: 8 * 12 + 40 * 4 + 8 * 4 bytes, 40 * 12 ops;
    # 4 poses x 3 points on the 3D table: 4 * 12 + 12 * 1 + 4 * 4 bytes, 12 * 16 ops
    run = _run(trace=t, work=[(8, 40, 4), (4, 12, 1)])
    least = (max(288 / 3.35e12, 480 / 67e12) + max(76 / 3.35e12, 192 / 67e12))
    want = 100 * least / 110e-6
    assert likelihood_roofline.read(run) == pytest.approx(want)
    assert peaks.least_s(288, 480) == pytest.approx(288 / 3.35e12)
    assert likelihood_roofline.read(_run()) is None
    assert math.isfinite(want) and want < 100
