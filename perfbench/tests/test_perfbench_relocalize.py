"""The relocalize traffic on the CPU at a size a test can hold: the kidnap
leaves the track traffic's stream as it was; a relocalizing node comes
out correct with its global localization's steps compared under the map
factors it used, and the same records held to the normal factors do not;
and every window has a score to compare, whether or not the node ran a
score round, without the window's counts seeing it. The check of the
Gompertz cells is handed and reads what it did before it had the node's
other models, bit for bit."""

import copy
import dataclasses
import hashlib
import types

import numpy as np
import pytest
import torch

from perfbench import core
from perfbench.drivers import node as node_driver
from perfbench.gen import route
from perfbench.reference import check
from perfbench.tests.conftest import SMALL_2D, SMALL_3D

SEED = 2 ** 31 + 5
RELOCALIZE = core.load_json(core.HERE, "traffic", "relocalize.json")
CELLS = {"amcl_2d_store.track": SMALL_2D, "amcl_3d_store.track": SMALL_3D}


def _stream_without_kidnaps(lap, steps, seed, rate_hz, odom_noise):
    """The stream as the benchmark made it before it had kidnaps."""
    n = len(lap.poses)
    rng = np.random.default_rng(seed + 20)
    first = int(rng.integers(0, n))
    idx = (first + np.arange(steps)) % n
    step = route._relative(lap.poses[np.roll(idx, 1)], lap.poses[idx])
    step += np.random.default_rng(seed + 21).standard_normal((steps, 3)) * np.asarray(odom_noise)
    step[0] = 0.0
    x0, y0, th0 = lap.poses[first]
    th = th0 + np.cumsum(step[:, 2])
    th_prev = np.concatenate([[th0], th[:-1]])
    c, s = np.cos(th_prev), np.sin(th_prev)
    odom = np.empty((steps, 3))
    odom[:, 0] = x0 + np.cumsum(c * step[:, 0] - s * step[:, 1])
    odom[:, 1] = y0 + np.cumsum(s * step[:, 0] + c * step[:, 1])
    odom[:, 2] = np.arctan2(np.sin(th), np.cos(th))
    return idx.astype(np.int64), odom


LAP = route.gondola_loop((2000, 1200), 0.05, 0, 0.5, 15.0, 1.0, 0.5)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_the_stream_without_kidnaps_is_as_before(seed):
    idx, odom = _stream_without_kidnaps(LAP, 3000, seed, 15.0, [0.002, 0.002, 0.001])
    for every in (None, 0):
        s = route.stream(LAP, 3000, seed, 15.0, [0.002, 0.002, 0.001], every)
        assert np.array_equal(s.lap_index, idx) and np.array_equal(s.odom, odom)


def test_a_kidnap_jumps_a_quarter_lap_and_the_odometry_goes_on():
    n, every = len(LAP.poses), 60
    s = route.stream(LAP, 1000, SEED, 15.0, [0.002, 0.002, 0.001], every)
    at = route.kidnap_steps(1000, every)
    assert list(at) == list(range(60, 1000, 60))
    moved = np.diff(s.lap_index) % n
    kidnapped = np.isin(np.arange(1, 1000), at)
    assert np.all(moved[~kidnapped] == 1)
    assert np.all((moved[kidnapped] - 1) % n >= n // 4)
    assert np.all((-(moved[kidnapped] - 1)) % n >= n // 4)
    # the odometry moves one lap step at a kidnap too
    d = np.hypot(*np.diff(s.odom[:, :2], axis=0).T)
    assert d.max() < 0.05
    again = route.stream(LAP, 1000, SEED, 15.0, [0.002, 0.002, 0.001], every)
    assert np.array_equal(again.lap_index, s.lap_index)


def _step_clock(monkeypatch):
    """The driver's clock moves 2**-10 s a reading, so a window holds the
    same steps on every machine."""
    now = [0.0]

    def perf_counter():
        now[0] += 2.0 ** -10
        return now[0]
    monkeypatch.setattr(node_driver, "time", types.SimpleNamespace(perf_counter=perf_counter))


def _spy_records(monkeypatch):
    """What the check is handed: the records, the configuration and the
    rest of its arguments, and the check itself."""
    real = check.readings
    seen = {"real": real}

    def readings(records, config, *args, **kwargs):
        seen.update(records=records, config=config, args=args)
        return real(records, config, *args, **kwargs)
    monkeypatch.setattr(check, "readings", readings)
    return seen


# the steps a track window of 0.6 s on the step clock sampled before the
# benchmark had kidnaps (2D cell at SMALL_2D, no score rounds, SEED): the
# window's steps 45-249; the first step (the longest, on this clock) is
# added to the resamples
TRACK_STEPS = {"updates": [45, 159, 106, 208, 202, 117, 166, 173, 147, 184, 151, 249],
               "resamples": [205, 246, 198, 219, 72, 79, 86, 92, 163, 141, 169, 192, 45]}

# what the check of the two Gompertz cells was handed and read in that
# window before the check had the node's other models: the sha256 of each
# sample's tensors, arrays and values (`_digest`), and the program's
# readings; with and without the uniform pool's score rounds
PARENT = {
    ("amcl_2d_store.track", False): (
        {"resamples": "9933d086530eef294ee26339cc7fcdc67280d072c5c96d6de06286f1a9a51d95",
         "scores": "539f9e75b8d9675cb6a2e98910d4dae09233adec31b6f7d988ba67e7bd4498f8",
         "updates": "65de9d12a570116d902af747ff90386b0deb30f3e463506de50abc4fae362084"},
        {"weights_rel": 0.004633771620241563, "score_rel": 3.7857154396736114e-07,
         "kld_count": 0, "draw_gap": 0.0, "motion_m": 2.845392946918704e-06,
         "motion_yaw_rel": 1.0160660170404574e-07, "pose_m": 9.973247001525273e-07,
         "pose_rad": 6.64322352683655e-08, "cov_abs": 2.2781205075261823e-05}),
    ("amcl_2d_store.track", True): (
        {"resamples": "d6df70856e76e22ff8bbd26fb7d369001e1911e9b5f74154b402e425e02f6155",
         "scores": "2041359d829ec46367642974cf28eb4740ac042810cb1d0f39d146b1ba693886",
         "updates": "83339747bec4d7c1140485b6762d1d3c843e46585af9ce3d0e32ef7f07cb77dc"},
        {"weights_rel": 0.00394187191419528, "score_rel": 4.808627882693899e-07,
         "kld_count": 0, "draw_gap": 0.0, "motion_m": 2.776201410831646e-06,
         "motion_yaw_rel": 1.0183946824105596e-07, "pose_m": 1.5322443738756345e-06,
         "pose_rad": 7.980744864966029e-08, "cov_abs": 6.119649236779878e-05}),
    ("amcl_3d_store.track", False): (
        {"resamples": "f369eef930827dd54b5f723c176b6742e67e53476ba3c92f3d818aa2fa71a0dd",
         "scores": "488b92104e81dde8835389b751b957283d0dada0e9c49007c1c2a7107bc2f2e2",
         "updates": "48ce7e9140ce33168338b67a9e548dc75053348f85df0b5e15b64b72c6e73452"},
        {"weights_rel": 0.0031025825931574554, "score_rel": 9.138241898868328e-07,
         "kld_count": 0, "draw_gap": 0.0, "motion_m": 2.7951920536202304e-06,
         "motion_yaw_rel": 9.204761106803853e-08, "pose_m": 1.4785884315262283e-06,
         "pose_rad": 1.1021127344079673e-07, "cov_abs": 5.1594430146906234e-05}),
    ("amcl_3d_store.track", True): (
        {"resamples": "2165fb4bf3a119fc3409d6ec74adc4f17aae460c178932b6f8a3b4c6bebed6ab",
         "scores": "d4ccf21e0bc1a388cd83e35031cf1ba5de40022bad852427e9d6ab9abb707613",
         "updates": "d893b46ffa067b503819e0ef5ae9169a080f4f1f998663b53456b93d51b33b4b"},
        {"weights_rel": 0.008504993273350532, "score_rel": 9.138241898868328e-07,
         "kld_count": 0, "draw_gap": 0.0, "motion_m": 2.8300437823700626e-06,
         "motion_yaw_rel": 9.727292831443066e-08, "pose_m": 1.8835156209094677e-06,
         "pose_rad": 9.847511339700077e-08, "cov_abs": 4.337435569823356e-05}),
}


def _feed(h, obj) -> None:
    """Hash obj into h: tensors and arrays by dtype, shape and bytes; dicts
    by sorted key; lists and dataclasses in order; anything else by its
    repr."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        h.update(f"T{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    elif isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        h.update(f"A{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    elif isinstance(obj, dict):
        for k in sorted(obj):
            h.update(f"K{k}".encode())
            _feed(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        h.update(f"L{len(obj)}".encode())
        for v in obj:
            _feed(h, v)
    elif dataclasses.is_dataclass(obj):
        h.update(type(obj).__name__.encode())
        for f in dataclasses.fields(obj):
            h.update(f"F{f.name}".encode())
            _feed(h, getattr(obj, f.name))
    else:
        h.update(repr(obj).encode())


def _digest(samples) -> str:
    h = hashlib.sha256()
    _feed(h, samples)
    return h.hexdigest()


@pytest.mark.parametrize("workload,score_rounds", sorted(PARENT))
def test_the_track_windows_sample_is_as_before(monkeypatch, workload, score_rounds):
    _step_clock(monkeypatch)
    seen = _spy_records(monkeypatch)
    ov = copy.deepcopy(CELLS[workload])
    if not score_rounds:
        ov["config"]["params"]["uniform_pose_starting_weight_threshold"] = 0.0
    _, _, read = core.run_cell(workload, SEED, 0.6, False, device="cpu", overrides=ov)
    if (workload, score_rounds) == ("amcl_2d_store.track", False):
        got = {k: [r["n"] for r in seen["records"][k]] for k in TRACK_STEPS}
        assert got == TRACK_STEPS
    digests, program = PARENT[workload, score_rounds]
    assert {k: _digest(v) for k, v in seen["records"].items()} == digests
    assert read["program"] == program


@pytest.fixture(scope="module")
def relocalized():
    """A relocalize run of a cell's configuration at a test's size, a
    kidnap every 2 s (30 / 20 steps), once a module: (result, log,
    readings, what the check was handed)."""
    runs = {}

    def run(workload):
        if workload not in runs:
            with pytest.MonkeyPatch.context() as mp:
                seen = _spy_records(mp)
                ov = copy.deepcopy(CELLS[workload])
                ov["traffic"] = dict(RELOCALIZE, **ov["traffic"], kidnap_every_s=2.0)
                result, log, read = core.run_cell(workload, SEED, 3.0, False, device="cpu",
                                                  overrides=ov)
            runs[workload] = result, log, read, seen
        return runs[workload]
    return run


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_relocalizing_node_is_correct(relocalized, workload):
    result, log, read, seen = relocalized(workload)
    assert result["correct"], log
    assert seen["records"]["global_updates"] and seen["records"]["global_resamples"]
    for name in ("weights_rel", "kld_count", "draw_gap", "score_rel"):
        assert read["global_counts"][name] >= 1, read["global_counts"]
        assert read["phases"]["global"][name] is not None
    assert any(line.startswith("compared in global localization") for line in log)
    assert log[-1].startswith("check cov_abs") and "global" in log[-1]


def test_the_normal_factors_fail_a_relocalizing_2d_node(relocalized):
    """The 2D node's global localization scores with other map factors
    than tracking (off map 0.001, not free 0.25): the same records held to
    the normal factors fail. (The 3D node's two sets differ only off the
    map, 0.95 against 1.0: no test can tell them apart by a limit.)"""
    result, log, read, seen = relocalized("amcl_2d_store.track")
    assert result["correct"], log
    config = copy.deepcopy(seen["config"])
    off, non_free, _ = config["factors"]["normal"]
    config["params"].update(global_localization_laser_off_map_factor=off,
                            global_localization_laser_non_free_space_factor=non_free)
    wrong = seen["real"](seen["records"], config, *seen["args"])
    limits = core.load_json(core.HERE, "limits", "amcl_2d_store.track.json")
    ok, rows = check.verdict(wrong["program"], limits)
    assert not ok
    assert wrong["phases"]["global"]["weights_rel"] > limits["weights_rel"], rows


def test_every_window_has_a_score_and_its_counts_do_not_see_it(monkeypatch):
    """With no score round in the window (no score rejection), the pool the
    driver scores after it gives `score_rel` its reading; the driver's
    counts stay as the window left them."""
    seen = {}
    real = node_driver.NodeDriver.after_window

    def after_window(self):
        before = dict(self.counts)
        out = real(self)
        seen.update(before=before, after=dict(self.counts), out=out)
        return out
    monkeypatch.setattr(node_driver.NodeDriver, "after_window", after_window)
    ov = copy.deepcopy(SMALL_2D)
    ov["config"]["params"]["uniform_pose_starting_weight_threshold"] = 0.0
    result, log, read = core.run_cell("amcl_2d_store.track", SEED, 1.0, False, device="cpu",
                                      overrides=ov)
    assert result["correct"], log
    assert read["counts"]["score_rel"] == 1
    assert seen["before"] == seen["after"] and len(seen["out"]["scores"]) == 1
    assert seen["out"]["scores"][0]["poses"].shape[0] == ov["config"]["params"]["max_particles"]
