"""PyTorch port: a resample builds the uniform pool only where a slot can
take a pool pose (w_diff > 0), on the CPU.

With both recovery alphas at 0 the first sensor update sets w_slow and
w_fast to the same average and every later one leaves them there, so
w_diff is 0: a tracking resample reads that once and passes a cached zero
pool, with no score round and no pool draw, and the recorder counts a
skip. The zero pool changes nothing: `_resample_jit` gives the same state
bit for bit as with a built pool, for systematic and multinomial
resampling and the log-space pipeline. Where w_diff > 0 (the averages
held apart, or kept apart by `set_pf_decay_rate_normal` after a global
localization) the node builds the pool with its rounds, counts a build,
and the injected slots take the pool's poses.
"""

import dataclasses

import numpy as np
import pytest
import torch

from badger_amcl_tpu_torch import config, scenario
from badger_amcl_tpu_torch.node import make_node, messages, transforms
from badger_amcl_tpu_torch.node import node as node_mod
from badger_amcl_tpu_torch.node import node_2d, node_3d
from badger_amcl_tpu_torch.pf import filter as pf_filter
from badger_amcl_tpu_torch.utils import profiling

torch.set_num_threads(1)

ANGLES = np.linspace(-2.35, 2.35, 32).astype(np.float32)
# every updating scan resamples; the pool, where built, runs score rounds
BASE = dict(min_particles=64, max_particles=256, resample_interval=1, update_min_d=0.01,
            update_min_a=0.01, odom_integrator_enabled=False, recovery_alpha_slow=0.0,
            recovery_alpha_fast=0.0, uniform_pose_starting_weight_threshold=0.5,
            uniform_pose_deweight_multiplier=0.9,
            saved_pose_filepath="/nonexistent/saved_pose.yaml")
MODELS = ("systematic", "multinomial")
KINDS = [(dim, model) for dim in ("2d", "3d") for model in MODELS] + [
    ("2d_log", "systematic"), ("2d_log", "multinomial")]


class Robot:
    """A CPU node of `kind` ("2d", "3d", or "2d_log": the log-space
    likelihood_field_prob pipeline) with its transforms and readings,
    after three tracking scans from its initial pose."""

    def __init__(self, kind, model):
        self.tf = transforms.TransformBuffer()
        cfg = dict(BASE, resample_model_type=model)
        if kind == "3d":
            occupied, cloud = scenario.scene_3d(64)
            self.tf.set_static("base_link", "lidar", transforms.Transform.identity())
            node = make_node(config.AMCLConfig.for_3d(laser_max_beams=64, **cfg),
                             tf_buffer=self.tf, seed=7, device="cpu")
            node.init_pose = np.array(scenario.TRUE_POSE_3D, float)
            node.octomap_msg_received(messages.OctomapMsg(resolution=scenario.RESOLUTION_3D,
                                                          occupied_centers=occupied))
            self.message = lambda pose, t: messages.PointCloud2(t, "lidar", cloud)
        else:
            if kind == "2d_log":
                cfg.update(laser_model_type="likelihood_field_prob",
                           laser_likelihood_log_space=True)
            self.tf.set_static("base_link", "laser", transforms.Transform.identity())
            node = make_node(config.AMCLConfig(laser_max_beams=16, **cfg), tf_buffer=self.tf,
                             seed=7, device="cpu")
            node.init_pose = np.array([0.3, -0.3, 0.2])
            node.map_msg_received(scenario.grid_msg(96))
            self.message = lambda pose, t: scenario.laser_scan(node.map, pose, ANGLES, t)
        self.node, self.steps = node, 0
        for _ in range(3):
            self.scan()

    def scan(self):
        """One scan 3 cm along x from the last; it updates and resamples."""
        node = self.node
        self.steps += 1
        pose = node.init_pose + np.array([0.03 * self.steps, 0.0, 0.0])
        t = 0.1 * self.steps
        self.tf.set_transform("odom", "base_link", t, transforms.Transform.from_pose2d(pose))
        r0 = node.resample_count
        node.scan_received(self.message(pose, t))
        assert node.resample_count in (1, r0 + 1)  # 1 after the odometry's start


@pytest.fixture(scope="module")
def robots():
    made = {}

    def get(kind, model):
        if (kind, model) not in made:
            made[kind, model] = Robot(kind, model)
        return made[kind, model]
    return get


# the node's helpers by the name the node module gives them
HELPERS = {id(h): name for name, h in (
    ("_resample_jit", node_mod._resample_jit), ("_uniform_pool_jit", node_mod._uniform_pool_jit),
    ("_score_poses_jit", node_2d._score_poses_jit), ("_score_poses_jit", node_3d._score_poses_jit),
    ("_sensor_update_jit", node_2d._sensor_update_jit),
    ("_sensor_update_jit", node_3d._sensor_update_jit),
    ("_motion_update_jit", node_mod._motion_update_jit))}


@pytest.fixture
def calls(monkeypatch):
    """The helpers the nodes call, by name, in order, with their arguments,
    and the node's host reads of a flag (("host_bool", value), as the node
    module calls it); the recorder's counters zeroed."""
    seen = []
    real, real_bool = node_mod.Node._call, node_mod.host_bool

    def call(self, helper, *args, **kwargs):
        seen.append((HELPERS[id(helper)], args, kwargs))
        return real(self, helper, *args, **kwargs)

    def host_bool(t):
        out = real_bool(t)
        seen.append(("host_bool", out, None))
        return out
    monkeypatch.setattr(node_mod.Node, "_call", call)
    monkeypatch.setattr(node_mod, "host_bool", host_bool)
    profiling.reset()
    yield seen
    profiling.reset()


def _names(seen):
    return [name for name, _, _ in seen]


def _same_state(a, b):
    """Every tensor of two states (their statistics included) equal bit for
    bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _same_state(x, y)
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), f.name


@pytest.mark.parametrize("kind,model", KINDS)
def test_a_tracking_resample_builds_no_pool(robots, calls, kind, model):
    node = robots(kind, model).node
    assert node._log_space == (kind == "2d_log")
    assert float(pf_filter._w_diff(node.state, node._log_space)) == 0.0
    profiling.reset()  # the counters of the node's own scans go
    pools = []
    for _ in range(2):
        calls.clear()
        with profiling.scan():
            node.resample_particles()
        # one read, w_diff > 0, false; no score round, no pool draw
        assert _names(calls) == ["host_bool", "_resample_jit"], _names(calls)
        assert calls[0][1] is False
        pools.append(calls[1][1][2])
    m = node.params.max_samples
    assert pools[0] is pools[1]  # cached: the same key and no allocation
    assert pools[0].shape == (m, 3) and pools[0].dtype == torch.float32
    assert not pools[0].any()
    c = profiling.counters()
    assert (c["pool_builds"], c["pool_skips"], c["pool_tests"]) == (0, 2, 0)


@pytest.mark.parametrize("kind,model", KINDS)
def test_the_zero_pool_changes_nothing(robots, kind, model):
    """The same state and variates: the zero pool and a built one give the
    same new state."""
    robot = robots(kind, model)
    robot.scan()  # an update for the resample to take
    node = robot.node
    assert float(pf_filter._w_diff(node.state, node._log_space)) == 0.0
    m = node.params.max_samples
    gen = torch.Generator().manual_seed(11)
    if model == "systematic":
        kw = dict(u_start=torch.rand((), generator=gen))
    else:
        kw = dict(u_inject=torch.rand((m,), generator=gen),
                  u_pick=torch.rand((m,), generator=gen))
    model_enum = node_mod._RESAMPLE_MODEL_MAP[node.config.resample_model_type]
    built = node.random_pose_pool()
    assert built.abs().sum() > 0
    out = [node_mod._resample_jit(node.state, node.params, pool, model=model_enum,
                                  log_averages=node._log_space, **kw)
           for pool in (torch.zeros((m, 3)), built)]
    _same_state(*out)


def _hold_apart(node):
    """w_slow and w_fast as a falling average leaves them: w_diff 0.3."""
    s = node.state
    if node._log_space:
        w_slow, w_fast = torch.zeros_like(s.w_slow), torch.full_like(s.w_fast, np.log(0.7))
    else:
        w_slow, w_fast = torch.ones_like(s.w_slow), torch.full_like(s.w_fast, 0.7)
    node.state = s.replace(w_slow=w_slow, w_fast=w_fast)
    assert float(pf_filter._w_diff(node.state, node._log_space)) == pytest.approx(0.3)


@pytest.mark.parametrize("kind,model", KINDS)
def test_where_a_slot_can_take_it_the_pool_is_built_and_injected(robots, calls, kind, model):
    robot = robots(kind, model)
    node = robot.node
    _hold_apart(node)
    profiling.reset()
    calls.clear()
    with profiling.scan():
        node.resample_particles()
    names = _names(calls)
    assert calls[0][:2] == ("host_bool", True)  # w_diff > 0
    rounds = names.count("_score_poses_jit")
    assert rounds >= 1 and names.count("_uniform_pool_jit") >= rounds
    assert names[-1] == "_resample_jit"
    c = profiling.counters()
    assert (c["pool_builds"], c["pool_skips"]) == (1, 0) and c["pool_tests"] >= 1
    _, args, kw = calls[-1]
    w_diff, pool, new = pf_filter._w_diff(args[0], node._log_space), args[2], node.state
    n = int(new.n_active)
    if model == "systematic":
        # the comb's first int(w_diff * count) slots take the pool's poses
        injected = torch.arange(n) < int(w_diff * torch.tensor(float(n)))
    else:
        injected = kw["u_inject"][:n] < w_diff
    assert injected.sum() > n // 5
    assert torch.equal(new.poses[:n][injected], pool[:n][injected])
    # the resample reset the averages, so the next update sets them equal
    robot.scan()
    assert float(pf_filter._w_diff(node.state, node._log_space)) == 0.0


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_after_a_global_localization_the_kept_averages_build_the_pool(calls, dim):
    """set_pf_decay_rate_normal puts the alphas back to 0 and keeps w_slow
    and w_fast: where the global localization left them apart, the first
    resample after it builds the pool; the next, after the reset, does
    not."""
    robot = Robot(dim, "multinomial")
    node = robot.node
    node.global_localization()
    robot.scan()
    _hold_apart(node)
    kept = node.state.w_slow, node.state.w_fast
    node.global_localization_active = False  # as on convergence
    node.deactivate_global_localization_params()
    assert float(node.state.alpha_slow) == float(node.state.alpha_fast) == 0.0
    assert (node.state.w_slow, node.state.w_fast) == kept
    profiling.reset()
    calls.clear()
    robot.scan()  # its update leaves the averages where they were
    c = profiling.counters()
    assert (c["pool_builds"], c["pool_skips"]) == (1, 0)
    assert "_score_poses_jit" in _names(calls)
    calls.clear()
    robot.scan()
    c = profiling.counters()
    assert (c["pool_builds"], c["pool_skips"]) == (1, 1)
    assert "_score_poses_jit" not in _names(calls) and "_uniform_pool_jit" not in _names(calls)


@pytest.mark.parametrize("first,second", [("pool_builds", "pool_skips"),
                                           ("pool_tests", "pool_stalls")])
def test_the_decisions_count_as_the_lagged_reads_do(first, second):
    """Each pair of tallies (the resamples' pool builds and skips, the
    lagged reads and their stalls) counts the timed scans' events: none
    outside a scan, restarted by a profiled scan and by reset."""
    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    with profiling.scan():
        for name in (first, second, second):
            profiling.tally(name)
    profiling.tally(first)  # outside every scan
    c = profiling.counters()
    assert (c[first], c[second], c["timed_scans"]) == (1, 2, 1)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.scan():
            profiling.tally(second)
    c = profiling.counters()
    assert (c[first], c[second], c["timed_scans"]) == (0, 0, 0)
    with profiling.scan():
        profiling.tally(second)
    assert profiling.counters()[second] == 1
    profiling.reset()
    assert profiling.counters()[second] == 0
