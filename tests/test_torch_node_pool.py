"""PyTorch port: the uniform pool's score rejection (`Node.random_pose_pool`)
with its stop test read a round late (`numerics.LaggedFlags`), on the CPU.

The pipelined loop queues round r before it reads round r-1's flag, so it
may score one round more than a loop that tests before each draw; it must
return the same pool bit for bit and leave the node's generator where that
loop leaves it. Held against that loop, written out here, on a 2D and a 3D
CPU node after two scans, and on scores stubbed to accept every slot at a
chosen round (the 100-round cap's edges included). A lagged read is one
counted host sync, one `sync` region and one of the recorder's
`pool_tests`.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from badger_amcl_tpu_torch import config, scenario
from badger_amcl_tpu_torch.node import make_node, messages, transforms
from badger_amcl_tpu_torch.utils import numerics, profiling

torch.set_num_threads(1)

ANGLES = np.linspace(-2.35, 2.35, 32).astype(np.float32)
LIMITS = dict(min_particles=64, max_particles=256,
              saved_pose_filepath="/nonexistent/saved_pose.yaml")
# (starting threshold, multiplier) by case and node; scores on these nodes
# lie in 1.0-9.4 (2D) and 0.45-0.52 (3D)
CASES = {
    "round_one": {"2d": (0.1, 0.9), "3d": (0.1, 0.9)},
    "several_rounds": {"2d": (4.0, 0.9), "3d": (0.5, 0.98)},
    "cap": {"2d": (100.0, 0.99), "3d": (10.0, 0.99)},
    "no_threshold": {"2d": (0.0, 0.9), "3d": (0.0, 0.9)},
    "no_scan": {"2d": (0.8, 0.98), "3d": (0.8, 0.98)},
}
# the rounds the sequential loop scores, by case
ROUNDS = {"round_one": lambda n: n == 1, "several_rounds": lambda n: 1 < n < 100,
          "cap": lambda n: n == 100, "no_threshold": lambda n: n == 0,
          "no_scan": lambda n: n == 1}


def _drive(node, tf, message):
    """Two scans from the node's initial pose: the odometry's start, then
    an update."""
    pose = node.init_pose
    for k in (1, 2):
        t = 0.1 * k
        tf.set_transform("odom", "base_link", t, transforms.Transform.from_pose2d(pose))
        node.scan_received(message(node, pose, t))
    return node


def _node_2d():
    tf = transforms.TransformBuffer()
    tf.set_static("base_link", "laser", transforms.Transform.identity())
    node = make_node(config.AMCLConfig(laser_max_beams=16, **LIMITS), tf_buffer=tf, seed=7,
                     device="cpu")
    node.init_pose = np.array([0.3, -0.3, 0.2])
    node.map_msg_received(scenario.grid_msg(96))
    return _drive(node, tf, lambda n, pose, t: scenario.laser_scan(n.map, pose, ANGLES, t))


def _node_3d():
    occupied, cloud = scenario.scene_3d(64)
    tf = transforms.TransformBuffer()
    tf.set_static("base_link", "lidar", transforms.Transform.identity())
    node = make_node(config.AMCLConfig.for_3d(laser_max_beams=64, **LIMITS), tf_buffer=tf,
                     seed=7, device="cpu")
    node.init_pose = np.array(scenario.TRUE_POSE_3D, float)
    node.octomap_msg_received(messages.OctomapMsg(resolution=scenario.RESOLUTION_3D,
                                                  occupied_centers=occupied))
    return _drive(node, tf, lambda n, pose, t: messages.PointCloud2(t, "lidar", cloud))


@pytest.fixture(scope="module")
def nodes():
    return {"2d": _node_2d(), "3d": _node_3d()}


def _sequential_pool(node, m):
    """The rejection loop with its test before each draw."""
    poses = node._draw_pool(m)
    thr0 = node.config.uniform_pose_starting_weight_threshold
    mult = node.config.uniform_pose_deweight_multiplier
    if thr0 > 0.0 and 0.0 <= mult < 1.0:
        thr = torch.full((m,), thr0, dtype=torch.float32, device=node.device)
        accepted = torch.zeros((m,), dtype=torch.bool, device=node.device)
        for _ in range(100):
            accepted = accepted | (node.score_poses(poses) >= thr)
            if bool(accepted.all()):
                break
            poses = torch.where(accepted[:, None], poses, node._draw_pool(m))
            thr = torch.where(accepted, thr, thr * mult)
    return poses


def _both_ways(node, monkeypatch, thr0, mult, score=None):
    """((pool, next draw, score calls) of the sequential loop, the same of
    the node's), each from the same generator state; score(poses, r), where
    given, stands for the node's scores in round r."""
    monkeypatch.setattr(node, "config", node.config.replace(
        uniform_pose_starting_weight_threshold=thr0, uniform_pose_deweight_multiplier=mult))
    real, calls = node.score_poses, [0]
    score = score or (lambda poses, r: real(poses))

    def counted(poses):
        calls[0] += 1
        return score(poses, calls[0])

    monkeypatch.setattr(node, "score_poses", counted)
    gen, m = node.generator, node.params.max_samples
    start = gen.get_state()
    out = []
    for pool in (_sequential_pool, lambda n, m: n.random_pose_pool(m)):
        gen.set_state(start)
        calls[0] = 0
        poses = pool(node, m)
        out.append((poses, torch.rand((m,), generator=gen, device=node.device), calls[0]))
    return out


def _assert_same(want, got):
    (pool_w, next_w, calls_w), (pool_g, next_g, calls_g) = want, got
    assert torch.equal(pool_g, pool_w)
    assert torch.equal(next_g, next_w)  # the generator's stream as the sequential loop's
    assert calls_w <= calls_g <= calls_w + 1


@pytest.mark.parametrize("dim", ["2d", "3d"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_pipelined_pool_is_the_sequential_one(nodes, monkeypatch, dim, case):
    node = nodes[dim]
    if case == "no_scan":  # every score 1
        monkeypatch.setattr(node, "latest_scan" if dim == "2d" else "latest_points_base", None)
    want, got = _both_ways(node, monkeypatch, *CASES[case][dim])
    assert ROUNDS[case](want[2]), want[2]
    _assert_same(want, got)
    if case == "cap":
        assert got[2] == 100


@pytest.mark.parametrize("last_round", [1, 2, 57, 99, 100, None])
def test_the_rounds_end_where_the_sequential_loop_ends(nodes, monkeypatch, last_round):
    """Scores stubbed so that slot i passes from round 1 + i % last_round
    on: every slot by round `last_round`, or, where it is None, slot 0
    never. The threshold stays above 0 through 100 rounds of 0.9."""
    node = nodes["2d"]
    m = node.params.max_samples
    first = (1 + torch.arange(m, device=node.device) % (last_round or 100)).float()
    if last_round is None:
        first[0] = 1000.0
    want, got = _both_ways(node, monkeypatch, 0.5, 0.9,
                           score=lambda poses, r: (first <= r).float())
    assert want[2] == (last_round or 100)
    _assert_same(want, got)


@pytest.fixture
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def test_a_lagged_read_is_one_counted_sync(fresh):
    flags, s0 = numerics.LaggedFlags(), numerics.SYNCS.count
    with profiling.scan():
        # as the pool uses them: each flag read after the next one started
        first = flags.start(torch.tensor(True))
        second = flags.start(torch.tensor(False))
        assert numerics.SYNCS.count == s0  # starting reads nothing
        assert numerics.host_bool(first) is True
        third = flags.start(torch.tensor(True))
        assert [numerics.host_bool(f) for f in (second, third)] == [False, True]
    assert numerics.SYNCS.count == s0 + 3
    c = profiling.counters()
    assert (c["pool_tests"], c["pool_stalls"]) == (3, 0)  # a CPU flag is there at once
    assert c["timed_scans"] == 1 and c["sync_ns"] > 0
    # each read is a sync span under a profiler, and a profiled scan
    # restarts the lagged-read counts with the other timed counters
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.scan():
            flag = flags.start(torch.tensor(False))
            assert numerics.host_bool(flag) is False
    assert sum(s.name == "sync" for s in profiling.spans()) == 1
    c = profiling.counters()
    assert (c["pool_tests"], c["pool_stalls"], c["timed_scans"]) == (0, 0, 0)
    # outside a scan a read counts a sync but no lagged read
    numerics.host_bool(flags.start(torch.tensor(True)))
    assert profiling.counters()["pool_tests"] == 0


def test_the_pool_reads_each_stop_test_late(nodes, monkeypatch, fresh):
    node = nodes["2d"]
    monkeypatch.setattr(node, "config", node.config.replace(
        uniform_pose_starting_weight_threshold=4.0, uniform_pose_deweight_multiplier=0.9))
    s0 = numerics.SYNCS.count
    with profiling.scan():
        node.random_pose_pool()
    c = profiling.counters()
    assert 1 < c["pool_tests"] == numerics.SYNCS.count - s0 and c["pool_stalls"] == 0
