"""PyTorch port: the entry layer (cli.py, __main__.py, sim/), held against
the JAX package's.

- load_config: every field of the port's AMCLConfig equals the JAX
  loader's (through convert.config_from_jax), exact.
- The simulators: the JAX message shapes, dtypes and frames; the same
  seed gives the same stream; with the noise off the port's simulators
  give the JAX simulators' odometry exactly, Sim2D their scans within
  1e-5 m (the raycasts' f32 trig), Sim3D clouds of occupied voxel
  centers seen through the scanner mount (their index draws differ).
- The CLI: a --sim run and a --replay run (2D, and 3D with a .bt octomap
  payload) on --device cpu, the pose saved on exit; --device cuda raises
  without a card.
"""

import json
import math
import pathlib
import signal

import numpy as np
import pytest
import torch

from badger_amcl_tpu import cli as jcli
from badger_amcl_tpu import sim as jsim
from badger_amcl_tpu.node.transforms import Transform as JaxTransform
from badger_amcl_tpu_torch import cli, convert, sim
from badger_amcl_tpu_torch.maps.octree_io import write_bt
from badger_amcl_tpu_torch.node.transforms import Transform

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ["examples/amcl_2d.yaml", "examples/amcl_3d.yaml"]


@pytest.mark.parametrize("path", EXAMPLES)
def test_load_config_matches_jax(path):
    got = cli.load_config(str(ROOT / path))
    assert got == convert.config_from_jax(jcli.load_config(str(ROOT / path)))
    assert got.save_pose and got.base_frame_id == "base_footprint"


def test_load_config_default_and_empty():
    assert cli.load_config(None) == convert.config_from_jax(jcli.load_config(None))
    assert cli.load_config("/dev/null") == cli.load_config(None)


def test_sim2d_matches_jax_without_noise():
    """Zero odometry and range noise: the port's Sim2D steps, odometry TF
    and scans equal the JAX Sim2D's (scans to 1e-5 m), through a mounted
    scanner."""
    grid = jsim.make_room_grid()
    pgrid = sim.make_room_grid()
    np.testing.assert_array_equal(pgrid.data, grid.data)
    mount = (0.1, 0.05, 0.0, 0.0, 0.0, 0.3)
    js = jsim.Sim2D(grid, start_pose=(-3.0, -3.0, 0.3), n_beams=90, range_noise=0.0,
                    odom_noise=(0.0, 0.0, 0.0), scanner_mount=JaxTransform.from_xyzrpy(*mount))
    ps = sim.Sim2D(pgrid, start_pose=(-3.0, -3.0, 0.3), n_beams=90, range_noise=0.0,
                   odom_noise=(0.0, 0.0, 0.0), scanner_mount=Transform.from_xyzrpy(*mount))
    for _ in range(5):
        jo, po = js.step(0.3, 0.15), ps.step(0.3, 0.15)
        np.testing.assert_array_equal(po.pose, jo.pose)
        jscan, pscan = js.make_scan(), ps.make_scan()
        assert pscan.ranges.dtype == np.float32 and pscan.ranges.shape == (90,)
        for f in ("stamp", "frame_id", "angle_min", "angle_increment", "range_min",
                  "range_max"):
            assert getattr(pscan, f) == getattr(jscan, f), f
        np.testing.assert_allclose(pscan.ranges, np.asarray(jscan.ranges), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ps.tf.lookup("odom", "base_link", ps.t).translation,
                                  js.tf.lookup("odom", "base_link", js.t).translation)


def test_sims_shapes_frames_and_seeds():
    """With noise: the JAX shapes, dtypes and frames; one seed, one stream;
    another seed, another stream."""
    grid = sim.make_room_grid(n=120)
    occ = np.random.default_rng(0).uniform(0.0, 8.0, (500, 3))

    def run2(seed):
        s = sim.Sim2D(grid, n_beams=60, seed=seed)
        return [(s.step(0.2, 0.1).pose, s.make_scan().ranges) for _ in range(3)]

    def run3(seed):
        s = sim.Sim3D(occ, 0.1, n_points=64, seed=seed)
        return [(s.step(0.2, 0.1).pose, s.make_cloud()) for _ in range(3)]

    a, b, c = run2(1), run2(1), run2(2)
    for (pa, ra), (pb, rb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ra, rb)
    assert not np.array_equal(a[-1][1], c[-1][1])
    a, b, c = run3(2), run3(2), run3(3)
    j = jsim.Sim3D(occ, 0.1, n_points=64)
    j.step(0.2, 0.1)
    jcloud = j.make_cloud()
    for (pa, ca), (pb, cb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ca.points, cb.points)
        assert ca.points.shape == jcloud.points.shape == (64, 3)
        assert ca.points.dtype == jcloud.points.dtype and ca.frame_id == jcloud.frame_id
    assert not np.array_equal(a[-1][1].points, c[-1][1].points)


def test_sim3d_matches_jax_without_noise():
    """Zero noise: the port's Sim3D odometry equals the JAX Sim3D's, and
    every cloud point, taken back through the true pose and the mount, is
    an occupied voxel center in both simulators (their draws differ)."""
    occ = np.random.default_rng(1).uniform(0.0, 8.0, (400, 3))
    mount = (0.2, 0.0, 0.4, 0.0, 0.0, 0.5)
    js = jsim.Sim3D(occ, 0.1, n_points=32, noise=0.0, odom_noise=(0.0, 0.0, 0.0),
                    scanner_mount=JaxTransform.from_xyzrpy(*mount))
    ps = sim.Sim3D(occ, 0.1, n_points=32, noise=0.0, odom_noise=(0.0, 0.0, 0.0),
                   scanner_mount=Transform.from_xyzrpy(*mount))
    for _ in range(3):
        np.testing.assert_array_equal(ps.step(0.25, 0.2).pose, js.step(0.25, 0.2).pose)
    for s, tr in ((ps, Transform), (js, JaxTransform)):
        cloud = s.make_cloud()
        assert cloud.frame_id == "lidar" and cloud.points.shape == (32, 3)
        world = tr.from_pose2d(s.true_pose).compose(s.scanner_mount).apply(cloud.points)
        assert np.abs(world[:, None, :] - occ[None]).sum(-1).min(axis=1).max() < 1e-9


def test_cli_sim_on_cpu_saves_pose(tmp_path, monkeypatch):
    """`--config examples/amcl_2d.yaml --sim` on --device cpu: rc 0, the
    node tracks (its frames are the config's: odom -> base_footprint), and
    the pose is saved on exit in the working directory; the signal
    handlers are the caller's again."""
    monkeypatch.chdir(tmp_path)
    handler = signal.getsignal(signal.SIGTERM)
    rc = cli.main(["--config", str(ROOT / EXAMPLES[0]), "--sim", "--steps", "12",
                   "--seed", "0", "--device", "cpu"])
    assert rc == 0 and signal.getsignal(signal.SIGTERM) is handler
    saved = (tmp_path / "badger_amcl_saved_pose.yaml").read_text()
    assert "on_exit: true" in saved


def test_cli_run_returns_the_tracking_node(tmp_path, monkeypatch):
    """`cli.run` returns (rc, node): a Node2D on the CPU whose last
    published pose is within 0.3 m and 0.25 rad of the simulator's true
    path (`SIM_START`, `SIM_TWIST`) at its stamp."""
    from badger_amcl_tpu_torch.node import Node2D

    monkeypatch.chdir(tmp_path)
    rc, node = cli.run(["--config", str(ROOT / EXAMPLES[0]), "--sim", "--steps", "20",
                        "--seed", "0", "--device", "cpu"])
    assert rc == 0 and isinstance(node, Node2D) and node.state.poses.device.type == "cpu"
    s = sim.Sim2D(sim.make_room_grid(), start_pose=cli.SIM_START)
    truth = [(s.step(*cli.SIM_TWIST).stamp, s.true_pose.copy()) for _ in range(20)]
    p = node.last_published_pose
    t, true = min(truth, key=lambda tp: abs(tp[0] - p.stamp))
    assert t == p.stamp
    assert np.hypot(*(p.pose[:2] - true[:2])) < 0.3
    assert abs(math.remainder(p.pose[2] - true[2], 2 * math.pi)) < 0.25


def test_cli_device_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the node would start")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--sim", "--steps", "1", "--seed", "0"])


def _replay_2d():
    grid_n = 60
    data = np.zeros((grid_n, grid_n), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = 100
    lines = [
        {"topic": "tf_static", "parent": "base_link", "child": "laser",
         "pose": [0.0, 0.0, 0.0], "stamp": 0.0},
        {"topic": "map", "width": grid_n, "height": grid_n, "resolution": 0.1,
         "origin_x": -3.0, "origin_y": -3.0, "data": data.ravel().tolist(), "stamp": 0.0},
        {"topic": "initialpose", "pose": [0.0, 0.0, 0.0], "cov3": [0.01, 0.01, 0.005],
         "stamp": 0.0},
    ]
    b = 30
    angles = np.linspace(-1.5, 1.5, b)
    for k in range(6):
        t = 0.1 * (k + 1)
        lines.append({"topic": "tf", "parent": "odom", "child": "base_link",
                      "pose": [0.05 * k, 0.0, 0.0], "stamp": t})
        lines.append({"topic": "odom", "pose": [0.05 * k, 0.0, 0.0], "stamp": t})
        lines.append({"topic": "scan", "frame_id": "laser", "stamp": t,
                      "angle_min": float(angles[0]),
                      "angle_increment": float(angles[1] - angles[0]), "range_max": 8.0,
                      "ranges": np.full(b, 2.5).tolist()})
    return "save_pose: true\n", lines


def _replay_3d(tmp_path):
    occ = np.random.default_rng(2).uniform(0.0, 4.0, (400, 3))
    write_bt(tmp_path / "m.bt", 0.1, occ)
    lines = [
        {"topic": "tf_static", "parent": "base_link", "child": "lidar",
         "pose": [0.1, 0.0, 0.3, 0.0, 0.0, 0.0, 1.0], "stamp": 0.0},
        {"topic": "octomap", "resolution": 0.1, "stamp": 0.0,
         "binary_hex": (tmp_path / "m.bt").read_bytes().hex()},
    ]
    for k in range(5):
        t = 0.1 * (k + 1)
        lines.append({"topic": "tf", "parent": "odom", "child": "base_link",
                      "pose": [2.0 + 0.1 * k, 2.0, 0.0], "stamp": t})
        lines.append({"topic": "odom", "pose": [2.0 + 0.1 * k, 2.0, 0.0], "stamp": t})
        lines.append({"topic": "cloud", "frame_id": "lidar", "stamp": t,
                      "points": (occ[k * 40:(k + 1) * 40] - [2.0, 2.0, 0.3]).tolist()})
    lines.append({"topic": "global_localization", "stamp": 0.6})
    return ("map_type: 3\nmin_particles: 200\nmax_particles: 400\nlaser_max_beams: 32\n"
            "save_pose: true\n", lines)


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_cli_replay_on_cpu(tmp_path, monkeypatch, kind):
    """A JSONL message log (map or octomap, TF, odometry, scans or clouds,
    an initial pose, the global-localization service) replayed through the
    node on --device cpu: rc 0 and the pose saved on exit."""
    yaml_text, lines = _replay_2d() if kind == "2d" else _replay_3d(tmp_path)
    (tmp_path / "cfg.yaml").write_text(yaml_text)
    (tmp_path / "run.jsonl").write_text("\n".join(json.dumps(x) for x in lines))
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--replay", str(tmp_path / "run.jsonl"), "--seed", "1", "--config",
                   str(tmp_path / "cfg.yaml"), "--device", "cpu"])
    assert rc == 0
    assert "on_exit: true" in (tmp_path / "badger_amcl_saved_pose.yaml").read_text()
