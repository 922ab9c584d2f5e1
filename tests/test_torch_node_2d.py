"""PyTorch port: the 2D node (config, messages, transforms, scan prep,
persistence, the node base and Node2D, checkpoints), held against the JAX
package's node on one message stream recorded from the JAX `Sim2D`.

The JAX node runs on "xla" and the port's on "exact" (both "auto" on the
CPU). The port's node draws from its own torch.Generator, so the tests
compare what does not depend on draws bit for bit, and the filter only on
the deterministic pipeline: zero-noise odometry, no resample (interval
above the scan count), the port's state converted from the JAX node's.

Tolerances:
- gating decisions, integrated odometry, scan prep arrays, the published
  pose (the max-weight cluster of the converted statistics), the map->odom
  TF and the saved-pose file: exact (host numpy, and f32 angle arithmetic
  through the C library as XLA's CPU float32 trig);
- weights rtol 1e-5, the published particle cloud 1e-5 m: the motion
  update's and the likelihood's f32 trig differ in the last ulp between
  XLA and PyTorch;
- the uniform pose pool 1e-6 (one ulp): XLA's CPU compile fuses its
  multiply-adds;
- localization: the JAX test_tracking_all_models bounds (0.3 m, 0.25 rad).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badger_amcl_tpu.config import AMCLConfig as JaxConfig
from badger_amcl_tpu.node import checkpoint as jcheckpoint
from badger_amcl_tpu.node import make_node as jax_make_node
from badger_amcl_tpu.node import scan_prep as jscan_prep
from badger_amcl_tpu.node.node import _uniform_pool_jit
from badger_amcl_tpu.node.transforms import Transform as JaxTransform
from badger_amcl_tpu.node.transforms import TransformBuffer as JaxTransformBuffer
from badger_amcl_tpu.sim import Sim2D, make_room_grid
from badger_amcl_tpu_torch import config as tconfig
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch.node import make_node, scan_prep
from badger_amcl_tpu_torch.node.node import pool_index, uniform_poses
from badger_amcl_tpu_torch.node.transforms import Transform, TransformBuffer
from badger_amcl_tpu_torch.ops import corr_kernel

torch.set_num_threads(1)

START = (-3.0, -3.0, 0.3)
BASE = dict(min_particles=100, max_particles=1000, laser_max_beams=40, update_min_d=0.05,
            update_min_a=0.05, odom_alpha1=0.05, odom_alpha2=0.05, odom_alpha3=0.05,
            odom_alpha4=0.05, odom_alpha5=0.05)
STEPS = 25


@pytest.fixture(scope="module")
def stream():
    """(grid, [(t, odom pose, Odometry, LaserScan)]) of tests/test_node_2d.py's
    `_mk` + `_drive` (160^2 room at 0.075 m, 120 ranges, v 0.3, w 0.15),
    recorded from the JAX Sim2D with its true poses."""
    grid = make_room_grid(n=160, resolution=0.075, n_pillars=8)
    sim = Sim2D(grid, start_pose=START, n_beams=120)
    steps = [(0.0, sim.odom_pose.copy(), None, None, sim.true_pose.copy())]
    for _ in range(STEPS):
        odom = sim.step(0.3, 0.15)
        steps.append((sim.t, sim.odom_pose.copy(), odom, sim.make_scan(),
                      sim.true_pose.copy()))
    return grid, steps


def _nodes(grid, overrides, port=None, init_cov=(0.25, 0.25, 0.05)):
    """(jax node, jax tf, port node, port tf) built from one config (the
    port's with `port` replaced), with _mk's initial pose and covariance
    unless `init_cov` is given, after the same map message."""
    jcfg = JaxConfig.for_2d(**{**BASE, **overrides})
    cfg = convert.config_from_jax(jcfg).replace(**(port or {}))
    out = []
    for make, tfb, tr, msg, kw in (
            (jax_make_node, JaxTransformBuffer(), JaxTransform, grid, {}),
            (make_node, TransformBuffer(), Transform, convert.message_from_jax(grid),
             {"device": "cpu"})):
        tfb.set_static("base_link", "laser", tr.identity())
        node = make(jcfg if make is jax_make_node else cfg, tf_buffer=tfb, **kw)
        node.init_pose = np.asarray(START, float)
        node.init_cov = np.asarray(init_cov)
        node.map_msg_received(msg)
        out += [node, tfb]
    return out


def _feed(node, tfb, tr, step, port):
    t, odom_pose, odom, scan, _ = step
    tfb.set_transform("odom", "base_link", t, tr.from_pose2d(odom_pose))
    if odom is None:
        return
    node.integrate_odom(convert.message_from_jax(odom) if port else odom)
    node.scan_received(convert.message_from_jax(scan) if port else scan)
    node.spin_once(t)


def _record(node):
    out = {k: [] for k in ("amcl_pose", "particlecloud", "tf", "amcl_absolute_motion",
                           "amcl_map_odom_transform")}
    for k, v in out.items():
        node.subscribe_output(k, v.append)
    return out


def test_deterministic_pipeline_matches(stream, tmp_path):
    """Zero-noise odometry, no resample, the port's state converted from
    the JAX node's: gating, integrated odometry, published outputs and the
    saved pose equal, weights and particle clouds within 1e-5."""
    grid, steps = stream
    overrides = dict(odom_alpha1=0.0, odom_alpha2=0.0, odom_alpha3=0.0, odom_alpha4=0.0,
                     odom_alpha5=0.0, resample_interval=1000, save_pose=True)
    jn, jtf, tn, ttf = _nodes(grid, overrides)
    jn.config = jn.config.replace(saved_pose_filepath=str(tmp_path / "jax.yaml"))
    tn.config = tn.config.replace(saved_pose_filepath=str(tmp_path / "port.yaml"))
    assert torch.equal(tn.map.cells, torch.from_numpy(np.array(jn.map.cells)))
    np.testing.assert_array_equal(tn.map.distances.numpy(), np.asarray(jn.map.distances))
    np.testing.assert_array_equal(tn.free_space_indices.numpy(),
                                  np.asarray(jn.free_space_indices))
    tn.state = convert.state_from_numpy(jn.state, device="cpu")
    jout, tout = _record(jn), _record(tn)
    for k, step in enumerate(steps[:13]):
        _feed(jn, jtf, JaxTransform, step, False)
        _feed(tn, ttf, Transform, step, True)
        assert tn.resample_count == jn.resample_count, k
        np.testing.assert_array_equal(tn.pf_odom_pose, jn.pf_odom_pose)
        np.testing.assert_array_equal(tn.odom_integrator_absolute_motion,
                                      jn.odom_integrator_absolute_motion)
        np.testing.assert_allclose(tn.state.weights.numpy(), np.asarray(jn.state.weights),
                                   rtol=1e-5, atol=0)
        for f in ("w_slow", "w_fast"):
            np.testing.assert_allclose(float(getattr(tn.state, f)),
                                       float(getattr(jn.state, f)), rtol=1e-5)
    assert 3 <= jn.resample_count < 13  # some scans were gated out
    for k in jout:
        assert len(tout[k]) == len(jout[k]) > 0, k
    for a, b in zip(tout["amcl_absolute_motion"], jout["amcl_absolute_motion"]):
        assert (a.x, a.y, a.theta) == (b.x, b.y, b.theta)
    for a, b in zip(tout["particlecloud"], jout["particlecloud"]):
        assert a.poses.shape == b.poses.shape and a.stamp == b.stamp
        np.testing.assert_allclose(a.poses, b.poses, rtol=0, atol=1e-5)
    for a, b in zip(tout["amcl_pose"], jout["amcl_pose"]):
        np.testing.assert_array_equal(a.pose, b.pose)
        np.testing.assert_array_equal(a.covariance, b.covariance)
    for a, b in zip(tout["tf"], jout["tf"]):
        assert (a.stamp, a.frame_id, a.child_frame_id) == (b.stamp, b.frame_id,
                                                           b.child_frame_id)
        np.testing.assert_array_equal(a.translation, b.translation)
        np.testing.assert_array_equal(a.rotation, b.rotation)
    for a, b in zip(tout["amcl_map_odom_transform"], jout["amcl_map_odom_transform"]):
        np.testing.assert_array_equal(a.pose, b.pose)
    jn.shutdown(steps[12][0])
    tn.shutdown(steps[12][0])
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    np.testing.assert_array_equal(tn.latest_pose.pose, jn.latest_pose.pose)


def test_scan_prep_and_transforms_match(stream):
    """prepare_scan for every model's decimation and an upside-down mount,
    and the transform algebra, bit for bit."""
    _, steps = stream
    scan = steps[3][3]
    tscan = convert.message_from_jax(scan)
    for mount in ((0.1, 0.0, 0.0, 0.0), (0.2, -0.1, math.pi, 0.4)):
        x, y, roll, yaw = mount
        jm = JaxTransform.from_xyzrpy(x, y, 0.0, roll, 0.0, yaw)
        tm = Transform.from_xyzrpy(x, y, 0.0, roll, 0.0, yaw)
        for model in ("beam", "likelihood_field", "likelihood_field_prob"):
            want = jscan_prep.prepare_scan(scan, jm, 0.1, 7.0, 40,
                                           JaxConfig(laser_model_type=model).laser_model_type)
            got = scan_prep.prepare_scan(tscan, tm, 0.1, 7.0, 40,
                                         tconfig.AMCLConfig(laser_model_type=model)
                                         .laser_model_type)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    # a 720-range scan at 720 beams keeps every range (the decimation quirk)
    assert len(scan_prep.decimation_indices(720, 720, tconfig.PlanarModelType.BEAM)) == 720
    a = Transform.from_pose2d([0.3, -1.2, 2.9]).compose(Transform.from_xyzrpy(0.1, 0.2, 0.0))
    b = JaxTransform.from_pose2d([0.3, -1.2, 2.9]).compose(JaxTransform.from_xyzrpy(0.1, 0.2))
    np.testing.assert_array_equal(a.inverse().translation, b.inverse().translation)
    np.testing.assert_array_equal(a.inverse().rotation, b.inverse().rotation)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_tracking_localizes(stream, package):
    """test_tracking_all_models' likelihood-field path: each node ends
    within 0.3 m and 0.25 rad of the true pose."""
    grid, steps = stream
    jn, jtf, tn, ttf = _nodes(grid, {})
    node, tfb, tr = (jn, jtf, JaxTransform) if package == "jax" else (tn, ttf, Transform)
    for step in steps:
        _feed(node, tfb, tr, step, package == "torch")
    _, est = node.get_max_weight_pose()
    true = steps[-1][4]
    assert math.hypot(est[0] - true[0], est[1] - true[1]) < 0.3
    assert abs(math.remainder(est[2] - true[2], 2 * math.pi)) < 0.25


def test_systematic_and_global_localization(stream):
    """The port's node with systematic resampling keeps tracking; the
    global-localization service then scatters max_particles over free
    space with the gl factors, and a few scans run on."""
    grid, steps = stream
    _, _, tn, ttf = _nodes(grid, {"resample_model_type": "systematic"})
    for step in steps[:14]:
        _feed(tn, ttf, Transform, step, True)
    _, est = tn.get_max_weight_pose()
    assert math.hypot(est[0] - steps[13][4][0], est[1] - steps[13][4][1]) < 0.3
    tn.global_localization()
    assert tn.global_localization_active and int(tn.state.n_active) == 1000
    ij = tn.map.world_to_map(tn.state.poses[:, :2])
    assert (tn.map.cell_state_at(ij) == -1).all()
    for step in steps[14:18]:
        _feed(tn, ttf, Transform, step, True)
    assert torch.isfinite(tn.state.weights).all()


def test_uniform_pool_matches_and_clamps():
    """The uniform pose pool against the JAX jit on its own draws (to one
    ulp); the f32 index (u * F) clamped to F - 1 at u = 1 - 2^-24 and at
    u = 1, where the JAX gather clamps."""
    rng = np.random.default_rng(0)
    fsi = rng.integers(0, 300, (5003, 2)).astype(np.int32)
    origin, half, res = np.array([0.5, -0.25]), np.array([150, 150]), 0.05
    key = jax.random.PRNGKey(3)
    m = 512
    want = np.asarray(_uniform_pool_jit(key, jnp.asarray(fsi), jnp.asarray(origin, jnp.float32),
                                        jnp.asarray(half, jnp.int32), jnp.float32(res),
                                        jnp.zeros((m,), jnp.float32)))
    k1, k2 = jax.random.split(key)
    geom = (torch.tensor(origin, dtype=torch.float32), torch.tensor(half, dtype=torch.int32),
            torch.tensor(res, dtype=torch.float32))
    got = uniform_poses(torch.from_numpy(np.array(jax.random.uniform(k1, (m,)))),
                        torch.from_numpy(np.array(jax.random.uniform(k2, (m,)))),
                        torch.from_numpy(fsi), *geom)
    # XLA's CPU compile fuses origin + cell * res and u * 2 pi - pi into
    # multiply-adds: one ulp (<= 4.8e-7 at these magnitudes)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for f in (5003, 1_000_003, 2 ** 24 + 3):
        u = torch.tensor([1.0 - 2.0 ** -24, 1.0, 0.0], dtype=torch.float32)
        idx = pool_index(u, f)
        jidx = np.minimum((np.asarray(u) * np.float32(f)).astype(np.int32), f - 1)
        np.testing.assert_array_equal(idx.numpy(), jidx)
        assert int(idx.max()) == f - 1
    edge = uniform_poses(torch.tensor([1.0]), torch.tensor([0.5]), torch.from_numpy(fsi),
                         *geom)
    jedge = np.asarray(jnp.asarray(fsi)[jnp.asarray([5003])])  # the clamped JAX gather
    np.testing.assert_allclose(
        edge[0, :2].numpy(),
        (origin.astype(np.float32) + (jedge[0] - half).astype(np.float32) * np.float32(res)),
        rtol=0, atol=1e-6)


def test_checkpoint_round_trip_and_jax_snapshot(stream, tmp_path):
    """save_full_state / restore_full_state with the weight domain and the
    generator recorded; a log-space node refuses a linear snapshot; a JAX
    node's version-1 snapshot loads when the caller states its domain."""
    grid, steps = stream
    jn, jtf, tn, ttf = _nodes(grid, {})
    for step in steps[:5]:
        _feed(tn, ttf, Transform, step, True)
    path = str(tmp_path / "state.npz")
    assert tn.save_full_state(path)
    with np.load(path) as z:
        assert int(z["version"]) == 2 and not bool(z["log_domain"])
    _, _, tn2, _ = _nodes(grid, {})
    assert tn2.restore_full_state(path)
    for f in ("poses", "weights", "n_active", "w_slow", "w_fast", "converged"):
        assert torch.equal(getattr(tn2.state, f), getattr(tn.state, f)), f
    assert int(tn2.state.stats.cluster_count) == int(tn.state.stats.cluster_count)
    assert torch.equal(tn2.generator.get_state(), tn.generator.get_state())
    _, _, tlog, _ = _nodes(grid, {"laser_model_type": "likelihood_field_prob",
                                  "laser_likelihood_log_space": True})
    assert not tlog.restore_full_state(path)
    jpath = str(tmp_path / "jax_state.npz")
    jcheckpoint.save_state(jpath, jn.state)
    assert not tn2.restore_full_state(jpath)  # version 1: the domain is unknown
    assert tn2.restore_full_state(jpath, log_domain=False)
    np.testing.assert_array_equal(tn2.state.poses.numpy(), np.asarray(jn.state.poses))
    assert not tn2.restore_full_state(str(tmp_path / "missing.npz"), log_domain=False)


def test_compute_backend_names_and_entry_points():
    """The JAX package's backend names map onto the port's, the
    interpret-mode names raise; make_node builds a Node3D for map_type 3
    (on "corr_q" its clouds take the exact gather); without a CUDA device a
    node asked for CUDA raises."""
    assert tconfig.resolve_backend("auto", "cpu") == "exact"
    assert tconfig.resolve_backend("auto", "cuda") == "corr"
    for jax_name, port in (("pallas_corr", "corr"), ("pallas_corr_q", "corr_q"),
                           ("pallas", "lf"), ("xla", "exact"), ("lf", "lf")):
        assert tconfig.resolve_backend(jax_name, "cpu") == port
    for bad in ("pallas_corr_interpret", "pallas_interpret", "pallas_corr_q_interpret",
                "tpu"):
        with pytest.raises(ValueError):
            tconfig.resolve_backend(bad, "cpu")
    cfg = tconfig.AMCLConfig(compute_backend="pallas_corr_q")
    assert make_node(cfg, device="cpu").backend == "corr_q"
    with pytest.raises(ValueError):
        make_node(cfg.replace(compute_backend="pallas_interpret"), device="cpu")
    node3 = make_node(tconfig.AMCLConfig.for_3d(compute_backend="pallas_corr_q"),
                      device="cpu")
    assert type(node3).__name__ == "Node3D" and node3.backend == "exact"
    assert make_node(tconfig.AMCLConfig.for_3d(), device="cpu").backend == "exact"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_node(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_node(tconfig.AMCLConfig.for_3d())
    jcfg = JaxConfig.for_2d(resample_model_type="systematic", odom_model_type="omni",
                            laser_max_beams=90)
    cfg = convert.config_from_jax(jcfg)
    assert cfg.resample_model_type is tconfig.ResampleModelType.SYSTEMATIC
    assert cfg.odom_model_type is tconfig.OdomModelType.OMNI and cfg.laser_max_beams == 90


def test_foreign_generator_state_warns(stream, tmp_path, caplog):
    """A snapshot whose generator was saved on another device type (a CUDA
    node's, faked here) restores the particles and logs a warning naming
    both device types; the node's own stream goes on."""
    grid, steps = stream
    _, _, tn, ttf = _nodes(grid, {})
    for step in steps[:3]:
        _feed(tn, ttf, Transform, step, True)
    path = str(tmp_path / "state.npz")
    assert tn.save_full_state(path)
    with np.load(path) as z:
        data = dict(z)
    data["generator_device"] = np.array("cuda")
    np.savez(path, **data)
    _, _, tn2, _ = _nodes(grid, {})
    own = tn2.generator.get_state()
    with caplog.at_level("WARNING", logger="badger_amcl_tpu_torch"):
        assert tn2.restore_full_state(path)
    assert torch.equal(tn2.state.poses, tn.state.poses)
    assert torch.equal(tn2.generator.get_state(), own)
    warned = [r.getMessage() for r in caplog.records if r.levelname == "WARNING"]
    assert len(warned) == 1 and "cuda" in warned[0] and "cpu" in warned[0]


@pytest.mark.parametrize("backend", ["corr", "corr_q"])
def test_corr_backends_match_pallas_interpret(stream, monkeypatch, backend):
    """The JAX node on "pallas_<backend>_interpret" (its corr kernels in
    the Pallas interpreter) against the port's node on "<backend>" (the
    plain versions) over the deterministic pipeline (zero-noise odometry,
    no resample, the converted state) at 1000 particles x 40 beams. The
    grid is supersampled 3x (480^2 at 0.025 m, inside the lattice's map
    gate), the cloud starts tight (inside its window) and the range is
    clamped to 4 m (160 cells, inside the lattice's padding).

    corr: weights within rtol 1e-5 (the JAX tap loop's fused multiply-add
    moves a table cell by one ulp; 6.8e-7 measured). corr_q: a documented
    divergence. The JAX node never uses its baked psi texture (its jit
    traces the fingerprint away), so its pallas_corr_q runs the f32 table;
    the port's node bakes it and runs the int8 table. The weights then
    differ by the int8 quantization: by more than 1e-4 and at most 1e-2
    (4.2e-3 measured)."""
    grid, steps = stream
    calls = {"corr_values": 0, "corr_values_q": 0}
    for name in calls:
        real = getattr(corr_kernel, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(corr_kernel, name, spy)
    overrides = dict(odom_alpha1=0.0, odom_alpha2=0.0, odom_alpha3=0.0, odom_alpha4=0.0,
                     odom_alpha5=0.0, resample_interval=1000, map_scale_up_factor=3,
                     laser_max_range=4.0, compute_backend=f"pallas_{backend}_interpret")
    jn, jtf, tn, ttf = _nodes(grid, overrides, port=dict(compute_backend=backend),
                              init_cov=(0.01, 0.01, 0.002))
    assert tn.backend == backend and tn.map.size_x == 480
    tn.state = convert.state_from_numpy(jn.state, device="cpu")
    rel = 0.0
    for step in steps[:10]:
        _feed(jn, jtf, JaxTransform, step, False)
        _feed(tn, ttf, Transform, step, True)
        assert tn.resample_count == jn.resample_count
        w_t, w_j = tn.state.weights.numpy(), np.asarray(jn.state.weights)
        rel = max(rel, float(np.max(np.abs(w_t - w_j) / w_j)))
    updates = tn.resample_count
    assert updates >= 3
    if backend == "corr":
        assert calls == {"corr_values": updates, "corr_values_q": 0}
        assert rel <= 1e-5, rel
    else:
        assert calls == {"corr_values": 0, "corr_values_q": updates}
        assert 1e-4 < rel <= 1e-2, rel
