"""PyTorch port: the 3D node (octomap receipt, the deferred bake, the
scanner registry with SE(3) extrinsics, the point-cloud update), held
against the JAX package's Node3D on one message stream recorded from the
JAX `Sim3D` (the `_voxel_room` of tests/test_node_3d.py, 800 particles,
128 points).

The JAX node runs on "xla" and the port's on "exact" (both "auto" on the
CPU). The port's node draws from its own torch.Generator, so the filter is
compared only on the deterministic pipeline: zero-noise odometry, no
resample, the port's state converted from the JAX node's.

Tolerances:
- gating decisions, integrated odometry, the cloud folded into the base
  frame, the voxel texture, the free cells, the published pose (the
  max-weight cluster of the converted statistics), the map->odom TF and
  the saved-pose file: exact (host numpy, the same EDT and quantization);
- weights and pose scores rtol 1e-5, the published particle cloud
  1e-5 m: the motion
  update's and the likelihood's f32 trig and sums differ in the last ulp
  between XLA and PyTorch;
- the corr backend (the JAX Pallas interpreter against the port's plain
  versions): weights rtol 1e-5 (the windowed arm reads the same uint8
  voxels; the port sums a 257-entry term table, bit-equal to the term);
- localization: the JAX tests' bounds (0.3 m, 0.25 rad).
"""

import math

import numpy as np
import pytest
import torch

from badger_amcl_tpu.config import AMCLConfig as JaxConfig
from badger_amcl_tpu.node import make_node as jax_make_node
from badger_amcl_tpu.node.messages import OccupancyGrid as JaxGrid
from badger_amcl_tpu.node.messages import OctomapMsg as JaxOctomapMsg
from badger_amcl_tpu.node.transforms import Transform as JaxTransform
from badger_amcl_tpu.node.transforms import TransformBuffer as JaxTransformBuffer
from badger_amcl_tpu.sim import Sim3D
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch.maps.octree_io import write_bt, write_ot
from badger_amcl_tpu_torch.node import Node3D, make_node
from badger_amcl_tpu_torch.node.messages import OccupancyGrid, OctomapMsg
from badger_amcl_tpu_torch.node.transforms import Transform, TransformBuffer
from badger_amcl_tpu_torch.ops import pc_kernel

torch.set_num_threads(1)

RES = 0.1
START = (2.0, 2.0, 0.4)
INIT_COV = (0.2, 0.2, 0.05)
MOUNT = (0.3, 0.1, 0.5, 0.0, 0.0, 0.8)  # x, y, z, roll, pitch, yaw
BASE = dict(min_particles=100, max_particles=800, update_min_d=0.05, update_min_a=0.05,
            cloud_max_beams=128, cloud_likelihood_max_dist=0.5,
            laser_model_type="likelihood_field", odom_alpha1=0.05, odom_alpha2=0.05,
            odom_alpha3=0.05, odom_alpha4=0.05, odom_alpha5=0.05)
STILL = dict(odom_alpha1=0.0, odom_alpha2=0.0, odom_alpha3=0.0, odom_alpha4=0.0,
             odom_alpha5=0.0, resample_interval=1000)
STEPS = 25


def _voxel_room(size=8.0, res=RES, height=1.0, seed=5):
    """tests/test_node_3d.py's room: four walls and six columns."""
    pts = []
    n = int(size / res)
    nz = int(height / res)
    rng = np.random.default_rng(seed)
    for k in range(nz):
        z = (k + 0.5) * res
        for i in range(n):
            x = (i + 0.5) * res
            pts += [[x, 0.5 * res, z], [x, size - 0.5 * res, z]]
            pts += [[0.5 * res, x, z], [size - 0.5 * res, x, z]]
    for _ in range(6):
        cx, cy = rng.uniform(1.0, size - 1.0, 2)
        for k in range(nz):
            pts.append([cx, cy, (k + 0.5) * res])
    return np.array(pts)


def _record(pts, mount=None, seed=2):
    """[(t, odom pose, Odometry, PointCloud2, true pose)] of the JAX Sim3D
    driven as tests/test_node_3d.py's `_drive` (v 0.25, w 0.2)."""
    kw = {} if mount is None else dict(scanner_mount=JaxTransform.from_xyzrpy(*mount))
    sim = Sim3D(pts, RES, start_pose=START, n_points=300, seed=seed, **kw)
    steps = [(0.0, sim.odom_pose.copy(), None, None, sim.true_pose.copy())]
    for _ in range(STEPS):
        odom = sim.step(0.25, 0.2)
        steps.append((sim.t, sim.odom_pose.copy(), odom, sim.make_cloud(),
                      sim.true_pose.copy()))
    return steps


@pytest.fixture(scope="module")
def world():
    pts = _voxel_room()
    return pts, _record(pts), _record(pts, MOUNT, seed=11)


def _nodes(overrides, map_msg=None, mount=None, pts=None, port=None, init_cov=INIT_COV):
    """(jax node, jax tf, port node, port tf) built from one config (the
    port's with `port` replaced) with the JAX tests' initial pose and
    covariance, after the same octomap message (occupied centres unless
    `map_msg` is given)."""
    jcfg = JaxConfig.for_3d(**{**BASE, **overrides})
    cfg = convert.config_from_jax(jcfg).replace(**(port or {}))
    if map_msg is None and pts is not None:
        map_msg = JaxOctomapMsg(resolution=RES, occupied_centers=pts)
    out = []
    for make, tfb, tr, c, kw in ((jax_make_node, JaxTransformBuffer(), JaxTransform, jcfg, {}),
                                 (make_node, TransformBuffer(), Transform, cfg,
                                  {"device": "cpu"})):
        tfb.set_static("base_link", "lidar",
                       tr.identity() if mount is None else tr.from_xyzrpy(*mount))
        node = make(c, tf_buffer=tfb, **kw)
        node.init_pose = np.asarray(START, float)
        node.init_cov = np.asarray(init_cov)
        if map_msg is not None:
            node.octomap_msg_received(map_msg if make is jax_make_node
                                      else convert.message_from_jax(map_msg))
        out += [node, tfb]
    return out


def _feed(node, tfb, tr, step, port):
    t, odom_pose, odom, cloud, _ = step
    tfb.set_transform("odom", "base_link", t, tr.from_pose2d(odom_pose))
    if odom is None:
        return
    node.integrate_odom(convert.message_from_jax(odom) if port else odom)
    node.scan_received(convert.message_from_jax(cloud) if port else cloud)
    node.spin_once(t)


def _outputs(node):
    out = {k: [] for k in ("amcl_pose", "particlecloud", "tf", "amcl_map_odom_transform")}
    for k, v in out.items():
        node.subscribe_output(k, v.append)
    return out


def _maps_equal(tn, jn):
    assert tn.map.min_cells == tuple(jn.map.min_cells)
    assert tn.map.max_cells == tuple(jn.map.max_cells)
    np.testing.assert_array_equal(tn.map.occupied_cells, np.asarray(jn.map.occupied_cells))
    np.testing.assert_array_equal(tn.map.distances_u8.numpy(), np.asarray(jn.map.distances_u8))
    np.testing.assert_array_equal(tn.free_space_indices.numpy(),
                                  np.asarray(jn.free_space_indices))


@pytest.mark.parametrize("backend", ["auto", "pallas_corr_q"])
def test_deterministic_pipeline_matches(world, tmp_path, backend):
    """Zero-noise odometry, no resample, the port's state converted from
    the JAX node's: the voxel texture, gating, the base-frame cloud,
    published outputs and the saved pose equal, weights and particle clouds
    within 1e-5. On "pallas_corr_q" both packages take the exact gather
    (the JAX dispatch sends that name to its XLA gather)."""
    pts, steps, _ = world
    jn, jtf, tn, ttf = _nodes(dict(STILL, save_pose=True, compute_backend=backend), pts=pts)
    assert isinstance(tn, Node3D) and tn.backend == "exact"
    jn.config = jn.config.replace(saved_pose_filepath=str(tmp_path / "jax.yaml"))
    tn.config = tn.config.replace(saved_pose_filepath=str(tmp_path / "port.yaml"))
    _maps_equal(tn, jn)
    tn.state = convert.state_from_numpy(jn.state, device="cpu")
    jout, tout = _outputs(jn), _outputs(tn)
    for k, step in enumerate(steps[:9]):
        _feed(jn, jtf, JaxTransform, step, False)
        _feed(tn, ttf, Transform, step, True)
        assert tn.resample_count == jn.resample_count, k
        np.testing.assert_array_equal(tn.pf_odom_pose, jn.pf_odom_pose)
        if jn.latest_points_base is not None:
            np.testing.assert_array_equal(tn.latest_points_base.numpy(),
                                          np.asarray(jn.latest_points_base))
        np.testing.assert_allclose(tn.state.weights.numpy(), np.asarray(jn.state.weights),
                                   rtol=1e-5, atol=0)
        for f in ("w_slow", "w_fast"):
            np.testing.assert_allclose(float(getattr(tn.state, f)),
                                       float(getattr(jn.state, f)), rtol=1e-5)
    assert 3 <= jn.resample_count < 9  # some scans were gated out
    for k in jout:
        assert len(tout[k]) == len(jout[k]) > 0, k
    for a, b in zip(tout["particlecloud"], jout["particlecloud"]):
        np.testing.assert_allclose(a.poses, b.poses, rtol=0, atol=1e-5)
    for a, b in zip(tout["amcl_pose"], jout["amcl_pose"]):
        np.testing.assert_array_equal(a.pose, b.pose)
        np.testing.assert_array_equal(a.covariance, b.covariance)
    for a, b in zip(tout["tf"], jout["tf"]):
        np.testing.assert_array_equal(a.translation, b.translation)
        np.testing.assert_array_equal(a.rotation, b.rotation)
    jn.shutdown(steps[8][0])
    tn.shutdown(steps[8][0])
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    np.testing.assert_allclose(tn.score_poses(tn.state.poses[:16]).numpy(),
                               np.asarray(jn.score_poses(jn.state.poses[:16])), rtol=1e-5)


@pytest.mark.parametrize("mounted", [False, True])
def test_tracking_localizes(world, mounted):
    """The port's node tracks the recorded path within the JAX tests'
    bounds, with the scanner at the footprint and on a translated and
    yawed mount (the extrinsic folded into the cloud once); the mounted
    cloud in the base frame equals the JAX node's."""
    pts, steps, mount_steps = world
    mount = MOUNT if mounted else None
    jn, jtf, tn, ttf = _nodes({}, pts=pts, mount=mount)
    stream = mount_steps if mounted else steps
    for step in stream[:2]:
        _feed(jn, jtf, JaxTransform, step, False)
        _feed(tn, ttf, Transform, step, True)
    np.testing.assert_array_equal(tn.latest_points_base.numpy(),
                                  np.asarray(jn.latest_points_base))
    for step in stream[2:]:
        _feed(tn, ttf, Transform, step, True)
    _, est = tn.get_max_weight_pose()
    true = stream[-1][4]
    assert math.hypot(est[0] - true[0], est[1] - true[1]) < 0.3
    assert abs(math.remainder(est[2] - true[2], 2 * math.pi)) < 0.25


def test_wait_for_occupancy_map_defers_bake_and_ignores_origin(world):
    """wait_for_occupancy_map: the EDT waits for the 2D bounds
    (node_3d.cpp:178-197,244-255), a scan before the bake is dropped, and
    the grid's origin is ignored (min bound hard-coded to 0,
    node_3d.cpp:189-190): the crop, the texture and the free cells equal
    the JAX node's."""
    pts, steps, _ = world
    jn, jtf, tn, ttf = _nodes({"wait_for_occupancy_map": True}, pts=pts)
    assert not tn.map.distances_lut_created and tn.free_space_indices is None
    for step in steps[:2]:
        _feed(tn, ttf, Transform, step, True)
    assert tn.resample_count == 0 and tn.latest_points_base is None
    grid = JaxGrid(width=40, height=30, resolution=0.2, origin_x=-3.5, origin_y=7.25,
                   data=np.zeros(1200, np.int8))
    jn.occupancy_map_msg_received(grid)
    tn.occupancy_map_msg_received(convert.message_from_jax(grid))
    assert tn.occupancy_map_min == jn.occupancy_map_min == [0.0, 0.0]
    assert tn.occupancy_map_max == jn.occupancy_map_max
    assert tn.occupancy_map_max == [pytest.approx(8.0), pytest.approx(6.0)]
    _maps_equal(tn, jn)
    # an octomap after the bounds bakes at once, cropped
    tn.octomap_msg_received(OctomapMsg(resolution=RES, occupied_centers=pts))
    assert tn.map.distances_lut_created and tn.map.max_cells == tuple(jn.map.max_cells)
    # without the flag the 2D map is ignored
    _, _, tn3, _ = _nodes({}, pts=pts)
    tn3.occupancy_map_msg_received(OccupancyGrid(width=4, height=4, resolution=0.2,
                                                 origin_x=0.0, origin_y=0.0,
                                                 data=np.zeros(16, np.int8)))
    assert tn3.occupancy_map_max is None


@pytest.mark.parametrize("field,writer", [("binary_data", write_bt), ("full_data", write_ot)])
def test_octree_message_through_node(world, tmp_path, field, writer):
    """The binary (.bt) and full (.ot) octomap branches
    (node_3d.cpp:262-284), the payload written by the port's writer: both
    nodes build the same map; the occupied voxels are the distinct octree
    keys (floor(c / res), not the map's floor(c / res + 0.5))."""
    pts = world[0]
    thin = pts[:: max(1, len(pts) // 1500)]
    path = str(tmp_path / "world.bin")
    writer(path, RES, thin)
    with open(path, "rb") as f:
        msg = JaxOctomapMsg(resolution=RES, **{field: f.read()})
    jn, _, tn, _ = _nodes({}, map_msg=msg)
    assert tn.map.resolution == RES and tn.map.distances_lut_created
    assert len(tn.map.occupied_cells) == len(np.unique(np.floor(thin / RES).astype(int), axis=0))
    _maps_equal(tn, jn)


@pytest.mark.parametrize("arm,init_cov", [("windowed", (0.005, 0.005, 0.001)),
                                          ("spread", INIT_COV)])
def test_corr_backend_matches_pallas_interpret(world, arm, init_cov):
    """One update of a JAX node on "pallas_corr_interpret" (its Pallas
    kernels in the interpreter) against the port's node on "corr" (the
    plain versions of #9's prepass and fused sums, or of #10) at 800
    particles x 64 points; weights within 1e-5. The windowed arm needs a
    tight cloud whose points all lie in rows a window can reach (a window's
    origin is clamped to ny - 96 and aligned down to 32 rows, so the top
    rows are out of reach) and in the crop's z band: its stream sees only
    the room below y = 5 m, and two voxels below and above the room widen
    the band past the cloud's noise. The spread arm takes the JAX tests'
    cloud and stream."""
    pts, steps, _ = world
    if arm == "windowed":
        sim = Sim3D(pts[pts[:, 1] < 5.0], RES, start_pose=START, n_points=300, seed=4)
        steps = [(0.0, sim.odom_pose.copy(), None, None, None)]
        odom = sim.step(0.25, 0.2)
        steps.append((sim.t, sim.odom_pose.copy(), odom, sim.make_cloud(), None))
        pts = np.concatenate([pts, [[0.05, 0.05, -0.15], [7.95, 7.95, 1.15]]])
    jn, jtf, tn, ttf = _nodes(dict(STILL, cloud_max_beams=64,
                                   compute_backend="pallas_corr_interpret"), pts=pts,
                              port=dict(compute_backend="corr"), init_cov=init_cov)
    assert tn.backend == "corr"
    tn.state = convert.state_from_numpy(jn.state, device="cpu")
    for step in steps[:2]:
        _feed(jn, jtf, JaxTransform, step, False)
        _feed(tn, ttf, Transform, step, True)
    assert tn.resample_count == jn.resample_count == 1
    fits = pc_kernel.window_origins(tn.map, tn.latest_points_base, tn.state.poses)[3]
    assert bool(fits) == (arm == "windowed")
    np.testing.assert_allclose(tn.state.weights.numpy(), np.asarray(jn.state.weights),
                               rtol=1e-5, atol=0)


def test_watchdog_global_localization_and_entry_point(world):
    """make_node gives a Node3D for map_type 3; the scan watchdog; global
    localization scatters max_particles over the crop's footprint with the
    gl factors, then restores the normal factors on the next scan."""
    pts, steps, _ = world
    _, _, tn, ttf = _nodes({}, pts=pts)
    for step in steps[:3]:
        _feed(tn, ttf, Transform, step, True)
    assert tn.check_scan_received(steps[2][0] + 1.0) is None
    assert "No point cloud scan" in tn.check_scan_received(steps[2][0] + 16.0)
    tn.global_localization()
    assert tn.global_localization_active and int(tn.state.n_active) == 800
    assert tn.pc_params.off_map_factor == np.float32(tn.config.
                                                     global_localization_laser_off_map_factor)
    cells = tn.map.world_to_map(tn.state.poses[:, :2])
    assert bool(tn.map.is_pose_valid(cells[:, 0], cells[:, 1]).all())
    tn.global_localization_active = False
    _feed(tn, ttf, Transform, steps[3], True)
    assert tn.pc_params.off_map_factor == np.float32(tn.config.laser_off_map_factor)
    assert torch.isfinite(tn.state.weights).all()
