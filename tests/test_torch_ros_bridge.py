"""PyTorch port: the pure ROS<->framework translation helpers of
node/ros_bridge.py (no rospy needed: ROS messages are duck-typed), the
mapping tests of tests/test_ros_bridge.py run against the port, each
message also held equal to the JAX bridge's translation of the same fake
message (exact: the same numpy on both sides).

Covers both directions plus the 3D intake path the reference wires at
node_3d.cpp:96-111 (cloud / octomap / map).
"""

import dataclasses
import types

import numpy as np

from badger_amcl_tpu.node import ros_bridge as jrb
from badger_amcl_tpu_torch.maps.octree_io import read_octree, write_bt, write_ot
from badger_amcl_tpu_torch.node import ros_bridge as rb
from badger_amcl_tpu_torch.node import messages as msgs


def _ns(**kw):
    return types.SimpleNamespace(**kw)


def _header(stamp=1.5, frame="frame"):
    return _ns(stamp=stamp, frame_id=frame)


def _same_as_jax(fn, m):
    """The port's translation of m equals the JAX bridge's, field by field."""
    got, want = getattr(rb, fn)(m), getattr(jrb, fn)(m)
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    return got


def test_laser_scan_from_ros():
    m = _ns(
        header=_header(2.0, "laser"),
        angle_min=-1.0,
        angle_increment=0.01,
        range_min=0.1,
        range_max=8.0,
        ranges=[1.0, 2.0, 3.0],
    )
    out = _same_as_jax("laser_scan_from_ros", m)
    assert out.stamp == 2.0 and out.frame_id == "laser"
    assert out.ranges.dtype == np.float32
    np.testing.assert_allclose(out.ranges, [1, 2, 3])


def test_occupancy_grid_from_ros():
    m = _ns(
        info=_ns(
            width=3,
            height=2,
            resolution=0.05,
            origin=_ns(position=_ns(x=-1.0, y=2.0)),
        ),
        data=[0, 100, -1, 0, 0, 100],
    )
    out = _same_as_jax("occupancy_grid_from_ros", m)
    assert (out.width, out.height) == (3, 2)
    assert out.origin_x == -1.0 and out.origin_y == 2.0
    assert out.data.dtype == np.int8


def _quat(yaw):
    return _ns(x=0.0, y=0.0, z=np.sin(yaw / 2), w=np.cos(yaw / 2))


def test_odometry_and_initial_pose_from_ros():
    pose = _ns(position=_ns(x=1.0, y=-2.0), orientation=_quat(0.7))
    m = _ns(header=_header(3.0), pose=_ns(pose=pose))
    out = _same_as_jax("odometry_from_ros", m)
    np.testing.assert_allclose(out.pose, [1.0, -2.0, 0.7], atol=1e-12)

    cov = np.arange(36, dtype=float)
    m2 = _ns(header=_header(4.0, "map"), pose=_ns(pose=pose, covariance=cov))
    out2 = _same_as_jax("initial_pose_from_ros", m2)
    assert out2.frame_id == "map"
    np.testing.assert_allclose(out2.pose, [1.0, -2.0, 0.7], atol=1e-12)
    np.testing.assert_array_equal(out2.covariance, cov)


def test_pose_to_ros_round_trip():
    p = msgs.PoseWithCovarianceStamped.make(5.0, "map", [0.5, -0.25, 1.1],
                                            np.array([0.1, 0.2, 0.3]))

    class FakePose:
        def __init__(self):
            self.header = _ns(frame_id="", stamp=None)
            self.pose = _ns(
                pose=_ns(position=_ns(x=0.0, y=0.0),
                         orientation=_ns(x=0.0, y=0.0, z=0.0, w=1.0)),
                covariance=None,
            )

    out = rb.pose_to_ros(p, FakePose, float)
    assert out.header.frame_id == "map" and out.header.stamp == 5.0
    # round-trip back through the from_ros direction
    back = rb.initial_pose_from_ros(
        _ns(header=_ns(stamp=out.header.stamp, frame_id=out.header.frame_id),
            pose=_ns(pose=_ns(position=_ns(x=out.pose.pose.position.x,
                                           y=out.pose.pose.position.y),
                              orientation=out.pose.pose.orientation),
                     covariance=out.pose.covariance))
    )
    np.testing.assert_allclose(back.pose, p.pose, atol=1e-12)
    np.testing.assert_allclose(back.covariance, p.covariance)


def _octomap_payload(path):
    """Strip the ASCII header: ROS octomap msgs carry only the node stream."""
    blob = open(path, "rb").read()
    return blob.split(b"data\n", 1)[1]


def test_octomap_from_ros_binary_and_full(tmp_path):
    centers = np.array([[0.05, 0.05, 0.05], [0.55, 0.05, 0.15]])
    bt, ot = tmp_path / "m.bt", tmp_path / "m.ot"
    write_bt(bt, 0.1, centers)
    write_ot(ot, 0.1, centers)

    m_bin = _ns(resolution=0.1, id="OcTree", binary=True,
                data=_octomap_payload(bt))
    m_full = _ns(resolution=0.1, id="OcTree", binary=False,
                 data=_octomap_payload(ot))
    out_bin = _same_as_jax("octomap_from_ros", m_bin)
    out_full = _same_as_jax("octomap_from_ros", m_full)
    assert out_bin.binary_data is not None and out_bin.full_data is None
    assert out_full.full_data is not None and out_full.binary_data is None

    vb = read_octree(out_bin.binary_data).occupied_centers()
    vf = read_octree(out_full.full_data).occupied_centers()
    ref = np.array(sorted(map(tuple, np.round(centers, 6))))
    np.testing.assert_allclose(np.array(sorted(map(tuple, vb))), ref, atol=1e-6)
    np.testing.assert_allclose(np.array(sorted(map(tuple, vf))), ref, atol=1e-6)


def test_point_cloud_from_ros_xyz_padded_layout():
    pts = np.array([[1.0, 2.0, 3.0], [-0.5, 0.25, 0.125]], np.float32)
    n = len(pts)
    step = 16  # x,y,z float32 + 4 pad bytes (the common PCL layout)
    raw = np.zeros((n, step), np.uint8)
    for i, off in enumerate((0, 4, 8)):
        raw[:, off : off + 4] = pts[:, i : i + 1].view(np.uint8).reshape(n, 4)
    m = _ns(
        header=_header(7.0, "lidar"),
        fields=[
            _ns(name="x", offset=0, datatype=7),
            _ns(name="y", offset=4, datatype=7),
            _ns(name="z", offset=8, datatype=7),
            _ns(name="intensity", offset=12, datatype=7),
        ],
        width=n,
        height=1,
        point_step=step,
        is_bigendian=False,
        data=raw.tobytes(),
    )
    out = _same_as_jax("point_cloud_from_ros", m)
    assert out.frame_id == "lidar" and out.stamp == 7.0
    np.testing.assert_array_equal(out.points, pts)


def test_point_cloud_from_ros_bigendian_f64():
    pts = np.array([[0.5, -1.5, 2.5]], np.float64)
    cols = [pts[:, i].astype(">f8").tobytes() for i in range(3)]
    data = b"".join(b"".join(c[i * 8 : (i + 1) * 8] for c in cols) for i in range(1))
    m = _ns(
        header=_header(0.0, "lidar"),
        fields=[
            _ns(name="x", offset=0, datatype=8),
            _ns(name="y", offset=8, datatype=8),
            _ns(name="z", offset=16, datatype=8),
        ],
        width=1,
        height=1,
        point_step=24,
        is_bigendian=True,
        data=data,
    )
    out = _same_as_jax("point_cloud_from_ros", m)
    np.testing.assert_allclose(out.points, pts.astype(np.float32))


# --- live reconfigure endpoint (node.cpp:169-171, handler :188-293) ---------


class _FakeNode:
    """Records reconfigure calls; carries a real AMCLConfig so
    merge_params semantics are exercised end-to-end."""

    def __init__(self):
        from badger_amcl_tpu_torch.config import AMCLConfig

        self.config = AMCLConfig.for_2d(min_particles=100, max_particles=5000)
        self.calls = []

    def reconfigure(self, new_config=None, restore_defaults=False):
        self.calls.append((new_config, restore_defaults))
        if new_config is not None:
            self.config = new_config


def test_apply_reconfigure_merges_delta():
    node = _FakeNode()
    ok = rb.apply_reconfigure(
        node, {"max_particles": 8000, "laser_scanner_off_map_factor": 0.5}
    )
    assert ok and len(node.calls) == 1
    cfg, restore = node.calls[0]
    assert not restore
    assert cfg.max_particles == 8000
    # alias resolved (REFERENCE_PARAM_ALIASES)
    assert cfg.laser_off_map_factor == 0.5
    # unspecified params keep their current values (delta contract)
    assert cfg.min_particles == 100


def test_apply_reconfigure_restore_defaults():
    node = _FakeNode()
    ok = rb.apply_reconfigure(node, {"restore_defaults": True, "max_particles": 9})
    assert ok
    assert node.calls == [(None, True)]  # rest of the dict discarded


def test_apply_reconfigure_empty_delta_is_noop():
    node = _FakeNode()
    assert not rb.apply_reconfigure(node, {})
    assert not rb.apply_reconfigure(node, {"restore_defaults": False})
    assert node.calls == []


def test_parse_reconfigure_payload():
    import pytest

    assert rb.parse_reconfigure_payload('{"max_particles": 7000}') == {
        "max_particles": 7000
    }
    # YAML fallback for non-JSON payloads
    assert rb.parse_reconfigure_payload("max_particles: 7000\nkld_err: 0.01") == {
        "max_particles": 7000,
        "kld_err": 0.01,
    }
    with pytest.raises(ValueError):
        rb.parse_reconfigure_payload("[1, 2, 3]")
    # malformed YAML (yaml importable, text unparseable) must surface as the
    # documented ValueError, not a raw yaml.YAMLError
    with pytest.raises(ValueError):
        rb.parse_reconfigure_payload("a: [unclosed")


def test_merge_params_min_max_coercion():
    """__post_init__ re-runs on merge: min<=max coercion (node.cpp:244-249)."""
    node = _FakeNode()
    rb.apply_reconfigure(node, {"min_particles": 9000})
    assert node.config.min_particles == 9000
    assert node.config.max_particles == 9000


def test_run_ros_bridge_without_rospy_raises():
    """rospy is imported only when the bridge runs; without it the bridge
    raises a RuntimeError that says so."""
    import pytest

    try:
        import rospy  # noqa: F401
        pytest.skip("rospy is installed: the bridge would start")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="rospy"):
        rb.run_ros_bridge(_FakeNode(), _FakeNode().config, types.SimpleNamespace(
            requested=True))
