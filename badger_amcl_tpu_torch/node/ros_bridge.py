"""Optional ROS 1 bridge: maps live ROS topics onto the framework's message
dataclasses and back (counterpart of badger_amcl_tpu.node.ros_bridge).

The reference *is* a ROS node; in this design ROS is one optional transport
among several (sim, JSONL replay). The bridge subscribes to the same topics
the reference does (scan/cloud/map/octomap/initialpose/odom, SURVEY.md
§1-L3), republishes amcl_pose / particlecloud / amcl_map_odom_transform /
amcl_absolute_motion and broadcasts the map->odom TF.

Import-guarded: everything degrades to a clear error when rospy isn't
installed. The translation helpers are pure functions so they're unit-tested
without ROS (tests/test_torch_ros_bridge.py).
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any

import numpy as np

from badger_amcl_tpu_torch.node import messages as msgs
from badger_amcl_tpu_torch.node.transforms import Transform, quat_yaw

log = logging.getLogger("badger_amcl_tpu_torch")


# --- pure translation helpers (ROS msg duck-typed; unit-testable) ----------


def laser_scan_from_ros(m: Any) -> msgs.LaserScan:
    return msgs.LaserScan(
        stamp=m.header.stamp.to_sec() if hasattr(m.header.stamp, "to_sec") else float(m.header.stamp),
        frame_id=m.header.frame_id,
        angle_min=float(m.angle_min),
        angle_increment=float(m.angle_increment),
        range_min=float(m.range_min),
        range_max=float(m.range_max),
        ranges=np.asarray(m.ranges, np.float32),
    )


def occupancy_grid_from_ros(m: Any) -> msgs.OccupancyGrid:
    return msgs.OccupancyGrid(
        width=int(m.info.width),
        height=int(m.info.height),
        resolution=float(m.info.resolution),
        origin_x=float(m.info.origin.position.x),
        origin_y=float(m.info.origin.position.y),
        data=np.asarray(m.data, np.int8),
    )


def odometry_from_ros(m: Any) -> msgs.Odometry:
    q = m.pose.pose.orientation
    yaw = quat_yaw(np.array([q.x, q.y, q.z, q.w]))
    return msgs.Odometry(
        stamp=m.header.stamp.to_sec() if hasattr(m.header.stamp, "to_sec") else float(m.header.stamp),
        pose=np.array([m.pose.pose.position.x, m.pose.pose.position.y, yaw]),
    )


def initial_pose_from_ros(m: Any) -> msgs.PoseWithCovarianceStamped:
    q = m.pose.pose.orientation
    yaw = quat_yaw(np.array([q.x, q.y, q.z, q.w]))
    return msgs.PoseWithCovarianceStamped(
        stamp=m.header.stamp.to_sec() if hasattr(m.header.stamp, "to_sec") else float(m.header.stamp),
        frame_id=m.header.frame_id,
        pose=np.array([m.pose.pose.position.x, m.pose.pose.position.y, yaw]),
        covariance=np.asarray(m.pose.covariance, float),
    )


def octomap_from_ros(m: Any) -> msgs.OctomapMsg:
    """octomap_msgs/Octomap -> OctomapMsg. The ROS message carries a
    headerless node stream plus id/resolution/binary fields; re-attach the
    file header our readers expect (the readers mirror binaryMsgToMap /
    fullMsgToMap, node_3d.cpp:262-284)."""
    res = float(m.resolution)
    tree_id = getattr(m, "id", "OcTree")
    header = (
        ("# Octomap OcTree binary file\n" if getattr(m, "binary", True)
         else "# Octomap OcTree file\n")
        + f"id {tree_id}\nsize 0\nres {res!r}\ndata\n"
    ).encode()
    payload = header + bytes(bytearray(m.data))
    if getattr(m, "binary", True):
        return msgs.OctomapMsg(resolution=res, binary_data=payload)
    return msgs.OctomapMsg(resolution=res, full_data=payload)


_POINT_FIELD_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def point_cloud_from_ros(m: Any) -> msgs.PointCloud2:
    """sensor_msgs/PointCloud2 -> (K, 3) xyz array. Mirrors the reference's
    pcl::fromROSMsg intake (node_3d.cpp:320-340); non-finite points are kept
    (the scan prep handles them, as pcl does)."""
    fields = {f.name: f for f in m.fields}
    for axis in ("x", "y", "z"):
        if axis not in fields:
            raise ValueError(f"PointCloud2 missing field {axis!r}")
    n = int(m.width) * int(m.height)
    step = int(m.point_step)
    raw = np.frombuffer(bytes(bytearray(m.data)), dtype=np.uint8)
    raw = raw[: n * step].reshape(n, step)
    prefix = ">" if getattr(m, "is_bigendian", False) else "<"
    cols = []
    for axis in ("x", "y", "z"):
        f = fields[axis]
        dt = np.dtype(_POINT_FIELD_DTYPES[int(f.datatype)]).newbyteorder(prefix)
        off = int(f.offset)
        col = raw[:, off : off + dt.itemsize].copy().view(dt)[:, 0]
        cols.append(col.astype(np.float32))
    stamp = m.header.stamp.to_sec() if hasattr(m.header.stamp, "to_sec") else float(m.header.stamp)
    return msgs.PointCloud2(
        stamp=stamp, frame_id=m.header.frame_id, points=np.stack(cols, axis=1)
    )


def pose_to_ros(p: msgs.PoseWithCovarianceStamped, ros_msg_cls, time_cls):
    out = ros_msg_cls()
    out.header.frame_id = p.frame_id
    out.header.stamp = time_cls(p.stamp)
    out.pose.pose.position.x = float(p.pose[0])
    out.pose.pose.position.y = float(p.pose[1])
    out.pose.pose.orientation.z = math.sin(p.pose[2] / 2.0)
    out.pose.pose.orientation.w = math.cos(p.pose[2] / 2.0)
    out.pose.covariance = list(map(float, p.covariance))
    return out


def apply_reconfigure(node, raw: dict, warn=None) -> bool:
    """Live-retune surface: a reference-style param dict -> `node.reconfigure`.

    This is the ROS-transport equivalent of the reference's
    dynamic_reconfigure server (node.cpp:169-171, handler :188-293): a
    running robot sends a (partial) param dict; unspecified params keep
    their current values; `restore_defaults: true` discards the rest of the
    dict and reverts to the construction-time snapshot (node.cpp:201-206).
    Returns True when a reconfigure was applied (an empty delta is a no-op,
    mirroring the no-op first dynamic_reconfigure callback)."""
    raw = dict(raw)
    if raw.pop("restore_defaults", False):
        node.reconfigure(restore_defaults=True)
        return True
    if not raw:
        return False
    node.reconfigure(node.config.merge_params(raw, warn=warn))
    return True


def parse_reconfigure_payload(text: str) -> dict:
    """Decode a reconfigure topic payload (JSON or simple YAML mapping) into
    a param dict. Raises ValueError on anything that isn't a mapping."""
    import json

    text = text.strip()
    data = None
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml

            data = yaml.safe_load(text)
        except ImportError:
            raise ValueError(
                f"reconfigure payload is not JSON and yaml is unavailable: {text!r}"
            ) from None
        except Exception as e:  # yaml.YAMLError: keep the ValueError contract
            raise ValueError(
                f"reconfigure payload is neither JSON nor YAML: {text!r}"
            ) from e
    if not isinstance(data, dict):
        raise ValueError(f"reconfigure payload must be a mapping, got {data!r}")
    return data


# --- live bridge ------------------------------------------------------------


def run_ros_bridge(node, cfg, shutdown) -> int:
    try:
        import rospy
        from geometry_msgs.msg import PoseArray, PoseWithCovarianceStamped as RosPWCS, Pose2D
        from nav_msgs.msg import OccupancyGrid as RosGrid, Odometry as RosOdom
        from sensor_msgs.msg import LaserScan as RosScan
        import tf2_ros
        from geometry_msgs.msg import TransformStamped as RosTS
        from std_srvs.srv import Empty, EmptyResponse
    except ImportError as e:  # pragma: no cover - needs a ROS install
        raise RuntimeError(
            "ROS bridge requested but rospy/message packages are unavailable"
        ) from e

    rospy.init_node("badger_amcl_tpu_torch")
    pose_pub = rospy.Publisher("amcl_pose", RosPWCS, queue_size=2, latch=True)
    cloud_pub = rospy.Publisher("particlecloud", PoseArray, queue_size=2, latch=True)
    motion_pub = rospy.Publisher("amcl_absolute_motion", Pose2D, queue_size=20)
    map_odom_pub = rospy.Publisher("amcl_map_odom_transform", RosOdom, queue_size=1)
    broadcaster = tf2_ros.TransformBroadcaster()
    listener_buf = tf2_ros.Buffer()
    tf2_ros.TransformListener(listener_buf)

    def publish_pose(p):
        pose_pub.publish(pose_to_ros(p, RosPWCS, rospy.Time))

    def publish_cloud(pa):
        out = PoseArray()
        out.header.frame_id = pa.frame_id
        out.header.stamp = rospy.Time(pa.stamp)
        from geometry_msgs.msg import Pose as RosPose

        for x, y, th in pa.poses:
            rp = RosPose()
            rp.position.x, rp.position.y = float(x), float(y)
            rp.orientation.z = math.sin(th / 2.0)
            rp.orientation.w = math.cos(th / 2.0)
            out.poses.append(rp)
        cloud_pub.publish(out)

    def publish_tf(ts: msgs.TransformStamped):
        out = RosTS()
        out.header.stamp = rospy.Time(ts.stamp)
        out.header.frame_id = ts.frame_id
        out.child_frame_id = ts.child_frame_id
        t = ts.translation
        q = ts.rotation
        out.transform.translation.x, out.transform.translation.y, out.transform.translation.z = map(float, t)
        (out.transform.rotation.x, out.transform.rotation.y,
         out.transform.rotation.z, out.transform.rotation.w) = map(float, q)
        broadcaster.sendTransform(out)

    node.subscribe_output("amcl_pose", publish_pose)
    node.subscribe_output("particlecloud", publish_cloud)
    node.subscribe_output("tf", publish_tf)
    node.subscribe_output(
        "amcl_absolute_motion",
        lambda p: motion_pub.publish(Pose2D(x=p.x, y=p.y, theta=p.theta)),
    )

    def sync_tf(parent, child, stamp):
        """Mirror a tf2 edge into the node's TransformBuffer at scan stamps."""
        try:
            t = listener_buf.lookup_transform(parent, child, rospy.Time(stamp),
                                              rospy.Duration(0.5))
        except Exception:
            return
        tr = t.transform
        node.tf.set_transform(
            parent, child, stamp,
            Transform(
                np.array([tr.translation.x, tr.translation.y, tr.translation.z]),
                np.array([tr.rotation.x, tr.rotation.y, tr.rotation.z, tr.rotation.w]),
            ),
        )

    is_3d = cfg.map_type == 3

    def on_scan(m):
        """scan (2D LaserScan) or cloud (3D PointCloud2) intake."""
        scan = laser_scan_from_ros(m) if not is_3d else point_cloud_from_ros(m)
        sync_tf(cfg.odom_frame_id, cfg.base_frame_id, scan.stamp)
        sync_tf(cfg.base_frame_id, scan.frame_id, scan.stamp)
        node.scan_received(scan, rospy.get_time())
        node.spin_once(rospy.get_time())

    if is_3d:
        # node_3d.cpp:96-111: cloud + octomap + (bounds-cropping) map
        from sensor_msgs.msg import PointCloud2 as RosCloud
        from octomap_msgs.msg import Octomap as RosOctomap

        rospy.Subscriber("cloud", RosCloud, on_scan, queue_size=1)
        rospy.Subscriber(
            "octomap", RosOctomap,
            lambda m: node.octomap_msg_received(octomap_from_ros(m)),
            queue_size=1,
        )
        rospy.Subscriber(
            "map", RosGrid,
            lambda m: node.occupancy_map_msg_received(occupancy_grid_from_ros(m)),
            queue_size=1,
        )
    else:
        rospy.Subscriber("scan", RosScan, on_scan, queue_size=1)
        rospy.Subscriber("map", RosGrid, lambda m: node.map_msg_received(occupancy_grid_from_ros(m)), queue_size=1)
    rospy.Subscriber("odom", RosOdom, lambda m: node.integrate_odom(odometry_from_ros(m)), queue_size=20)
    rospy.Subscriber(
        "initialpose", RosPWCS,
        lambda m: node.initial_pose_received(initial_pose_from_ros(m), rospy.get_time()),
        queue_size=2,
    )
    rospy.Service("global_localization", Empty,
                  lambda req: (node.global_localization(), EmptyResponse())[1])

    # Live retune over the wire — the dynamic_reconfigure-server surface
    # (node.cpp:169-171). Payload: JSON/YAML param mapping on a String
    # topic (no custom srv type needed); `{"restore_defaults": true}`
    # mirrors node.cpp:201-206.
    from std_msgs.msg import String as RosString

    def on_reconfigure(m):
        try:
            apply_reconfigure(node, parse_reconfigure_payload(m.data))
        except Exception:
            log.exception("reconfigure payload rejected: %r", m.data)

    rospy.Subscriber("reconfigure", RosString, on_reconfigure, queue_size=2)

    rate = rospy.Rate(cfg.transform_publish_rate)
    while not rospy.is_shutdown() and not shutdown.requested:
        node.spin_once(rospy.get_time())
        rate.sleep()
    node.shutdown(rospy.get_time() if not rospy.is_shutdown() else time.time())
    return 0
