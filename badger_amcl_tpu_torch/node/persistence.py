"""Pose persistence — the localization checkpoint.

Same file contract as the reference (node.cpp:493-668): a YAML document with
header{stamp, frame_id, on_exit} and pose{pose{position, orientation},
covariance[36]}. Loading trusts the stored covariance only when the pose was
written on clean exit (`on_exit`), otherwise falls back to defaults
(node.cpp:540-551); NaN poses and NaN-yaw quaternions are rejected
(node.cpp:523-536); the legacy Python-YAML `state:` nesting is migrated
(loadYamlFromFile, node.cpp:555-606). Writes are crash-safe: tmp file +
fsync + atomic rename (badger_file_lib::atomic_ofstream equivalent,
node.cpp:665-667).

A copy of badger_amcl_tpu.node.persistence, except that `yaml` is imported
inside the functions: a node whose saved-pose file is missing starts
without PyYAML installed (`load_pose_from_file` returns None before it
needs the parser).
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from badger_amcl_tpu_torch.node.messages import (
    COVARIANCE_AA,
    COVARIANCE_XX,
    COVARIANCE_YY,
    PoseWithCovarianceStamped,
)
from badger_amcl_tpu_torch.node.transforms import quat_from_rpy, quat_yaw


def save_pose_to_file(
    path: str, pose: PoseWithCovarianceStamped, on_exit: bool
) -> None:
    """savePoseToFile (node.cpp:608-668). Only yaw is persisted (quaternion
    x/y stored as 0), only the XX/YY/AA covariance entries are kept."""
    import yaml

    q = quat_from_rpy(0.0, 0.0, float(pose.pose[2]))
    sec = int(pose.stamp)
    nsec = int(round((pose.stamp - sec) * 1e9))
    cov = [0.0] * 36
    cov[COVARIANCE_XX] = float(pose.covariance[COVARIANCE_XX])
    cov[COVARIANCE_YY] = float(pose.covariance[COVARIANCE_YY])
    cov[COVARIANCE_AA] = float(pose.covariance[COVARIANCE_AA])
    doc = {
        "header": {
            "stamp": {"sec": sec, "nsec": nsec},
            "frame_id": "map",
            "on_exit": bool(on_exit),
        },
        "pose": {
            "pose": {
                "position": {"x": float(pose.pose[0]), "y": float(pose.pose[1]), "z": 0.0},
                "orientation": {"x": 0.0, "y": 0.0, "z": float(q[2]), "w": float(q[3])},
            },
            "covariance": cov,
        },
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".amcl_pose_")
    try:
        with os.fdopen(fd, "w") as f:
            yaml.safe_dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _migrate_legacy(node: dict) -> Optional[dict]:
    """Old Python-style YAML (`state:` nesting) -> new layout
    (loadYamlFromFile, node.cpp:566-599)."""
    try:
        s = node["state"]
        pos = s[1]["state"][0]["state"][0]["state"]
        ori = s[1]["state"][0]["state"][1]["state"]
        cov = s[1]["state"][1]
        return {
            "header": {"frame_id": s[0]["state"][2]},
            "pose": {
                "pose": {
                    "position": {"x": pos[0], "y": pos[1]},
                    "orientation": {"x": 0.0, "y": 0.0, "z": ori[2], "w": ori[3]},
                },
                "covariance": {
                    COVARIANCE_XX: cov[COVARIANCE_XX],
                    COVARIANCE_YY: cov[COVARIANCE_YY],
                    COVARIANCE_AA: cov[COVARIANCE_AA],
                },
            },
        }
    except (KeyError, IndexError, TypeError):
        return None


def load_pose_from_file(
    path: str, default_cov: Tuple[float, float, float]
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """loadPoseFromFile (node.cpp:493-553). Returns (pose3, cov3) or None on
    any parse/validation failure."""
    try:
        f = open(path)
    except OSError:
        return None
    with f:
        import yaml

        try:
            node = yaml.safe_load(f)
        except (OSError, yaml.YAMLError):
            return None
    if not isinstance(node, dict) or not node:
        return None
    first_key = next(iter(node))
    if first_key == "state":
        node = _migrate_legacy(node)
        if node is None:
            return None
    elif first_key not in ("header", "pose"):
        return None
    try:
        p = node["pose"]["pose"]
        px = float(p["position"]["x"])
        py = float(p["position"]["y"])
        ori = p["orientation"]
        qx = float(ori.get("x", 0.0))
        qy = float(ori.get("y", 0.0))
        qz = float(ori["z"])
        qw = float(ori["w"])
        cov_node = node["pose"]["covariance"]
        xx = float(cov_node[COVARIANCE_XX])
        yy = float(cov_node[COVARIANCE_YY])
        aa = float(cov_node[COVARIANCE_AA])
        header = node.get("header", {})
        # assume saved-on-exit when the flag is missing (node.cpp:512-516)
        on_exit = bool(header.get("on_exit", True))
    except (KeyError, IndexError, TypeError, ValueError):
        return None
    vals = [px, py, qx, qy, qz, qw, xx, yy, aa]
    if any(math.isnan(v) for v in vals):
        return None
    yaw = quat_yaw(np.array([qx, qy, qz, qw]))
    if math.isnan(yaw):
        return None
    pose = np.array([px, py, yaw])
    cov = np.array([xx, yy, aa]) if on_exit else np.asarray(default_cov, float)
    return pose, cov
