"""Process entry point — the `main.cpp` equivalent (reference
src/main.cpp:37-54; counterpart of badger_amcl_tpu.cli).

Seeds the node's generator, installs SIGINT/SIGTERM handlers that request
a clean shutdown, constructs the node from a YAML config (same parameter
names as the reference's rosparams) on the chosen device, runs a data
source (built-in simulator, a JSONL replay file, or the optional ROS
bridge), and saves the pose once more on exit (`attemptSavePose(true)`,
main.cpp:51).

Usage:
    python -m badger_amcl_tpu_torch --config examples/amcl_2d.yaml --sim
    python -m badger_amcl_tpu_torch --config cfg.yaml --replay run.jsonl
    python -m badger_amcl_tpu_torch --config cfg.yaml --ros   (needs rospy)

The node runs on CUDA (`--device cuda`, the default) and raises where
there is no card; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import time
from typing import Optional

import numpy as np

log = logging.getLogger("badger_amcl_tpu_torch")

# the built-in simulator's script: the start pose and the (v, w) twist of
# every 0.1 s step
SIM_START = (-3.0, -3.0, 0.3)
SIM_TWIST = (0.3, 0.15)


def load_config(path: Optional[str]):
    from badger_amcl_tpu_torch.config import AMCLConfig

    if path is None:
        return AMCLConfig()
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    # Accepts the reference's exact rosparam spellings (aliases + declared-
    # but-unread params) so reference launch configs translate 1:1.
    return AMCLConfig.from_params(raw, warn=log.warning)


class _Shutdown:
    """SIGINT/SIGTERM -> requestShutdown (main.cpp:30-35), for the life of
    the run: `close` puts the previous handlers back (main may run inside
    another program)."""

    def __init__(self):
        self.requested = False
        self._previous = {sig: signal.signal(sig, self._handler)
                          for sig in (signal.SIGINT, signal.SIGTERM)}

    def _handler(self, signum, frame):
        self.requested = True

    def close(self):
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)


def run_sim(node, cfg, steps: int, shutdown: _Shutdown) -> int:
    """The built-in 2D simulator: the room map, a scripted arc, raycast
    scans. The simulator publishes odom -> the configured base frame (the
    JAX package's run_sim publishes base_link whatever the config names, so
    a config with another base frame, examples/amcl_2d.yaml's
    base_footprint, never updates there)."""
    from badger_amcl_tpu_torch.sim import Sim2D, make_room_grid

    grid = make_room_grid()
    sim = Sim2D(grid, start_pose=SIM_START, base_frame=cfg.base_frame_id)
    node.tf = sim.tf
    node.init_pose = np.array(SIM_START)
    node.map_msg_received(grid)
    for step in range(steps):
        if shutdown.requested:
            break
        odom = sim.step(*SIM_TWIST)
        node.integrate_odom(odom)
        node.scan_received(sim.make_scan())
        node.spin_once(sim.t)
        if step % 10 == 9 and node.last_published_pose is not None:
            p = node.last_published_pose.pose
            log.info("step %d pose (%.2f, %.2f, %.2f) true (%.2f, %.2f)",
                     step, p[0], p[1], p[2], sim.true_pose[0], sim.true_pose[1])
    node.shutdown(sim.t)
    return 0


def _transform(pose):
    from badger_amcl_tpu_torch.node.transforms import Transform

    if len(pose) == 3:
        return Transform.from_pose2d(pose)
    return Transform(np.asarray(pose[:3]), np.asarray(pose[3:]))


def run_replay(node, cfg, path: str, shutdown: _Shutdown) -> int:
    """Replay a JSONL message log: one JSON object per line with a `topic`
    field (map, scan, cloud, octomap, odom, initialpose, tf, tf_static,
    global_localization) mirroring the reference's subscriptions."""
    from badger_amcl_tpu_torch.node import messages as msgs

    t = 0.0
    with open(path) as f:
        for line in f:
            if shutdown.requested:
                break
            if not line.strip():
                continue
            rec = json.loads(line)
            topic = rec.get("topic")
            t = float(rec.get("stamp", t))
            if topic == "map":
                node.map_msg_received(msgs.OccupancyGrid(
                    width=rec["width"], height=rec["height"],
                    resolution=rec["resolution"],
                    origin_x=rec.get("origin_x", 0.0),
                    origin_y=rec.get("origin_y", 0.0),
                    data=np.asarray(rec["data"], np.int8),
                ))
            elif topic == "tf":
                node.tf.set_transform(rec["parent"], rec["child"], t, _transform(rec["pose"]))
            elif topic == "tf_static":
                node.tf.set_static(rec["parent"], rec["child"], _transform(rec["pose"]))
            elif topic == "scan":
                node.scan_received(msgs.LaserScan(
                    stamp=t, frame_id=rec.get("frame_id", "laser"),
                    angle_min=rec["angle_min"],
                    angle_increment=rec["angle_increment"],
                    range_min=rec.get("range_min", 0.0),
                    range_max=rec["range_max"],
                    ranges=np.asarray(rec["ranges"], np.float32),
                ))
            elif topic == "cloud":
                node.scan_received(msgs.PointCloud2(
                    stamp=t, frame_id=rec.get("frame_id", "lidar"),
                    points=np.asarray(rec["points"], np.float32),
                ))
            elif topic == "octomap":
                node.octomap_msg_received(msgs.OctomapMsg(
                    resolution=rec["resolution"],
                    occupied_centers=np.asarray(rec["occupied_centers"], float)
                    if "occupied_centers" in rec else None,
                    binary_data=bytes.fromhex(rec["binary_hex"])
                    if "binary_hex" in rec else None,
                ))
            elif topic == "odom":
                node.integrate_odom(msgs.Odometry(t, np.asarray(rec["pose"], float)))
            elif topic == "initialpose":
                node.initial_pose_received(
                    msgs.PoseWithCovarianceStamped.make(
                        t, rec.get("frame_id", "map"), rec["pose"],
                        np.asarray(rec.get("cov3")) if "cov3" in rec else None,
                    ),
                    t,
                )
            elif topic == "global_localization":
                node.global_localization()
            node.spin_once(t)
    node.shutdown(t)
    return 0


def run(argv=None):
    """Parse argv, build the node and run its data source: (exit code, the
    node)."""
    ap = argparse.ArgumentParser(prog="badger_amcl_tpu_torch")
    ap.add_argument("--config", default=None, help="YAML config file")
    ap.add_argument("--sim", action="store_true", help="run the built-in simulator")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--replay", default=None, help="JSONL message log to replay")
    ap.add_argument("--ros", action="store_true", help="bridge to ROS topics")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the node (default cuda; cpu without a card)")
    ap.add_argument("--seed", type=int, default=None, help="PRNG seed (default: time)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(levelname)s] %(message)s",
    )
    cfg = load_config(args.config)
    # srand48(time(NULL)) equivalent (main.cpp:39): seed from wall clock
    seed = args.seed if args.seed is not None else int(time.time()) & 0x7FFFFFFF
    from badger_amcl_tpu_torch.node import make_node

    node = make_node(cfg, seed=seed, device=args.device)
    shutdown = _Shutdown()
    try:
        if args.replay:
            return run_replay(node, cfg, args.replay, shutdown), node
        if args.ros:
            from badger_amcl_tpu_torch.node.ros_bridge import run_ros_bridge

            return run_ros_bridge(node, cfg, shutdown), node
        return run_sim(node, cfg, args.steps, shutdown), node
    finally:
        shutdown.close()


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
