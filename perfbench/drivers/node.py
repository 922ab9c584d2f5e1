"""The node driver: one production localization node of the port
(`badger_amcl_tpu_torch.node`, 2D or 3D by the configuration's map_type),
fed as the ROS bridge feeds it.

Set-up builds the store (its plan and the lap's gondola fixed by the
configuration's `layout_seed`, so every seed does the same work; the seed
draws the lap's starting point, the noise of odometry and readings and
the node's own variates), hands it to the node as its map message (timed
to its end on the card: `map_receipt_s`), samples the lap, raycasts one
lap of readings on the card and drives the warm-up stretch of the stream,
then captures every graph key the window can reach that the warm-up did
not. A step of the stream puts the odometry into the node's TF buffer and
its integrator, then hands the reading to `scan_received`, whose return is
the scan's latency: the node reads its published outputs to the host
itself. The timers' work (`spin_once`) follows, outside the latency.

Where the traffic sets `kidnap_every_s`, the stream carries the robot to
another part of its lap every that many simulated seconds (warm-up
included), and the driver calls the node's `global_localization()` just
before that step's `scan_received`, inside its latency: the service call a
supervisor makes on a kidnap.

The driver watches the node's compiled helpers through the node's own
`_call` (each call of a helper on the card is one graph replay): it counts
them, the score-rejection rounds of each resample and the host syncs, and
keeps a seeded sample of the steps' inputs and outputs for the check, each
with whether the node's global localization was active at the call (the
map factors it scored with). After the window, `after_window` scores one
seeded pool through the node's scoring helper for the check.
"""

from __future__ import annotations

import contextlib
import math
import os
import random
import time

import numpy as np

from perfbench.gen import raycast, route, store

# the node's compiled helpers by role, as (module, attribute) of the port
HELPERS = {
    "sensor_update": ("badger_amcl_tpu_torch.node.{dim}", "_sensor_update_jit"),
    "score_poses": ("badger_amcl_tpu_torch.node.{dim}", "_score_poses_jit"),
    "resample": ("badger_amcl_tpu_torch.node.node", "_resample_jit"),
    "motion_update": ("badger_amcl_tpu_torch.node.node", "_motion_update_jit"),
    "uniform_pool": ("badger_amcl_tpu_torch.node.node", "_uniform_pool_jit"),
}


# the resampler's variates as the node passes them to its helper:
# systematic's comb start, multinomial's injection and pick uniforms
VARIATES = ("u_start", "u_inject", "u_pick")


@contextlib.contextmanager
def _no_span(name):
    yield


def _stride(n: int, max_beams: int, model: str = None) -> int:
    """The node's decimation stride of a reading of n beams or points:
    ceil(n / max_beams) for the prob model's scan, else (n - 1) //
    (max_beams - 1)."""
    if model == "likelihood_field_prob":
        return max(1, math.ceil(n / max_beams))
    return max(1, (n - 1) // max(1, max_beams - 1))


def _kept(n: int, max_beams: int) -> int:
    """How many of n beams or points the node keeps."""
    return len(range(0, n, _stride(n, max_beams)))


class Reservoir:
    """A seeded uniform sample of at most k items of a stream (algorithm
    R)."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


class NodeDriver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, workdir: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.workdir = device, workdir
        self.params = config["params"]
        self.dim = "node_3d" if self.params.get("map_type", 2) == 3 else "node_2d"
        self.sensor = config["sensor"]
        self.rate = float(self.sensor["rate_hz"])
        self.info = {}
        self.recording = False
        self.counts = dict(scans=0, helper_calls=0, score_rounds=0, resamples=0)
        self._in_resample = False
        self._tracing = None

    # ------------------------------------------------------------------ set-up

    def _helper(self, role):
        import importlib

        mod, attr = HELPERS[role]
        return getattr(importlib.import_module(mod.format(dim=self.dim)), attr)

    def _make_map(self):
        m = self.config["map"]
        res, seed = m["resolution"], m["layout_seed"]
        if m["kind"] == "occupancy_grid":
            w, h = m["cells"]
            self.grid = store.grid(w, h, seed)
            self.map_input = dict(kind="occupancy_grid", data=self.grid.ravel(), width=w,
                                  height=h, resolution=res, origin=(0.0, 0.0))
        else:
            nx, ny, nz = m["cells"]
            self.voxels = store.voxels(nx, ny, nz, seed)
            self.map_input = dict(kind="octomap", cells=self.voxels, resolution=res)

    def _receive_map(self):
        """Hand the node its map message; time the receipt to its end on
        the card."""
        import torch

        from badger_amcl_tpu_torch.node import messages

        m = self.config["map"]
        if m["kind"] == "occupancy_grid":
            w, h = m["cells"]
            msg = messages.OccupancyGrid(width=w, height=h, resolution=m["resolution"],
                                         origin_x=0.0, origin_y=0.0, data=self.map_input["data"])
            receive = self.node.map_msg_received
        else:
            msg = messages.OctomapMsg(resolution=m["resolution"], occupied_centers=(
                self.voxels.astype(np.float64) * m["resolution"]))
            receive = self.node.octomap_msg_received
        t0 = time.perf_counter()
        receive(msg)
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
        self.info["map_receipt_s"] = time.perf_counter() - t0

    def _make_readings(self):
        import torch

        gen = torch.Generator(device=self.device).manual_seed(self.seed + 30)
        poses = self.lap.poses
        s = self.sensor
        m = self.config["map"]
        if s["kind"] == "laser":
            angles = np.linspace(s["angle_min"], s["angle_max"], s["beams"])
            occ = torch.as_tensor(self.grid == 100, device=self.device)
            self.readings = raycast.planar_ranges(
                occ, m["resolution"], int(self.params.get("map_scale_up_factor", 1)), poses,
                angles, s["range_max"], s["range_noise_m"], gen)
        else:
            nx, ny, nz = m["cells"]
            v = torch.as_tensor(self.voxels, device=self.device)
            tops = torch.zeros(nx * ny, dtype=torch.int64, device=self.device)
            tops.scatter_reduce_(0, v[:, 0] * ny + v[:, 1], v[:, 2], reduce="amax")
            el = np.deg2rad(np.linspace(s["elevation_min_deg"], s["elevation_max_deg"],
                                        s["rings"]))
            az = np.arange(s["azimuth_steps"]) * (2 * math.pi / s["azimuth_steps"]) - math.pi
            self.readings = raycast.lidar_clouds(
                tops.view(nx, ny).int(), nz, m["resolution"], poses, s["mount_height_m"], el,
                az, s["range_max"], s["range_noise_m"], gen)

    def reading(self, n: int):
        """The message of stream step n."""
        from badger_amcl_tpu_torch.node import messages

        k = int(self.stream.lap_index[n])
        stamp = n * self.stream.dt
        s = self.sensor
        if s["kind"] == "laser":
            inc = (s["angle_max"] - s["angle_min"]) / (s["beams"] - 1)
            return messages.LaserScan(stamp=stamp, frame_id=s["frame"],
                                      angle_min=s["angle_min"], angle_increment=inc,
                                      range_min=s["range_min"], range_max=s["range_max"],
                                      ranges=self.readings[k])
        return messages.PointCloud2(stamp=stamp, frame_id=s["frame"], points=self.readings[k])

    def setup(self, max_steps: int) -> None:
        """Everything before the window: map, node, readings, warm-up."""
        import torch

        from badger_amcl_tpu_torch.config import AMCLConfig
        from badger_amcl_tpu_torch.node import Transform, TransformBuffer, make_node

        t = self.traffic
        self._make_map()
        m = self.config["map"]
        self.lap = route.gondola_loop(tuple(m["cells"][:2]), m["resolution"], m["layout_seed"],
                                      t["speed_mps"], self.rate, t["turn_radius_m"],
                                      t["max_turn_rps"])
        self.info["lap"] = dict(metres=round(self.lap.length_m, 3), steps=len(self.lap.poses))
        self.warmup_steps = int(round(t["warmup_s"] * self.rate))
        self.trace_steps = int(round(t["trace_s"] * self.rate))
        every = t["kidnap_every_s"]
        self.kidnap_every = int(round(every * self.rate)) if every else 0
        steps = self.warmup_steps + max_steps
        self.stream = route.stream(self.lap, steps, self.seed, self.rate, t["odom_noise"],
                                   self.kidnap_every)
        self.kidnaps = set(route.kidnap_steps(steps, self.kidnap_every).tolist())
        cfg = AMCLConfig.from_params(dict(self.params))
        cfg = cfg.replace(saved_pose_filepath=os.path.join(self.workdir,
                                                           "badger_amcl_saved_pose.yaml"))
        self.tf = TransformBuffer()
        s = self.sensor
        mount = (Transform.identity() if s["kind"] == "laser"
                 else Transform.from_xyzrpy(z=s["mount_height_m"]))
        self.mount = mount.translation.copy()
        self.tf.set_static(cfg.base_frame_id, s["frame"], mount)
        self.cfg = cfg
        self.node = make_node(cfg, tf_buffer=self.tf, seed=self.seed, device=self.device)
        self.node.init_pose = self.lap.poses[self.stream.lap_index[0]].copy()
        self._receive_map()
        self._make_readings()
        self._watch()
        self.node.subscribe_output("amcl_pose", self._published)
        self.next_step = 0
        for _ in range(self.warmup_steps):
            self.step()
        self._warm_keys()
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def _warm_keys(self) -> None:
        """Capture the graph keys of the window that the warm-up missed:
        the 3D node's sensor update and scoring for every decimated cloud
        size of the lap, under the normal map factors and, where the
        traffic kidnaps, the global localization's too. Their outputs are
        dropped; the node's state and factors are left as they were."""
        if self.dim != "node_3d" or not self.device.startswith("cuda"):
            return
        import torch

        node = self.node
        sizes = sorted({_kept(len(c), int(self.params["laser_max_beams"]))
                        for c in self.readings})
        self.info["decimated_sizes"] = sizes
        upd, score = self._helper("sensor_update"), self._helper("score_poses")
        poses = node.state.poses
        model, backend = self.cfg.point_cloud_model_type.value, node.backend
        in_force = node.pc_params
        node._apply_normal_factors()
        factor_sets = [node.pc_params]
        if self.kidnap_every:
            node._apply_global_localization_factors()
            factor_sets.append(node.pc_params)
        node.pc_params = in_force
        for params in factor_sets:
            for k in sizes:
                pts = torch.zeros((k, 3), dtype=torch.float32, device=self.device)
                upd(node.state, node.map, params, pts, model, backend)
                score(node.map, params, pts, poses, model, backend)

    # ---------------------------------------------------------------- watching

    def _watch(self) -> None:
        """Route the node's helper calls through the driver."""
        node = self.node
        inner = node._call
        roles = {id(self._helper(role)): role for role in HELPERS}

        def call(helper, *args, **kwargs):
            role = roles.get(id(helper), "other")
            if self._tracing is None:
                out = inner(helper, *args, **kwargs)
            else:
                with self._tracing(role):
                    out = inner(helper, *args, **kwargs)
            self._on_helper(role, args, kwargs, out)
            return out

        node._call = call
        resample = node.resample_particles

        def resample_particles():
            self._in_resample = True
            try:
                resample()
            finally:
                self._in_resample = False
            if self.recording:
                self.counts["resamples"] += 1

        node.resample_particles = resample_particles

    def _on_helper(self, role, args, kwargs, out) -> None:
        """Keep what the check needs of a helper call: the state before and
        after (the state before holds the convergence flag that gates beam
        skipping), the reading, the variates (the motion's normals, the
        resample's pool and its comb uniform or its per-slot injection and
        pick uniforms), whether global localization was active and, for
        the motion, the stream's odometry from the last update's step to
        this one. The nodes put the normal map factors back at the start of
        the first scan after global localization ends, so the flag at a
        likelihood call names the factors it used."""
        cur = self._current
        if cur is None:
            return
        glob = self.node.global_localization_active
        if role == "motion_update":
            n, last = cur["n"], self._last_motion
            self._last_motion = n
            odom = None if last is None else self.stream.odom[last:n + 1].copy()
            cur["motion"] = dict(state_in=args[0], state_out=out, normals=args[5], odom=odom)
        elif role == "sensor_update":
            self._latest_msg, self._latest_n = cur["msg"], cur["n"]
            cur["update"] = dict(state_in=args[0], state_out=out, msg=cur["msg"], glob=glob)
        elif role == "resample":
            # the resampler's variates: the comb's start, or each slot's
            # injection and pick uniforms
            cur["resample"] = dict(state_in=args[0], state_out=out, pool=args[2], glob=glob,
                                   **{k: kwargs[k] for k in VARIATES if k in kwargs})
        elif role == "score_poses":
            cur["scores"].append(dict(poses=args[3], out=out, msg=self._latest_msg, glob=glob))
        if self.recording:
            self.counts["helper_calls"] += 1
            if role == "score_poses" and self._in_resample:
                self.counts["score_rounds"] += 1
            if self._tracing is not None and role in ("sensor_update", "score_poses"):
                poses = args[0].poses if role == "sensor_update" else args[3]
                n_active = args[0].n_active if role == "sensor_update" else None
                self._trace_work.append((role, int(poses.shape[0]), n_active,
                                            self._latest_msg))

    def _published(self, msg) -> None:
        if self._current is not None:
            self._current["published"] = (np.asarray(msg.pose, float),
                                          np.asarray(msg.covariance, float))

    # ------------------------------------------------------------------ window

    _current = None
    _latest_msg = None
    _latest_n = None
    _last_motion = None
    _trace_work = None
    _scan_glob = False

    def step(self) -> float:
        """Deliver the next step of the stream; returns its latency in
        seconds (the scan_received call)."""
        from badger_amcl_tpu_torch.node import Transform, messages

        n = self.next_step
        if n >= len(self.stream.lap_index):
            raise RuntimeError("the stream ran out: the window outran its sizing")
        self.next_step += 1
        stamp = n * self.stream.dt
        odom = self.stream.odom[n]
        msg = self.reading(n)
        span = self._tracing or _no_span
        with span("odometry"):
            self.tf.set_transform(self.cfg.odom_frame_id, self.cfg.base_frame_id, stamp,
                                  Transform.from_pose2d(odom))
            self.node.integrate_odom(messages.Odometry(stamp, odom.copy()))
        self._current = dict(n=n, msg=msg, scores=[], motion=None, update=None, resample=None,
                             published=None)
        kidnap = n in self.kidnaps
        if kidnap:
            # the node takes its odometry afresh after a global localization
            self._last_motion = None
        t0 = time.perf_counter()
        with span("scan_received"):
            if kidnap:
                self.node.global_localization()
            self._scan_glob = self.node.global_localization_active
            self.node.scan_received(msg)
        latency = time.perf_counter() - t0
        with span("spin_once"):
            self.node.spin_once(stamp)
        return latency

    def window(self, seconds: float, rng: random.Random, check: dict, tracer=None) -> dict:
        """Closed loop for `seconds` of wall time: each step starts when the
        last returns. With a tracer, its first trace_steps steps run inside
        tracer's profile (tracer.start / stop / span)."""
        from badger_amcl_tpu_torch.utils.numerics import SYNCS

        self.recording = True
        samples = {k: Reservoir(v, rng) for k, v in check.items()}
        longest = (-1.0, None)
        latencies = []
        syncs0 = SYNCS.count
        captures0 = self._captures()
        self._tracing = tracer.span if tracer is not None else None
        self._trace_work = [] if tracer is not None else None
        traced = 0
        untraced_from = None
        if tracer is not None:
            tracer.start()
        start = time.perf_counter()
        end = start + seconds
        while True:
            lat = self.step()
            latencies.append(lat)
            cur = self._current
            for kind, key in (("updates", "update"), ("resamples", "resample")):
                if cur[key] is not None:
                    samples[kind].offer(cur)
                    if cur[key]["glob"] and "global_" + kind in samples:
                        samples["global_" + kind].offer(cur)
            for sc in cur["scores"]:
                samples["scores"].offer(sc)
            cur["scores"] = len(cur["scores"])
            if lat > longest[0]:
                longest = (lat, cur)
            done = time.perf_counter()
            if tracer is not None and traced is not None:
                traced += 1
                if traced == self.trace_steps:
                    tracer.stop()
                    traced = None
                    untraced_from = (len(latencies), time.perf_counter())
                    self._tracing = None
            if done >= end and (tracer is None or traced is None):
                break
        self._current = None
        self.recording = False
        self._tracing = None
        self.counts["scans"] = len(latencies)
        self.counts["syncs"] = SYNCS.count - syncs0
        self.counts["window_captures"] = self._captures() - captures0
        records = {k: r.items for k, r in samples.items()}
        if longest[1] is not None:
            for kind, key in (("updates", "update"), ("resamples", "resample")):
                if longest[1][key] is not None and longest[1] not in records[kind]:
                    records[kind].append(longest[1])
        return dict(latencies=latencies, window_s=done - start, records=records,
                    trace_work=self._trace_work,
                    untraced=None if untraced_from is None else (
                        len(latencies) - untraced_from[0], done - untraced_from[1]))

    def after_window(self) -> dict:
        """More records for the check, made once the window's counts and
        metrics have been read: one seeded pool of max_particles poses,
        half near the true pose of the last reading the node updated on
        and half anywhere on the map, scored through the node's own
        scoring helper against that reading, with the map factors the last
        scan put in force. So every window has a score to compare, whether
        or not the node ran a score round in it."""
        import torch

        if self._latest_msg is None:
            return {}
        m = self.config["map"]
        n = int(self.params["max_particles"])
        kw = dict(dtype=torch.float64, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 50)
        truth = torch.as_tensor(self.lap.poses[self.stream.lap_index[self._latest_n]], **kw)
        near = truth + torch.randn((n // 2, 3), generator=gen, **kw) * torch.tensor(
            [0.3, 0.3, 0.2], **kw)
        size = torch.tensor([m["cells"][0] * m["resolution"], m["cells"][1] * m["resolution"],
                             2 * math.pi], **kw)
        anywhere = torch.rand((n - n // 2, 3), generator=gen, **kw) * size - torch.tensor(
            [0.0, 0.0, math.pi], **kw)
        poses = torch.cat([near, anywhere]).float()
        out = self.node.score_poses(poses)
        return {"scores": [dict(poses=poses, out=out, msg=self._latest_msg,
                                glob=self._scan_glob)]}

    def _captures(self) -> int:
        return sum(getattr(self._helper(r), "captures", 0) for r in HELPERS)

    # ----------------------------------------------------------------- reports

    def arms(self) -> dict:
        """Executions of each conditional arm in the likelihood helpers'
        graphs over the run (one host read an entry)."""
        out = {}
        for role in ("sensor_update", "score_poses"):
            for entry in self._helper(role).entries.values():
                for k, v in entry.capture.arm_counts().items():
                    out[f"{role}/{k}"] = out.get(f"{role}/{k}", 0) + v
        return out

    def work(self, role: str, n_poses: int, msg) -> tuple:
        """(pairs, texel bytes a pair) of one likelihood evaluation: poses
        times valid beams (2D, with the model's decimation) or kept points
        (3D)."""
        if self.sensor["kind"] == "laser":
            r = np.asarray(msg.ranges, np.float64)
            r = np.where(r <= self.sensor["range_min"], self.sensor["range_max"], r)
            kept = r[::_stride(len(r), int(self.params["laser_max_beams"]),
                               self.params.get("laser_model_type"))]
            return n_poses * int(np.sum(kept < self.sensor["range_max"])), 4
        return n_poses * _kept(len(msg.points), int(self.params["laser_max_beams"])), 1

    def close(self) -> None:
        self.node.shutdown(self.next_step * self.stream.dt)


DRIVER = NodeDriver
