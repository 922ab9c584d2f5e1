"""The numbers that decide `correct`: the sampled steps of a window, each
held against the plain reference (`reference.amcl`), in float64; and the
same numbers of the control, the reference computed in bfloat16 and put in
the program's place.

The node is a particle filter: what it computes from a step follows from
its state before the step and the random variates it drew, so the
reference follows it from that state. Each sampled step gives:

- `weights_rel`: the weights after the sensor update against the
  reference's Gompertz likelihood field (and map factor) of the step's
  reading times the weights before it, normalized; the widest gap of a
  particle, relative to the larger of its reference weight and the
  median one;
- `score_rel`: the measurement model's raw per-pose output in a round of
  the uniform pool's score rejection, or on the pool the driver scores
  after the window, the same way;
- `kld_count`: the gap of the particle count a resample drew to the
  reference's KLD count of the set it resampled (any count a bin edge
  within float32 rounding of a pose allows);
- `draw_gap`: the set a resample drew against the reference's systematic
  draw from the same set, weights, random pool and comb uniform (`amcl.
  draw_gap`: the widest distance, in weight mass, between a slot's comb
  point and the interval of the particle the program put there);
- `motion_m`, `motion_yaw_rel`: the particles after the motion update
  against the reference's Gaussian motion model of the set before it, with
  the update's standard normals and the motion the reference works out
  again from the stream's odometry since the last update; the widest gap
  of a particle in metres, and of its yaw relative to the yaw's size (at
  least 1 rad: the model leaves yaw unwrapped, so it grows lap by lap and
  its float32 rounding with it);
- `pose_m`, `pose_rad`: the published amcl_pose after a resample against
  the heaviest cluster's mean of the reference's statistics of the
  resampled set (where clusters tie for the heaviest, the nearest);
- `cov_abs`: the published covariance (xx, xy, yy, yaw) against the
  reference's statistics of the whole set, the widest absolute gap.

Each record says whether the node's global localization was active at
the call (`glob`); the likelihood then takes the global localization's map
factors, read from the configuration's parameters as the upstream nodes
read them, and its readings are kept apart as the global phase's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import amcl

NAMES = ("weights_rel", "score_rel", "kld_count", "draw_gap", "motion_m", "motion_yaw_rel",
         "pose_m", "pose_rad", "cov_abs")
# the published 6 x 6 covariance's xx, xy, yy and yaw entries
COV_ENTRIES = (0, 1, 7, 35)


def _rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    floor = torch.maximum(ref, ref.median().clamp(min=1e-300))
    return float(((prog.double() - ref).abs() / floor).max())


def _angle(a: float, b: float) -> float:
    return abs(math.atan2(math.sin(a - b), math.cos(a - b)))


def global_factors(p: dict) -> tuple:
    """The map factors of global localization as the upstream nodes read
    them from their parameters, 1.0 (their default) for one left unset:
    the 2D node's off map and not free space, with the normal radius; the
    3D node's off map (`global_localization_scanner_off_map_factor`: the
    3D launch file's `global_localization_point_cloud_scanner_*` spellings
    are declared there but never read, node_3d.cpp:75-77)."""
    if p.get("map_type", 2) == 3:
        return (float(p.get("global_localization_scanner_off_map_factor", 1.0)),)
    return (float(p.get("global_localization_laser_off_map_factor", 1.0)),
            float(p.get("global_localization_laser_non_free_space_factor", 1.0)),
            float(p["laser_non_free_space_radius"]))


class Model:
    """The reference's map and measurement model of one configuration in
    one dtype, built from the raw map the node was given."""

    def __init__(self, config: dict, map_input: dict, mount, dtype, device):
        p = config["params"]
        self.p, self.dtype, self.mount = p, dtype, mount
        self.factors = {"normal": tuple(config["factors"]["normal"]),
                        "global": global_factors(p)}
        if p["odom_model_type"] != "gaussian" or p["resample_model_type"] != "systematic":
            raise ValueError("the reference has the Gaussian odometry model and systematic "
                             "resampling only")
        # badger_amcl's default for an alpha the launch file leaves out
        self.alphas = tuple(float(p.get(f"odom_alpha{i}", 0.2)) for i in range(1, 6))
        self.planar = map_input["kind"] == "occupancy_grid"
        if self.planar:
            self.map = amcl.PlanarMap(
                map_input["data"], map_input["width"], map_input["height"],
                map_input["resolution"], map_input["origin"],
                int(p.get("map_scale_up_factor", 1)), p["laser_likelihood_max_dist"], dtype,
                device)
        else:
            self.map = amcl.VoxelMap(map_input["cells"], map_input["resolution"],
                                     p["laser_likelihood_max_dist"], dtype, device)

    def likelihood(self, msg, poses: torch.Tensor, glob: bool = False) -> torch.Tensor:
        """Per pose, under the normal map factors or (glob) the global
        localization's."""
        fac = self.factors["global" if glob else "normal"]
        if self.planar:
            r, a, v = amcl.planar_beams(msg.ranges, msg.angle_min, msg.angle_increment,
                                        msg.range_min, msg.range_max,
                                        int(self.p["laser_max_beams"]), self.dtype)
            return amcl.planar_gompertz(self.map, self.p, fac, r, a, v, poses)
        pts = amcl.cloud_points(msg.points, int(self.p["laser_max_beams"]), self.mount,
                                self.dtype)
        return amcl.cloud_gompertz(self.map, self.p, fac[0], pts, poses)


def _stats(poses, n, dtype):
    q = poses[:n]
    return amcl.cluster_stats(q, torch.full((n,), 1.0 / n, dtype=torch.float64,
                                            device=q.device), dtype)


def _heaviest(stats) -> list:
    w = stats["weights"].double()
    top = float(w.max())
    return [stats["means"][i].double().tolist()
            for i in torch.nonzero(w >= top * (1 - 1e-9)).flatten().tolist()]


class _Gaps:
    """Each compared number's readings, kept apart by the phase of the
    step they came from: normal tracking or global localization."""

    def __init__(self):
        self.by = {k: {False: [], True: []} for k in NAMES}

    def add(self, name: str, value, glob: bool) -> None:
        self.by[name][bool(glob)].append(value)

    def widest(self, phases=(False, True)) -> dict:
        """{name: the widest reading of those phases, or None}."""
        out = {}
        for k, v in self.by.items():
            vals = [x for ph in phases for x in v[ph]]
            out[k] = max(vals) if vals else None
        return out

    def counts(self, phases=(False, True)) -> dict:
        return {k: sum(len(v[ph]) for ph in phases) for k, v in self.by.items()}


def _merged(records: dict, kind: str) -> list:
    """A kind's records with its global phase's sample ("global_<kind>"),
    each record once."""
    out, seen = [], set()
    for rec in records.get(kind, []) + records.get("global_" + kind, []):
        if id(rec) not in seen:
            seen.add(id(rec))
            out.append(rec)
    return out


def readings(records: dict, config: dict, map_input: dict, mount, device,
             control: bool = False) -> dict:
    """{"program": {name: value or None}, "counts": {name: readings},
    "phases": {"normal": ..., "global": ...}, "global_counts": ...,
    "control": ... (with control)}: the widest gap of each number over the
    sampled steps (None where the window gave none to compare), overall
    and by phase."""
    p = config["params"]
    f64 = torch.float64
    ref = Model(config, map_input, mount, f64, device)
    low = Model(config, map_input, mount, torch.bfloat16, device) if control else None
    prog, ctl = _Gaps(), _Gaps()
    for rec in _merged(records, "updates"):
        u = rec["update"]
        glob = u["glob"]
        st_in, st_out = u["state_in"], u["state_out"]
        n = int(st_in.n_active)
        poses = st_in.poses[:n].to(device)
        w_in = st_in.weights[:n].to(device)
        w_ref = amcl.normalize(w_in, ref.likelihood(u["msg"], poses, glob), n)
        prog.add("weights_rel", _rel_gap(st_out.weights[:n].to(device), w_ref), glob)
        if low:
            w_low = amcl.normalize(w_in, low.likelihood(u["msg"], poses, glob), n)
            ctl.add("weights_rel", _rel_gap(w_low, w_ref), glob)
        mo = rec.get("motion")
        if mo is not None and mo["odom"] is not None:
            motion = amcl.odometry_motion(mo["odom"], float(p["update_min_d"]),
                                          float(p["update_min_a"]))
            n = int(mo["state_in"].n_active)
            before = mo["state_in"].poses[:n].to(device)
            normals = mo["normals"][:, :n].to(device)
            want = amcl.gaussian_motion(before, normals, *motion, ref.alphas, f64)
            outs = [(mo["state_out"].poses[:n].to(device), prog)]
            if low:
                outs.append((amcl.gaussian_motion(before, normals, *motion, ref.alphas,
                                                  torch.bfloat16), ctl))
            for got, into in outs:
                got = got.double()
                into.add("motion_m", float(torch.hypot(got[:, 0] - want[:, 0],
                                                       got[:, 1] - want[:, 1]).max()), glob)
                into.add("motion_yaw_rel", float(
                    ((got[:, 2] - want[:, 2]).abs() / want[:, 2].abs().clamp(min=1.0)).max()),
                    glob)
    for sc in records.get("scores", []):
        poses = sc["poses"].to(device)
        p_ref = ref.likelihood(sc["msg"], poses, sc["glob"])
        prog.add("score_rel", _rel_gap(sc["out"].to(device), p_ref), sc["glob"])
        if low:
            ctl.add("score_rel", _rel_gap(low.likelihood(sc["msg"], poses, sc["glob"]), p_ref),
                    sc["glob"])
    kld = (int(p["min_particles"]), int(p["max_particles"]), float(p["kld_err"]),
           float(p["kld_z"]))
    for rec in _merged(records, "resamples"):
        r = rec["resample"]
        glob = r["glob"]
        st_in, st_out = r["state_in"], r["state_out"]
        n_in, n_out = int(st_in.n_active), int(st_out.n_active)
        ws, wf = float(st_in.w_slow), float(st_in.w_fast)
        poses_in = st_in.poses.to(device)
        want = amcl.kld_counts(poses_in, n_in, ws, wf, *kld, f64)
        prog.add("kld_count", min(abs(n_out - c) for c in want), glob)
        if low:
            got = amcl.kld_counts(poses_in, n_in, ws, wf, *kld, torch.bfloat16, slack=0.0,
                                  rel=0.0)
            ctl.add("kld_count", min(abs(g - c) for g in got for c in want), glob)
        # the draw: the program's count, the pool's share of it from w_diff
        weights_in, pool = st_in.weights.to(device), r["pool"].to(device)
        u = float(r["u_start"])
        w_diff = max(0.0, 1.0 - wf / ws) if ws > 0 else 0.0
        drawn = st_out.poses[:n_out].to(device)
        prog.add("draw_gap", amcl.draw_gap(poses_in, weights_in, pool, drawn, u,
                                           int(w_diff * n_out)), glob)
        if low:
            k = int(torch.tensor(w_diff, dtype=torch.bfloat16) * n_out)
            mine = amcl.comb_draw(poses_in, weights_in, pool, u, n_out, k, torch.bfloat16)
            ctl.add("draw_gap", amcl.draw_gap(poses_in, weights_in, pool, mine, u, k), glob)
        if rec["published"] is None:
            continue
        poses_out = st_out.poses.to(device)
        stats = _stats(poses_out, n_out, f64)
        cands = _heaviest(stats)
        cov_ref = stats["cov"].double().cpu().numpy()
        outs = [(rec["published"][0], rec["published"][1][list(COV_ENTRIES)], prog)]
        if low:
            s_low = _stats(poses_out, n_out, torch.bfloat16)
            i = int(torch.argmax(s_low["weights"].double()))
            outs.append((np.asarray(s_low["means"][i].double().tolist()),
                         s_low["cov"].double().cpu().numpy(), ctl))
        for pose, cov, into in outs:
            best = min(cands, key=lambda m: math.hypot(pose[0] - m[0], pose[1] - m[1]))
            into.add("pose_m", math.hypot(pose[0] - best[0], pose[1] - best[1]), glob)
            into.add("pose_rad", _angle(pose[2], best[2]), glob)
            into.add("cov_abs", float(np.max(np.abs(np.asarray(cov) - cov_ref))), glob)
    out = {"program": prog.widest(), "counts": prog.counts(),
           "phases": {"normal": prog.widest((False,)), "global": prog.widest((True,))},
           "global_counts": prog.counts((True,))}
    if control:
        out["control"] = ctl.widest()
    return out


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number compared at least
    once and within its limit. A number with no reading fails: the window
    gave it nothing to compare (no resample, no score round), or the
    driver no longer sees the helper that produces it."""
    rows = [(k, values.get(k), limits[k]) for k in NAMES]
    ok = all(v is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
