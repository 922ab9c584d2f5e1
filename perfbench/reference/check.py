"""The numbers that decide `correct`: the sampled steps of a window, each
held against the plain reference (`reference.amcl`), in float64; and the
same numbers of the control, the reference computed in bfloat16 and put in
the program's place.

The node is a particle filter: what it computes from a step follows from
its state before the step and the random variates it drew, so the
reference follows it from that state. `Model` takes the measurement,
motion and resampling models the configuration names (`laser_model_type`
with `do_beamskip`, `odom_model_type`, `resample_model_type`). Each
sampled step gives:

- `weights_rel`: the weights after the sensor update against the
  reference's likelihood (and map factor) of the step's reading times the
  weights before it, normalized; the widest gap of a particle, relative to
  the larger of its reference weight and the median one. Beam skipping
  runs where the set before the update had converged;
- `score_rel`: the measurement model's raw per-pose output in a round of
  the uniform pool's score rejection, or on the pool the driver scores
  after the window, the same way (never with beam skipping);
- `kld_count`: the gap of the particle count a resample drew to the
  reference's KLD count: under systematic resampling the Fox bound of the
  set it resampled, inflated by w_diff; under multinomial resampling the
  nearest count at which the stop rule, applied while drawing, allows the
  draws to end (any count a bin edge within float32 rounding of a pose
  allows);
- `draw_gap`: the set a resample drew against the reference's draw from
  the same set, weights, random pool and variates: under systematic
  resampling the comb from its uniform (`amcl.draw_gap`), under
  multinomial each slot's injection and pick uniforms
  (`amcl.multinomial_gap`); the widest distance, in weight mass, between
  a slot's point and the interval of the particle the program put there,
  1 where a slot holds the wrong pose;
- `motion_m`, `motion_yaw_rel`: the particles after the motion update
  against the reference's motion model of the set before it, with the
  update's standard normals and the motion the reference works out again
  from the stream's odometry since the last update; the widest gap of a
  particle in metres, and of its yaw relative to the yaw's size (at least
  1 rad: the models leave yaw unwrapped, so it grows lap by lap and its
  float32 rounding with it);
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


# float32's least normal number: the program's weights and scores are
# float32, so below it they hold no relative precision, and a likelihood
# under it (the prob model's product of tens of beams, far from the pose)
# reads 0
F32_TINY = torch.finfo(torch.float32).tiny


def _rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap of prog to ref relative to the larger of the
    reference's value, its median and F32_TINY."""
    return float(((prog.double() - ref.double()).abs() / _floor(ref)).max())


def _floor(ref: torch.Tensor) -> torch.Tensor:
    ref = ref.double()
    return torch.maximum(ref, ref.median().clamp(min=F32_TINY))


def _interval_gap(prog, lo, hi, floor) -> torch.Tensor:
    prog = prog.double()
    return torch.clamp(torch.maximum(lo - prog, prog - hi), min=0.0) / floor


def _score_gap(prog: torch.Tensor, ref: torch.Tensor, alts) -> float:
    """`_rel_gap`, where alts (`Model.bounds`) leave each reference value
    an interval: the distance from it, the nearest alternative's."""
    if alts is None:
        return _rel_gap(prog, ref)
    floor = _floor(ref)
    return min(float(_interval_gap(prog, lo, hi, floor).max()) for lo, hi in alts)


def _weights_gap(prog: torch.Tensor, ref: torch.Tensor, w_in: torch.Tensor, alts) -> float:
    """`_rel_gap` of normalized weights, where alts leave each likelihood
    an interval: prog must be the weights before it times a likelihood in
    each particle's interval, over one total common to all particles (a
    total between the least and greatest the intervals allow); the widest
    gap at the total that makes it least (along the total's inverse each
    particle's gap falls, then rises, and so does the widest: a ternary
    search finds its least), the nearest alternative's. An alternative
    whose likelihoods are all 0 leaves the weights uniform."""
    if alts is None:
        return _rel_gap(prog, ref)
    floor = _floor(ref)
    w = w_in.double()
    n = w.shape[0]
    best = math.inf
    for lo, hi in alts:
        w_lo, w_hi = w * lo, w * hi
        t_lo, t_hi = float(w_lo.sum()), float(w_hi.sum())
        if t_lo <= 0.0:
            u = torch.full_like(w, 1.0 / n)
            best = min(best, float(_interval_gap(prog, u, u, floor).max()))
            if t_hi <= 0.0:
                continue
        a, b = -math.log(t_hi), -math.log(t_lo) if t_lo > 0.0 else -math.log(t_hi) + 700.0

        def widest(log_s):
            s = math.exp(log_s)
            return float(_interval_gap(prog, s * w_lo, s * w_hi, floor).max())

        for _ in range(100):
            m1, m2 = a + (b - a) / 3.0, b - (b - a) / 3.0
            if widest(m1) <= widest(m2):
                b = m2
            else:
                a = m1
        best = min(best, widest((a + b) / 2.0))
    return best


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


# the models the reference holds, by the configuration's parameter (with
# upstream's default where the configuration leaves it out)
PLANAR_MODELS = ("likelihood_field", "likelihood_field_prob", "likelihood_field_gompertz")
CLOUD_MODELS = ("likelihood_field_gompertz",)
ODOM_MODELS = ("diff", "diff-corrected", "gaussian")
RESAMPLE_MODELS = ("multinomial", "systematic")


def _model(p: dict, key: str, default: str, known: tuple, what: str) -> str:
    name = p.get(key, default)
    if name not in known:
        raise ValueError(f"the reference has no {what} {name!r} ({key}); it has "
                         f"{', '.join(known)}")
    return name


class Model:
    """The reference's map and its measurement, motion and resampling models
    of one configuration in one dtype, built from the raw map the node was
    given. The models follow the configuration's `laser_model_type` (and
    `do_beamskip`), `odom_model_type` and `resample_model_type`; one the
    reference lacks raises, naming it."""

    def __init__(self, config: dict, map_input: dict, mount, dtype, device):
        p = config["params"]
        self.p, self.dtype, self.mount = p, dtype, mount
        self.factors = {"normal": tuple(config["factors"]["normal"]),
                        "global": global_factors(p)}
        self.planar = map_input["kind"] == "occupancy_grid"
        self.laser = (_model(p, "laser_model_type", "likelihood_field", PLANAR_MODELS,
                             "planar model") if self.planar else
                      _model(p, "laser_model_type", "likelihood_field", CLOUD_MODELS,
                             "point-cloud model"))
        self.odom = _model(p, "odom_model_type", "diff", ODOM_MODELS, "odometry model")
        self.resample = _model(p, "resample_model_type", "multinomial", RESAMPLE_MODELS,
                               "resampling model")
        self.beamskip = self.laser == amcl.PROB and bool(p.get("do_beamskip", False))
        # badger_amcl's default for an alpha the launch file leaves out
        self.alphas = tuple(float(p.get(f"odom_alpha{i}", 0.2)) for i in range(1, 6))
        if self.planar:
            self.map = amcl.PlanarMap(
                map_input["data"], map_input["width"], map_input["height"],
                map_input["resolution"], map_input["origin"],
                int(p.get("map_scale_up_factor", 1)), p["laser_likelihood_max_dist"], dtype,
                device)
        else:
            self.map = amcl.VoxelMap(map_input["cells"], map_input["resolution"],
                                     p["laser_likelihood_max_dist"], dtype, device)

    def likelihood(self, msg, poses: torch.Tensor, glob: bool = False,
                   converged: bool = False) -> torch.Tensor:
        """Per pose, under the normal map factors or (glob) the global
        localization's. `converged`, the set's flag before the update,
        gates beam skipping, whose poses are then the whole active set; the
        scoring of poses passes none (the node scores without beam
        skipping, node_2d.py `_score_poses`)."""
        fac = self.factors["global" if glob else "normal"]
        if not self.planar:
            pts = amcl.cloud_points(msg.points, int(self.p["laser_max_beams"]), self.mount,
                                    self.dtype)
            return amcl.cloud_gompertz(self.map, self.p, fac[0], pts, poses)
        if self.laser != "likelihood_field_gompertz":
            return self._field(msg, poses, glob, converged)[0][0]
        r, a, v, _ = self._scan(msg)
        return amcl.planar_gompertz(self.map, self.p, fac, r, a, v, poses)

    def bounds(self, msg, poses: torch.Tensor, glob: bool = False, converged: bool = False):
        """What the likelihood may give each pose where a beam's endpoint
        within float32 rounding of a cell's edge falls on either side of it
        (`amcl.planar_field` with `amcl.EDGE_SLACK`: alternatives of
        (least, greatest)), for the plain and prob likelihood fields, whose
        sums and products carry a cell's step whole; None for the Gompertz
        models, whose mean of many beams does not."""
        if not self.planar or self.laser == "likelihood_field_gompertz":
            return None
        return self._field(msg, poses, glob, converged, amcl.EDGE_SLACK)

    def _scan(self, msg) -> tuple:
        """(ranges, angles, valid, range_max) of the beams the model keeps,
        range_min and range_max after the node's own limits (node_2d.cpp
        updateLatestScanData: laser_min_range and laser_max_range where
        positive)."""
        lo, hi = (float(self.p.get(k, -1.0)) for k in ("laser_min_range", "laser_max_range"))
        range_min = max(msg.range_min, lo) if lo > 0 else msg.range_min
        range_max = min(msg.range_max, hi) if hi > 0 else msg.range_max
        r, a, v = amcl.planar_beams(msg.ranges, msg.angle_min, msg.angle_increment, range_min,
                                    range_max, int(self.p["laser_max_beams"]), self.dtype,
                                    model=self.laser)
        return r, a, v, range_max

    def _field(self, msg, poses, glob, converged, slack=0.0) -> list:
        r, a, v, range_max = self._scan(msg)
        slots = int(self.p["laser_max_beams"]) if self.beamskip and converged else 0
        return amcl.planar_field(self.map, self.p, self.factors["global" if glob else "normal"],
                                 r, a, v, range_max, poses, self.laser, skip_slots=slots,
                                 slack=slack)

    def motion(self, before, normals, motion, dtype) -> torch.Tensor:
        """The particles (M, 3) after the motion model, from the set before
        it, the update's normals (3, M) and `amcl.odometry_motion`'s
        (pose, delta, absolute motion)."""
        if self.odom == "gaussian":
            return amcl.gaussian_motion(before, normals, *motion, self.alphas, dtype)
        pose, delta, _ = motion
        return amcl.diff_motion(before, normals, pose, delta, self.alphas, dtype,
                                corrected=self.odom == "diff-corrected")


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


def _multinomial(r, poses_in, weights_in, pool, drawn, w_diff, kld, prog, ctl, glob):
    """`kld_count` and `draw_gap` of a multinomial resample (each slot's
    injection and pick uniforms): the drawn set's distance from the draw
    (`amcl.multinomial_gap`), and the distance of its count from the
    nearest count at which the stop rule allows the draws to end
    (`amcl.multinomial_counts`). Those draws are the program's drawn set,
    which `draw_gap` holds to the draw, then the reference's own draw of
    the slots past it; the control's are its own draw in bfloat16."""
    dev = poses_in.device
    u_inject, u_pick = r["u_inject"].to(dev), r["u_pick"].to(dev)
    ref_draw = amcl.multinomial_draw(poses_in, weights_in, pool, u_inject, u_pick, w_diff,
                                     torch.float64)
    outs = [(drawn, prog)]
    if ctl is not None:
        low = amcl.multinomial_draw(poses_in, weights_in, pool, u_inject, u_pick, w_diff,
                                    torch.bfloat16)
        counts = amcl.multinomial_counts(low, *kld, torch.bfloat16, slack=0.0, rel=0.0)
        outs.append((low[:int(torch.nonzero(counts)[0]) + 1], ctl))
    for got, into in outs:
        n = got.shape[0]
        into.add("draw_gap", amcl.multinomial_gap(poses_in, weights_in, pool, got, u_inject,
                                                  u_pick, w_diff), glob)
        seq = torch.cat([got, ref_draw[n:].to(got.dtype)])
        allowed = torch.nonzero(amcl.multinomial_counts(seq, *kld, torch.float64)).flatten() + 1
        into.add("kld_count", int((allowed - n).abs().min()), glob)


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
        # the beam-skip test reads the set's convergence before the update
        conv = bool(st_in.converged) if ref.beamskip else False
        w_ref = amcl.normalize(w_in, ref.likelihood(u["msg"], poses, glob, conv), n)
        alts = ref.bounds(u["msg"], poses, glob, conv)
        prog.add("weights_rel", _weights_gap(st_out.weights[:n].to(device), w_ref, w_in, alts),
                 glob)
        if low:
            w_low = amcl.normalize(w_in, low.likelihood(u["msg"], poses, glob, conv), n)
            ctl.add("weights_rel", _weights_gap(w_low, w_ref, w_in, alts), glob)
        mo = rec.get("motion")
        if mo is not None and mo["odom"] is not None:
            motion = amcl.odometry_motion(mo["odom"], float(p["update_min_d"]),
                                          float(p["update_min_a"]))
            n = int(mo["state_in"].n_active)
            before = mo["state_in"].poses[:n].to(device)
            normals = mo["normals"][:, :n].to(device)
            want = ref.motion(before, normals, motion, f64)
            outs = [(mo["state_out"].poses[:n].to(device), prog)]
            if low:
                outs.append((ref.motion(before, normals, motion, torch.bfloat16), ctl))
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
        alts = ref.bounds(sc["msg"], poses, sc["glob"])
        prog.add("score_rel", _score_gap(sc["out"].to(device), p_ref, alts), sc["glob"])
        if low:
            ctl.add("score_rel", _score_gap(low.likelihood(sc["msg"], poses, sc["glob"]), p_ref,
                                            alts), sc["glob"])
    kld = (int(p["min_particles"]), int(p["max_particles"]), float(p["kld_err"]),
           float(p["kld_z"]))
    for rec in _merged(records, "resamples"):
        r = rec["resample"]
        glob = r["glob"]
        st_in, st_out = r["state_in"], r["state_out"]
        n_in, n_out = int(st_in.n_active), int(st_out.n_active)
        ws, wf = float(st_in.w_slow), float(st_in.w_fast)
        poses_in = st_in.poses.to(device)
        weights_in, pool = st_in.weights.to(device), r["pool"].to(device)
        w_diff = max(0.0, 1.0 - wf / ws) if ws > 0 else 0.0
        drawn = st_out.poses[:n_out].to(device)
        if ref.resample == "multinomial":
            _multinomial(r, poses_in, weights_in, pool, drawn, w_diff, kld, prog,
                         ctl if low else None, glob)
        else:
            want = amcl.kld_counts(poses_in, n_in, ws, wf, *kld, f64)
            prog.add("kld_count", min(abs(n_out - c) for c in want), glob)
            if low:
                got = amcl.kld_counts(poses_in, n_in, ws, wf, *kld, torch.bfloat16,
                                      slack=0.0, rel=0.0)
                ctl.add("kld_count", min(abs(g - c) for g in got for c in want), glob)
            # the draw: the program's count, the pool's share of it from w_diff
            u = float(r["u_start"])
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
