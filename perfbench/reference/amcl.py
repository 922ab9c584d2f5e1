"""Plain reference of what the benchmark checks the localization nodes
against, written from badger_amcl's semantics (the C++ node), in plain
PyTorch with the arithmetic in one dtype: float64 for the reference,
bfloat16 for its control.

- `capped_field_2d`, `voxel_levels`: the distance look-up tables the
  upstream maps build at receipt (occupancy_map.cpp updateDistancesLUT: a
  distance to the nearest occupied cell, capped; octomap.cpp: the same in
  3D, quantized to 255 levels of max_distance / 255), as exact squared
  distances from windowed minima along each axis.
- `planar_gompertz`, `cloud_gompertz`: calcLikelihoodFieldModelGompertz of
  planar_scanner.cpp and point_cloud_scanner.cpp, times recalcWeight's
  map factor, per pose.
- `planar_field`: calcLikelihoodFieldModel (planar_scanner.cpp:236-323)
  and calcLikelihoodFieldModelProb with and without beam skipping
  (:325-533), times recalcWeight's map factor (:642-682), per pose, and
  what they may give where an endpoint within float32 rounding of a cell's
  edge falls on either side of it; `planar_beams` decimates a scan with
  each model's stride.
- `normalize`: the weights after a sensor update (particle_filter.cpp).
- `odometry_motion`, `gaussian_motion`, `diff_motion`: the motion the node
  hands its model at an update (node.cpp updatePf / integrateOdom /
  updateOdom: the odometry since the last update, the integrated absolute
  motion) and odom.cpp's ODOM_MODEL_GAUSSIAN, ODOM_MODEL_DIFF and
  ODOM_MODEL_DIFF_CORRECTED applied to every particle.
- `comb`, `draw_gap`: resampleSystematic's draw (particle_filter.cpp): the
  first slots from the random pool, the rest a low-variance comb from one
  uniform over the cumulative weights; and how far a drawn set lies from
  it.
- `multinomial_draw`, `multinomial_gap`: resampleMultinomial's draw
  (particle_filter.cpp:356-420): each slot a random pose where its
  injection uniform falls below w_diff, else the particle whose interval
  of the cumulative weights holds its pick uniform; and how far a drawn
  set lies from it.
- `kld_counts`: the particle count that systematic resampling draws: the
  Fox bound of the previous set's occupied histogram bins (0.5 m, 0.5 m,
  10 degrees; particle_filter.cpp resampleLimit), inflated by w_diff.
- `multinomial_counts`: the counts at which multinomial resampling stops
  drawing: the first count above the Fox bound of the bins its own draws
  occupy so far (resampleLimit as resampleMultinomial applies it while it
  draws).
- `cluster_stats`: computeClusterStatsForSet: histogram bins joined with
  their 26 neighbours into clusters, each cluster's weighted mean with a
  circular yaw mean, and the whole set's covariance with the yaw term
  -2 log of the mean resultant length.

Where the reference departs from upstream's code, the function's
docstring says so. Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import torch

BIN = (0.5, 0.5, 10.0 * math.pi / 180.0)


def windowed_sq_distances(occupied: torch.Tensor, r: int) -> torch.Tensor:
    """int64 squared distance (in cells) from each cell to the nearest
    occupied one, exact where it is at most r * r; larger elsewhere."""
    far = torch.iinfo(torch.int64).max // 4
    g = torch.where(occupied, 0, far).to(torch.int64)
    for dim in range(occupied.dim()):
        n = g.shape[dim]
        out = g.clone()
        for o in range(1, min(r, n - 1) + 1):
            lo = out.narrow(dim, 0, n - o)
            torch.minimum(lo, g.narrow(dim, o, n - o) + o * o, out=lo)
            hi = out.narrow(dim, o, n - o)
            torch.minimum(hi, g.narrow(dim, 0, n - o) + o * o, out=hi)
        g = out
    return g


def capped_field_2d(occupied: torch.Tensor, resolution: float, max_dist: float,
                    dtype) -> torch.Tensor:
    """(H, W) distance in metres to the nearest occupied cell, max_dist
    beyond floor(max_dist / resolution) cells."""
    r = int(math.floor(max_dist / resolution))
    d2 = windowed_sq_distances(occupied, r)
    d = torch.sqrt(d2.clamp(max=r * r).to(dtype)) * resolution
    return torch.where(d2 <= r * r, d, torch.full_like(d, max_dist))


def voxel_levels(occupied: torch.Tensor, resolution: float, max_dist: float) -> torch.Tensor:
    """uint8 levels floor(min(d, max) / max * 255) of a boolean volume (any
    axis order), d the distance in metres to the nearest occupied voxel."""
    r = int(math.ceil(max_dist / resolution)) + 1
    d2 = windowed_sq_distances(occupied, r)
    d = torch.sqrt(d2.clamp(max=r * r).to(torch.float64)) * resolution
    lv = torch.floor(torch.clamp(d, max=max_dist) / max_dist * 255.0)
    return torch.where(d2 <= r * r, lv, 255.0).to(torch.uint8)


def gompertz(p: dict, s: torch.Tensor) -> torch.Tensor:
    """applyGompertz: a * exp(-b * exp(-c * (s * scale + shift))) + out."""
    x = s * p["laser_gompertz_input_scale"] + p["laser_gompertz_input_shift"]
    return (p["laser_gompertz_a"] * torch.exp(-p["laser_gompertz_b"] * torch.exp(
        -p["laser_gompertz_c"] * x)) + p["laser_gompertz_output_shift"])


def _term(p: dict, d: torch.Tensor) -> torch.Tensor:
    """The Gompertz models' pz: z_hit exp(-d^2 / 2 sigma^2) + z_rand."""
    sigma = p["laser_sigma_hit"]
    return p["laser_z_hit"] * torch.exp(-(d * d) / (2.0 * sigma * sigma)) + p["laser_z_rand"]


class PlanarMap:
    """The 2D node's map from an OccupancyGrid (0 free, 100 occupied, else
    unknown), supersampled by `scale` as the node does (node_2d.cpp): each
    cell split into scale x scale, the centre origin msg.origin + (size //
    2) * resolution, a world point's cell floor((w - origin) / res + 0.5)
    + size // 2."""

    def __init__(self, data, width: int, height: int, resolution: float, origin, scale: int,
                 max_dist: float, dtype, device):
        grid = torch.as_tensor(data, device=device).reshape(height, width)
        grid = grid.repeat_interleave(scale, 0).repeat_interleave(scale, 1)
        self.w, self.h = width * scale, height * scale
        self.res = resolution / scale
        self.ox = origin[0] + (self.w // 2) * self.res
        self.oy = origin[1] + (self.h // 2) * self.res
        self.free = grid == 0
        self.max_dist = max_dist
        self.dtype = dtype
        self.field = capped_field_2d(grid == 100, self.res, max_dist, dtype)

    def cells(self, x: torch.Tensor, y: torch.Tensor):
        i = torch.floor((x - self.ox) / self.res + 0.5).long() + self.w // 2
        j = torch.floor((y - self.oy) / self.res + 0.5).long() + self.h // 2
        return i, j, (i >= 0) & (i < self.w) & (j >= 0) & (j < self.h)

    def distance(self, i, j, inside):
        d = self.field[j.clamp(0, self.h - 1), i.clamp(0, self.w - 1)]
        return torch.where(inside, d, torch.full_like(d, self.max_dist))

    def cells_near(self, x: torch.Tensor, y: torch.Tensor, slack: float):
        """The cells a point may fall in where it lies within `slack` cells
        of a cell's edge: [(i, j, inside)] of the point's own cell and (with
        slack) of its neighbour across each near edge, four in all."""
        if not slack:
            return [self.cells(x, y)]
        fx = (x - self.ox) / self.res + 0.5
        fy = (y - self.oy) / self.res + 0.5
        i0, j0 = torch.floor(fx), torch.floor(fy)

        def across(f, c):
            frac = f - c
            return c + torch.where(frac < slack, -1.0, torch.where(frac > 1.0 - slack, 1.0, 0.0))

        out = []
        for i in (i0, across(fx, i0)):
            for j in (j0, across(fy, j0)):
                ii, jj = i.long() + self.w // 2, j.long() + self.h // 2
                out.append((ii, jj, (ii >= 0) & (ii < self.w) & (jj >= 0) & (jj < self.h)))
        return out


PROB = "likelihood_field_prob"
# how near a cell's edge, in cells, a beam's endpoint may fall on either
# side of it in the program's float32 arithmetic: a pose's coordinate on a
# 100 m map rounds at 7.6e-6 m, a beam's bearing at 2.4e-7 rad, 5e-6 m at
# 20 m; 2e-3 of a 0.025 m cell is 5e-5 m
EDGE_SLACK = 2e-3


def beam_step(n: int, max_beams: int, model: str) -> int:
    """The stride of a model's decimation of n beams: ceil(n / max_beams)
    for the prob model (planar_scanner.cpp:339), (n - 1) // (max_beams - 1)
    for the others (:193, :265, :578); at least 1."""
    if model == PROB:
        return max(1, math.ceil(n / max_beams))
    return max(1, (n - 1) // max(1, max_beams - 1))


def planar_beams(ranges, angle_min: float, angle_increment: float, range_min: float,
                 range_max: float, max_beams: int, dtype,
                 model: str = "likelihood_field_gompertz"):
    """The scan as the planar models read it (node_2d.cpp, planar_scanner
    .cpp): readings at or below range_min count as range_max, every
    `beam_step`-th beam, a beam valid below range_max. Returns (ranges,
    angles, valid) of the beams kept."""
    r = torch.as_tensor(ranges, dtype=torch.float64).clone()
    n = r.shape[0]
    r[r <= range_min] = range_max
    idx = torch.arange(0, n, beam_step(n, max_beams, model))
    a = angle_min + idx.to(torch.float64) * angle_increment
    r = r[idx]
    valid = (r < range_max) & ~torch.isnan(r)
    return r.to(dtype), a.to(dtype), valid


def map_factor(m: PlanarMap, factors: tuple, poses: torch.Tensor) -> torch.Tensor:
    """recalcWeight's factor of each pose's cell (M,): off_map off the map,
    non_free on a cell that is not free, the interpolation from non_free up
    to 1 within the radius of an obstacle. factors: (off_map, non_free,
    radius)."""
    off_map, non_free, radius = factors
    i, j, inside = m.cells(poses[:, 0], poses[:, 1])
    d = m.distance(i, j, inside)
    free = m.free[j.clamp(0, m.h - 1), i.clamp(0, m.w - 1)]
    near = non_free + d / radius * (1.0 - non_free) if radius > 0 else torch.ones_like(d)
    f = torch.where(d < radius, near, 1.0)
    f = torch.where(free, f, non_free)
    return torch.where(inside, f, off_map)


def _beams_on(m: PlanarMap, ranges, angles, valid, poses):
    """The beams on the poses' device, the poses in the map's dtype."""
    dt, dev = m.dtype, poses.device
    return ranges.to(dev), angles.to(dev), valid.to(dev), poses.to(dt)


def planar_gompertz(m: PlanarMap, p: dict, factors: tuple, ranges, angles, valid,
                    poses: torch.Tensor) -> torch.Tensor:
    """Per pose (M, 3): the Gompertz likelihood field of the beams times the
    map factor of the pose's cell (`map_factor`)."""
    dt = m.dtype
    ranges, angles, valid, poses = _beams_on(m, ranges, angles, valid, poses)
    th = poses[:, 2:3] + angles[None]
    i, j, inside = m.cells(poses[:, 0:1] + ranges[None] * torch.cos(th),
                           poses[:, 1:2] + ranges[None] * torch.sin(th))
    pz = torch.where(valid[None], _term(p, m.distance(i, j, inside)), 0.0)
    nv = int(valid.sum())
    lik = gompertz(p, pz.sum(dim=1) / nv) if nv else torch.ones(poses.shape[0], dtype=dt,
                                                                 device=poses.device)
    return (lik * map_factor(m, factors, poses)).to(dt)


def lf_pz(p: dict, d: torch.Tensor, range_max: float) -> torch.Tensor:
    """The likelihood field's pz of an endpoint d metres from the nearest
    obstacle: z_hit exp(-d^2 / 2 sigma^2) + z_rand / range_max
    (planar_scanner.cpp:302-306); the Gaussian is not normalized, as
    upstream's is not."""
    sigma = p["laser_sigma_hit"]
    return (p["laser_z_hit"] * torch.exp(-(d * d) / (2.0 * sigma * sigma))
            + p["laser_z_rand"] / range_max)


def _error_threshold(p: dict) -> float:
    """beam_skip_error_threshold under either of upstream's spellings (the
    2D node reads `beam_skip_error_threshold_`, node_2d.cpp:73)."""
    return float(p.get("beam_skip_error_threshold",
                       p.get("beam_skip_error_threshold_", 0.9)))


def planar_field(m: PlanarMap, p: dict, factors: tuple, ranges, angles, valid,
                 range_max: float, poses: torch.Tensor, model: str, skip_slots: int = 0,
                 slack: float = 0.0) -> list:
    """calcLikelihoodFieldModel (`model` "likelihood_field", :236-323) or
    calcLikelihoodFieldModelProb (:325-533) per pose (M, 3), times the map
    factor of the pose's cell, which recalcWeight multiplies into each
    sample's weight after the model (:642-682). The plain field is 1 plus
    the sum of pz^3 over the valid beams (the ad-hoc combination of :315);
    the prob field the exp of the sum of their log pz (max-range and NaN
    readings ignored, an endpoint off the map at max_dist).

    Beam skipping (`skip_slots`, max_beams; the caller passes it only
    where do_beamskip is set and the set has converged, :361-364; the poses
    are then the whole active set): a beam counts a particle whose
    endpoint lies on the map within beam_skip_distance of an obstacle, and
    is kept for everyone where more than beam_skip_threshold of the
    particles count. Upstream's arrays have max_beams slots, the kept beams
    first and empty slots after them, and its error test counts skipped
    slots: where beam_skip_error_threshold of them or more are skipped,
    every slot is integrated, and a slot that holds no pz (an invalid beam,
    an empty slot) gives log 0, so every weight 0, which the update resets
    to uniform. Departure: upstream's buffer of pz keeps, in an invalid
    beam's slot, what an earlier scan wrote there; the reference reads it
    cleared, as a fresh buffer would be.

    Returns alternatives, each a (least, greatest) pair of (M,)
    likelihoods. With `slack` 0 there is one, whose two ends are the
    likelihood. With `slack`, an endpoint within that many cells of a
    cell's edge may fall in either cell (`PlanarMap.cells_near`); a beam
    whose keeping the particles that agree under every such cell and
    those that agree under any leave open adds anything from its log pz to
    nothing; where they leave the error open, both of its outcomes are
    alternatives. The pose's own cell (the map factor) is read as it
    lies."""
    dt = m.dtype
    ranges, angles, valid, poses = _beams_on(m, ranges, angles, valid, poses)
    th = poses[:, 2:3] + angles[None]
    cand = m.cells_near(poses[:, 0:1] + ranges[None] * torch.cos(th),
                        poses[:, 1:2] + ranges[None] * torch.sin(th), slack)
    ds = torch.stack([m.distance(i, j, inside) for i, j, inside in cand])
    pz_lo, pz_hi = lf_pz(p, ds.max(dim=0).values, range_max), lf_pz(p, ds.min(dim=0).values,
                                                                      range_max)
    f = map_factor(m, factors, poses)
    v = valid[None]
    if model != PROB:
        return [tuple(((1.0 + torch.where(v, pz * pz * pz, 0.0).sum(dim=1)) * f).to(dt)
                      for pz in (pz_lo, pz_hi))]
    log_lo, log_hi = torch.log(pz_lo), torch.log(pz_hi)

    def bounds(sure, maybe):
        # a beam surely in use adds its log pz; one maybe in use anything
        # from it to nothing; an invalid beam in use holds no pz (log 0)
        if bool((sure & ~valid).any()):
            return torch.zeros_like(f), torch.zeros_like(f)
        lo = torch.where((sure | maybe)[None], log_lo, 0.0).sum(dim=1)
        if bool((maybe & ~valid).any()):
            lo = torch.full_like(f, float("-inf"))
        hi = torch.where(sure[None], log_hi, 0.0).sum(dim=1)
        return (torch.exp(lo) * f).to(dt), (torch.exp(hi) * f).to(dt)

    if not skip_slots:
        return [bounds(valid, torch.zeros_like(valid))]
    n = poses.shape[0]
    agree = (torch.stack([inside for _, _, inside in cand])
             & (ds < p.get("beam_skip_distance", 0.5)) & v)
    thr = p.get("beam_skip_threshold", 0.3)
    keep_sure = agree.all(dim=0).sum(dim=0).to(torch.float64) / max(n, 1) > thr
    keep_maybe = agree.any(dim=0).sum(dim=0).to(torch.float64) / max(n, 1) > thr
    limit = skip_slots * _error_threshold(p)
    alts = []
    if skip_slots - int(keep_maybe.sum()) < limit:  # the error may not come
        alts.append(bounds(keep_sure, keep_maybe & ~keep_sure))
    if skip_slots - int(keep_sure.sum()) >= limit:  # the error may come
        empty = bool((~valid).any()) or skip_slots > valid.shape[0]
        alts.append((torch.zeros_like(f), torch.zeros_like(f)) if empty else
                    bounds(valid, torch.zeros_like(valid)))
    return alts


class VoxelMap:
    """The 3D node's map from occupied voxel centres (world = cell *
    resolution): the volume between the least and greatest occupied cells,
    a point's cell floor(w / res + 0.5), the 255-level table, max_dist
    outside the volume."""

    def __init__(self, cells, resolution: float, max_dist: float, dtype, device):
        c = torch.as_tensor(cells, device=device).long()
        self.lo = c.min(dim=0).values
        self.hi = c.max(dim=0).values
        size = (self.hi - self.lo + 1).tolist()
        vol = torch.zeros(size, dtype=torch.bool, device=device)
        rel = c - self.lo
        vol[rel[:, 0], rel[:, 1], rel[:, 2]] = True
        self.levels = voxel_levels(vol, resolution, max_dist)
        self.res, self.max_dist, self.dtype = resolution, max_dist, dtype

    def distance(self, xyz: torch.Tensor) -> torch.Tensor:
        c = torch.floor(xyz / self.res + 0.5).long()
        inside = ((c >= self.lo) & (c <= self.hi)).all(dim=-1)
        rel = torch.minimum((c - self.lo).clamp(min=0), self.hi - self.lo)
        lv = self.levels[rel[..., 0], rel[..., 1], rel[..., 2]].to(self.dtype)
        d = lv * (self.max_dist / 255.0)
        return torch.where(inside, d, torch.full_like(d, self.max_dist))

    def on_map(self, xy: torch.Tensor) -> torch.Tensor:
        c = torch.floor(xy / self.res + 0.5).long()
        return ((c >= self.lo[:2]) & (c <= self.hi[:2])).all(dim=-1)


def cloud_points(points, max_beams: int, mount, dtype):
    """The cloud as the node reads it (node_3d.cpp): every ((n - 1) //
    (max_beams - 1))-th point, moved from the lidar's frame to the
    footprint's by the mount's translation."""
    pts = torch.as_tensor(points, dtype=torch.float64)
    n = pts.shape[0]
    step = max(1, (n - 1) // max(1, max_beams - 1))
    return (pts[::step] + torch.as_tensor(mount, dtype=torch.float64)).to(dtype)


def cloud_gompertz(m: VoxelMap, p: dict, off_map: float, points: torch.Tensor,
                   poses: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """Per pose: the Gompertz model of the mean pz over every point, times
    off_map where the pose's cell lies off the map."""
    dt, dev = m.dtype, poses.device
    pts = points.to(dev)
    out = []
    for s in range(0, poses.shape[0], block):
        q = poses[s:s + block].to(dt)
        c, sn = torch.cos(q[:, 2:3]), torch.sin(q[:, 2:3])
        x = q[:, 0:1] + c * pts[None, :, 0] - sn * pts[None, :, 1]
        y = q[:, 1:2] + sn * pts[None, :, 0] + c * pts[None, :, 1]
        z = pts[None, :, 2].expand_as(x)
        pz = _term(p, m.distance(torch.stack([x, y, z], dim=-1)))
        lik = gompertz(p, pz.sum(dim=1) / pts.shape[0])
        out.append(torch.where(m.on_map(q[:, :2]), lik, lik * off_map))
    return torch.cat(out).to(dt)


def normalize(weights: torch.Tensor, likelihood: torch.Tensor, n_active: int) -> torch.Tensor:
    """The active weights times the likelihood, normalized to sum 1 (the
    zero total leaves them uniform)."""
    w = weights[:n_active].to(likelihood.dtype) * likelihood[:n_active]
    total = w.sum()
    if float(total) > 0:
        return w / total
    return torch.full_like(w, 1.0 / n_active)


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def odometry_motion(odom, min_d: float, min_a: float) -> tuple:
    """(pose, delta, absolute motion) of an update from the odometry poses
    (k + 1, 3) of the steps from the last update to this one: delta the
    odom-frame difference (yaw the shortest turn), the absolute motion the
    sum of each step's |(trans cos b, trans sin b, rot)|, b the bearing of
    the step against its mid-heading; delta in its place where that sum
    reaches twice update_min_d or update_min_a."""
    o = torch.as_tensor(odom, dtype=torch.float64)
    pose = o[-1]
    delta = torch.stack([pose[0] - o[0, 0], pose[1] - o[0, 1], _wrap(pose[2] - o[0, 2])])
    d = o[1:] - o[:-1]
    rot = _wrap(d[:, 2])
    trans = torch.hypot(d[:, 0], d[:, 1])
    b = _wrap(torch.atan2(d[:, 1], d[:, 0]) - (o[:-1, 2] + rot / 2.0))
    b = torch.where(trans < 1e-6, 0.0, b)
    absolute = torch.stack([trans * torch.cos(b), trans * torch.sin(b), rot], 1).abs().sum(0)
    if float(torch.hypot(absolute[0], absolute[1])) >= 2 * min_d or float(
            absolute[2]) >= 2 * min_a:
        absolute = delta
    return pose, delta, absolute


def gaussian_motion(poses, normals, pose, delta, absolute, alphas, dtype) -> torch.Tensor:
    """ODOM_MODEL_GAUSSIAN on each particle (M, 3) with its three standard
    normals (3, M) (trans, strafe, rot): the odometry's translation along
    the particle's bearing, Gaussian noise along and across its
    mid-heading with the deviations of the absolute motion, the odometry's
    turn plus noise; yaw not wrapped."""
    q = poses.to(dtype)
    n = normals.to(device=q.device, dtype=dtype)
    pose, delta, absolute = (torch.as_tensor(v, dtype=torch.float64).to(q.device, dtype)
                             for v in (pose, delta, absolute))
    a1, a2, a3, a4, a5 = alphas
    at2, as2, ar2 = absolute[0] ** 2, absolute[1] ** 2, absolute[2] ** 2
    rot_sd = torch.sqrt(a1 * ar2 + a2 * at2)
    trans_sd = torch.sqrt(a3 * at2 + a4 * ar2)
    strafe_sd = torch.sqrt(a4 * ar2 + a5 * as2)
    trans = torch.sqrt(delta[0] ** 2 + delta[1] ** 2)
    bearing = _wrap(torch.atan2(delta[1], delta[0]) - (pose[2] - delta[2])) + q[:, 2]
    heading = q[:, 2] + delta[2] / 2.0
    ch, sh = torch.cos(heading), torch.sin(heading)
    along, across = n[0] * trans_sd, n[1] * strafe_sd
    x = q[:, 0] + trans * torch.cos(bearing) + along * ch + across * sh
    y = q[:, 1] + trans * torch.sin(bearing) + along * sh - across * ch
    th = q[:, 2] + delta[2] + n[2] * rot_sd
    return torch.stack([x, y, th], 1)


def angle_diff(a, b):
    """Odom::angleDiff (odom.cpp:313-321, amcl's angle_diff): a and b
    normalized, then d = a - b or the turn the other way round, whichever
    is shorter."""
    a, b = _wrap(a), _wrap(b)
    d1 = a - b
    d2 = 2.0 * math.pi - d1.abs()
    d2 = torch.where(d1 > 0, -d2, d2)
    return torch.where(d1.abs() < d2.abs(), d1, d2)


def diff_motion(poses, normals, pose, delta, alphas, dtype, corrected: bool) -> torch.Tensor:
    """ODOM_MODEL_DIFF and ODOM_MODEL_DIFF_CORRECTED (odom.cpp:125-169,
    208-256; sample_motion_odometry, Probabilistic Robotics p. 136) on each
    particle (M, 3) with its three standard normals (3, M), one for each
    of upstream's Gaussian draws in its order: the first turn, the
    translation, the second turn. The turns and translation come from the
    odometry's delta against the heading it started from (pose - delta);
    the first turn is 0 below 1 cm of translation (an in-place rotation);
    each turn's noise is measured from the nearer of forward and backward.
    `diff` hands alpha1 rot^2 + alpha2 trans^2 and the like to the draw as
    its deviation, the variance where a sigma belongs (odom.cpp:98-103);
    `diff-corrected` takes their square roots. Yaw is not wrapped."""
    q = poses.to(dtype)
    n = normals.to(device=q.device, dtype=dtype)
    pose, delta = (torch.as_tensor(v, dtype=torch.float64).to(q.device, dtype)
                   for v in (pose, delta))
    a1, a2, a3, a4 = alphas[:4]
    trans = torch.sqrt(delta[0] ** 2 + delta[1] ** 2)
    old_yaw = pose[2] - delta[2]
    rot1 = torch.where(trans < 0.01, torch.zeros_like(trans),
                       angle_diff(torch.atan2(delta[1], delta[0]), old_yaw))
    rot2 = angle_diff(delta[2], rot1)
    zero = torch.zeros_like(rot1)
    rot1_n = torch.minimum(angle_diff(rot1, zero).abs(), angle_diff(rot1, zero + math.pi).abs())
    rot2_n = torch.minimum(angle_diff(rot2, zero).abs(), angle_diff(rot2, zero + math.pi).abs())
    sd = torch.stack([a1 * rot1_n ** 2 + a2 * trans ** 2,
                      a3 * trans ** 2 + a4 * rot1_n ** 2 + a4 * rot2_n ** 2,
                      a1 * rot2_n ** 2 + a2 * trans ** 2])
    if corrected:
        sd = torch.sqrt(sd)
    rot1_hat = angle_diff(rot1, n[0] * sd[0])
    trans_hat = trans - n[1] * sd[1]
    rot2_hat = angle_diff(rot2, n[2] * sd[2])
    x = q[:, 0] + trans_hat * torch.cos(q[:, 2] + rot1_hat)
    y = q[:, 1] + trans_hat * torch.sin(q[:, 2] + rot1_hat)
    th = q[:, 2] + rot1_hat + rot2_hat
    return torch.stack([x, y, th], 1)


def comb(u_start: float, n_out: int, n_random: int, dtype, device) -> torch.Tensor:
    """The comb's points of slots n_random .. n_out - 1: (u + (i -
    n_random) / n_sys) mod 1, n_sys = n_out - n_random (at least 1)."""
    n_sys = max(n_out - n_random, 1)
    i = torch.arange(n_random, n_out, device=device).to(dtype)
    u = torch.tensor(u_start, dtype=dtype, device=device)
    return torch.remainder(u + (i - n_random) * (1.0 / torch.tensor(float(n_sys), dtype=dtype,
                                                                     device=device)), 1.0)


def comb_draw(poses, weights, pool, u_start: float, n_out: int, n_random: int,
              dtype) -> torch.Tensor:
    """resampleSystematic's new set (n_out, 3), its sums and comb in dtype."""
    c = torch.cumsum(weights.to(dtype), 0)
    t = comb(u_start, n_out, n_random, dtype, poses.device)
    idx = torch.searchsorted(c, t, right=True).clamp(max=poses.shape[0] - 1)
    return torch.cat([pool[:n_random].to(poses.dtype), poses[idx]])


def _pick_gaps(poses, weights, drawn, t, circle: bool) -> torch.Tensor:
    """Each drawn pose's (K, 3) distance, in weight mass, from its point t
    (K,) to the interval of the cumulative weights (float64) of a particle
    of the set (M, 3) with that pose, the nearest such particle (1 where
    the set holds no such pose). Poses are matched bit for bit, as a draw
    copies them. With `circle` the distance runs round a circle of the
    whole mass (a point at 1 - e and one at e are e apart)."""
    m = poses.shape[0]
    hi = torch.cumsum(weights.double(), 0)
    lo = torch.cat([hi.new_zeros(1), hi[:-1]])
    keys = torch.cat([poses, drawn]).float().contiguous().view(torch.int32)
    _, inv = torch.unique(keys, dim=0, return_inverse=True)
    ids_in, ids_out = inv[:m], inv[m:]
    ids_sorted, order = torch.sort(ids_in, stable=True)
    first = torch.searchsorted(ids_sorted, ids_out)
    count = torch.searchsorted(ids_sorted, ids_out, right=True) - first
    best = torch.ones_like(t)
    for j in range(int(count.max()) if count.numel() else 0):
        idx = order[(first + j).clamp(max=m - 1)]
        g = torch.clamp(torch.maximum(lo[idx] - t, t - hi[idx]), min=0.0)
        if circle:
            g = torch.minimum(g, torch.minimum(lo[idx] + 1.0 - t, t + 1.0 - hi[idx]))
        best = torch.where(j < count, torch.minimum(best, g), best)
    return best


def _pool_gaps(pool, drawn) -> torch.Tensor:
    """0 where a slot (K, 3) holds the pool's pose of that slot, else 1."""
    same = (drawn == pool[:drawn.shape[0]].to(drawn.dtype)).all(1)
    return torch.where(same, 0.0, 1.0).to(torch.float64)


def draw_gap(poses, weights, pool, drawn, u_start: float, n_random: int) -> float:
    """How far a drawn set (n_out, 3) lies from the systematic draw, as a
    share of the weight mass: a pool slot holds the pool's pose (else 1); a
    comb slot a pose of the set (else 1) whose interval of the cumulative
    weights lies within the gap of the slot's comb point, measured round
    the circle of the mass; the widest slot."""
    dev, n_out = poses.device, drawn.shape[0]
    gap = torch.zeros(n_out, dtype=torch.float64, device=dev)
    k = min(n_random, n_out)
    if k:
        gap[:k] = _pool_gaps(pool, drawn[:k])
    if k == n_out:
        return float(gap.max())
    t = comb(u_start, n_out, n_random, torch.float64, dev)
    gap[k:] = _pick_gaps(poses, weights, drawn[k:], t, circle=True)
    return float(gap.max())


def multinomial_draw(poses, weights, pool, u_inject, u_pick, w_diff: float,
                     dtype) -> torch.Tensor:
    """resampleMultinomial's candidates (M, 3), one a slot in draw order,
    with its sums in dtype: slot i takes the pool's pose i where u_inject[i]
    < w_diff, else the particle whose interval of the cumulative weights
    holds u_pick[i] times the total weight."""
    c = torch.cumsum(weights.to(dtype), 0)
    t = u_pick.to(dtype) * c[-1]
    idx = torch.searchsorted(c, t, right=True).clamp(max=poses.shape[0] - 1)
    inject = u_inject.to(dtype) < torch.tensor(w_diff, dtype=dtype)
    return torch.where(inject[:, None].to(poses.device), pool.to(poses.dtype), poses[idx])


def multinomial_gap(poses, weights, pool, drawn, u_inject, u_pick, w_diff: float) -> float:
    """How far a drawn set (n_out, 3) lies from the multinomial draw, as a
    share of the weight mass: a slot whose injection uniform lies below
    w_diff holds the pool's pose of that slot (else 1); any other slot a
    pose of the set (else 1) whose interval of the cumulative weights
    lies within the gap of its pick uniform times the total weight; the
    widest slot. A uniform within 1e-6 of w_diff (which the program rounds
    in float32) may fall either way: the nearer reading counts.

    Upstream draws a fresh random pose for each slot that injects one; the
    program draws the pool ahead, one pose for each slot, so slot i's call
    of the random pose function is the pool's pose i."""
    n_out = drawn.shape[0]
    dev = poses.device
    u_inject = u_inject[:n_out].to(dev, torch.float64)
    hi = torch.cumsum(weights.double(), 0)
    t = u_pick[:n_out].to(dev, torch.float64) * hi[-1]
    pick = _pick_gaps(poses, weights, drawn, t, circle=False)
    from_pool = _pool_gaps(pool, drawn)
    near = (u_inject - w_diff).abs() <= 1e-6
    gap = torch.where(u_inject < w_diff, from_pool, pick)
    gap = torch.where(near, torch.minimum(pick, from_pool), gap)
    return float(gap.max()) if n_out else 0.0


def bin_keys(poses: torch.Tensor) -> torch.Tensor:
    """(N, 3) int64 histogram keys floor(pose / BIN) (pf_kdtree.cpp); yaw
    keys do not wrap."""
    return torch.floor(poses / torch.tensor(BIN, dtype=poses.dtype, device=poses.device)).long()


def fox_limit(k: int, min_samples: int, max_samples: int, err: float, z: float,
              dtype=torch.float64, rel: float = 0.0) -> set:
    """resampleLimit: ceil((k - 1) / (2 err) * (1 - b + sqrt(b) z)^3), b =
    2 / (9 (k - 1)), within [min, max]; max_samples for k <= 1. With `rel`,
    every count the bound rounds to within that relative error (a float32
    program's ceil may fall on either side of an integer)."""
    k = torch.tensor([k])
    return {int(fox_limits(k, min_samples, max_samples, err, z, dtype, f))
            for f in (1.0 - rel, 1.0, 1.0 + rel)}


def fox_limits(k: torch.Tensor, min_samples: int, max_samples: int, err: float, z: float,
               dtype=torch.float64, f: float = 1.0) -> torch.Tensor:
    """`fox_limit` of each bin count in k, the bound worked out in dtype and
    scaled by f before the ceiling."""
    kf = k.to(dtype)
    b = 2.0 / (9.0 * (kf - 1.0).clamp(min=1.0))
    x = 1.0 - b + torch.sqrt(b) * z
    v = torch.ceil(((kf - 1.0) / (2.0 * err) * x * x * x).double() * f)
    lim = v.clamp(min=min_samples, max=max_samples).long()
    return torch.where(k <= 1, max_samples, lim)


def kld_counts(poses: torch.Tensor, n_active: int, w_slow: float, w_fast: float,
               min_samples: int, max_samples: int, err: float, z: float, dtype,
               slack: float = 2e-4, rel: float = 1e-6) -> set:
    """The counts a systematic resample of this set may draw: the Fox bound
    of its occupied bins, times 1 + w_diff (truncated, at most
    max_samples) where w_diff = 1 - w_fast / w_slow is positive. A pose
    within `slack` of a bin's edge (in bins) may fall on either side of it
    in float32, so every bin count from k - a to k + a is allowed, a the
    number of such poses (0 as a rule); each bound and product may round
    either way within `rel`."""
    q = poses[:n_active].to(dtype)
    scaled = q / torch.tensor(BIN, dtype=dtype, device=q.device)
    k = int(torch.unique(torch.floor(scaled).long(), dim=0).shape[0])
    a = int(((scaled - torch.round(scaled)).abs() < slack).any(dim=1).sum())
    w_diff = max(0.0, 1.0 - w_fast / w_slow) if w_slow > 0 else 0.0
    out = set()
    for j in range(max(1, k - a), k + a + 1):
        for base in fox_limit(j, min_samples, max_samples, err, z, dtype, rel):
            if w_diff > 0:
                v = float(torch.tensor(float(base), dtype=dtype) * (1.0 + w_diff))
                out |= {min(int(v * f), max_samples) for f in (1.0 - rel, 1.0, 1.0 + rel)}
            else:
                out.add(base)
    return out


def multinomial_counts(drawn: torch.Tensor, min_samples: int, max_samples: int, err: float,
                       z: float, dtype, slack: float = 2e-4, rel: float = 1e-6) -> torch.Tensor:
    """(len(drawn),) bool: for each count n = 1, 2, ... whether the draws
    (in draw order) stop there. resampleMultinomial stops after the first
    draw that brings the count above the Fox bound of the bins its draws
    occupy so far, or at max_samples. A pose within `slack` of a bin's
    edge (in bins) may fall on either side of it in float32, and each
    bound may round either way within `rel`: a count is allowed where the
    stop may come there and cannot have come before it."""
    q = drawn.to(dtype)
    scaled = q / torch.tensor(BIN, dtype=dtype, device=q.device)
    keys = torch.floor(scaled).long()
    _, inv = torch.unique(keys, dim=0, return_inverse=True)
    n = keys.shape[0]
    order = torch.arange(n, device=q.device)
    first = torch.full((int(inv.max()) + 1 if n else 0,), n, dtype=torch.long,
                       device=q.device).scatter_reduce_(0, inv, order, reduce="amin")
    k = torch.cumsum((first[inv] == order).long(), 0)
    a = torch.cumsum(((scaled - torch.round(scaled)).abs() < slack).any(dim=1).long(), 0)
    lim = (min_samples, max_samples, err, z, dtype)
    k_lo, k_hi = (k - a).clamp(min=1), k + a
    # the bound rises with the count of bins from 2 on; one bin bounds at max_samples
    least = torch.where(k_hi >= 2, fox_limits(k_lo.clamp(min=2), *lim, 1.0 - rel),
                        max_samples)
    most = torch.where(k_lo <= 1, max_samples, fox_limits(k_hi, *lim, 1.0 + rel))
    count = order + 1
    may, must = count > least, count > most
    must_before = torch.cumsum(must.long(), 0) - must.long() > 0
    return (may | (count == max_samples)) & ~must_before


def _components(keys: torch.Tensor) -> torch.Tensor:
    """Cluster label (its least member index) of each unique bin key (U, 3),
    bins joined with their 26 neighbours."""
    u = keys.shape[0]
    lo = keys.min(dim=0).values - 1
    span = keys.max(dim=0).values - lo + 2
    code = ((keys[:, 0] - lo[0]) * span[1] + (keys[:, 1] - lo[1])) * span[2] + (keys[:, 2] - lo[2])
    order = torch.argsort(code)
    sorted_code = code[order]
    src, dst = [], []
    rng = (-1, 0, 1)
    for dx in rng:
        for dy in rng:
            for da in rng:
                if dx == dy == da == 0:
                    continue
                c = code + (dx * span[1] + dy) * span[2] + da
                pos = torch.searchsorted(sorted_code, c).clamp(max=u - 1)
                hit = sorted_code[pos] == c
                src.append(torch.nonzero(hit).flatten())
                dst.append(order[pos[hit]])
    src, dst = torch.cat(src), torch.cat(dst)
    label = torch.arange(u, device=keys.device)
    while True:
        new = label.clone()
        new.scatter_reduce_(0, src, label[dst], reduce="amin")
        new = new[new]  # pointer jumping
        if torch.equal(new, label):
            return label
        label = new


def cluster_stats(poses: torch.Tensor, weights: torch.Tensor, dtype) -> dict:
    """Clusters of a particle set (N, 3) with weights (N,): each cluster's
    weight and mean (x, y, circular yaw), and the set's covariance entries
    xx, xy, yy and the yaw term -2 log |sum w e^{i yaw}| (weights summing to
    1)."""
    q = poses.to(dtype)
    w = weights.to(dtype)
    keys = bin_keys(q)
    uniq, inv = torch.unique(keys, dim=0, return_inverse=True)
    lab_u = _components(uniq)
    _, cl = torch.unique(lab_u[inv], return_inverse=True)
    k = int(cl.max()) + 1
    x, y, c, s = q[:, 0], q[:, 1], torch.cos(q[:, 2]), torch.sin(q[:, 2])

    def seg(v):
        return torch.zeros(k, dtype=dtype, device=q.device).index_add_(0, cl, v)

    cw = seg(w)
    mx, my, mc, ms = seg(w * x), seg(w * y), seg(w * c), seg(w * s)
    means = torch.stack([mx / cw, my / cw, torch.atan2(ms, mc)], dim=1)
    tw = w.sum()
    sx, sy = (w * x).sum() / tw, (w * y).sum() / tw
    cov = torch.stack([(w * x * x).sum() / tw - sx * sx, (w * x * y).sum() / tw - sx * sy,
                       (w * y * y).sum() / tw - sy * sy,
                       -2.0 * torch.log(torch.sqrt((w * c).sum() ** 2 + (w * s).sum() ** 2))])
    return {"weights": cw, "means": means, "cov": cov}
