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
- `normalize`: the weights after a sensor update (particle_filter.cpp).
- `odometry_motion`, `gaussian_motion`: the motion the node hands its
  model at an update (node.cpp updatePf / integrateOdom / updateOdom: the
  odometry since the last update, the integrated absolute motion) and
  odom.cpp's ODOM_MODEL_GAUSSIAN applied to every particle.
- `comb`, `draw_gap`: resampleSystematic's draw (particle_filter.cpp): the
  first slots from the random pool, the rest a low-variance comb from one
  uniform over the cumulative weights; and how far a drawn set lies from
  it.
- `kld_counts`: the particle count that systematic resampling draws: the
  Fox bound of the previous set's occupied histogram bins (0.5 m, 0.5 m,
  10 degrees; particle_filter.cpp resampleLimit), inflated by w_diff.
- `cluster_stats`: computeClusterStatsForSet: histogram bins joined with
  their 26 neighbours into clusters, each cluster's weighted mean with a
  circular yaw mean, and the whole set's covariance with the yaw term
  -2 log of the mean resultant length.

Nothing here imports the program under test.
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


def planar_beams(ranges, angle_min: float, angle_increment: float, range_min: float,
                 range_max: float, max_beams: int, dtype):
    """The scan as the Gompertz model reads it (node_2d.cpp, planar_scanner
    .cpp): readings at or below range_min count as range_max, every
    ((n - 1) // (max_beams - 1))-th beam, a beam valid below range_max.
    Returns (ranges, angles, valid) of the beams kept."""
    r = torch.as_tensor(ranges, dtype=torch.float64).clone()
    n = r.shape[0]
    r[r <= range_min] = range_max
    step = max(1, (n - 1) // max(1, max_beams - 1))
    idx = torch.arange(0, n, step)
    a = angle_min + idx.to(torch.float64) * angle_increment
    r = r[idx]
    valid = (r < range_max) & ~torch.isnan(r)
    return r.to(dtype), a.to(dtype), valid


def planar_gompertz(m: PlanarMap, p: dict, factors: tuple, ranges, angles, valid,
                    poses: torch.Tensor) -> torch.Tensor:
    """Per pose (M, 3): the Gompertz likelihood field of the beams times the
    map factor of the pose's cell (recalcWeight: off_map off the map,
    non_free on a cell that is not free, the interpolation up to 1 within
    the radius of an obstacle). factors: (off_map, non_free, radius)."""
    dt, dev = m.dtype, poses.device
    ranges, angles, valid = ranges.to(dev), angles.to(dev), valid.to(dev)
    poses = poses.to(dt)
    th = poses[:, 2:3] + angles[None]
    i, j, inside = m.cells(poses[:, 0:1] + ranges[None] * torch.cos(th),
                           poses[:, 1:2] + ranges[None] * torch.sin(th))
    pz = torch.where(valid[None], _term(p, m.distance(i, j, inside)), 0.0)
    nv = int(valid.sum())
    lik = gompertz(p, pz.sum(dim=1) / nv) if nv else torch.ones(poses.shape[0], dtype=dt,
                                                                 device=dev)
    off_map, non_free, radius = factors
    i, j, inside = m.cells(poses[:, 0], poses[:, 1])
    d = m.distance(i, j, inside)
    free = m.free[j.clamp(0, m.h - 1), i.clamp(0, m.w - 1)]
    near = non_free + d / radius * (1.0 - non_free) if radius > 0 else torch.ones_like(d)
    f = torch.where(d < radius, near, 1.0)
    f = torch.where(free, f, non_free)
    f = torch.where(inside, f, off_map)
    return (lik * f).to(dt)


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


def draw_gap(poses, weights, pool, drawn, u_start: float, n_random: int) -> float:
    """How far a drawn set (n_out, 3) lies from the draw, as a share of the
    weight mass: a pool slot holds the pool's pose (else 1); a comb slot a
    pose of the set (else 1) whose interval of the cumulative weights
    (float64) lies within the gap of the slot's comb point, measured round
    the circle of the mass (a comb point at 1 - e and one at e are e
    apart); the widest slot. Poses are matched bit for bit, as a draw
    copies them."""
    dev, m, n_out = poses.device, poses.shape[0], drawn.shape[0]
    gap = torch.zeros(n_out, dtype=torch.float64, device=dev)
    k = min(n_random, n_out)
    if k:
        same = (drawn[:k] == pool[:k].to(drawn.dtype)).all(1)
        gap[:k] = torch.where(same, 0.0, 1.0)
    if k == n_out:
        return float(gap.max())
    hi = torch.cumsum(weights.double(), 0)
    lo = torch.cat([hi.new_zeros(1), hi[:-1]])
    t = comb(u_start, n_out, n_random, torch.float64, dev)
    keys = torch.cat([poses, drawn[k:]]).float().contiguous().view(torch.int32)
    _, inv = torch.unique(keys, dim=0, return_inverse=True)
    ids_in, ids_out = inv[:m], inv[m:]
    ids_sorted, order = torch.sort(ids_in, stable=True)
    first = torch.searchsorted(ids_sorted, ids_out)
    count = torch.searchsorted(ids_sorted, ids_out, right=True) - first
    best = torch.ones_like(t)
    for j in range(int(count.max()) if count.numel() else 0):
        idx = order[(first + j).clamp(max=m - 1)]
        # the comb runs round a circle of the whole mass: 0 and 1 meet
        g = torch.clamp(torch.maximum(lo[idx] - t, t - hi[idx]), min=0.0)
        g = torch.minimum(g, torch.minimum(lo[idx] + 1.0 - t, t + 1.0 - hi[idx]))
        best = torch.where(j < count, torch.minimum(best, g), best)
    gap[k:] = best
    return float(gap.max())


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
    if k <= 1:
        return {max_samples}
    kf = torch.tensor(float(k), dtype=dtype)
    b = 2.0 / (9.0 * (kf - 1.0))
    x = 1.0 - b + torch.sqrt(b) * z
    v = float((kf - 1.0) / (2.0 * err) * x * x * x)
    return {int(min(max(math.ceil(v * f), min_samples), max_samples))
            for f in (1.0 - rel, 1.0, 1.0 + rel)}


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
