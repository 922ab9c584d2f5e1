"""Connected-component clustering of occupied pose-histogram bins and
cluster/set statistics (counterpart of badger_amcl_tpu.pf.cluster).

Two bins share a cluster when their keys are within the 3x3x3 neighborhood
(pf_kdtree.cpp:58-76,169-194); statistics accumulate per cluster with
circular yaw means (particle_filter.cpp:505-636). Labels start as each
occupied grid cell's flat index and take its component's minimum, the
fixpoint of the JAX package's separable 3x3x3 min-dilation
(`ops.cluster_kernel.cluster_labels`: a kernel on the card, the sweeps on
the CPU); dense root ranks come from a cumulative sum of root flags.
Segment sums are a float64 `index_add_`, rounded to float32 (the JAX
package's one-hot MXU contractions exist only for the TPU). Each
`lax.cond` of the JAX module is a `utils.control.cond`: a host branch in
eager steps, a conditional node of a compiled step's graph.

A fleet (leading robot axis R) takes `_ranks_fleet`: one composite-key
sort over R * M, the unique (robot, bin) keys compacted to the front, one
batched labelling over (R, ga, gx, gy), or past FLEET_U_MAX keys the same
labelling over every robot's full grid; `stats_from_ranks` serves one robot
and a fleet alike (one `index_add_` over R * k segments, a batched
`_finalize`).
"""

from __future__ import annotations

import torch

from badger_amcl_tpu_torch.ops.cluster_kernel import cluster_labels
from badger_amcl_tpu_torch.pf import kld
from badger_amcl_tpu_torch.pf.types import ClusterStats, map_tensors
from badger_amcl_tpu_torch.utils import control

MAX_FAST_CLUSTERS = 128
MAX_UNIQUE_BINS = 8192
# capacity of the fleet's unique (robot, bin) compaction, across all robots;
# past it the ranks come from the batched grid path (cluster.py:200-203)
FLEET_U_MAX = 32768
SMALL_GRID = (32, 32, 40)


def _label_grid_machinery(occ: torch.Tensor, shape):
    """Component labels, dense root ranks and the cluster count (per
    leading index of occ (..., n_cells))."""
    labels_grid = cluster_labels(occ, shape)
    cell_idx = torch.arange(labels_grid.shape[-1], dtype=torch.int32,
                            device=occ.device)
    is_root = occ & (labels_grid == cell_idx)
    rank_grid = torch.cumsum(is_root.to(torch.int32), -1, dtype=torch.int32) - 1
    cluster_count = is_root.sum(-1).to(torch.int32)
    return labels_grid, rank_grid, cluster_count


def _ranks_grid_path(flat: torch.Tensor, active: torch.Tensor, shape):
    """Per-particle cluster ranks from the full grid: occupancy scatter plus
    two M-sized gathers (the arm past MAX_UNIQUE_BINS)."""
    occ = kld.occupancy_grid(flat, active, shape)
    labels_grid, rank_grid, cluster_count = _label_grid_machinery(occ, shape)
    n_cells = labels_grid.shape[0]
    lbl_p = labels_grid[flat.long()]
    rank_p = rank_grid[lbl_p.clamp(0, n_cells - 1).long()]
    return rank_p, cluster_count


def _ranks_from_unique(uk_raw: torch.Tensor, valid_u: torch.Tensor, shape):
    """(rank_u (u,), cluster_count) for compacted unique bins (big-grid flat
    encodings; valid_u masks real entries, invalid slots get garbage ranks).
    Labels on the compact SMALL_GRID when the valid bins' spans fit it
    (identical ranks: the recode is a monotone per-axis shift), else on the
    full hist grid."""
    gx, gy, ga = shape
    n_cells = gx * gy * ga
    a_u = uk_raw // (gx * gy)
    rem = uk_raw - a_u * (gx * gy)
    x_u = rem // gy
    y_u = rem - x_u * gy

    def lo(v):
        return torch.where(valid_u, v, kld.BIG).min()

    def hi(v):
        return torch.where(valid_u, v, -kld.BIG).max()

    x_lo, y_lo, a_lo = lo(x_u), lo(y_u), lo(a_u)
    gsx, gsy, gsa = SMALL_GRID
    fits_small = ((hi(x_u) - x_lo <= gsx - 3) & (hi(y_u) - y_lo <= gsy - 3)
                  & (hi(a_u) - a_lo <= gsa - 3))

    def small():
        xs = (x_u - x_lo + 1).clamp(0, gsx - 2)
        ys = (y_u - y_lo + 1).clamp(0, gsy - 2)
        as_ = (a_u - a_lo + 1).clamp(0, gsa - 2)
        flat_s = (as_ * gsx + xs) * gsy + ys
        return ranks_on(flat_s, SMALL_GRID)

    def ranks_on(flat_u, grid):
        n = grid[0] * grid[1] * grid[2]
        # invalid slots scatter into a spare last cell (no mask index: it
        # would read the mask's count back to the host)
        occ = torch.zeros((n + 1,), dtype=torch.bool, device=uk_raw.device)
        occ.index_fill_(0, torch.where(valid_u, flat_u, n).long(), True)
        labels_grid, rank_grid, cluster_count = _label_grid_machinery(occ[:n], grid)
        lab_u = labels_grid[flat_u.clamp(0, n - 1).long()]
        return rank_grid[lab_u.clamp(0, n - 1).long()], cluster_count

    return control.cond(fits_small, small, lambda: ranks_on(uk_raw, shape),
                        name="cluster.small_grid")


def _compact_front(segstart: torch.Tensor, *carried: torch.Tensor):
    """Stable partition: entries where segstart is set move to the front,
    both halves keeping their order; returns the carried tensors permuted."""
    _, order = torch.sort(torch.where(segstart, 0, 1).to(torch.int32), stable=True)
    return [c[order] for c in carried]


def _ranks_sorted_path(sb, shape):
    """Per-particle cluster ranks from the pre-sorted bin structure: the
    <= MAX_UNIQUE_BINS unique bins compacted to the front are ranked on the
    occupancy grid, broadcast back to particles, restored to draw order."""
    u = MAX_UNIQUE_BINS
    ks, idx_s, _, segstart = sb
    segid = torch.cumsum(segstart.to(torch.int32), 0, dtype=torch.int32) - 1
    (ks_c,) = _compact_front(segstart, ks)
    uk_raw = ks_c[:u]
    valid_u = uk_raw < kld.BIG
    rank_u, cluster_count = _ranks_from_unique(uk_raw, valid_u, shape)
    rank_s = rank_u[segid.clamp(0, uk_raw.shape[0] - 1).long()]
    return kld.to_draw_order(idx_s, rank_s), cluster_count


def _ranks_grid_fleet(flat: torch.Tensor, active: torch.Tensor, shape):
    """`_ranks_grid_path` of every robot of a fleet as one batched grid
    path: flat, active (R, M); one occupancy scatter over (R, n_cells),
    one labelling launch, two (R, M) gathers. Returns (rank_p (R, M),
    cluster_count (R,)), each robot's equal to `_ranks_grid_path`'s."""
    r = flat.shape[0]
    gx, gy, ga = shape
    n_cells = gx * gy * ga
    robot = torch.arange(r, device=flat.device)[:, None] * n_cells
    occ = torch.zeros((r * n_cells + 1,), dtype=torch.bool, device=flat.device)
    occ.index_fill_(0, torch.where(active, robot + flat, r * n_cells).reshape(-1).long(), True)
    labels, rank_grid, cluster_count = _label_grid_machinery(occ[:-1].reshape(r, n_cells),
                                                             shape)
    lbl_p = torch.take_along_dim(labels, flat.long(), dim=1)
    rank_p = torch.take_along_dim(rank_grid, lbl_p.clamp(0, n_cells - 1).long(), dim=1)
    return rank_p, cluster_count


def _ranks_fleet(flat: torch.Tensor, active: torch.Tensor, shape):
    """Per-robot cluster ranks for a fleet (cluster.py:206-282): flat,
    active (R, M). Returns (rank_p (R, M) int32, cluster_count (R,)
    int32). A `control.cond` ("cluster.fleet_u", filter.py:634) on whether
    the fleet holds at most FLEET_U_MAX occupied (robot, bin) keys: its
    true arm ranks the unique keys compacted to the front, its false arm
    is the batched grid path `_ranks_grid_fleet`. Root ranks equal the
    per-robot grid path's: the same occupancy grid, min-label components
    and cumsum ranking."""
    r, m = flat.shape
    gx, gy, ga = shape
    n_cells = gx * gy * ga
    u = min(FLEET_U_MAX, r * m)
    dev = flat.device
    ks, idx_s, segstart = kld.composite_sort(flat, active, n_cells)

    def unique_keys():
        segid = torch.cumsum(segstart.to(torch.int32), 0, dtype=torch.int32) - 1
        # unique keys to the front, ascending: each segment start writes slot
        # segid; every other entry, and a start past the capacity (the
        # warm-up of a compiled step runs this arm on any fleet), the spare
        # slot u
        uk = torch.full((u + 1,), kld.FLEET_SENTINEL, dtype=torch.int64, device=dev)
        uk.scatter_(0, torch.where(segstart & (segid < u), segid, u).long(), ks)
        uk = uk[:u]
        valid_u = uk < kld.FLEET_SENTINEL
        rk = (uk // n_cells).clamp(0, r - 1)
        cell = (uk - rk * n_cells).clamp(0, n_cells - 1)
        occ = torch.zeros((r * n_cells + 1,), dtype=torch.bool, device=dev)
        occ.index_fill_(0, torch.where(valid_u, rk * n_cells + cell, r * n_cells), True)
        labels, rank_grid, cluster_count = _label_grid_machinery(
            occ[:-1].reshape(r, n_cells), shape)
        lab_u = labels[rk, cell].clamp(0, n_cells - 1).long()
        rank_u = torch.where(valid_u, rank_grid[rk, lab_u], 0)
        rank_s = rank_u[segid.clamp(0, u - 1).long()]
        return kld.to_draw_order(idx_s, rank_s).reshape(r, m), cluster_count

    return control.cond(segstart.sum() <= u, unique_keys,
                        lambda: _ranks_grid_fleet(flat, active, shape), name="cluster.fleet_u")


def compute_cluster_stats(poses, weights, active, params,
                          precomputed_ranks=None) -> ClusterStats:
    """computeClusterStatsForSet (particle_filter.cpp:505-636): cluster the
    histogram, then per-cluster and whole-set weighted statistics with
    circular yaw means. precomputed_ranks: (rank_p, cluster_count) from the
    fused resample, which already sorted these poses by bin."""
    m = poses.shape[0]
    shape = params.hist_shape
    dev = poses.device

    if precomputed_ranks is not None:
        rank_p, cluster_count = precomputed_ranks
    else:
        _, flat = kld.grid_cells(kld.bin_keys(poses), active, shape)
        sb = kld.sort_by_bin(flat, active)
        rank_p, cluster_count = control.cond(
            sb[3].sum() <= MAX_UNIQUE_BINS, lambda: _ranks_sorted_path(sb, shape),
            lambda: _ranks_grid_path(flat, active, shape), name="cluster.sorted")

    return stats_from_ranks(poses, weights, active, params, rank_p, cluster_count)


def stats_from_ranks(poses, weights, active, params, rank_p, cluster_count) -> ClusterStats:
    """Per-cluster and whole-set statistics from cluster ranks, for one
    robot (poses (M, 3), rank_p (M,), cluster_count 0-dim) or a fleet
    (leading robot axis R): one `index_add_` over R * width segments and
    one batched `_finalize`. width is the JAX fast arm's k (the cap, or
    MAX_FAST_CLUSTERS when every robot has at most that many clusters),
    else M; both arms give the same statistics, the narrow one with less
    work. With the cap (the fleet setting) clusters past it drop out of
    the statistics, as in the JAX package (cluster.py:415-420)."""
    if weights.dim() == 1:
        stats = stats_from_ranks(poses[None], weights[None], active[None], params,
                                 rank_p[None], cluster_count.reshape(1))
        return map_tensors(lambda t: t[0], stats)
    m = weights.shape[1]
    cap = params.stats_max_clusters
    k_fast = min(cap if cap else MAX_FAST_CLUSTERS, m)
    args = poses, weights, active, rank_p, cluster_count
    if cap:
        return _stats_width(k_fast, *args)
    return control.cond(cluster_count.max() <= k_fast, lambda: _stats_width(k_fast, *args),
                        lambda: _stats_width(m, *args), name="cluster.stats_width")


def _stats_width(width, poses, weights, active, rank_p, cluster_count) -> ClusterStats:
    """`stats_from_ranks` over `width` segments a robot."""
    r, m = weights.shape
    dev = poses.device
    pc = torch.where(active, rank_p, m - 1).clamp(0, m - 1).to(torch.int32)
    # float64 products and sums: the order in which a card's atomic adds
    # land then moves no rounded float32 sum, so a replay, an eager step and
    # a second run publish the same means (float32 atomic sums moved a
    # 50,000-particle cluster's mean by up to 1e-4 m between two runs)
    w = torch.where(active, weights, 0.0).double()
    x, y, th = poses[..., 0].double(), poses[..., 1].double(), poses[..., 2]
    c, s = torch.cos(th).double(), torch.sin(th).double()
    vals = torch.stack([w, active.double(), w * x, w * y, w * c,
                        w * s, w * x * x, w * x * y, w * y * y])
    robot = torch.arange(r, device=dev)[:, None]
    seg = torch.where(pc < width, robot * width + pc, r * width).reshape(-1)
    sums = torch.zeros((9, r * width + 1), dtype=torch.float64, device=dev)
    sums.index_add_(1, seg, vals.reshape(9, -1))
    sums = sums[:, :-1].to(torch.float32)
    return _finalize(sums.reshape(9, r, width), width, m, cluster_count, pc)


def _finalize(sums, width, m, cluster_count, pc) -> ClusterStats:
    """Per-cluster means/covs and whole-set stats from (9, ..., width)
    sums (a fleet's robots ride the middle axes)."""
    dev = sums.device
    cw, cnt_f, mx, my, mc, ms, cxx, cxy, cyy = sums
    cnt = torch.round(cnt_f).to(torch.int32)
    root = torch.arange(width, device=dev) < cluster_count[..., None]
    safe_w = torch.where(cw > 0, cw, 1.0)
    mean_x = mx / safe_w
    mean_y = my / safe_w
    mean_a = torch.atan2(ms, mc)
    cluster_means = torch.stack([mean_x, mean_y, mean_a], dim=-1)
    # covariance (normalizeCluster, particle_filter.cpp:555-568); yaw
    # variance from the *raw* weighted cos/sin sums, as the reference
    cov = torch.zeros(cw.shape + (3, 3), dtype=torch.float32, device=dev)
    cov[..., 0, 0] = cxx / safe_w - mean_x * mean_x
    cov[..., 0, 1] = cxy / safe_w - mean_x * mean_y
    cov[..., 1, 0] = cxy / safe_w - mean_x * mean_y
    cov[..., 1, 1] = cyy / safe_w - mean_y * mean_y
    r = torch.sqrt(mc * mc + ms * ms)
    cov[..., 2, 2] = -2.0 * torch.log(torch.clamp(r, min=1e-30))

    # whole-set stats (computeSetStats, particle_filter.cpp:620-636)
    rootf = root.to(torch.float32)
    tw = (cw * rootf).sum(-1)
    safe_tw = torch.where(tw > 0, tw, 1.0)
    smx = (mx * rootf).sum(-1) / safe_tw
    smy = (my * rootf).sum(-1) / safe_tw
    smc, sms = (mc * rootf).sum(-1), (ms * rootf).sum(-1)
    set_mean = torch.stack([smx, smy, torch.atan2(sms, smc)], dim=-1)
    set_cov = torch.zeros(tw.shape + (3, 3), dtype=torch.float32, device=dev)
    set_cov[..., 0, 0] = (cxx * rootf).sum(-1) / safe_tw - smx * smx
    set_cov[..., 0, 1] = (cxy * rootf).sum(-1) / safe_tw - smx * smy
    set_cov[..., 1, 0] = set_cov[..., 0, 1]
    set_cov[..., 1, 1] = (cyy * rootf).sum(-1) / safe_tw - smy * smy
    sr = torch.sqrt(smc * smc + sms * sms)
    set_cov[..., 2, 2] = -2.0 * torch.log(torch.clamp(sr, min=1e-30))

    axis = cw.dim() - 1  # the cluster axis

    def padm(a):
        if width == m:
            return a
        pad = a.shape[:axis] + (m - width,) + a.shape[axis + 1:]
        return torch.cat([a, torch.zeros(pad, dtype=a.dtype, device=dev)], dim=axis)

    return ClusterStats(
        cluster_count=cluster_count,
        cluster_valid=padm(root),
        cluster_weights=padm(torch.where(root, cw, 0.0)),
        cluster_counts=padm(torch.where(root, cnt, 0)),
        cluster_means=padm(torch.where(root[..., None], cluster_means, 0.0)),
        cluster_covs=padm(torch.where(root[..., None, None], cov, 0.0)),
        mean=set_mean.to(torch.float32),
        cov=set_cov,
        particle_cluster=pc,
    )
