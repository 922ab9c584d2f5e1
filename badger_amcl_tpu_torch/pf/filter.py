"""The particle filter core (counterpart of badger_amcl_tpu.pf.filter).

- `init_with_gaussian`   <- initWithGaussian (particle_filter.cpp:106-133)
- `init_with_poses`      <- initWithPoseFn (particle_filter.cpp:136-162)
- `sensor_update`        <- updateSensor with the w_slow/w_fast averages
                            (particle_filter.cpp:223-267)
- `sensor_update_log`    <- the same with per-particle LOG likelihoods and
                            log-domain averages (the JAX package's log-space
                            pipeline, filter.py:158-237)
- `resample`             <- updateResample (particle_filter.cpp:423-471):
                            resampleMultinomial with random-pose injection
                            and the mid-stream KLD stop (:356-420), fused
                            with the cluster ranks, or with the grid flags
                            under a cluster cap; resampleSystematic, a
                            low-variance comb (:269-354)
- `update_converged`     <- updateConverged (particle_filter.cpp:170-220)
- `fleet_resample`       <- the JAX package's batched multinomial resample
                            of a fleet (filter.py:570-658): composite-key
                            KLD stop and cluster ranks over R * M
- `sensor_resample_cells` <- the JAX package's cell-space resampling
                            contract (filter.py:660-866): sensor update and
                            multinomial resample fused over occupied
                            lattice cells

`sensor_update` and `update_converged` take a fleet state (leading robot
axis) as well as a single robot's.

Random variates are arguments: `resample` takes the injection and pick
uniforms (M,) each, as the JAX package draws them from its key
(filter.py:351-353), and for the systematic comb its start, a 0-dim
uniform (filter.py:476); mcl.StepNoise draws them from a torch.Generator
when the caller does not pass them. The pick is `torch.searchsorted` on the
cumulative weights (the JAX package's chunked one-hot search exists only
because TPU searchsorted lowers to a scalar loop); the cell contract's
pick is `torch.searchsorted` too, and its pose fetch plain indexing (the
JAX package's one-hot MXU fetches `_pick_cells` and
`mxu_gather.gather_rows` exist because a TPU gather is slow).
"""

from __future__ import annotations

import collections
import enum

import torch

from badger_amcl_tpu_torch.pf import cluster, gaussian, kld
from badger_amcl_tpu_torch.pf.types import MCLState, PFParams
from badger_amcl_tpu_torch.utils import control
from badger_amcl_tpu_torch.utils.numerics import cumsum_det


class ResampleModel(enum.IntEnum):
    """PFResampleModelType (particle_filter.h)."""

    MULTINOMIAL = 0
    SYSTEMATIC = 1


def _scalar(v, dtype, device):
    return torch.full((), v, dtype=dtype, device=device)


def _finalize_init(params, poses, alpha_slow, alpha_fast) -> MCLState:
    m = params.max_samples
    dev = poses.device
    weights = torch.full((m,), 1.0 / m, dtype=torch.float32, device=dev)
    active = torch.ones((m,), dtype=torch.bool, device=dev)
    stats = cluster.compute_cluster_stats(poses, weights, active, params)
    return MCLState(
        poses=poses, weights=weights,
        n_active=_scalar(m, torch.int32, dev),
        w_slow=_scalar(0.0, torch.float32, dev),
        w_fast=_scalar(0.0, torch.float32, dev),
        alpha_slow=_scalar(alpha_slow, torch.float32, dev),
        alpha_fast=_scalar(alpha_fast, torch.float32, dev),
        converged=_scalar(False, torch.bool, dev),  # initConverged
        stats=stats,
    )


def init_with_gaussian(params: PFParams, gen: torch.Generator, mean, cov,
                       alpha_slow: float = 0.001, alpha_fast: float = 0.1,
                       device="cuda") -> MCLState:
    """max_samples poses from N(mean, cov) drawn from `gen`, uniform
    weights, reset recovery averages, fresh cluster stats."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    cov = torch.as_tensor(cov, dtype=torch.float32, device=device)
    poses = gaussian.sample_poses_gen(gen, mean, cov, params.max_samples)
    return _finalize_init(params, poses, alpha_slow, alpha_fast)


def init_with_poses(params: PFParams, poses: torch.Tensor,
                    alpha_slow: float = 0.001, alpha_fast: float = 0.1) -> MCLState:
    """The caller supplies max_samples pre-drawn poses."""
    if tuple(poses.shape) != (params.max_samples, 3):
        raise ValueError(f"poses must be ({params.max_samples}, 3), got "
                         f"{tuple(poses.shape)}")
    return _finalize_init(params, poses.to(torch.float32), alpha_slow, alpha_fast)


def sensor_update(state: MCLState, p_model: torch.Tensor, map_factor=None) -> MCLState:
    """Multiply the model's particle likelihoods into the weights; the map
    factor applies only when the model's total is positive
    (planar_scanner.cpp:159-162). Passing the pre-folded product with
    map_factor=None is exactly equivalent (p, factor >= 0). Then normalize
    and update w_slow/w_fast (particle_filter.cpp:237-266); a zero total
    resets to uniform."""
    active = state.active_mask
    w1 = torch.where(active, state.weights * p_model, 0.0)
    t1 = w1.sum(-1)
    if map_factor is None:
        w2, t2 = w1, t1
    else:
        w2 = torch.where(active, w1 * map_factor, 0.0)
        t2 = w2.sum(-1)
    w_unnorm = torch.where((t1 > 0.0)[..., None], w2, w1)
    total = torch.where(t1 > 0.0, t2, 0.0)

    n = state.n_active.to(torch.float32)
    nf = torch.clamp(n, min=1.0)
    w_avg = total / nf
    new_wslow = torch.where(state.w_slow == 0.0, w_avg,
                            state.w_slow + state.alpha_slow * (w_avg - state.w_slow))
    new_wfast = torch.where(state.w_fast == 0.0, w_avg,
                            state.w_fast + state.alpha_fast * (w_avg - state.w_fast))
    uniform = torch.where(active, 1.0 / nf[..., None], 0.0)
    ok = total > 0.0
    new_weights = torch.where(ok[..., None],
                              w_unnorm / torch.where(ok, total, 1.0)[..., None], uniform)
    return state.replace(
        weights=new_weights.to(torch.float32),
        w_slow=torch.where(ok, new_wslow, state.w_slow),
        w_fast=torch.where(ok, new_wfast, state.w_fast),
    )


# w_slow/w_fast "uninitialized" sentinel of the log-space pipeline: log
# w_avg is finite or -inf, never +inf (filter.py:173-176)
LOG_UNINIT = float("inf")


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    out = m + torch.log1p(torch.exp(-(a - b).abs()))
    return torch.where(torch.isinf(m), m, out)


def sensor_update_log(state: MCLState, log_p: torch.Tensor, map_factor=None) -> MCLState:
    """`sensor_update` with per-particle LOG likelihoods (the prob model's
    log-space output, filter.py:186-231): log weights through a
    log-sum-exp normalization, w_slow/w_fast as log-domain averages (their
    EMA is a logaddexp), normalized linear weights out; an all -inf total
    is the zero-total uniform reset. Pair with resample(log_averages=True)
    and a state from init_log_averages."""
    active = state.active_mask
    neg_inf = float("-inf")
    logw_prev = torch.where(active & (state.weights > 0), torch.log(state.weights), neg_inf)
    lw = logw_prev + log_p
    if map_factor is not None:
        lw = lw + torch.log(map_factor)
    lse = torch.logsumexp(torch.where(active, lw, neg_inf), dim=0)
    n = state.n_active.to(torch.float32).clamp(min=1.0)
    log_wavg = lse - torch.log(n)
    new_wslow = torch.where(
        state.w_slow == LOG_UNINIT, log_wavg,
        _logaddexp(torch.log1p(-state.alpha_slow) + state.w_slow,
                   torch.log(state.alpha_slow) + log_wavg))
    new_wfast = torch.where(
        state.w_fast == LOG_UNINIT, log_wavg,
        _logaddexp(torch.log1p(-state.alpha_fast) + state.w_fast,
                   torch.log(state.alpha_fast) + log_wavg))
    ok = torch.isfinite(lse)
    uniform = torch.where(active, 1.0 / n, 0.0)
    new_weights = torch.where(ok, torch.where(active, torch.exp(lw - lse), 0.0), uniform)
    return state.replace(
        weights=new_weights.to(torch.float32),
        w_slow=torch.where(ok, new_wslow, state.w_slow),
        w_fast=torch.where(ok, new_wfast, state.w_fast),
    )


def init_log_averages(state: MCLState) -> MCLState:
    """w_slow/w_fast reset to the log-domain sentinel (the log twin of
    initializing them to 0)."""
    return state.replace(w_slow=torch.full_like(state.w_slow, LOG_UNINIT),
                         w_fast=torch.full_like(state.w_fast, LOG_UNINIT))


def update_converged(state: MCLState, params: PFParams, mean_xy=None) -> MCLState:
    """Fraction of active particles within dist_threshold (L-inf) of the
    mean x/y must reach convergence_threshold percent. mean_xy: the fresh
    cluster stats' set mean (weights are uniform after resampling)."""
    active = state.active_mask
    n = torch.clamp(state.n_active.to(torch.float32), min=1.0)
    x, y = state.poses[..., 0], state.poses[..., 1]
    if mean_xy is not None:
        mx, my = mean_xy[..., 0], mean_xy[..., 1]
    else:
        mx = torch.where(active, x, 0.0).sum(-1) / n
        my = torch.where(active, y, 0.0).sum(-1) / n
    within = ((torch.abs(x - mx[..., None]) <= params.dist_threshold)
              & (torch.abs(y - my[..., None]) <= params.dist_threshold)
              & active)
    pct = 100.0 * within.sum(-1).to(torch.float32) / n
    return state.replace(converged=pct >= params.convergence_threshold)


def _pick_indices(weights: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Index i with cum[i-1] <= r < cum[i] (particle_filter.cpp:394-398),
    clipped to the last particle."""
    cum = cumsum_det(weights)
    idx = torch.searchsorted(cum, r, right=True)
    return idx.clamp(max=weights.shape[0] - 1)


def _resample_multinomial_fused(state, params, w_diff, pool, u_inject, u_pick):
    """resampleMultinomial (particle_filter.cpp:356-420) over all
    max_samples candidates (iid draws commute) plus the cluster ranks of the
    new set. Returns (new_poses, new_count, rank_p, cluster_count)."""
    use_random = u_inject < w_diff
    idx = _pick_indices(state.weights, u_pick)
    picked = state.poses[idx]
    new_poses = torch.where(use_random[:, None], pool, picked)
    new_count, rank_p, cluster_count = _kld_stop_and_ranks(new_poses, params)
    return new_poses, new_count, rank_p, cluster_count


def _kld_stop_and_ranks(new_poses: torch.Tensor, params: PFParams):
    """Mid-stream KLD stop (particle_filter.cpp:416) and cluster ranks over a
    full (M, 3) candidate set in draw order, from one stable bin sort.

    With <= MAX_UNIQUE_BINS occupied bins the stop comes from the sorted
    new-bin event times: k_n == j for n in [D_j + 1, D_{j+1}] where D_j is
    the j-th smallest first-occurrence draw index, so the first n with
    n > limit(k_n) is min_j max(D_j + 1, limit(j) + 1) clipped to that
    interval. Past it, the exact draw-order prefix scan and the grid rank
    path run instead."""
    m = params.max_samples
    dev = new_poses.device
    ones = torch.ones((m,), dtype=torch.bool, device=dev)
    _, flat = kld.grid_cells(kld.bin_keys(new_poses), ones, params.hist_shape)
    ks, idx_s = torch.sort(flat, stable=True)
    segstart = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          ks[1:] != ks[:-1]])
    u_count = segstart.sum().to(torch.int32)
    u = min(cluster.MAX_UNIQUE_BINS, m)
    lim = (params.min_samples, params.max_samples, params.pop_err, params.pop_z)

    def sorted_bins():
        ks_c, d_c = cluster._compact_front(segstart, ks, idx_s.to(torch.int32))
        uk = ks_c[:u]
        dmin = d_c[:u]
        front = torch.arange(u, dtype=torch.int32, device=dev) < u_count
        d_sorted = torch.sort(torch.where(front, dmin, m)).values
        kj = torch.arange(1, u + 1, dtype=torch.int32, device=dev)
        limit_j = kld.resample_limit(kj, *lim)
        d_next = torch.cat([d_sorted[1:],
                            torch.full((1,), m, dtype=torch.int32, device=dev)])
        n0 = torch.maximum(d_sorted + 1, limit_j + 1)
        cand = torch.where(n0 <= d_next, n0, m + 1)
        new_count = torch.clamp(cand.min(), max=m).to(torch.int32)
        # ranks among ACTIVE bins only: a bin holds an active particle iff
        # its minimum draw index beat the stop
        act_bin = front & (dmin < new_count)
        rank_u, cluster_count = cluster._ranks_from_unique(
            uk, act_bin, params.hist_shape)
        segid = torch.cumsum(segstart.to(torch.int32), 0, dtype=torch.int32) - 1
        rank_s = rank_u[segid.clamp(0, u - 1).long()]
        return new_count, kld.to_draw_order(idx_s, rank_s), cluster_count

    def prefix_scan():
        flags = kld.to_draw_order(idx_s, segstart.to(torch.int32))
        k_n = torch.cumsum(flags, 0, dtype=torch.int32)
        limit_n = kld.resample_limit(k_n, *lim)
        draw = torch.arange(m, dtype=torch.int32, device=dev)
        stop = (draw + 1) > limit_n
        new_count = torch.where(stop.any(), torch.argmax(stop.to(torch.int32)) + 1,
                                m).to(torch.int32)
        active = draw < new_count
        rank_p, cluster_count = cluster._ranks_grid_path(
            torch.where(active, flat, 0), active, params.hist_shape)
        return new_count, rank_p, cluster_count

    return control.cond(u_count <= u, sorted_bins, prefix_scan, name="resample.u_count")


def _resample_multinomial(state, params, w_diff, pool, u_inject, u_pick):
    """The capped (stats_max_clusters) arm of resampleMultinomial
    (filter.py:310-341): the same picks, the KLD stop from the grid
    scatter-min flags. Returns (new_poses, new_count); the statistics
    rank the new set afresh."""
    m = params.max_samples
    use_random = u_inject < w_diff
    new_poses = torch.where(use_random[:, None], pool,
                            state.poses[_pick_indices(state.weights, u_pick)])
    ones = torch.ones((m,), dtype=torch.bool, device=new_poses.device)
    _, flat = kld.grid_cells(kld.bin_keys(new_poses), ones, params.hist_shape)
    k_n = torch.cumsum(kld.first_occurrence_flags(flat, ones, params.hist_shape).to(
        torch.int32), 0, dtype=torch.int32)
    limit_n = kld.resample_limit(k_n, params.min_samples, params.max_samples,
                                 params.pop_err, params.pop_z)
    stop = torch.arange(1, m + 1, dtype=torch.int32, device=new_poses.device) > limit_n
    new_count = torch.where(stop.any(), torch.argmax(stop.to(torch.int32)) + 1, m)
    return new_poses, new_count.to(torch.int32)


def systematic_comb(poses, weights, k_old, params: PFParams, w_diff, pool, u_start):
    """resampleSystematic (particle_filter.cpp:269-354, filter.py:454-483)
    for one robot (poses (M, 3)) or a fleet (leading robot axis): the
    target count from the previous set's leaf count k_old, inflated by
    w_diff (C++ int conversion truncates, :296-303); the first
    w_diff * count slots take the pool's poses, the rest a low-variance
    comb from u_start over the cumulative weights. Returns (new_poses,
    new_count)."""
    m = params.max_samples
    base = kld.resample_limit(k_old, params.min_samples, params.max_samples,
                              params.pop_err, params.pop_z)
    inflated = torch.clamp((base.to(torch.float32) * (1.0 + w_diff)).to(torch.int32), max=m)
    new_count = torch.where(w_diff > 0.0, inflated, base)
    num_random = (w_diff * new_count.to(torch.float32)).to(torch.int32)
    num_sys = torch.clamp(new_count - num_random, min=1)
    delta = 1.0 / num_sys.to(torch.float32)
    i = torch.arange(m, dtype=torch.int32, device=poses.device)
    t = torch.remainder(u_start[..., None]
                        + (i - num_random[..., None]).to(torch.float32) * delta[..., None],
                        1.0)
    idx = torch.searchsorted(cumsum_det(weights), t.contiguous(), right=True)
    picked = torch.take_along_dim(poses, idx.clamp(max=m - 1)[..., None], dim=-2)
    new_poses = torch.where((i < num_random[..., None])[..., None], pool, picked)
    return new_poses, new_count.to(torch.int32)


def _w_diff(state: MCLState, log_averages: bool) -> torch.Tensor:
    """max(0, 1 - w_fast / w_slow), 0 while w_slow is unset; in the log
    domain 1 - exp(w_fast - w_slow) (filter.py:499-522)."""
    if log_averages:
        ok_ws = torch.isfinite(state.w_slow)
        return torch.where(
            ok_ws, torch.clamp(1.0 - torch.exp(
                state.w_fast - torch.where(ok_ws, state.w_slow, 0.0)), min=0.0), 0.0)
    return torch.where(
        state.w_slow > 0.0,
        torch.clamp(1.0 - state.w_fast / torch.where(state.w_slow > 0, state.w_slow, 1.0),
                    min=0.0),
        0.0)


def injects(state: MCLState, log_averages: bool) -> torch.Tensor:
    """Whether a resample of `state` can put pool poses in its set: w_diff
    > 0 (0-dim bool). At w_diff 0 the comb takes no pool pose and no
    multinomial slot's injection uniform falls below it."""
    return _w_diff(state, log_averages) > 0.0


def resample(state: MCLState, params: PFParams, random_pose_pool: torch.Tensor,
             u_inject=None, u_pick=None,
             model: ResampleModel = ResampleModel.MULTINOMIAL,
             log_averages: bool = False, u_start=None) -> MCLState:
    """updateResample (particle_filter.cpp:423-471, filter.py:486-567).

    random_pose_pool: (M, 3) candidate random poses. Multinomial takes
    u_inject, u_pick: (M,) uniforms in [0, 1) for the injection decision
    and the pick; systematic takes u_start, the comb's 0-dim uniform start.
    log_averages: w_slow/w_fast hold log-domain averages (the
    sensor_update_log contract): w_diff = 1 - exp(w_fast - w_slow), and the
    recovery reset restores LOG_UNINIT (filter.py:499-555)."""
    w_diff = _w_diff(state, log_averages)
    m = params.max_samples
    shape = params.hist_shape
    ranks = None
    if model == ResampleModel.SYSTEMATIC:
        leaf = kld.leaf_count if params.stats_max_clusters else kld.leaf_count_sorted
        new_poses, new_count = systematic_comb(
            state.poses, state.weights, leaf(state.poses, state.active_mask, shape), params,
            w_diff, random_pose_pool, u_start)
    elif params.stats_max_clusters:
        new_poses, new_count = _resample_multinomial(state, params, w_diff,
                                                     random_pose_pool, u_inject, u_pick)
    else:
        new_poses, new_count, rank_p, cluster_count = _resample_multinomial_fused(
            state, params, w_diff, random_pose_pool, u_inject, u_pick)
        ranks = (rank_p, cluster_count)

    active = torch.arange(m, device=new_poses.device) < new_count
    weights = torch.where(active, 1.0 / new_count.to(torch.float32), 0.0)
    # reset averages to avoid spiraling into randomness (:453-455)
    reset = w_diff > 0.0
    uninit = LOG_UNINIT if log_averages else 0.0
    new_state = state.replace(
        poses=new_poses.to(torch.float32),
        weights=weights.to(torch.float32),
        n_active=new_count.to(torch.int32),
        w_slow=torch.where(reset, uninit, state.w_slow),
        w_fast=torch.where(reset, uninit, state.w_fast),
    )
    stats = cluster.compute_cluster_stats(
        new_state.poses, new_state.weights, new_state.active_mask, params,
        precomputed_ranks=ranks)
    new_state = new_state.replace(stats=stats)
    return update_converged(new_state, params, mean_xy=stats.mean[:2])


def fleet_resample(states: MCLState, params: PFParams, pools: torch.Tensor,
                   u_inject: torch.Tensor, u_pick: torch.Tensor) -> MCLState:
    """`resample` (multinomial, linear-domain averages) for a fleet state
    with a leading robot axis R, as the JAX package's fleet_resample
    (filter.py:570-658): the picks batched over robots, the KLD stop from
    one composite-key sort over R * M, cluster ranks from `_ranks_fleet`
    (the batched grid path past cluster.FLEET_U_MAX).

    pools: (R, M, 3); u_inject, u_pick: (R, M) uniforms in [0, 1) (the JAX
    head's k1/k2 draws). The candidates are binned over ALL M draws, not
    over the active subset: equal to vmap(resample) until the hist grid
    clamps (ADVICE.md)."""
    r, m = states.weights.shape
    dev = states.poses.device
    shape = params.hist_shape
    w_diff = _w_diff(states, False)
    use_random = u_inject < w_diff[:, None]
    idx = torch.searchsorted(cumsum_det(states.weights), u_pick.contiguous(),
                             right=True).clamp(max=m - 1)
    picked = torch.gather(states.poses, 1, idx[..., None].expand(r, m, 3))
    new_poses = torch.where(use_random[..., None], pools, picked)
    ones = torch.ones((r, m), dtype=torch.bool, device=dev)
    _, flat = kld.grid_cells(kld.bin_keys(new_poses), ones, shape)

    # mid-stream KLD stop (particle_filter.cpp:416), batched prefix form
    flags = kld.first_occurrence_flags_fleet(flat, ones, shape)
    k_n = torch.cumsum(flags.to(torch.int32), 1, dtype=torch.int32)
    limit_n = kld.resample_limit(k_n, params.min_samples, params.max_samples,
                                 params.pop_err, params.pop_z)
    stop = torch.arange(1, m + 1, dtype=torch.int32, device=dev) > limit_n
    new_count = torch.where(stop.any(1), torch.argmax(stop.to(torch.int32), 1) + 1,
                            m).to(torch.int32)
    return _fleet_finish(states, params, new_poses, new_count, w_diff, flat)


def _fleet_finish(states, params, new_poses, new_count, w_diff, flat=None):
    """A fleet's new set (R, M, 3) with its per-robot count -> the new
    state: uniform weights over the active set, the averages reset where
    w_diff > 0, cluster statistics from `_ranks_fleet` (the batched grid
    path past its capacity), convergence. flat: the
    candidates' bins over all M draws (fleet_resample); None bins the
    active set, as vmap(resample) does."""
    m = states.weights.shape[1]
    dev = states.poses.device
    shape = params.hist_shape
    act = torch.arange(m, device=dev) < new_count[:, None]
    if flat is None:
        _, flat = kld.grid_cells(kld.bin_keys(new_poses), act, shape)
    ranks = cluster._ranks_fleet(torch.where(act, flat, 0), act, shape)

    weights = torch.where(act, 1.0 / new_count[:, None].to(torch.float32), 0.0)
    reset = w_diff > 0.0
    new_states = states.replace(
        poses=new_poses.to(torch.float32), weights=weights.to(torch.float32),
        n_active=new_count,
        w_slow=torch.where(reset, 0.0, states.w_slow),
        w_fast=torch.where(reset, 0.0, states.w_fast))
    stats = cluster.stats_from_ranks(new_states.poses, new_states.weights, act, params,
                                     *ranks)
    new_states = new_states.replace(stats=stats)
    return update_converged(new_states, params, mean_xy=stats.mean[..., :2])


def fleet_resample_systematic(states: MCLState, params: PFParams, pools: torch.Tensor,
                              u_start: torch.Tensor) -> MCLState:
    """`resample` (systematic, linear-domain averages) for a fleet state,
    batched over the robot axis: equal to the JAX package's vmapped
    `resample` (fleet.py:104-106). Each robot's leaf count comes from one
    composite-key sort over R * M, the comb from its u_start (R,), the
    cluster ranks from `_ranks_fleet` over the active set (the batched
    grid path past cluster.FLEET_U_MAX)."""
    shape = params.hist_shape
    w_diff = _w_diff(states, False)
    _, flat_old = kld.grid_cells(kld.bin_keys(states.poses), states.active_mask, shape)
    k_old = kld.leaf_count_fleet(flat_old, states.active_mask, shape)
    new_poses, new_count = systematic_comb(states.poses, states.weights, k_old, params,
                                           w_diff, pools, u_start)
    return _fleet_finish(states, params, new_poses, new_count, w_diff)


# ---------------------------------------------------------------------------
# Cell-space resampling contract (filter.py:660-866)
#
# On the corr fast path the likelihood and the folded recalcWeight factor
# are constant over each lattice cell, so with uniform prior weights the
# particles of a cell are exchangeable: a cell drawn by mass, then a member
# uniformly within it, is distributed as a per-particle multinomial pick,
# P(cell) * P(member | cell) = (cnt_c p_c / T) (1 / cnt_c) = w_i. The pick
# sequence differs from the pick contract's; the distribution does not
# (particle_filter.cpp:356-420,475-502).

# capacity of the unique-cell compaction; a cloud over more cells takes the
# pick contract's step (filter.py:685)
CELL_U_MAX = 8192
# the arm each eager sensor_resample_cells call took (diagnostic, as SYNCS;
# a compiled step's arms are its capture's counters, `Capture.arm_counts`,
# under "cells.ok:true" / "cells.ok:false")
CELL_ARMS = collections.Counter()


def sensor_resample_cells(state: MCLState, params: PFParams, random_pose_pool: torch.Tensor,
                          tbl, key_m, cells_ok, classic_fn, u_inject: torch.Tensor,
                          u_pick: torch.Tensor) -> MCLState:
    """Sensor update + multinomial KLD resample under the cell-space
    contract (filter.py:728-866, particle_filter.cpp:223-267 + :356-471).
    tbl, key_m, cells_ok come from sensors.planar.planar_likelihood_cells
    (cells_ok a bool or a 0-dim bool tensor; no table at all, tbl None,
    takes classic_fn at once); classic_fn () -> MCLState is the pick
    contract's step on the same variates. One `control.cond` ("cells.ok",
    as JAX's lax.cond at filter.py:876) takes classic_fn where cells_ok is
    False, the cloud holds more than CELL_U_MAX cells, the active prior
    weights are not all equal (the exchangeability precondition) or no
    particle is active: one host sync in an eager step, a conditional
    node in a compiled one. u_inject, u_pick: (M,) uniforms in [0, 1),
    the draws JAX takes from split(split(state.key)[1]) (filter.py:830-833),
    as `resample` takes them."""
    if tbl is None:
        CELL_ARMS["classic"] += 1
        return classic_fn()
    active = state.active_mask
    # the active particles stably sorted by cell key, one segment a cell
    ks, order, _, segstart = kld.sort_by_bin(key_m, active)
    u_count = segstart.sum().to(torch.int32)
    wa_max = torch.where(active, state.weights, 0.0).max()
    wa_min = torch.where(active, state.weights, float("inf")).min()
    (ok,) = control.read(cells_ok & (u_count <= CELL_U_MAX) & (wa_max == wa_min)
                         & (state.n_active > 0))
    if isinstance(ok, bool):  # an eager step
        CELL_ARMS["cell" if ok else "classic"] += 1
    return control.cond(
        ok, lambda: _cell_arm(state, params, random_pose_pool, tbl, ks, order, segstart,
                              u_count, u_inject, u_pick),
        classic_fn, name="cells.ok")


def _cell_arm(state, params, random_pose_pool, tbl, ks, order, segstart, u_count, u_inject,
              u_pick) -> MCLState:
    """The cell arm of `sensor_resample_cells`, from the particles sorted
    by cell (ks, order, segstart) and the cell count. Memory-safe on any
    input (a compiled step's warm-up runs it where its preconditions
    fail): every index is clamped."""
    m = params.max_samples
    dev = state.poses.device

    # the cells compacted to the front: each segment's key and first
    # sorted position, padded to u (the JAX package's 128-aligned size)
    u = min(CELL_U_MAX, -(-m // 128) * 128)
    ks_c, start_c = cluster._compact_front(
        segstart, ks, torch.arange(m, dtype=torch.int32, device=dev))
    if u > m:
        ks_c = torch.nn.functional.pad(ks_c, (0, u - m), value=kld.BIG)
        start_c = torch.nn.functional.pad(start_c, (0, u - m))
    uk, start_u = ks_c[:u], start_c[:u]
    idx_u = torch.arange(u, dtype=torch.int32, device=dev)
    valid_u = idx_u < u_count
    nxt = torch.where(idx_u == u_count - 1, state.n_active,
                      torch.cat([start_u[1:], torch.zeros(1, dtype=torch.int32, device=dev)]))
    cnt_f = torch.where(valid_u, nxt - start_u, 0).to(torch.float32)
    p_u = torch.where(valid_u, tbl[uk.clamp(0, tbl.shape[0] - 1).long()], 0.0)

    # updateSensor's averages (prior weights 1/n): t1 = sum_c cnt_c p_c / n
    nf = state.n_active.to(torch.float32).clamp(min=1.0)
    t1 = (cnt_f * p_u).sum() / nf
    ok_t = t1 > 0.0
    w_avg = t1 / nf
    w_slow = torch.where(ok_t, torch.where(
        state.w_slow == 0.0, w_avg, state.w_slow + state.alpha_slow * (w_avg - state.w_slow)),
        state.w_slow)
    w_fast = torch.where(ok_t, torch.where(
        state.w_fast == 0.0, w_avg, state.w_fast + state.alpha_fast * (w_avg - state.w_fast)),
        state.w_fast)

    # cell masses; a zero total resets to uniform over the active set
    # (particle_filter.cpp:258-266)
    mass_u = torch.where(ok_t, cnt_f * p_u, cnt_f)
    mass_n = mass_u / mass_u.sum()
    cum_u = cumsum_det(mass_n)
    # updateResample: w_diff from the updated averages
    w_diff = torch.where(w_slow > 0.0, torch.clamp(
        1.0 - w_fast / torch.where(w_slow > 0, w_slow, 1.0), min=0.0), 0.0)
    use_random = u_inject < w_diff

    # the cell of each draw (the count of cum values <= r, clipped to the
    # last padded cell), then its member: the residual (r - cumprev) /
    # mass is U[0, 1) given the cell, so it picks the member uniformly
    c = torch.searchsorted(cum_u, u_pick.contiguous(), right=True).clamp(max=u - 1)
    cumprev = torch.cat([torch.zeros(1, dtype=torch.float32, device=dev), cum_u[:-1]])
    pos_m = mass_n > 0
    invm = torch.where(pos_m, cnt_f / torch.where(pos_m, mass_n, 1.0), 0.0)
    c_cnt = cnt_f[c]
    off = torch.floor((u_pick - cumprev[c]) * invm[c])
    off = torch.minimum(off.clamp(min=0.0), (c_cnt - 1.0).clamp(min=0.0))
    member = (start_u[c].to(torch.float32) + off).to(torch.int64).clamp(0, m - 1)
    new_poses = torch.where(use_random[:, None], random_pose_pool,
                            state.poses[order[member]])

    new_count, rank_p, cluster_count = _kld_stop_and_ranks(new_poses, params)
    act2 = torch.arange(m, device=dev) < new_count
    reset = w_diff > 0.0
    new_state = state.replace(
        poses=new_poses.to(torch.float32),
        weights=torch.where(act2, 1.0 / new_count.to(torch.float32), 0.0).to(torch.float32),
        n_active=new_count.to(torch.int32),
        w_slow=torch.where(reset, 0.0, w_slow), w_fast=torch.where(reset, 0.0, w_fast))
    stats = cluster.compute_cluster_stats(new_state.poses, new_state.weights,
                                          new_state.active_mask, params,
                                          precomputed_ranks=(rank_p, cluster_count))
    return update_converged(new_state.replace(stats=stats), params, mean_xy=stats.mean[:2])


def max_weight_cluster(stats):
    """The heaviest cluster's (weight, mean): the published pose hypothesis
    (getMaxWeightPose, node_2d.cpp:588-617; filter.py:883-887). The argmax
    stays on the device: a 0-dim index tensor would be read to the host."""
    cidx = torch.argmax(stats.cluster_weights).reshape(1)
    return (stats.cluster_weights.index_select(0, cidx)[0],
            stats.cluster_means.index_select(0, cidx)[0])
