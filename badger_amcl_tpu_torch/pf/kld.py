"""KLD-sampling support: pose-histogram binning and the Fox population
bound (counterpart of badger_amcl_tpu.pf.kld, sorted formulation).

Bins are floor(pose / [0.5 m, 0.5 m, 10 deg]) (pf_kdtree.cpp:33-56) placed
on a dense grid relative to the cloud's minimum bin; yaw bins do not wrap
(pf_kdtree.cpp treats the yaw key as a plain integer). Occupied-bin counts
and first-occurrence flags come from stable sorts (`leaf_count_sorted`,
`first_occurrence_flags_sorted`) or, as the JAX package's capped
(`stats_max_clusters`) resample takes them, from the dense grid
(`leaf_count`, the scatter-min `first_occurrence_flags`); both give the
same integers. Keys stay int32 as in the JAX package: the single-robot grid holds
at most hist_x*hist_y*hist_a < 2**30 cells. A fleet's composite keys
robot * n_cells + bin are int64: in int32 with the JAX package's 2**30
sentinel they collide past R * n_cells >= 2**30 (ADVICE.md).
"""

from __future__ import annotations

import math

import torch

from badger_amcl_tpu_torch.utils.numerics import device_vector, fdiv

CELL_X = 0.5
CELL_Y = 0.5
CELL_A = 10.0 * math.pi / 180.0

BIG = 2 ** 30


def bin_keys(poses: torch.Tensor) -> torch.Tensor:
    """(N, 3) poses -> (N, 3) int32 histogram keys (pf_kdtree.cpp:49-56)."""
    cell = device_vector((CELL_X, CELL_Y, CELL_A), poses.dtype, poses.device)
    return torch.floor(poses / cell).to(torch.int32)


def grid_cells(keys3: torch.Tensor, active: torch.Tensor, shape):
    """Bin keys (..., N, 3) -> dense-grid cells relative to the active
    minimum (per robot for a fleet): (cells (..., N, 3) int32 clamped to [1, size-2] so the empty border keeps
    roll dilation from wrapping, flat (N,) int32 with inactive -> 0)."""
    gx, gy, ga = shape
    masked = torch.where(active[..., None], keys3, BIG)
    mins = masked.min(dim=-2).values
    mins = torch.where(mins == BIG, 0, mins)
    sizes = device_vector((gx - 2, gy - 2, ga - 2), torch.int32, keys3.device)
    rel = torch.minimum(torch.clamp(keys3 - mins[..., None, :], min=0), sizes - 1) + 1
    flat = (rel[..., 2] * gx + rel[..., 0]) * gy + rel[..., 1]
    return rel, torch.where(active, flat, 0).to(torch.int32)


def occupancy_grid(flat: torch.Tensor, active: torch.Tensor, shape) -> torch.Tensor:
    """bool (gx*gy*ga,) occupancy of the bin grid. Inactive entries
    scatter into a spare last cell: a mask index would read the mask's
    count back to the host."""
    gx, gy, ga = shape
    n = gx * gy * ga
    occ = torch.zeros((n + 1,), dtype=torch.bool, device=flat.device)
    occ.index_fill_(0, torch.where(active, flat, n).long(), True)
    return occ[:n]


def leaf_count(poses: torch.Tensor, active: torch.Tensor, shape) -> torch.Tensor:
    """Occupied-bin count == kd-tree leaf count (pf_kdtree.cpp:92-95), from
    the occupancy grid (kld.py:77-80)."""
    _, flat = grid_cells(bin_keys(poses), active, shape)
    return occupancy_grid(flat, active, shape).sum().to(torch.int32)


def first_occurrence_flags(flat: torch.Tensor, active: torch.Tensor, shape):
    """Whether each entry's bin is unseen at any earlier active index: a
    scatter-min of the draw index over the grid, then one gather back
    (kld.py:83-100). Inactive entries scatter into a spare last cell."""
    gx, gy, ga = shape
    n_cells = gx * gy * ga
    idx = torch.arange(flat.shape[0], dtype=torch.int32, device=flat.device)
    dst = torch.where(active, flat, n_cells).long()
    grid = torch.full((n_cells + 1,), BIG, dtype=torch.int32, device=flat.device)
    grid.scatter_reduce_(0, dst, idx, reduce="amin")
    return (grid[flat.long()] == idx) & active


def sort_by_bin(flat: torch.Tensor, active: torch.Tensor):
    """Stable sort of particle indices by bin key, inactive last. Returns
    (keys_sorted, draw_idx_sorted, active_sorted, segstart); segstart marks
    the first (draw-earliest) entry of each occupied bin."""
    skey = torch.where(active, flat, BIG)
    ks, idx_s = torch.sort(skey, stable=True)
    act_s = ks < BIG
    segstart = act_s & torch.cat([torch.ones(1, dtype=torch.bool, device=ks.device),
                                  ks[1:] != ks[:-1]])
    return ks, idx_s, act_s, segstart


def to_draw_order(idx_s: torch.Tensor, vals_s: torch.Tensor) -> torch.Tensor:
    """Values in sorted order -> draw order (idx_s is the sort permutation)."""
    out = torch.empty_like(vals_s)
    out[idx_s] = vals_s
    return out


def first_occurrence_flags_sorted(flat: torch.Tensor, active: torch.Tensor):
    """Whether each entry's bin is unseen at any earlier active index."""
    _, idx_s, _, segstart = sort_by_bin(flat, active)
    return to_draw_order(idx_s, segstart)


def leaf_count_sorted(poses: torch.Tensor, active: torch.Tensor, shape) -> torch.Tensor:
    """`leaf_count` from one stable sort (kld.py:134-138)."""
    _, flat = grid_cells(bin_keys(poses), active, shape)
    return sort_by_bin(flat, active)[3].sum().to(torch.int32)


FLEET_SENTINEL = 2 ** 62  # int64 composite-key sentinel: sorts after every key


def composite_sort(flat: torch.Tensor, active: torch.Tensor, n_cells: int):
    """One stable sort of a fleet's (R, M) bins by the int64 composite key
    robot * n_cells + bin, inactive entries last. Returns (keys_sorted,
    flat draw index sorted, segstart) over the flattened R * M axis;
    segstart marks the first (draw-earliest) entry of each occupied
    (robot, bin)."""
    r = flat.shape[0]
    robot = torch.arange(r, dtype=torch.int64, device=flat.device)[:, None]
    comp = torch.where(active, robot * n_cells + flat.to(torch.int64),
                       FLEET_SENTINEL).reshape(-1)
    ks, idx_s = torch.sort(comp, stable=True)
    segstart = (ks < FLEET_SENTINEL) & torch.cat(
        [torch.ones(1, dtype=torch.bool, device=ks.device), ks[1:] != ks[:-1]])
    return ks, idx_s, segstart


def leaf_count_fleet(flat: torch.Tensor, active: torch.Tensor, shape) -> torch.Tensor:
    """Per robot, the occupied-bin count of flat, active (R, M): the
    segment starts of one composite-key sort, counted by robot. Returns
    (R,) int32."""
    gx, gy, ga = shape
    n_cells = gx * gy * ga
    r = flat.shape[0]
    ks, _, segstart = composite_sort(flat, active, n_cells)
    counts = torch.zeros((r,), dtype=torch.int32, device=flat.device)
    return counts.scatter_add_(0, (ks // n_cells).clamp(max=r - 1), segstart.to(torch.int32))


def first_occurrence_flags_fleet(flat: torch.Tensor, active: torch.Tensor, shape):
    """Per robot, whether each entry's bin is unseen at any earlier active
    index (kld.py:141-167): one composite-key sort over R * M. Within a
    robot the composite order is bin order and stability keeps draw order
    inside a bin, so segment starts are the per-robot first occurrences.
    flat, active: (R, M). Returns (R, M) bool."""
    gx, gy, ga = shape
    _, idx_s, segstart = composite_sort(flat, active, gx * gy * ga)
    return to_draw_order(idx_s, segstart).reshape(flat.shape)


def resample_limit(k: torch.Tensor, min_samples: int, max_samples: int,
                   pop_err: float, pop_z: float) -> torch.Tensor:
    """Fox et al. KLD bound, exactly as particle_filter.cpp:475-502, in f32
    like the JAX package. k <= 1 -> max_samples."""
    kf = k.to(torch.float32)
    b = 2.0 / (9.0 * (kf - 1.0))
    c = torch.sqrt(b) * pop_z
    x = 1.0 - b + c
    n = torch.ceil(fdiv(kf - 1.0, 2.0 * pop_err) * x * x * x)
    n = torch.clamp(n, min_samples, max_samples).to(torch.int32)
    return torch.where(k <= 1, max_samples, n).to(torch.int32)
