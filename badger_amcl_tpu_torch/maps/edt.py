"""Exact Euclidean distance transform for map preprocessing (2D and 3D).

A copy of badger_amcl_tpu.maps.edt's numpy Felzenszwalb-Huttenlocher
lower-envelope transform and its capping contract, kept here because any
import from badger_amcl_tpu loads JAX (its package __init__ imports the
JAX map modules) and the port runs where JAX is absent. The optional
native-library hook of the JAX package is left out.

Capping contract (reference occupancy_map.cpp:181,224-242):

    d_cells <= cell_radius (== floor(max_dist / resolution))
        -> value = d_cells * resolution
    otherwise
        -> value = max_dist
"""

from __future__ import annotations

import numpy as np

_INF = 1e18


def _edt_1d_sq(f: np.ndarray) -> np.ndarray:
    """Felzenszwalb 1-D squared distance transform along the last axis.

    `f` is the squared-distance cost per cell (INF where no source),
    shape (..., n); vectorized over leading axes, python loop over n."""
    shape = f.shape
    n = shape[-1]
    f2 = f.reshape(-1, n)
    m = f2.shape[0]
    v = np.zeros((m, n), dtype=np.int64)  # parabola locations
    z = np.full((m, n + 1), np.inf)  # boundaries
    z[:, 0] = -np.inf
    k = np.zeros(m, dtype=np.int64)  # index of rightmost parabola
    rows = np.arange(m)

    for q in range(1, n):
        fq = f2[:, q]
        while True:
            vk = v[rows, k]
            s = ((fq + q * q) - (f2[rows, vk] + vk * vk)) / (2.0 * q - 2.0 * vk)
            pop = (s <= z[rows, k]) & (k > 0)
            if not pop.any():
                break
            k[pop] -= 1
        vk = v[rows, k]
        s = ((fq + q * q) - (f2[rows, vk] + vk * vk)) / (2.0 * q - 2.0 * vk)
        k += 1
        v[rows, k] = q
        z[rows, k] = s
        z[rows, k + 1] = np.inf

    out = np.empty_like(f2)
    k = np.zeros(m, dtype=np.int64)
    for q in range(n):
        adv = z[rows, k + 1] < q
        while adv.any():
            k[adv] += 1
            adv = z[rows, k + 1] < q
        vk = v[rows, k]
        out[:, q] = (q - vk) ** 2 + f2[rows, vk]
    return out.reshape(shape)


def edt_2d(occupied: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance (cell units) to the nearest True cell.

    occupied: bool (H, W). Returns float64 (H, W); inf where no True exists."""
    f = np.where(occupied, 0.0, _INF)
    f = _edt_1d_sq(f)  # along W
    f = _edt_1d_sq(np.swapaxes(f, -1, -2))  # along H
    f = np.swapaxes(f, -1, -2)
    return np.sqrt(f)


def edt_3d(occupied: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance (cell units) to the nearest True voxel.

    occupied: bool (X, Y, Z). Returns float64 (X, Y, Z)."""
    f = np.where(occupied, 0.0, _INF)
    f = _edt_1d_sq(f)  # along Z
    f = _edt_1d_sq(np.swapaxes(f, -1, -2))  # along Y
    f = np.swapaxes(f, -1, -2)
    f = np.moveaxis(_edt_1d_sq(np.moveaxis(f, 0, -1)), -1, 0)  # along X
    return np.sqrt(f)


def capped_distance_field(
    occupied: np.ndarray, resolution: float, max_dist: float
) -> np.ndarray:
    """Distance-to-object field in meters with the reference capping
    contract (module docstring). occupied: bool (H, W). Returns float32."""
    if max_dist <= 0.0:
        raise ValueError("max_dist must be > 0")
    d_cells = edt_2d(occupied)
    cell_radius = int(np.floor(max_dist / resolution))
    return np.where(
        d_cells <= cell_radius, d_cells * resolution, max_dist
    ).astype(np.float32)
