"""Per-angle range images for the beam model (counterpart of
badger_amcl_tpu.maps.range_image, its numpy algorithm; the native C++ hook
is not ported).

R[k, j, i] is the distance in cells from cell (i, j) along theta_k =
2 pi k / K to the first non-FREE cell (out of bounds blocks, a blocked
start cell gives 0): the blocked mask is rotated so each direction is the
+u axis, a reverse cumulative minimum per row finds the next blocked cell,
and the result is sampled back at the map cells (range_image.py:39-80).

The bake runs in float64 on the map's device, a chunk of angles at a time.
cos/sin of each angle are numpy's, and every multiply and add is its own
op (no fused multiply-add), so the result is bit-equal to the numpy path.
"""

from __future__ import annotations

import numpy as np
import torch

from badger_amcl_tpu_torch.maps.occupancy_2d import CellState

# elements of one rotated-frame temporary per chunk of angles (a float64
# temporary is 64 MiB; a 1024^2 map bakes 3 angles per chunk)
CHUNK_ELEMENTS = 1 << 23


def to_u16(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor with values in [0, 65535] -> uint16 (through an int16
    bit view: torch's uint16 supports few ops)."""
    return x.to(torch.int16).view(torch.uint16)


def u16_to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint16 tensor (or its int16 bit view) -> int32 values."""
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def gather_u16(x: torch.Tensor, *index) -> torch.Tensor:
    """x[index] of a uint16 tensor as int32 values (CUDA indexes no uint16,
    so through the int16 view)."""
    return u16_to_i32(x.view(torch.int16)[index])


def build_range_image(cells: torch.Tensor, n_angles: int = 256) -> torch.Tensor:
    """cells: int8 (H, W) CellState grid ([j, i]) on any device. Returns
    uint16 (n_angles, H, W) on that device: the range in cells along each
    theta_k, Euclidean cell distance, saturating at 65535."""
    dev = cells.device
    f64 = torch.float64
    blocked = cells != int(CellState.FREE)
    h, w = blocked.shape
    d = int(np.ceil(np.hypot(h, w))) + 2
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rc = (d - 1) / 2.0
    u = torch.arange(d, dtype=f64, device=dev) - rc
    uu, vv = u[None, :], u[:, None]  # [v, u]
    jj = torch.arange(h, device=dev, dtype=f64)[:, None]
    ii = torch.arange(w, device=dev, dtype=f64)[None, :]
    xr = ii - cx
    yr = jj - cy
    uidx = torch.arange(d, dtype=torch.int32, device=dev)
    big = d + 10
    flat_blocked = blocked.reshape(-1)
    out = torch.empty((n_angles, h, w), dtype=torch.uint16, device=dev)
    step = max(1, CHUNK_ELEMENTS // (d * d))
    for k0 in range(0, n_angles, step):
        ks = np.arange(k0, min(k0 + step, n_angles))
        th = 2.0 * np.pi * ks / n_angles
        c = torch.as_tensor(np.cos(th), dtype=f64, device=dev)[:, None, None]
        s = torch.as_tensor(np.sin(th), dtype=f64, device=dev)[:, None, None]
        # world cell under rotated grid point (u, v): p = u e1 + v e2
        px = uu * c - vv * s + cx
        py = uu * s + vv * c + cy
        pi = torch.floor(px + 0.5).to(torch.int32)
        pj = torch.floor(py + 0.5).to(torch.int32)
        inb = (pi >= 0) & (pi < w) & (pj >= 0) & (pj < h)
        flat = pj.clamp(0, h - 1).to(torch.int64) * w + pi.clamp(0, w - 1)
        blk = ~inb | (inb & flat_blocked[flat])
        # next blocked index >= u per row: reverse cumulative minimum
        cand = torch.where(blk, uidx, big).flip(-1)
        nb = torch.cummin(cand, dim=-1).values.flip(-1)
        dist = nb - uidx  # cells along +u
        # sample at map cells: rotated coordinates of cell (i, j)
        su = xr * c + yr * s + rc
        sv = -xr * s + yr * c + rc
        si = torch.floor(su + 0.5).to(torch.int32).clamp(0, d - 1)
        sj = torch.floor(sv + 0.5).to(torch.int32).clamp(0, d - 1)
        idx = (sj.to(torch.int64) * d + si).reshape(len(ks), -1)
        r = torch.gather(dist.reshape(len(ks), -1), 1, idx)
        out[k0:k0 + len(ks)] = to_u16(r.clamp(0, 65535).reshape(len(ks), h, w))
    return out


def range_rows(range_image: torch.Tensor) -> torch.Tensor:
    """The transposed image (H * W, K) uint16: each cell's K-vector
    contiguous."""
    k = range_image.shape[0]
    rows = range_image.view(torch.int16).reshape(k, -1).t().contiguous()
    return rows.view(torch.uint16)
