"""2D occupancy map as device-resident tensors (counterpart of
badger_amcl_tpu.maps.occupancy_2d).

Conventions preserved exactly (reference occupancy_map.cpp):
- cell states FREE=-1, UNKNOWN=0, OCCUPIED=1 (occupancy_map.h:36-41)
- center-origin world<->map conversion (occupancy_map.cpp:75-98):
    ij = floor((world - origin)/res + 0.5) + size//2
- distance LUT capped at max_distance_to_object (occupancy_map.cpp:224-242)
- textures are (size_y, size_x) tensors indexed [j, i] (row-major i + j*W).

Baked textures: `distances_q` (the int8 ratio-quantized distance texture
of the spread kernel) and `distances_bf16` (the lf kernels' bf16 copy),
both filled with the distance field, `corr_psi_pad` (the
padded psi texture of the corr kernel, tagged by `corr_psi_key`) with its
int8 twin `corr_psi_pad_q` and
scale `corr_psi_q` (the corr_q backend), `factor_tex` (the recalcWeight factor
texture, tagged by `factor_key`), see sensors.planar.bake_corr_texture /
bake_factor_texture; `range_image` and `range_rows` for the beam model,
see `with_range_image`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from badger_amcl_tpu_torch.ops import edt_kernel
from badger_amcl_tpu_torch.utils.numerics import fdiv


class CellState(enum.IntEnum):
    """MapCellState (reference occupancy_map.h:36-41)."""

    FREE = -1
    UNKNOWN = 0
    OCCUPIED = 1


def grid_from_probabilities(data: np.ndarray) -> np.ndarray:
    """ROS OccupancyGrid data (0..100 / -1) -> CellState int8: 0 -> FREE,
    100 -> OCCUPIED, anything else -> UNKNOWN (node_2d.cpp:286-291)."""
    data = np.asarray(data)
    out = np.zeros(data.shape, dtype=np.int8)  # UNKNOWN
    out[data == 0] = int(CellState.FREE)
    out[data == 100] = int(CellState.OCCUPIED)
    return out


@dataclasses.dataclass(frozen=True)
class OccupancyMap2D:
    """Immutable 2D map bundle; tensor fields live on one device.

    cells:     int8 (H, W) CellState values, indexed [j, i]
    distances: float32 (H, W) capped distance-to-obstacle in meters, or
               None until `with_distance_field` is called
    distances_q: int8 (H, W) `ops.spread_kernel.quantized_tex` of them
    distances_bf16: bfloat16 (H, W) copy of them (`ops.lf_kernel.lf_texture`)
    """

    resolution: float
    size_x: int
    size_y: int
    origin_x: float
    origin_y: float
    cells: torch.Tensor
    distances: Optional[torch.Tensor] = None
    max_distance_to_object: float = 0.0
    distances_q: Optional[torch.Tensor] = None
    distances_bf16: Optional[torch.Tensor] = None
    # per-angle range image, uint16 (K, H, W) cells (maps.range_image), and
    # its transpose (H * W, K) for the spread-cloud beam kernel
    range_image: Optional[torch.Tensor] = None
    range_rows: Optional[torch.Tensor] = None
    corr_psi_pad: Optional[torch.Tensor] = None
    corr_psi_key: Optional[tuple] = None
    # int8 ratio-quantized psi (PAD_RQ-row padding) and its (2,) f32 scale
    # [qstep, qoff]; shares corr_psi_key's fingerprint
    corr_psi_pad_q: Optional[torch.Tensor] = None
    corr_psi_q: Optional[torch.Tensor] = None
    factor_tex: Optional[torch.Tensor] = None
    factor_key: Optional[tuple] = None

    @staticmethod
    def from_cells(cells: np.ndarray, resolution: float, origin_x: float = 0.0,
                   origin_y: float = 0.0, device="cuda") -> "OccupancyMap2D":
        """cells: int8 (H=size_y, W=size_x) CellState grid, indexed [j, i]."""
        cells = np.asarray(cells, dtype=np.int8)
        h, w = cells.shape
        return OccupancyMap2D(
            resolution=float(resolution), size_x=w, size_y=h,
            origin_x=float(origin_x), origin_y=float(origin_y),
            cells=torch.as_tensor(cells, device=device),
        )

    @staticmethod
    def from_occupancy_grid_msg(width: int, height: int, resolution: float,
                                origin_position_x: float, origin_position_y: float,
                                data: np.ndarray, map_scale_up_factor: int = 1,
                                device="cuda") -> "OccupancyMap2D":
        """Build from a ROS-style OccupancyGrid message with the reference's
        supersampling (node_2d.cpp:265-295): resolution / scale, size *
        scale, the centre origin msg.origin + (size // 2) * resolution, each
        supersampled cell its parent's state."""
        s = int(map_scale_up_factor)
        res = float(resolution) / s
        w, h = int(width) * s, int(height) * s
        base = grid_from_probabilities(np.asarray(data).reshape(int(height), int(width)))
        cells = np.repeat(np.repeat(base, s, axis=0), s, axis=1)
        return OccupancyMap2D.from_cells(cells, res, float(origin_position_x) + (w // 2) * res,
                                         float(origin_position_y) + (h // 2) * res, device)

    @property
    def device(self) -> torch.device:
        return self.cells.device

    @property
    def distances_lut_created(self) -> bool:
        """Whether the distance field exists: the node drops scans until it
        does (map.h:53, node_2d.cpp:406)."""
        return self.distances is not None

    def with_distance_field(self, max_distance_to_object: float) -> "OccupancyMap2D":
        """Build the capped distance LUT (reference updateDistancesLUT,
        occupancy_map.cpp:138-160) on the map's device
        (`ops.edt_kernel.capped_field_2d`), and bake its textures there
        (`with_distance_bakes`)."""
        lut = edt_kernel.capped_field_2d(self.cells, self.resolution,
                                         float(max_distance_to_object))
        return dataclasses.replace(
            self, distances=lut, max_distance_to_object=float(max_distance_to_object),
        ).with_distance_bakes()

    def with_distance_bakes(self) -> "OccupancyMap2D":
        """Bake the distance field's int8 quantized texture and bf16 copy."""
        from badger_amcl_tpu_torch.ops.spread_kernel import quantized_tex

        return dataclasses.replace(self, distances_q=quantized_tex(self),
                                   distances_bf16=self.distances.to(torch.bfloat16))

    def with_range_image(self, n_angles: int = 256) -> "OccupancyMap2D":
        """Bake the per-angle range image on the map's device, and its
        transpose when it fits the JAX package's RANGE_ROWS_MAX_BYTES gate
        (occupancy_2d.py:175-192)."""
        from badger_amcl_tpu_torch.maps import range_image as ri
        from badger_amcl_tpu_torch.ops.beam_spread_kernel import RANGE_ROWS_MAX_BYTES

        img = ri.build_range_image(self.cells, n_angles)
        rows = ri.range_rows(img) if 2 * img.numel() <= RANGE_ROWS_MAX_BYTES else None
        return dataclasses.replace(self, range_image=img, range_rows=rows)

    # --- conversions ------------------------------------------------------

    def cells_of(self, x: torch.Tensor, y: torch.Tensor):
        """World meters -> int32 cell indices (ci, cj), occupancy_map.cpp:90-98."""
        ci = torch.floor(fdiv(x - self.origin_x, self.resolution) + 0.5)
        cj = torch.floor(fdiv(y - self.origin_y, self.resolution) + 0.5)
        return (ci.to(torch.int32) + self.size_x // 2,
                cj.to(torch.int32) + self.size_y // 2)

    def world_to_map(self, xy: torch.Tensor) -> torch.Tensor:
        """(..., 2) world meters -> (..., 2) int32 cell indices (i, j)."""
        ci, cj = self.cells_of(xy[..., 0], xy[..., 1])
        return torch.stack([ci, cj], dim=-1)

    def map_to_world(self, ij: torch.Tensor) -> torch.Tensor:
        """(..., 2) integer cell indices -> (..., 2) f32 world meters of the
        cell centres (occupancy_map.cpp:75-88)."""
        half = torch.tensor([self.size_x // 2, self.size_y // 2], dtype=ij.dtype,
                            device=ij.device)
        origin = torch.tensor([self.origin_x, self.origin_y], dtype=torch.float32,
                              device=ij.device)
        res = torch.full((), self.resolution, dtype=torch.float32, device=ij.device)
        return origin + (ij - half).to(torch.float32) * res

    def in_bounds(self, ci: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
        return (ci >= 0) & (ci < self.size_x) & (cj >= 0) & (cj < self.size_y)

    def is_valid(self, ij: torch.Tensor) -> torch.Tensor:
        """(..., 2) -> bool (...). Bounds check (occupancy_map.cpp:100-105)."""
        return self.in_bounds(ij[..., 0], ij[..., 1])

    def flat_index(self, ci: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
        """Clipped int64 linear index into an (H, W) texture."""
        i = ci.clamp(0, self.size_x - 1).long()
        j = cj.clamp(0, self.size_y - 1).long()
        return j * self.size_x + i

    def cell_state_at(self, ij: torch.Tensor) -> torch.Tensor:
        """CellState at (..., 2) cells, clipped into the map: pair with
        `is_valid` (occupancy_2d.py:226-230)."""
        return self.cells.reshape(-1)[self.flat_index(ij[..., 0], ij[..., 1])]

    def distance_at(self, ij: torch.Tensor) -> torch.Tensor:
        """Distance at (..., 2) cells; out of bounds -> max distance
        (reference getDistanceToObject, occupancy_map.cpp:64-73)."""
        ci, cj = ij[..., 0], ij[..., 1]
        d = self.distances.reshape(-1)[self.flat_index(ci, cj)]
        return torch.where(self.in_bounds(ci, cj), d,
                           torch.full_like(d, self.max_distance_to_object))

    # --- derived host-side products ----------------------------------------

    def free_space_indices(self, non_free_space_radius: float = 0.0) -> np.ndarray:
        """(F, 2) int32 (i, j) of the FREE cells farther than the radius from
        any obstacle (updateFreeSpaceIndices, node_2d.cpp:318-338), in the
        JAX package's order (row-major over [j, i])."""
        free = self.cells.cpu().numpy() == int(CellState.FREE)
        if self.distances is not None:
            free &= self.distances.cpu().numpy() > non_free_space_radius
        j, i = np.nonzero(free)
        return np.stack([i, j], axis=1).astype(np.int32)
