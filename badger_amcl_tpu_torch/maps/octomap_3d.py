"""3D voxel distance field as a device-resident texture (counterpart of
badger_amcl_tpu.maps.octomap_3d).

Occupied voxel centers are rasterized into the cropped voxel volume on
the map's device, and the Euclidean distance field, quantized to uint8 with
the reference's contract, is built there (`ops.edt_kernel.
voxel_texture_3d`), z-major: `tex_zyx` is (nz, ny, nx), the layout both
point-cloud kernels read (the JAX package transposes its (nx, ny, nz) array
on every kernel call). `distances_u8` is the (nx, ny, nz) view of the same
storage.

Contracts preserved (reference octomap.cpp):
- zero-origin world<->map conversion: world = cell * res,
  cell = floor(w / res + 0.5) (:83-109);
- cropped cell bounds from the metric min/max (:53-74), optionally
  intersected with 2D-map bounds padded by max_distance_to_object
  (`set_map_bounds`, :128-150);
- uint8 quantization: ratio = floor(min(d, max_d) / max_d * 255), read back
  as ratio * (max_d / 255) (:315-350);
- out-of-bounds lookups return max_distance_to_object (:336-341).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from badger_amcl_tpu_torch.ops import edt_kernel
from badger_amcl_tpu_torch.utils.numerics import fdiv


def _cell(v: float, resolution: float) -> int:
    return int(np.floor(v / resolution + 0.5))


@dataclasses.dataclass(frozen=True)
class OctoMap3D:
    """Immutable 3D map bundle.

    min_cells/max_cells: inclusive cropped voxel bounds in map cells.
    occupied_cells: (K, 3) int32 host array of occupied voxels (pre-crop).
    tex_zyx: uint8 (nz, ny, nx) quantized distance ratios on `device`, None
             until `with_distance_field` runs.
    """

    resolution: float
    max_distance_to_object: float
    min_cells: Tuple[int, int, int]
    max_cells: Tuple[int, int, int]
    occupied_cells: np.ndarray
    device: torch.device = torch.device("cuda")
    tex_zyx: Optional[torch.Tensor] = None

    # --- construction -----------------------------------------------------

    @staticmethod
    def from_occupied_points(points: np.ndarray, resolution: float,
                             max_distance_to_object: float,
                             metric_min: Optional[Sequence[float]] = None,
                             metric_max: Optional[Sequence[float]] = None,
                             device="cuda") -> "OctoMap3D":
        """points: (K, 3) world coordinates of occupied voxel centers;
        metric_min/max default to the point extents (the reference uses the
        octree's metric bounds, octomap.cpp:58-70)."""
        pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        if metric_min is None:
            metric_min = pts.min(axis=0) if len(pts) else np.zeros(3)
        if metric_max is None:
            metric_max = pts.max(axis=0) if len(pts) else np.zeros(3)
        return OctoMap3D(
            resolution=float(resolution),
            max_distance_to_object=float(max_distance_to_object),
            min_cells=tuple(_cell(v, resolution) for v in metric_min),
            max_cells=tuple(_cell(v, resolution) for v in metric_max),
            occupied_cells=np.floor(pts / resolution + 0.5).astype(np.int32),
            device=torch.device(device),
        )

    @staticmethod
    def from_binary_octree(tree, max_distance_to_object: float,
                           device="cuda") -> "OctoMap3D":
        """Build from a `maps.octree_io.BinaryOcTree`: its occupied voxel
        centers, metric bounds from their extents (octomap_3d.py:86-91)."""
        return OctoMap3D.from_occupied_points(tree.occupied_centers(), tree.resolution,
                                              max_distance_to_object, device=device)

    def set_map_bounds(self, map_min: Sequence[float],
                       map_max: Sequence[float]) -> "OctoMap3D":
        """Intersect the cropped bounds with 2D-map (x, y) bounds padded by
        max_distance_to_object, then rebake (setMapBounds,
        octomap.cpp:128-150)."""
        new_min, new_max = list(self.min_cells), list(self.max_cells)
        for a in range(len(map_min)):
            lo = _cell(map_min[a] - self.max_distance_to_object, self.resolution)
            hi = _cell(map_max[a] + self.max_distance_to_object, self.resolution)
            new_min[a] = max(new_min[a], lo)
            new_max[a] = min(new_max[a], hi)
        cropped = dataclasses.replace(self, min_cells=tuple(new_min),
                                      max_cells=tuple(new_max))
        return cropped.with_distance_field()

    def with_distance_field(self) -> "OctoMap3D":
        """Bake the quantized voxel EDT (updateDistancesLUT,
        octomap.cpp:174-207) on the map's device."""
        tex = edt_kernel.voxel_texture_3d(self.occupancy_volume(), self.resolution,
                                          self.max_distance_to_object)
        return dataclasses.replace(self, tex_zyx=tex)

    def occupancy_volume(self) -> torch.Tensor:
        """uint8 (nz, ny, nx) volume of the cropped map on its device, 1 at
        the occupied voxels; out-of-crop occupied leaves are skipped
        (octomap.cpp:232)."""
        nx, ny, nz = self.size
        if nx <= 0 or ny <= 0 or nz <= 0:
            raise ValueError("empty cropped volume")
        n = nx * ny * nz
        c = (torch.as_tensor(self.occupied_cells, device=self.device).long()
             - torch.tensor(self.min_cells, device=self.device))
        inb = ((c >= 0) & (c < torch.tensor([nx, ny, nz], device=self.device))).all(dim=1)
        # out-of-crop leaves land on the spare last element, cut off below
        flat = torch.where(inb, (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0], n)
        vol = torch.zeros(n + 1, dtype=torch.uint8, device=self.device)
        vol[flat] = 1
        return vol[:n].view(nz, ny, nx)

    # --- geometry -----------------------------------------------------------

    @property
    def size(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) voxels of the cropped volume."""
        return tuple(hi - lo + 1 for lo, hi in zip(self.min_cells, self.max_cells))

    @property
    def distances_u8(self) -> Optional[torch.Tensor]:
        """The (nx, ny, nz) view of the texture (the JAX package's layout)."""
        return None if self.tex_zyx is None else self.tex_zyx.permute(2, 1, 0)

    @property
    def distances_lut_created(self) -> bool:
        return self.tex_zyx is not None

    @property
    def max_distance_ratio(self) -> float:
        """Quantization step: max_distance_to_object / 255 (octomap.cpp:57)."""
        return self.max_distance_to_object / 255.0

    # --- conversions --------------------------------------------------------

    def world_to_map(self, xyz: torch.Tensor) -> torch.Tensor:
        """(..., D) world meters -> (..., D) int32 voxel cells
        (octomap.cpp:98-109)."""
        return torch.floor(fdiv(xyz.to(torch.float32), self.resolution) + 0.5).to(torch.int32)

    def map_to_world(self, cells: torch.Tensor) -> torch.Tensor:
        """(..., 3) voxel cells -> (..., 3) world meters (octomap.cpp:83-95)."""
        return cells.to(torch.float32) * self.resolution

    def is_pose_valid(self, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
        """2D in-bounds check used by recalcWeight (octomap.cpp:112-116)."""
        return ((i >= self.min_cells[0]) & (i <= self.max_cells[0])
                & (j >= self.min_cells[1]) & (j <= self.max_cells[1]))

    def is_voxel_valid(self, ijk: torch.Tensor) -> torch.Tensor:
        k = ijk[..., 2]
        return (self.is_pose_valid(ijk[..., 0], ijk[..., 1])
                & (k >= self.min_cells[2]) & (k <= self.max_cells[2]))

    def flat_index(self, ci: torch.Tensor, cj: torch.Tensor, ck: torch.Tensor) -> torch.Tensor:
        """Clipped int64 linear index into the z-major texture of texture-local
        cells (ci, cj, ck)."""
        nx, ny, nz = self.size
        i = ci.clamp(0, nx - 1).long()
        j = cj.clamp(0, ny - 1).long()
        k = ck.clamp(0, nz - 1).long()
        return (k * ny + j) * nx + i

    def distance_at(self, ijk: torch.Tensor) -> torch.Tensor:
        """Distance-to-object (meters) at (..., 3) voxel cells; out of bounds
        -> max_distance_to_object (octomap.cpp:336-350)."""
        flat = self.flat_index(ijk[..., 0] - self.min_cells[0],
                               ijk[..., 1] - self.min_cells[1],
                               ijk[..., 2] - self.min_cells[2])
        d = self.tex_zyx.reshape(-1)[flat].to(torch.float32) * self.max_distance_ratio
        return torch.where(self.is_voxel_valid(ijk), d,
                           torch.full_like(d, self.max_distance_to_object))

    def distances_lut_cloud(self, max_count: int = 1_000_000) -> np.ndarray:
        """Debug dump of the LUT as an intensity point cloud: (K, 4) rows of
        (x, y, z, distance) for voxels closer than the maximum, capped at
        max_count (publishDistancesLUT, octomap.cpp:357-395)."""
        if self.tex_zyx is None:
            return np.zeros((0, 4))
        ratios = self.distances_u8.cpu().numpy()
        idx = np.argwhere(ratios < 255)[:max_count]
        cells = idx + np.array(self.min_cells)
        d = ratios[idx[:, 0], idx[:, 1], idx[:, 2]] * self.max_distance_ratio
        world = cells.astype(np.float64) * self.resolution
        return np.concatenate([world, d[:, None]], axis=1)

    def free_space_indices(self) -> np.ndarray:
        """(F, 2) int32 (i, j) cells spanning the cropped footprint, exclusive
        of the max cell (the reference's TODO at node_3d.cpp:306-318)."""
        i = np.arange(self.min_cells[0], self.max_cells[0])
        j = np.arange(self.min_cells[1], self.max_cells[1])
        gi, gj = np.meshgrid(i, j, indexing="ij")
        return np.stack([gi.ravel(), gj.ravel()], axis=1).astype(np.int32)
