"""2D occupancy map, 3D voxel map, distance fields and baked textures."""

from badger_amcl_tpu_torch.maps.occupancy_2d import CellState, OccupancyMap2D  # noqa: F401
from badger_amcl_tpu_torch.maps.octomap_3d import OctoMap3D  # noqa: F401
