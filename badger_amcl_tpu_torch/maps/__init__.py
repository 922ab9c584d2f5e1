"""2D occupancy map, distance field and baked textures."""

from badger_amcl_tpu_torch.maps.occupancy_2d import CellState, OccupancyMap2D  # noqa: F401
