"""PyTorch port: the exact Bresenham raycast and the per-angle range-image
bake, held against the JAX package on the same inputs.

Tolerances:
- calc_range: >= 99.9% of rays bit-equal (all 60,000 rays of a trial on
  this map were). The rest must be rays whose f32 endpoint cell differs
  between the two packages: the endpoint is origin + max_range *
  cos/sin(angle), whose f32 cos/sin may differ between XLA and PyTorch in
  the last ulp, and a value on a cell boundary then floors to the
  neighbouring cell, which changes the Bresenham line;
- the range image: bit-equal to the JAX package's numpy path (native hook
  off): both bake in float64 from numpy's cos/sin with every multiply and
  add a separate op; range_rows: exactly its transpose.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import badger_amcl_tpu.utils.native as jax_native
from badger_amcl_tpu.maps import CellState
from badger_amcl_tpu.maps import OccupancyMap2D as JaxMap
from badger_amcl_tpu.maps.range_image import build_range_image as jax_build_range_image
from badger_amcl_tpu.sensors.raycast import calc_range as jax_calc_range
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch.maps import range_image as tri
from badger_amcl_tpu_torch.sensors.raycast import calc_range

torch.set_num_threads(1)


def beam_cells(n=320, seed=6):
    """tests/test_beam_kernel.py's map: border walls and 12 6x6 blocks."""
    rng = np.random.default_rng(seed)
    cells = np.full((n, n), int(CellState.FREE), np.int8)
    cells[0:2, :] = cells[-2:, :] = int(CellState.OCCUPIED)
    cells[:, 0:2] = cells[:, -2:] = int(CellState.OCCUPIED)
    for _ in range(12):
        cx, cy = rng.integers(20, n - 28, 2)
        cells[cy:cy + 6, cx:cx + 6] = int(CellState.OCCUPIED)
    return cells


def numpy_range_image(cells, n_angles):
    """The JAX package's numpy bake, with the native hook switched off
    (tests/test_native.py:44-50)."""
    orig = jax_native.range_image
    jax_native.range_image = lambda *a, **k: None
    try:
        return jax_build_range_image(cells, 0.05, n_angles)
    finally:
        jax_native.range_image = orig


@pytest.fixture(scope="module")
def maps():
    cells = beam_cells()
    jmap = JaxMap.from_cells(cells, 0.05)
    return cells, jmap, convert.map_from_numpy(jmap, device="cpu")


def test_calc_range_matches_jax(maps):
    _, jmap, tmap = maps
    rng = np.random.default_rng(1)
    n = 6000
    ox = rng.uniform(-8.5, 8.5, n).astype(np.float32)  # some start off the map
    oy = rng.uniform(-8.5, 8.5, n).astype(np.float32)
    oa = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    want = np.asarray(jax_calc_range(jmap, jnp.asarray(ox), jnp.asarray(oy),
                                     jnp.asarray(oa), 8.0))
    got = calc_range(tmap, torch.from_numpy(ox), torch.from_numpy(oy),
                     torch.from_numpy(oa), 8.0).numpy()
    eq = got == want
    assert eq.mean() >= 0.999, eq.mean()
    assert (want < 8.0).mean() > 0.5  # most rays hit something
    # every other ray has an endpoint cell that differs between the packages
    end_j = np.asarray(jmap.world_to_map(jnp.stack([
        jnp.asarray(ox) + jnp.float32(8.0) * jnp.cos(jnp.asarray(oa)),
        jnp.asarray(oy) + jnp.float32(8.0) * jnp.sin(jnp.asarray(oa))], axis=-1)))
    end_t = tmap.world_to_map(torch.stack([
        torch.from_numpy(ox) + 8.0 * torch.cos(torch.from_numpy(oa)),
        torch.from_numpy(oy) + 8.0 * torch.sin(torch.from_numpy(oa))], dim=-1)).numpy()
    assert (end_j[~eq] != end_t[~eq]).any(axis=1).all()


def test_calc_range_broadcasts_and_start_cell(maps):
    _, jmap, tmap = maps
    # a start cell inside a wall returns 0; a zero-length ray max_range
    x = torch.tensor([-7.95, 0.3], dtype=torch.float32)
    y = torch.tensor([0.0, 0.2], dtype=torch.float32)
    a = torch.linspace(-1.0, 1.0, 5)
    got = calc_range(tmap, x[:, None], y[:, None], a[None, :], 4.0)
    want = np.asarray(jax_calc_range(jmap, jnp.asarray(x.numpy())[:, None],
                                     jnp.asarray(y.numpy())[:, None],
                                     jnp.asarray(a.numpy())[None, :], 4.0))
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0] == 0.0).all()
    assert (calc_range(tmap, x, y, torch.zeros(2), 0.0) == 0.0).all()


def test_range_image_bit_equal_to_numpy_path(maps):
    cells, _, tmap = maps
    want = numpy_range_image(cells, 96)
    got = tri.build_range_image(tmap.cells, 96)
    assert got.dtype == torch.uint16 and tuple(got.shape) == (96, 320, 320)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk_elements", [1, 1 << 16, 1 << 30])
def test_range_image_chunking_is_exact(chunk_elements, monkeypatch):
    monkeypatch.setattr(tri, "CHUNK_ELEMENTS", chunk_elements)
    cells = beam_cells(64, seed=2)
    want = numpy_range_image(cells, 32)
    got = tri.build_range_image(torch.from_numpy(cells), 32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_range_rows_is_the_transpose(maps):
    cells = beam_cells(96, seed=3)
    jmap = JaxMap.from_cells(cells, 0.05)
    orig = jax_native.range_image
    jax_native.range_image = lambda *a, **k: None
    try:
        jmap = jmap.with_range_image(64)
    finally:
        jax_native.range_image = orig
    tmap = convert.map_from_numpy(JaxMap.from_cells(cells, 0.05), device="cpu")
    tmap = tmap.with_range_image(64)
    img = tmap.range_image.numpy()
    rows = tmap.range_rows.numpy()
    assert rows.dtype == np.uint16 and rows.shape == (96 * 96, 64)
    np.testing.assert_array_equal(rows, img.reshape(64, -1).T)
    np.testing.assert_array_equal(img, np.asarray(jmap.range_image))
    np.testing.assert_array_equal(rows, np.asarray(jmap.range_rows))
    np.testing.assert_array_equal(tri.u16_to_i32(tmap.range_rows).numpy(),
                                  rows.astype(np.int32))
