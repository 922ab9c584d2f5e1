"""PyTorch port: the maps' distance fields (`ops.edt_kernel`), held
against the JAX package's capped 2D field and uint8 voxel texture on the
same seeded numpy inputs, and against the JAX package's numpy exact EDT
capped by hand.

On the CPU the wrappers run their plain versions (windowed int32 minima,
then float64 arithmetic rounded as numpy rounds it); the CUDA kernel in
csrc/edt.cu is held against the same plain version on the card by
chip_smoke.py. Tolerance: none. Squared distances are integers and the
capping and quantization take the same float64 operations in the same
order, so every comparison is bit-equal.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from badger_amcl_tpu.maps import OctoMap3D as JaxOctoMap
from badger_amcl_tpu.maps import edt as jax_edt
from badger_amcl_tpu_torch.maps import edt
from badger_amcl_tpu_torch.maps.occupancy_2d import CellState, OccupancyMap2D
from badger_amcl_tpu_torch.maps.octomap_3d import OctoMap3D
from badger_amcl_tpu_torch.ops import edt_kernel

torch.set_num_threads(1)

CAPS_2D = [(0.05, 2.0), (0.025, 0.36), (0.05, 0.3)]


def _cells(occ):
    """int8 CellState grid of a bool mask: OCCUPIED where True, else FREE."""
    return torch.as_tensor(np.where(occ, int(CellState.OCCUPIED),
                                    int(CellState.FREE)).astype(np.int8))


def _grid_2d(seed=0, h=256, w=192):
    """Border walls, seeded 6 x 6 blocks and scattered cells."""
    rng = np.random.default_rng(seed)
    occ = rng.random((h, w)) < 0.004
    occ[0, :] = occ[:, 0] = True
    for _ in range(12):
        y, x = rng.integers(0, h - 6), rng.integers(0, w - 6)
        occ[y:y + 6, x:x + 6] = True
    return occ


def _texture_by_hand(occ, res, max_dist):
    """The JAX package's numpy exact EDT, quantized as octomap_3d.py:136-141
    does."""
    d_m = np.minimum(jax_edt.edt_3d(occ) * res, max_dist)
    return np.floor(d_m / max_dist * 255.0).astype(np.uint8)


@pytest.mark.parametrize("res,max_dist", CAPS_2D)
def test_field_2d_bit_equal_to_jax(res, max_dist):
    occ = _grid_2d()
    got = edt_kernel.capped_field_2d(_cells(occ), res, max_dist)
    assert got.dtype == torch.float32 and tuple(got.shape) == occ.shape
    np.testing.assert_array_equal(got.numpy(),
                                  jax_edt.capped_distance_field(occ, res, max_dist))


def test_field_2d_map_receipt_bit_equal_to_jax(monkeypatch):
    """OccupancyMap2D.with_distance_field on the CPU takes the plain version,
    not the numpy EDT, and matches the JAX package's field."""
    def refuse(*_):
        raise AssertionError("the numpy EDT ran at map receipt")

    for name in ("edt_2d", "edt_3d", "capped_distance_field", "_edt_1d_sq"):
        monkeypatch.setattr(edt, name, refuse)
    occ = _grid_2d(seed=4)
    omap = OccupancyMap2D.from_cells(np.where(occ, 1, -1).astype(np.int8), 0.025,
                                     device="cpu").with_distance_field(0.36)
    monkeypatch.undo()
    np.testing.assert_array_equal(omap.distances.numpy(),
                                  jax_edt.capped_distance_field(occ, 0.025, 0.36))


def _volume_points(seed=1, shape=(64, 48, 20), res=0.05):
    """Voxel centres of a floor, two walls and seeded columns, in a
    (nx, ny, nz) grid from the origin."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    cells = [(i, j, 0) for i in range(nx) for j in range(ny) if rng.random() < 0.5]
    cells += [(i, 3, k) for i in range(nx) for k in range(nz)]
    cells += [(nx - 2, j, k) for j in range(ny) for k in range(0, nz, 2)]
    for _ in range(6):
        i, j = rng.integers(0, nx), rng.integers(0, ny)
        cells += [(i, j, k) for k in range(rng.integers(1, nz))]
    return np.asarray(cells, np.float64) * res


@pytest.mark.parametrize("max_dist", [0.3, 0.36])
@pytest.mark.parametrize("crop", [False, True])
def test_texture_3d_bit_equal_to_jax(max_dist, crop):
    """The port's OctoMap3D bake (scatter, then the wrapper) against the JAX
    package's distances_u8 at 64 x 48 x 20; the crop drops the leaves of the
    floor's first rows and the top slabs (octomap.cpp:232)."""
    pts = _volume_points()
    bounds = (dict(metric_min=(0.4, 0.0, 0.0), metric_max=(3.15, 2.35, 0.6)) if crop
              else dict(metric_min=(0, 0, 0), metric_max=(3.15, 2.35, 0.95)))
    jmap = JaxOctoMap.from_occupied_points(pts, 0.05, max_dist, **bounds).with_distance_field()
    tmap = OctoMap3D.from_occupied_points(pts, 0.05, max_dist, **bounds,
                                          device="cpu").with_distance_field()
    want = np.asarray(jmap.distances_u8)
    assert tmap.size == want.shape
    assert tmap.size == ((56, 48, 13) if crop else (64, 48, 20))
    np.testing.assert_array_equal(tmap.distances_u8.numpy(), want)
    got = edt_kernel.voxel_texture_3d(tmap.occupancy_volume(), 0.05, max_dist)
    np.testing.assert_array_equal(got.numpy(), want.transpose(2, 1, 0))


def _edge_2d(case):
    occ = np.zeros((37, 29), bool)
    if case == "one_corner":
        occ[0, 0] = True
    elif case == "all_occupied":
        occ[:] = True
    elif case == "narrow":  # 3 x 90 against a window of 40
        occ = np.zeros((3, 90), bool)
        occ[1, 45] = occ[2, 0] = True
    elif case == "lines_without_source":  # most rows and columns hold no source
        occ[5, ::7] = occ[30, 3] = occ[12, 20] = True
    return occ


EDGE_CASES = ["empty", "one_corner", "all_occupied", "narrow", "lines_without_source"]


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("res,max_dist", CAPS_2D)
def test_field_2d_edges(case, res, max_dist):
    occ = _edge_2d(case)
    np.testing.assert_array_equal(
        edt_kernel.capped_field_2d(_cells(occ), res, max_dist).numpy(),
        jax_edt.capped_distance_field(occ, res, max_dist))


def _edge_3d(case):
    occ = np.zeros((11, 9, 7), bool)
    if case == "one_corner":
        occ[-1, -1, -1] = True
    elif case == "all_occupied":
        occ[:] = True
    elif case == "narrow":  # 2 x 30 x 3 against a window of 7
        occ = np.zeros((2, 30, 3), bool)
        occ[0, 29, 1] = True
    elif case == "lines_without_source":
        occ[2, :, 3] = occ[8, 4, :] = True
    return occ


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("max_dist", [0.3, 0.36])
def test_texture_3d_edges(case, max_dist):
    occ = _edge_3d(case)
    got = edt_kernel.voxel_texture_3d(torch.as_tensor(occ.astype(np.uint8)), 0.05, max_dist)
    np.testing.assert_array_equal(got.numpy(), _texture_by_hand(occ, 0.05, max_dist))


def test_windows():
    """The 2D window is cell_radius; the 3D one reaches past max / res when
    that is not an integer (0.3 / 0.05 is 5.999... in float64)."""
    assert edt_kernel.window_2d(0.025, 0.36) == 14
    assert edt_kernel.window_2d(0.05, 0.3) == 5
    assert edt_kernel.window_3d(0.05, 0.3) == 6
    assert edt_kernel.window_3d(0.05, 0.36) == 8
    assert edt_kernel.window_3d(0.05, 0.4) == 9
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError):
            edt_kernel.window_2d(0.05, bad)
        with pytest.raises(ValueError):
            edt_kernel.window_3d(0.05, bad)
    with pytest.raises(ValueError):
        edt_kernel.window_2d(1e-6, 1.0)


def test_sqrt35_voxel_is_not_capped():
    """A voxel at offset (5, 3, 1) from its one source, d = sqrt(35) cells,
    reads floor(sqrt(35) * 0.05 / 0.3 * 255) < 255 at max 0.3 m."""
    occ = np.zeros((8, 8, 8), np.uint8)
    occ[0, 0, 0] = 1
    got = edt_kernel.voxel_texture_3d(torch.as_tensor(occ), 0.05, 0.3).numpy()
    assert got[5, 3, 1] == int(np.floor(np.sqrt(35.0) * 0.05 / 0.3 * 255.0)) < 255
    np.testing.assert_array_equal(got, _texture_by_hand(occ.astype(bool), 0.05, 0.3))


def test_input_checks():
    with pytest.raises(ValueError):
        edt_kernel.capped_field_2d(torch.zeros((4, 4), dtype=torch.uint8), 0.05, 1.0)
    with pytest.raises(ValueError):
        edt_kernel.capped_field_2d(torch.zeros((4, 4, 1), dtype=torch.int8), 0.05, 1.0)
    with pytest.raises(ValueError):
        edt_kernel.voxel_texture_3d(torch.zeros((4, 4), dtype=torch.uint8), 0.05, 1.0)
    with pytest.raises(ValueError):
        edt_kernel.voxel_texture_3d(torch.zeros((4, 4, 4), dtype=torch.bool), 0.05, 1.0)
    with pytest.raises(ValueError):
        edt_kernel.capped_field_2d(torch.zeros((4, 4), dtype=torch.int8), 0.05, 0.0)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24), density=st.floats(0.0, 0.3),
       seed=st.integers(0, 2**31 - 1), res=st.sampled_from([0.05, 0.025, 0.1, 0.03]),
       max_dist=st.floats(0.01, 1.5))
def test_field_2d_property(h, w, density, seed, res, max_dist):
    """Any small grid and cap: the JAX package's numpy exact EDT capped by
    hand."""
    occ = np.random.default_rng(seed).random((h, w)) < density
    d = jax_edt.edt_2d(occ)
    want = np.where(d <= int(np.floor(max_dist / res)), d * res, max_dist).astype(np.float32)
    np.testing.assert_array_equal(
        edt_kernel.capped_field_2d(_cells(occ), res, max_dist).numpy(), want)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(shape=st.tuples(st.integers(1, 12), st.integers(1, 12), st.integers(1, 12)),
       density=st.floats(0.0, 0.2), seed=st.integers(0, 2**31 - 1),
       res=st.sampled_from([0.05, 0.1, 0.03]), max_dist=st.floats(0.01, 0.8))
def test_texture_3d_property(shape, density, seed, res, max_dist):
    occ = np.random.default_rng(seed).random(shape) < density
    got = edt_kernel.voxel_texture_3d(torch.as_tensor(occ.astype(np.uint8)), res, max_dist)
    np.testing.assert_array_equal(got.numpy(), _texture_by_hand(occ, res, max_dist))


@pytest.mark.parametrize("fn,dtype", [(edt_kernel.capped_field_2d, torch.int8),
                                      (edt_kernel.voxel_texture_3d, torch.uint8)])
def test_cpu_wrappers_launch_nothing(fn, dtype):
    """On CPU tensors the wrappers run the plain version and count no
    launch."""
    before = fn.launches
    shape = (6, 5) if dtype == torch.int8 else (6, 5, 4)
    fn(torch.ones(shape, dtype=dtype), 0.05, 0.3)
    assert fn.launches == before
