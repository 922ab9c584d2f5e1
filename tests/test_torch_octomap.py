"""PyTorch port: the 3D voxel EDT, the uint8 bake, the map's conversions and
lookups, and the point-cloud map factors, held against the JAX package on
the same inputs.

Tolerances: everything here is integer or EDT arithmetic done the same way
in numpy on both sides, or one f32 division and floor per coordinate, so
every comparison is bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badger_amcl_tpu.maps import OctoMap3D as JaxOctoMap
from badger_amcl_tpu.maps import edt as jax_edt
from badger_amcl_tpu.sensors import point_cloud as jpc
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch.maps import edt
from badger_amcl_tpu_torch.maps.octomap_3d import OctoMap3D
from badger_amcl_tpu_torch.sensors import point_cloud as tpc

torch.set_num_threads(1)


def _scene_points():
    """tests/test_pc_kernel.py's 20 x 20 x 1 m scene: walls every other
    cell along the border, 30 seeded columns."""
    rng = np.random.default_rng(2)
    pts = []
    n, nz = 400, 20
    for k in range(nz):
        z = (k + 0.5) * 0.05
        for i in range(0, n, 2):
            x = (i + 0.5) * 0.05
            pts += [[x, 0.025, z], [x, 20 - 0.025, z],
                    [0.025, x, z], [20 - 0.025, x, z]]
    for _ in range(30):
        cx, cy = rng.uniform(2, 18, 2)
        for k in range(nz):
            pts.append([cx, cy, (k + 0.5) * 0.05])
    return np.array(pts)


BOUNDS = dict(metric_min=(0, 0, 0), metric_max=(20, 20, 1.0))


@pytest.fixture(scope="module")
def maps():
    pts = _scene_points()
    jmap = JaxOctoMap.from_occupied_points(pts, 0.05, 0.4, **BOUNDS).with_distance_field()
    tmap = OctoMap3D.from_occupied_points(pts, 0.05, 0.4, **BOUNDS,
                                          device="cpu").with_distance_field()
    return jmap, tmap


def test_edt_3d_bit_equal():
    rng = np.random.default_rng(7)
    occ = rng.random((23, 31, 9)) < 0.02
    got = edt.edt_3d(occ)
    np.testing.assert_array_equal(got, jax_edt.edt_3d(occ))
    assert got.shape == occ.shape


def test_bake_bit_equal(maps):
    jmap, tmap = maps
    assert tmap.min_cells == jmap.min_cells and tmap.max_cells == jmap.max_cells
    np.testing.assert_array_equal(tmap.occupied_cells, jmap.occupied_cells)
    assert tmap.size == (401, 401, 21)
    assert tmap.tex_zyx.dtype == torch.uint8 and tmap.tex_zyx.is_contiguous()
    assert tuple(tmap.tex_zyx.shape) == (21, 401, 401)
    np.testing.assert_array_equal(tmap.distances_u8.numpy(), np.asarray(jmap.distances_u8))
    assert tmap.max_distance_ratio == jmap.max_distance_ratio
    assert tmap.distances_lut_created and not OctoMap3D.from_occupied_points(
        np.zeros((1, 3)), 0.05, 0.4, device="cpu").distances_lut_created


def test_set_map_bounds(maps):
    jmap, tmap = maps
    jc = jmap.set_map_bounds((2.0, 3.0), (15.0, 12.5))
    tc = tmap.set_map_bounds((2.0, 3.0), (15.0, 12.5))
    assert tc.min_cells == jc.min_cells and tc.max_cells == jc.max_cells
    assert tc.min_cells[:2] == (32, 52) and tc.max_cells[:2] == (308, 258)
    np.testing.assert_array_equal(tc.distances_u8.numpy(), np.asarray(jc.distances_u8))


def test_world_to_map_and_distance_at(maps):
    jmap, tmap = maps
    rng = np.random.default_rng(4)
    # in bounds, off the footprint and outside the z band
    xyz = rng.uniform([-1.0, -1.0, -0.4], [21.0, 21.0, 1.4], (6000, 3)).astype(np.float32)
    ijk_j = np.asarray(jmap.world_to_map(jnp.asarray(xyz)))
    ijk_t = tmap.world_to_map(torch.from_numpy(xyz))
    np.testing.assert_array_equal(ijk_t.numpy(), ijk_j)
    valid = tmap.is_voxel_valid(ijk_t).numpy()
    np.testing.assert_array_equal(valid, np.asarray(jmap.is_voxel_valid(jnp.asarray(ijk_j))))
    assert 0.3 < valid.mean() < 0.9
    d_t = tmap.distance_at(ijk_t).numpy()
    np.testing.assert_array_equal(d_t, np.asarray(jmap.distance_at(jnp.asarray(ijk_j))))
    assert (d_t[~valid] == np.float32(0.4)).all()
    np.testing.assert_array_equal(tmap.map_to_world(ijk_t).numpy(),
                                  np.asarray(jmap.map_to_world(jnp.asarray(ijk_j))))


def test_free_space_indices_and_lut_cloud(maps):
    jmap, tmap = maps
    np.testing.assert_array_equal(tmap.free_space_indices(), jmap.free_space_indices())
    np.testing.assert_array_equal(tmap.distances_lut_cloud(50_000),
                                  jmap.distances_lut_cloud(50_000))


def test_map_factors(maps):
    jmap, tmap = maps
    rng = np.random.default_rng(8)
    poses = rng.uniform([-2.0, -2.0, -3.0], [22.0, 22.0, 3.0], (3000, 3)).astype(np.float32)
    jparams = jpc.PointCloudParams(off_map_factor=0.3)
    tparams = convert.pc_params_from_numpy(jparams)
    assert tparams == tpc.PointCloudParams(off_map_factor=0.3)
    got = tpc.map_factors(tmap, tparams, torch.from_numpy(poses)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpc.map_factors(jmap, jparams,
                                                                  jnp.asarray(poses))))
    assert (got == np.float32(0.3)).any() and (got == 1.0).any()


def test_converted_octomap_equals_port_bake(maps):
    jmap, tmap = maps
    cmap = convert.octomap_from_numpy(jmap, device="cpu")
    for f in ("resolution", "max_distance_to_object", "min_cells", "max_cells", "size"):
        assert getattr(cmap, f) == getattr(tmap, f), f
    assert cmap.tex_zyx.is_contiguous()
    assert torch.equal(cmap.tex_zyx, tmap.tex_zyx)
