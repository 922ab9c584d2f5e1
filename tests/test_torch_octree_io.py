"""PyTorch port: the OctoMap reader and writers (maps/octree_io.py), held
against the JAX package's on the same voxels and bytes.

Exact throughout: the writers must emit the JAX writers' bytes (the
port lists the tree's nodes by sorting Morton prefixes where the JAX
writers scan the key set per cube), and both readers parse the same
bytes into the same leaves.
"""

import time

import numpy as np
import pytest

from badger_amcl_tpu.maps import octree_io as jio
from badger_amcl_tpu_torch import scenario
from badger_amcl_tpu_torch.maps import octree_io as tio
from badger_amcl_tpu_torch.maps.octomap_3d import OctoMap3D

WRITERS = ["write_bt", "write_ot"]


def _centers(case):
    rng = np.random.default_rng(7)
    if case == "empty":
        return np.zeros((0, 3))
    if case == "one":
        return np.array([[0.05, -0.05, 0.15]])
    if case == "cluster":  # duplicates, negative keys, shared prefixes
        c = rng.uniform(-0.6, 0.6, (150, 3))
        return np.concatenate([c, c[:40]])
    return rng.uniform(-40.0, 40.0, (300, 3))  # "spread": deep, sparse branches


def _same_tree(a, b):
    assert a.resolution == b.resolution
    for f in ("occupied_keys", "occupied_sizes", "free_keys", "free_sizes"):
        np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)), err_msg=f)


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("case", ["empty", "one", "cluster", "spread"])
def test_writers_bytes_equal_jax(tmp_path, writer, case):
    """The port's write_bt / write_ot emit the JAX writers' bytes."""
    c = _centers(case)
    getattr(jio, writer)(tmp_path / "jax.bin", 0.1, c)
    getattr(tio, writer)(tmp_path / "port.bin", 0.1, c)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


@pytest.mark.parametrize("writer,reader", [("write_bt", "read_bt"), ("write_ot", "read_ot")])
def test_round_trip_through_both_readers(tmp_path, writer, reader):
    """A file written by the port reads back, through the port's and the
    JAX reader (by name and through read_octree's header dispatch), as the
    same leaves: the distinct keys floor(c / res), at the voxel centers."""
    c = _centers("cluster")
    path = tmp_path / "m.bin"
    getattr(tio, writer)(path, 0.1, c)
    got = getattr(tio, reader)(str(path))
    _same_tree(got, getattr(jio, reader)(str(path)))
    _same_tree(tio.read_octree(path.read_bytes()), got)
    keys = np.unique(np.floor(c / 0.1).astype(np.int64) + tio.TREE_CENTER, axis=0)
    np.testing.assert_array_equal(np.unique(got.occupied_voxel_keys(), axis=0), keys)
    assert (got.occupied_sizes == 1).all() and len(got.free_keys) == 0
    np.testing.assert_array_equal(got.occupied_centers(),
                                  jio.read_octree(str(path)).occupied_centers())


def test_free_leaves_and_malformed_streams(tmp_path):
    """Free leaves (a .bt child coded 0b10, a .ot leaf at negative log-odds)
    parse as the JAX readers parse them; a truncated stream, a wrong header
    and an unsupported tree id raise ValueError in both."""
    c = _centers("one")
    tio.write_bt(tmp_path / "m.bt", 0.1, c)
    blob = bytearray((tmp_path / "m.bt").read_bytes())
    # the deepest node's two bytes hold only 0b01 (occupied leaf) fields:
    # shifted left by one, each becomes 0b10 (free leaf)
    for j in (-2, -1):
        blob[j] = (blob[j] << 1) & 0xFF
    got = tio.read_bt(bytes(blob))
    _same_tree(got, jio.read_bt(bytes(blob)))
    assert len(got.occupied_keys) == 0 and len(got.free_keys) == 1
    tio.write_ot(tmp_path / "m.ot", 0.1, c)
    blob = bytearray((tmp_path / "m.ot").read_bytes())
    blob[-5:-1] = np.float32(-2.0).tobytes()  # the one leaf turns free
    got = tio.read_ot(bytes(blob))
    _same_tree(got, jio.read_ot(bytes(blob)))
    assert len(got.occupied_keys) == 0 and len(got.free_keys) == 1
    good = (tmp_path / "m.bt").read_bytes()
    bad = [good[:-1], b"# not an octree\n" + good,
           (tmp_path / "m.ot").read_bytes().replace(b"id OcTree", b"id ColorOcTree")]
    for blob in bad:
        for mod in (tio, jio):
            with pytest.raises(ValueError):
                mod.read_octree(blob)


def test_scene_writes_in_seconds_and_builds_the_map(tmp_path):
    """The 3D scene (scenario.scene_3d, 22,512 voxel centers) written as
    .bt and .ot in seconds (the JAX writers scan every key per inner cube),
    read back to its distinct keys, and the map built from the tree
    (`OctoMap3D.from_binary_octree`) has those voxels."""
    occ, _ = scenario.scene_3d()
    t0 = time.perf_counter()
    tio.write_bt(tmp_path / "s.bt", scenario.RESOLUTION_3D, occ)
    tio.write_ot(tmp_path / "s.ot", scenario.RESOLUTION_3D, occ)
    assert time.perf_counter() - t0 < 10.0
    keys = np.unique(np.floor(occ.astype(np.float64) / scenario.RESOLUTION_3D)
                     .astype(np.int64) + tio.TREE_CENTER, axis=0)
    for reader, path in ((tio.read_bt, "s.bt"), (tio.read_ot, "s.ot")):
        tree = reader(str(tmp_path / path))
        np.testing.assert_array_equal(np.unique(tree.occupied_voxel_keys(), axis=0), keys)
    omap = OctoMap3D.from_binary_octree(tree, scenario.MAX_DIST_3D, device="cpu")
    assert omap.resolution == scenario.RESOLUTION_3D and omap.tex_zyx is None
    assert len(omap.occupied_cells) == len(keys)
    np.testing.assert_array_equal(
        omap.occupied_cells,
        np.floor(tree.occupied_centers() / scenario.RESOLUTION_3D + 0.5).astype(np.int32))
