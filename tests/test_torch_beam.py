"""PyTorch port: the beam model — the lattice table (kernel #7's plain
version), the spread-cloud sums (kernel #8's plain version), the beam
dispatch of `planar_likelihood` and the exact raycast arm — held against
the JAX package on the same map, range image, scan and poses
(tests/test_beam_kernel.py's 320^2 map, K = 256, baked by the JAX
package's numpy path and carried over with `convert.map_from_numpy`).

Tolerances:
- lattice table: rtol 1e-5. Both sides run the TPU kernel's arithmetic in
  its order (beams summed in ascending order in f32); exp differs between
  XLA and PyTorch in the last ulp, and that ulp rides through 64 beams;
- spread sums: rtol 1e-5, the f32 order of the Phi segment sums (a one-hot
  matmul in the JAX package, an index_add_ in the port) and of exp;
- the prepasses (window origins, yaw-bin compaction, slabs, occupied
  offsets) are integer results and must be equal;
- the exact arm: rtol 1e-5 — the raycast ranges are bit-equal
  (test_torch_raycast.py) and the mixture's exp differs in the last ulp.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import badger_amcl_tpu.utils.native as jax_native
from badger_amcl_tpu.maps import CellState
from badger_amcl_tpu.maps import OccupancyMap2D as JaxMap
from badger_amcl_tpu.ops import beam_kernel as jbk
from badger_amcl_tpu.ops import beam_spread_kernel as jbsk
from badger_amcl_tpu.sensors import planar as jplanar
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch.ops import beam_kernel as tbk
from badger_amcl_tpu_torch.ops import beam_spread_kernel as tbsk
from badger_amcl_tpu_torch.ops import corr_kernel
from badger_amcl_tpu_torch.sensors import planar as tplanar

torch.set_num_threads(1)
M, B, RANGE_MAX = 2048, 64, 8.0


@pytest.fixture(scope="module")
def beam_maps():
    """tests/test_beam_kernel.py's map with its range image, numpy bake."""
    rng = np.random.default_rng(6)
    n = 320
    cells = np.full((n, n), int(CellState.FREE), np.int8)
    cells[0:2, :] = cells[-2:, :] = int(CellState.OCCUPIED)
    cells[:, 0:2] = cells[:, -2:] = int(CellState.OCCUPIED)
    for _ in range(12):
        cx, cy = rng.integers(20, n - 28, 2)
        cells[cy:cy + 6, cx:cx + 6] = int(CellState.OCCUPIED)
    plain = JaxMap.from_cells(cells, 0.05).with_distance_field(2.0)
    orig = jax_native.range_image
    jax_native.range_image = lambda *a, **k: None
    try:
        jmap = plain.with_range_image(n_angles=256)
    finally:
        jax_native.range_image = orig
    return (jmap, convert.map_from_numpy(jmap, device="cpu"),
            convert.map_from_numpy(plain, device="cpu"))


def _scan(nan_beam=None):
    angles = np.linspace(-2.2, 2.2, B).astype(np.float32)
    ranges = np.clip(2.0 + 0.5 * np.sin(3.0 * angles), 0.2, 7.9).astype(np.float32)
    ranges[3] = RANGE_MAX  # one max-range reading: the z_max term
    if nan_beam is not None:
        ranges[nan_beam] = np.nan
    jscan = jplanar.PlanarScan(ranges=jnp.asarray(ranges), angles=jnp.asarray(angles),
                               range_max=jnp.float32(RANGE_MAX))
    return jscan, convert.scan_from_numpy(jscan, device="cpu")


# (x/y half-widths in m, yaw half-width in rad) -> window variant
CLOUDS = {
    "tight": (0.4, 0.4, 0.1),
    "narrow": (0.4, 0.65, 0.1),
    "standard": (0.4, 1.4, 0.1),
    "spread": (7.0, 7.0, np.pi),
}


def _poses(cloud, m=M, seed=0):
    hx, hy, ha = CLOUDS[cloud]
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-hx, hx, m), rng.uniform(-hy, hy, m),
                     rng.uniform(-ha, ha, m)], axis=1).astype(np.float32)


@pytest.mark.parametrize("cloud", ["tight", "narrow", "standard"])
def test_beam_table_plain_matches_pallas(beam_maps, cloud):
    jmap, tmap, _ = beam_maps
    jscan, tscan = _scan()
    poses = _poses(cloud)
    jpre = jbk.beam_prepass(jmap, jnp.asarray(poses), RANGE_MAX)
    want = np.asarray(jbk.beam_corr_values(jmap, jplanar.PlanarScanParams(), jscan,
                                           jnp.asarray(poses), jpre, interpret=True))
    tpre = tbk.beam_prepass(tmap, torch.from_numpy(poses), RANGE_MAX)
    flags = [bool(tpre[k]) for k in ("fits", "tight", "narrow")]
    assert flags == [bool(jpre[k]) for k in ("fits", "tight", "narrow")]
    assert flags == {"tight": [True, True, True], "narrow": [True, False, True],
                     "standard": [True, False, False]}[cloud]
    for k in ("i0", "j0", "j0_narrow", "j0_tight", "t_min", "t_n", "t_order", "t_slot"):
        np.testing.assert_array_equal(tpre[k].numpy(), np.asarray(jpre[k]), err_msg=k)
    assert tpre["dtheta"] == float(jpre["dtheta"])
    rows, j0 = corr_kernel.window_variant(tpre, flags[1], flags[2])
    assert rows == {"tight": 24, "narrow": 32, "standard": 64}[cloud]
    launches = tbk.beam_table.launches
    got = tbk.beam_corr_values(tmap, tplanar.PlanarScanParams(), tscan, tpre, rows, j0)
    assert tbk.beam_table.launches == launches  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_beam_spread_plain_matches_pallas(beam_maps):
    jmap, tmap, _ = beam_maps
    jscan, tscan = _scan()
    poses = _poses("spread")
    jpre = jbsk.beam_spread_prepass(jmap, jnp.asarray(poses), jscan)
    assert bool(jpre["fits"]) and tbsk.fits(tmap, RANGE_MAX)
    want = np.asarray(jbsk.beam_spread_values(jmap, jplanar.PlanarScanParams(), jscan,
                                              jnp.asarray(poses), jpre, interpret=True))
    tpre = tbsk.beam_spread_prepass(tmap, torch.from_numpy(poses), tscan.angles)
    assert int(tpre["n_g"]) == int(jpre["n_g"])
    np.testing.assert_array_equal(tpre["gocc"].numpy(), np.asarray(jpre["gocc"]))
    perm = np.asarray(jpre["perm"])
    np.testing.assert_array_equal(tpre["sig"].numpy()[perm], np.asarray(jpre["sig_s"])[:M])
    np.testing.assert_array_equal(tpre["flat"].numpy()[perm], np.asarray(jpre["flat_s"])[:M])
    got = tbsk.beam_spread_values(tmap, tplanar.PlanarScanParams(), tscan,
                                  torch.from_numpy(poses))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("k", [256, 60])
def test_beam_spread_rotated_rows_equal_plain(beam_maps, k):
    """The CUDA kernel's formulation: each particle's row capped at `cap`
    into bytes and rotated by its slab, then Phi[g, row[g]] added in
    ascending g in f32, is the plain version bit for bit, also for K not a
    multiple of 8 (60 of the 256 slabs: the kernel's unaligned row path)."""
    _, tmap, _ = beam_maps
    _, tscan = _scan()
    pre = tbsk.beam_spread_prepass(tmap, torch.from_numpy(_poses("spread")), tscan.angles)
    phi = tbsk.phi_tables(tmap, tplanar.PlanarScanParams(), tscan, pre["kap"])
    cap = tbsk.value_cap(tmap, RANGE_MAX)
    rows = tmap.range_rows[:, :k].contiguous()
    sig = pre["sig"] % k
    n_g = torch.tensor(min(int(pre["n_g"]), k // 2), dtype=torch.int32)
    gocc = torch.zeros((k,), dtype=torch.int32)
    gocc[:int(n_g)] = torch.unique(pre["gocc"][:int(pre["n_g"])] % k)[:int(n_g)]
    args = (rows, pre["flat"], sig, gocc, n_g, phi[:k].contiguous(), cap)
    want = tbsk.beam_spread_sums_plain(*args)
    assert torch.equal(tbsk.beam_spread_sums(*args), want)  # CPU: the plain version
    full = rows[pre["flat"]].to(torch.int64)  # (M, K)
    rot = torch.gather(full, 1, (torch.arange(k)[None, :] + sig.long()[:, None]) % k)
    rot = rot.clamp(max=cap).to(torch.uint8)
    acc = torch.zeros((full.shape[0],), dtype=torch.float32)
    for g in gocc[:int(n_g)].tolist():
        acc = acc + phi[g, rot[:, g].long()]
    assert torch.equal(acc, want)


@pytest.mark.parametrize("cloud,arm", [("tight", "table"), ("spread", "spread")])
def test_planar_beam_corr_matches_jax(beam_maps, cloud, arm):
    jmap, tmap, _ = beam_maps
    jscan, tscan = _scan()
    poses = _poses(cloud, seed=1)
    act = jnp.ones((M,), bool)
    pj, mfj = jplanar.planar_likelihood(
        jmap, jplanar.PlanarScanParams(), jscan, jnp.asarray(poses), act, jnp.int32(M),
        "beam", backend="pallas_corr_interpret", fold_factors=True)
    tp = torch.from_numpy(poses)
    assert tplanar.beam_arm(tmap, tscan, tp) == arm
    pt, mft = tplanar.planar_likelihood(
        tmap, tplanar.PlanarScanParams(), tscan, tp, torch.ones(M, dtype=torch.bool),
        torch.tensor(M, dtype=torch.int32), "beam", backend="corr", fold_factors=True)
    assert mft is not None and mfj is not None  # the beam model never folds
    np.testing.assert_array_equal(mft.numpy(), np.asarray(mfj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5)


def test_beam_without_range_image_is_exact_xla(beam_maps):
    jmap, _, tplain = beam_maps
    jplain = JaxMap.from_cells(np.asarray(jmap.cells), 0.05).with_distance_field(2.0)
    jscan, tscan = _scan()
    poses = np.concatenate([_poses("tight", 256, seed=2), _poses("spread", 256, seed=3)])
    act = jnp.ones((512,), bool)
    pj, _ = jplanar.planar_likelihood(jplain, jplanar.PlanarScanParams(), jscan,
                                      jnp.asarray(poses), act, jnp.int32(512), "beam",
                                      backend="xla")
    tp = torch.from_numpy(poses)
    assert tplanar.beam_arm(tplain, tscan, tp) == "exact"
    for backend in ("corr", "exact"):
        pt, _ = tplanar.planar_likelihood(
            tplain, tplanar.PlanarScanParams(), tscan, tp, torch.ones(512, dtype=torch.bool),
            torch.tensor(512, dtype=torch.int32), "beam", backend=backend)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5)


@pytest.mark.parametrize("cloud,arm", [("tight", "table"), ("spread", "spread")])
def test_nan_beam_poisons_every_particle(beam_maps, cloud, arm):
    """calcBeamModel has no NaN-beam skip (beam_spread_kernel.py:229-235):
    one NaN range makes every particle's p NaN in both kernel arms, as in
    the exact arm."""
    _, tmap, tplain = beam_maps
    _, tscan = _scan(nan_beam=7)
    tp = torch.from_numpy(_poses(cloud, 512, seed=4))
    assert tplanar.beam_arm(tmap, tscan, tp) == arm
    for omap in (tmap, tplain):
        p, _ = tplanar.planar_likelihood(omap, tplanar.PlanarScanParams(), tscan, tp,
                                         torch.ones(512, dtype=torch.bool),
                                         torch.tensor(512, dtype=torch.int32), "beam",
                                         backend="corr")
        assert torch.isnan(p).all()


def test_convert_carries_range_image_and_every_scan_param(beam_maps):
    jmap, tmap, _ = beam_maps
    assert tmap.range_image.dtype == torch.uint16 and tmap.range_rows.dtype == torch.uint16
    np.testing.assert_array_equal(tmap.range_image.numpy(), np.asarray(jmap.range_image))
    np.testing.assert_array_equal(tmap.range_rows.numpy(), np.asarray(jmap.range_rows))
    for f in ("resolution", "size_x", "size_y", "origin_x", "origin_y",
              "max_distance_to_object"):
        assert getattr(tmap, f) == getattr(jmap, f), f
    names = [f for f in tplanar.PlanarScanParams.__dataclass_fields__ if f != "scanner_pose"]
    values = {n: 0.01 * (i + 3) for i, n in enumerate(names)}
    jp = jplanar.PlanarScanParams(**values,
                                  scanner_pose=jnp.array([0.1, -0.2, 0.3], jnp.float32))
    tp = convert.scan_params_from_numpy(jp)
    for n in names:
        assert getattr(tp, n) == values[n], n
    assert tp.scanner_pose == tuple(float(v) for v in np.float32([0.1, -0.2, 0.3]))


def test_beam_wrappers_check_inputs(beam_maps):
    _, tmap, _ = beam_maps
    _, tscan = _scan()
    pre = tbk.beam_prepass(tmap, torch.from_numpy(_poses("tight", 64)), RANGE_MAX)
    mix = tbk.BeamMix.of(tplanar.PlanarScanParams(), RANGE_MAX, tmap.resolution)
    org = tbk.window_origin(pre, pre["j0"])
    args = (tscan.ranges, tscan.angles, pre["t_n"], pre["t_min"], pre["t_order"], org, mix,
            pre["dtheta"])
    with pytest.raises(ValueError):
        tbk.beam_table(tmap.range_image.to(torch.int32), *args, 64)
    with pytest.raises(ValueError):
        tbk.beam_table(tmap.range_image, *args, 48)
    with pytest.raises(ValueError):  # t_n must be int32
        tbk.beam_table(tmap.range_image, *args[:2], args[2].to(torch.int64), *args[3:], 64)
    with pytest.raises(ValueError):  # more angle bins than the kernel stages
        tbk.beam_table(torch.zeros((tbk.MAX_ANGLES + 1, 1, 1), dtype=torch.uint16), *args, 64)
    spre = tbsk.beam_spread_prepass(tmap, torch.from_numpy(_poses("spread", 64)),
                                    tscan.angles)
    phi = tbsk.phi_tables(tmap, tplanar.PlanarScanParams(), tscan, spre["kap"])
    sargs = (spre["flat"], spre["sig"], spre["gocc"], spre["n_g"])
    with pytest.raises(ValueError):
        tbsk.beam_spread_sums(tmap.range_rows, *sargs, phi[:, :128], 160)
    with pytest.raises(ValueError):
        tbsk.beam_spread_sums(tmap.range_rows, *sargs, phi, 256)
    assert tbsk.value_cap(tmap, RANGE_MAX) == 160


def _table_from_values(rimg, obs, angles, pre, org, mix, rows):
    """The lattice table as the CUDA kernel forms it: Phi[b, min(v, cap)]
    of the plain value table, summed over beams in ascending order."""
    cap = tbk.table_cap(mix)
    phi = tbk.beam_value_table_plain(obs, mix, cap)
    assert phi.shape == (obs.shape[0], cap + 1)
    kk = tbk.slab_indices(pre["t_min"], pre["t_order"], angles, pre["dtheta"], rimg.shape[0])
    jj = (org[0] + torch.arange(rows)).long()
    ii = (org[1] + torch.arange(corr_kernel.PWIN_C)).long()
    win = torch.from_numpy(rimg.numpy()[:, jj.numpy()[:, None], ii.numpy()[None, :]]
                           .astype(np.int64))
    acc = torch.zeros((corr_kernel.T_MAX, rows, corr_kernel.PWIN_C))
    for b in range(obs.shape[0]):
        acc = acc + phi[b][win[kk[:, b]].clamp(max=cap)]
    live = torch.arange(corr_kernel.T_MAX) < torch.clamp(pre["t_n"], min=1)
    return torch.where(live[:, None, None], acc, 0.0)


@pytest.mark.parametrize("cloud", ["tight", "narrow", "standard"])
def test_value_table_lookups_equal_beam_table_plain(beam_maps, cloud):
    """Summing the per-beam value table at min(v, cap) in beam order is the
    plain table bit for bit, at each window variant."""
    _, tmap, _ = beam_maps
    _, tscan = _scan()
    pre = tbk.beam_prepass(tmap, torch.from_numpy(_poses(cloud)), RANGE_MAX)
    rows, j0 = corr_kernel.window_variant(pre, bool(pre["tight"]), bool(pre["narrow"]))
    mix = tbk.BeamMix.of(tplanar.PlanarScanParams(), RANGE_MAX, tmap.resolution)
    org = tbk.window_origin(pre, j0)
    args = (tscan.ranges, tscan.angles, pre["t_n"], pre["t_min"], pre["t_order"], org, mix,
            pre["dtheta"], rows)
    want = tbk.beam_table_plain(tmap.range_image, *args)
    assert torch.equal(tbk.beam_table(tmap.range_image, *args), want)
    got = _table_from_values(tmap.range_image, tscan.ranges, tscan.angles, pre, org, mix, rows)
    assert torch.equal(got, want)


def test_value_table_cap_edges(beam_maps):
    """cap = the first v at range_max (160 at 8 m / 0.05 m): the window's
    ranges set to cap - 1, cap, cap + 1 and 65535 still give the plain
    table bit for bit; a cap past the uint16 range stops at 65535."""
    _, tmap, _ = beam_maps
    _, tscan = _scan()
    mix = tbk.BeamMix.of(tplanar.PlanarScanParams(), RANGE_MAX, tmap.resolution)
    cap = tbk.table_cap(mix)
    assert cap == 160
    res = np.float32(mix.res)
    assert np.float32(cap) * res >= np.float32(RANGE_MAX) > np.float32(cap - 1) * res
    assert tbk.table_cap(tbk.BeamMix.of(tplanar.PlanarScanParams(), RANGE_MAX, 1e-4)) == 65535
    pre = tbk.beam_prepass(tmap, torch.from_numpy(_poses("tight")), RANGE_MAX)
    org = tbk.window_origin(pre, pre["j0_tight"])
    img = tmap.range_image.numpy().copy()
    j0, i0 = (int(v) for v in org)
    rng = np.random.default_rng(3)
    edge = np.array([cap - 1, cap, cap + 1, 65535], np.uint16)
    img[:, j0:j0 + 24, i0:i0 + 128] = edge[rng.integers(0, 4, (img.shape[0], 24, 128))]
    rimg = torch.from_numpy(img)
    args = (tscan.ranges, tscan.angles, pre["t_n"], pre["t_min"], pre["t_order"], org, mix,
            pre["dtheta"], 24)
    want = tbk.beam_table_plain(rimg, *args)
    got = _table_from_values(rimg, tscan.ranges, tscan.angles, pre, org, mix, 24)
    assert torch.equal(got, want)


def test_launch_constants_match_the_mixture(beam_maps):
    """The struct the table kernel's launch reads holds the mixture's f32
    constants, the bin width and bin_inv in the C struct's order (ten
    floats, 40 bytes), and the value table's cap."""
    mix = tbk.BeamMix.of(tplanar.PlanarScanParams(), RANGE_MAX, 0.05)
    _, tmap, _ = beam_maps
    dth = tbk.dtheta(tmap, RANGE_MAX)
    cap, consts = tbk._launch_consts(mix, dth, 256)
    assert cap == tbk.table_cap(mix) == 160
    assert ctypes.sizeof(consts) == 40
    want = (mix.z_hit, mix.z_short, mix.z_max, mix.z_rand_mult, mix.range_max, mix.denom_inv,
            mix.lam, mix.res, dth, tbk.bin_inv(256))
    got = tuple(getattr(consts, name) for name, _ in consts._fields_)
    assert got == tuple(float(np.float32(v)) for v in want)
    assert tbk._launch_consts(mix, dth, 256)[1] is consts
