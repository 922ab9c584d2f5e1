"""PyTorch port: the spread-cloud term sums, the endpoint distance lookup,
the fused lf term sums and the lf window prepass, held against the JAX
package's Pallas kernels in interpret mode (and its window_origins) on the
same inputs.

Tolerances:
- spread sums: the JAX test's own bounds (tests/test_spread_kernel.py:82-85,
  per-beam int8 quantization plus rare one-cell floor flips), since the JAX
  arm mixes its kernel tiers with an exact-formula escape gather;
- distances: >= 99.9% bit-equal; the rest are one-cell flips from a
  last-ulp cos/sin difference, within res * sqrt(2) (the distance field is
  1-Lipschitz) plus one bf16 spacing below the 2 m cap (2**-7) on the bf16
  arm;
- fused lf term sums: bit-equal to the port's own (B, M) combine; against
  the JAX model's sums over its interpret-mode distances >= 99% of
  particles to rtol 1e-5 (f32 sums in another order) and all within 2.0 (a
  one-cell flip moves one beam's pz^3, pz or log pz by at most ~0.8);
- window prepass and beam skipping's agreement counts: integer results,
  equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badger_amcl_tpu.maps import CellState
from badger_amcl_tpu.maps import OccupancyMap2D as JaxMap
from badger_amcl_tpu.ops import lf_kernel as jlf
from badger_amcl_tpu.ops import spread_kernel as jsk
from badger_amcl_tpu.sensors import planar as jplanar
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch.maps.occupancy_2d import OccupancyMap2D as TorchMap
from badger_amcl_tpu_torch.ops import lf_kernel as tlf
from badger_amcl_tpu_torch.ops import spread_kernel as tsk
from badger_amcl_tpu_torch.sensors import planar as tplanar

torch.set_num_threads(1)


def _map(n, seed, blocks, size, lo, hi):
    rng = np.random.default_rng(seed)
    cells = np.full((n, n), int(CellState.FREE), np.int8)
    cells[0:2, :] = cells[-2:, :] = int(CellState.OCCUPIED)
    cells[:, 0:2] = cells[:, -2:] = int(CellState.OCCUPIED)
    for _ in range(blocks):
        cx, cy = rng.integers(lo, n - hi, 2)
        cells[cy:cy + size, cx:cx + size] = int(CellState.OCCUPIED)
    jmap = JaxMap.from_cells(cells, 0.05).with_distance_field(2.0)
    return jmap, convert.map_from_numpy(jmap, device="cpu")


@pytest.fixture(scope="module")
def huge_map():
    """tests/test_spread_kernel.py's 512^2 map."""
    return _map(512, 11, 24, 6, 16, 24)


@pytest.fixture(scope="module")
def big_map():
    """tests/test_lf_kernel.py's 448^2 map."""
    return _map(448, 4, 10, 6, 20, 28)


def _scan(b, range_max, lo, hi, freq):
    angles = jnp.linspace(-2.2, 2.2, b).astype(jnp.float32)
    ranges = jnp.clip(2.0 + jnp.sin(angles * freq), lo, hi).astype(jnp.float32)
    jscan = jplanar.PlanarScan(ranges=ranges, angles=angles,
                               range_max=jnp.float32(range_max))
    return jscan, convert.scan_from_numpy(jscan, device="cpu")


def _spread_poses(n, seed, half):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-half, half, (n, 2)),
                           rng.uniform(-3.14, 3.14, (n, 1))], axis=1).astype(np.float32)


@pytest.mark.parametrize("term", ["identity", "lf"])
def test_spread_plain_matches_pallas_interpret(huge_map, term):
    jmap, tmap = huge_map
    jscan, tscan = _scan(24, 6.0, 0.3, 2.5, 5.0)
    poses = _spread_poses(4000, 3, 4.0)
    if term == "identity":
        jterm, tterm = (lambda z: z), (lambda z: z)
    else:
        jterm = jplanar._lf_term(jplanar.PlanarScanParams(), jscan)
        tterm = tplanar.model_term("likelihood_field", tplanar.PlanarScanParams(),
                                   tscan.range_max)
    valid = (jscan.ranges < jscan.range_max) & ~jnp.isnan(jscan.ranges)
    pre = jsk.spread_prepass(jmap, jnp.asarray(poses), jscan.ranges, jscan.angles, valid)
    s = jsk.spread_term_sums(jmap, jnp.asarray(poses), jscan.ranges, jscan.angles, valid,
                             pre, jterm, interpret=True)
    want = np.asarray(jsk.unsort(s, pre), np.float64)
    got = tsk.spread_term_sums(tmap, torch.from_numpy(poses), tscan.ranges, tscan.angles,
                               tscan.valid(), tterm).numpy()
    b = 24
    tol = b * 0.009 + 3 * tmap.resolution * 1.5
    np.testing.assert_allclose(got, want, atol=tol)
    assert np.abs(got - want).mean() < b * 0.01
    # same formula and texture on both sides: nearly every particle agrees
    # to the f32 summation order
    assert np.mean(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6) >= 0.99


def test_baked_texture_equals_quantized_tex(huge_map):
    """`with_distance_field` and `convert.map_from_numpy` bake the int8
    texture once: it equals the port's `quantized_tex` and the JAX
    package's (spread_kernel.py:161)."""
    jmap, tmap = huge_map
    own = TorchMap.from_cells(np.array(jmap.cells), 0.05, device="cpu").with_distance_field(2.0)
    want = np.asarray(jsk.quantized_tex(jmap))
    for m in (own, tmap):
        assert m.distances_q.dtype == torch.int8
        np.testing.assert_array_equal(m.distances_q.numpy(), tsk.quantized_tex(m).numpy())
        np.testing.assert_array_equal(m.distances_q.numpy(), want)


@pytest.mark.parametrize("model,form", [("likelihood_field", "cube"),
                                        ("likelihood_field_gompertz", "pz"),
                                        ("likelihood_field_prob", "log")])
def test_term_table_equals_plain_terms(huge_map, model, form):
    """`term_table` holds the plain version's term bit for bit at every int8
    level and off the map: one-beam sums of the plain version over particles
    whose endpoint is a cell of each level, or off the map."""
    _, tmap = huge_map
    term = tplanar.model_term(model, tplanar.PlanarScanParams(), 6.0)
    assert term.form == form
    levels = np.arange(-128, 128, dtype=np.int8)
    rng = np.random.default_rng(9)
    qtex = rng.integers(-128, 128, (tmap.size_y, tmap.size_x), dtype=np.int8)
    cells = rng.choice(tmap.size_x * tmap.size_y, levels.size, replace=False)
    qtex.reshape(-1)[cells] = levels
    qtex = torch.from_numpy(qtex)
    # endpoint = the particle's own cell (zero-length beam); then 3 off the map
    px = np.concatenate([cells % tmap.size_x + 0.5, [-3.5, tmap.size_x + 2.5, 7.5]])
    py = np.concatenate([cells // tmap.size_x + 0.5, [4.5, 9.5, -0.5]])
    n = px.size
    one = torch.ones(n)
    zero = torch.zeros(1)
    s = tsk.spread_term_sums_plain(tmap, qtex, torch.tensor(px, dtype=torch.float32),
                                   torch.tensor(py, dtype=torch.float32), one, 0 * one, zero,
                                   zero, torch.ones(1, dtype=torch.bool), term)
    table = tsk.term_table(term, tmap.max_distance_to_object, torch.device("cpu"))
    assert table.shape == (257,) and table.dtype == torch.float32
    want = torch.cat([table[torch.from_numpy(levels.astype(np.int64) + 128)], table[256:].repeat(3)])
    assert torch.equal(s, want)


def _compare_distances(got, want, res, bf16):
    eq = got == want
    assert eq.mean() >= 0.999, eq.mean()
    tol = res * np.sqrt(2.0) + (2.0 ** -7 if bf16 else 0.0)
    assert np.abs(got - want).max() <= tol


def _steady_poses():
    rng = np.random.default_rng(0)
    return np.concatenate([0.15 * rng.standard_normal((600, 2)),
                           0.04 * rng.standard_normal((600, 1))], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_steady_distances():
    """The JAX lf kernel in interpret mode on the steady cloud (compiled
    once per file)."""
    jmap, _ = _map(448, 4, 10, 6, 20, 28)
    jscan, _ = _scan(64, 6.0, 0.3, 5.9, 5.0)
    return np.asarray(jlf.lf_distances_t(jmap, jnp.asarray(_steady_poses()), jscan.ranges,
                                         jscan.angles, interpret=True))


def test_lf_plain_matches_windowed_kernel(big_map):
    jmap, tmap = big_map
    jscan, tscan = _scan(64, 6.0, 0.3, 5.9, 5.0)
    poses = _steady_poses()
    _, _, jfits = jlf.window_origins(jmap, jnp.asarray(poses), jscan.ranges, jscan.angles)
    _, _, tfits = tlf.window_origins(tmap, torch.from_numpy(poses), tscan.ranges,
                                     tscan.angles)
    assert bool(jfits) and bool(tfits)
    want = _jax_steady_distances()
    got = tlf.lf_distances_t(tmap, torch.from_numpy(poses), tscan.ranges,
                             tscan.angles).numpy()
    _compare_distances(got, want, tmap.resolution, bf16=True)


def test_lf_spread_cloud_takes_exact_gather(big_map):
    jmap, tmap = big_map
    jscan, tscan = _scan(64, 6.0, 0.3, 5.9, 5.0)
    poses = _spread_poses(500, 6, 9.0)
    want = np.asarray(jlf.lf_distances_t(jmap, jnp.asarray(poses), jscan.ranges,
                                         jscan.angles, interpret=True))
    _, _, tfits = tlf.window_origins(tmap, torch.from_numpy(poses), tscan.ranges,
                                     tscan.angles)
    assert not bool(tfits)
    got = tlf.lf_distances_t(tmap, torch.from_numpy(poses), tscan.ranges,
                             tscan.angles).numpy()
    _compare_distances(got, want, tmap.resolution, bf16=False)
    assert (got == tmap.max_distance_to_object).any()  # some endpoints off the map


def test_lf_wrapper_checks_inputs(big_map):
    _, tmap = big_map
    poses = torch.zeros((4, 3))
    r = torch.ones(3)
    with pytest.raises(TypeError):
        tlf.lf_distances(tmap, tmap.distances.to(torch.float64), poses, r, r)
    with pytest.raises(ValueError):
        tlf.lf_distances(tmap, tmap.distances[:-1], poses, r, r)
    with pytest.raises(ValueError):
        tlf.lf_distances(tmap, tmap.distances, poses[:, :2], r, r)


# the JAX side of each term form (sensors/planar.py:_lf_term, the Gompertz
# model's pz with z_rand raw, the prob model's log pz)
def _jax_term(form, range_max):
    sp = jplanar.PlanarScanParams()
    denom = 2.0 * sp.sigma_hit * sp.sigma_hit
    if form == "pz":
        return lambda z: sp.z_hit * jnp.exp(-(z * z) / denom) + sp.z_rand
    zr = sp.z_rand / jnp.float32(range_max)
    if form == "log":
        return lambda z: jnp.log(sp.z_hit * jnp.exp(-(z * z) / denom) + zr)
    jscan, _ = _scan(64, range_max, 0.3, 5.9, 5.0)
    return jplanar._lf_term(sp, jscan)


@pytest.mark.parametrize("model,form", [("likelihood_field", "cube"),
                                        ("likelihood_field_gompertz", "pz"),
                                        ("likelihood_field_prob", "log")])
def test_lf_term_sums_plain_matches_combine_and_pallas(big_map, model, form):
    """The fused sums' plain version is the (B, M) combine the lf arm took,
    bit for bit, on the bf16 texture of the steady cloud; and it matches the
    JAX model's sums over its interpret-mode kernel's distances."""
    _, tmap = big_map
    _, tscan = _scan(64, 6.0, 0.3, 5.9, 5.0)
    valid = tscan.valid().clone()
    valid[5] = False  # one skipped beam
    term = tplanar.model_term(model, tplanar.PlanarScanParams(), tscan.range_max)
    assert term.form == form
    poses = torch.from_numpy(_steady_poses())
    tex = tmap.distances_bf16
    got = tlf.lf_term_sums(tmap, tex, poses, tscan.ranges, tscan.angles, valid, term)
    z = tlf.lf_distances_plain(tmap, tex, poses, tscan.ranges, tscan.angles)
    assert torch.equal(got, torch.where(valid[:, None], term(z), 0.0).sum(dim=0))
    jz = jnp.asarray(_jax_steady_distances())
    jvalid = jnp.asarray(valid.numpy())
    want = np.asarray(jnp.sum(jnp.where(jvalid[:, None], _jax_term(form, 6.0)(jz), 0.0),
                              axis=0), np.float64)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert np.mean(err <= 1e-5 * np.abs(want)) >= 0.99
    assert err.max() <= 2.0


@pytest.mark.parametrize("cloud", ["steady", "spread", "edge", "off_map"])
def test_window_prepass_matches_jax_window_origins(big_map, cloud):
    """The extents' plain version plus the finish give the JAX package's
    window origins and fits, also where a beam (edge) or every beam
    (off_map) has no endpoint on the map."""
    jmap, tmap = big_map
    jscan, tscan = _scan(64, 6.0, 0.3, 5.9, 5.0)
    if cloud == "steady":
        poses = _steady_poses()
    elif cloud == "spread":
        poses = _spread_poses(500, 6, 9.0)
    else:
        poses = _steady_poses()[:200] + np.float32([10.5 if cloud == "edge" else 30.0, 0, 0])
    jr0, jc0, jfits = jlf.window_origins(jmap, jnp.asarray(poses), jscan.ranges, jscan.angles)
    tp = torch.from_numpy(poses)
    ext = tlf.beam_extents(tmap, tp, tscan.ranges, tscan.angles)
    assert ext.shape == (4, 64) and ext.dtype == torch.int32
    assert torch.equal(ext, tlf.beam_extents_plain(tmap, tp, tscan.ranges, tscan.angles))
    no_end = ext[0] == tlf.BIG
    assert bool(no_end.any()) == (cloud in ("edge", "off_map"))
    assert bool(no_end.all()) == (cloud == "off_map")
    assert bool((ext[1][no_end] == -tlf.BIG).all() and (ext[2][no_end] == tlf.BIG).all())
    for r0, c0, fits in (tlf.window_finish(tmap, ext),
                         tlf.window_origins(tmap, tp, tscan.ranges, tscan.angles)):
        np.testing.assert_array_equal(r0.numpy(), np.asarray(jr0))
        np.testing.assert_array_equal(c0.numpy(), np.asarray(jc0))
        assert bool(fits) == bool(jfits)
    assert bool(jfits) == (cloud != "spread")


def test_baked_bf16_texture(big_map):
    """`with_distance_field` and `convert.map_from_numpy` bake the lf
    kernels' bf16 texture: the distance field rounded to bf16."""
    jmap, tmap = big_map
    own = TorchMap.from_cells(np.array(jmap.cells), 0.05, device="cpu").with_distance_field(2.0)
    for m in (own, tmap):
        assert m.distances_bf16.dtype == torch.bfloat16
        assert torch.equal(m.distances_bf16, m.distances.to(torch.bfloat16))


def test_lf_term_sums_and_extents_check_inputs(big_map):
    _, tmap = big_map
    poses = torch.zeros((4, 3))
    r = torch.ones(3)
    valid = torch.ones(3, dtype=torch.bool)
    term = tplanar.model_term("likelihood_field", tplanar.PlanarScanParams(), 8.0)
    with pytest.raises(TypeError):
        tlf.lf_term_sums(tmap, tmap.distances.to(torch.float64), poses, r, r, valid, term)
    with pytest.raises(ValueError):
        tlf.lf_term_sums(tmap, tmap.distances[:, :-1], poses, r, r, valid, term)
    with pytest.raises(ValueError):
        tlf.lf_term_sums(tmap, tmap.distances, poses, r, r, valid.to(torch.int32), term)
    with pytest.raises(ValueError):
        tlf.lf_term_sums(tmap, tmap.distances, poses, r, r, valid[:2], term)
    with pytest.raises(ValueError):
        tlf.lf_term_sums(tmap, tmap.distances, poses[:, :2], r, r, valid, term)
    with pytest.raises(ValueError):
        tlf.beam_extents(tmap, poses.to(torch.float64), r, r)
    with pytest.raises(ValueError):
        tlf.beam_extents(tmap, poses, r, r[:2])


def _count_case():
    """Beam skipping's count inputs on the 448^2 map: the steady cloud, a
    third of it moved to the map's right edge (endpoints off the map), a
    NaN beam and a max-range beam, every third particle inactive."""
    _, tscan = _scan(64, 6.0, 0.3, 5.9, 5.0)
    ranges = tscan.ranges.clone()
    ranges[3] = float("nan")
    ranges[9] = 6.0  # range_max
    scan = tplanar.PlanarScan(ranges=ranges, angles=tscan.angles, range_max=6.0)
    poses = _steady_poses()
    poses[::3] += np.float32([10.5, 0.0, 0.0])
    active = torch.ones(poses.shape[0], dtype=torch.bool)
    active[1::3] = False
    return scan, torch.from_numpy(poses), active


@pytest.mark.parametrize("texture", ["bf16", "f32"])
def test_lf_obs_counts_plain_matches_numpy_count(big_map, texture):
    """Per valid beam, the active particles whose endpoint cell is on the
    map and reads below the skip distance, counted in numpy on the same
    endpoint cells; the CPU wrapper is the plain version (no launch)."""
    _, tmap = big_map
    scan, poses, active = _count_case()
    tex = tmap.distances_bf16 if texture == "bf16" else tmap.distances
    valid = scan.valid()
    assert not bool(valid[3]) and not bool(valid[9])
    skip = 0.5
    launches = tlf.lf_obs_counts.launches
    got = tlf.lf_obs_counts(tmap, tex, poses, scan.ranges, scan.angles, valid, active, skip)
    assert tlf.lf_obs_counts.launches == launches
    assert got.dtype == torch.int32 and got.shape == (64,)
    ci, cj = (c.numpy().astype(np.int64) for c in
              tlf._endpoint_cells(tmap, poses, scan.ranges, scan.angles))
    tex_np = tex.to(torch.float32).numpy()
    want = np.zeros(64, np.int64)
    off_map = 0
    for b in np.flatnonzero(valid.numpy()):
        for m in np.flatnonzero(active.numpy()):
            i, j = ci[b, m], cj[b, m]
            if not (0 <= i < tmap.size_x and 0 <= j < tmap.size_y):
                off_map += 1
            elif tex_np[j, i] < np.float32(skip):
                want[b] += 1
    assert off_map > 0  # the edge particles' endpoints leave the map
    assert want.max() > 0 and (want[valid.numpy()] < int(active.sum())).any()
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3] == 0 and got[9] == 0


def test_lf_obs_counts_checks_inputs(big_map):
    _, tmap = big_map
    poses = torch.zeros((4, 3))
    r = torch.ones(3)
    valid = torch.ones(3, dtype=torch.bool)
    active = torch.ones(4, dtype=torch.bool)
    tex = tmap.distances
    with pytest.raises(TypeError):
        tlf.lf_obs_counts(tmap, tex.to(torch.float64), poses, r, r, valid, active, 0.5)
    with pytest.raises(ValueError):
        tlf.lf_obs_counts(tmap, tex, poses, r, r, valid.to(torch.int32), active, 0.5)
    with pytest.raises(ValueError):
        tlf.lf_obs_counts(tmap, tex, poses, r, r, valid[:2], active, 0.5)
    with pytest.raises(ValueError):
        tlf.lf_obs_counts(tmap, tex, poses, r, r, valid, active.to(torch.uint8), 0.5)
    with pytest.raises(ValueError):
        tlf.lf_obs_counts(tmap, tex, poses, r, r, valid, active[:3], 0.5)
    with pytest.raises(ValueError):  # every input on one device
        tlf.lf_obs_counts(tmap, tex, poses, r, r, valid, active.to("meta"), 0.5)
    with pytest.raises(ValueError):
        tlf.lf_obs_counts(tmap, tex, poses[:, :2], r, r, valid, active, 0.5)
