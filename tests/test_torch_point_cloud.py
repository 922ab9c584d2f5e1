"""PyTorch port: the 3D point-cloud path — the voxel distance lookup, the
windowed arm's fused term sums and window prepass, the spread-cloud term
sums, both cloud models on every arm of the dispatch, and one whole 3D
step — held against the JAX package on the same inputs, its Pallas
kernels in interpret mode.

The JAX step draws from `state.key`; its draws are replayed (odom.py:144,
filter.py:502 and :351-353) and passed to the port.

Tolerances:
- distances: >= 99.9% bit-equal; the rest are one-voxel floor flips from a
  last-ulp cos/sin difference between XLA and PyTorch, within res * sqrt(2)
  (the distance field is 1-Lipschitz) plus one quantization step
  (max_distance_ratio);
- window prepass: integer extents, origins and fits flag, equal;
- term sums and likelihoods: >= 99% of particles to rtol 1e-5 (the same
  cells and terms, summed in another order) and all to 5% (a floor flip
  moves one of the cloud's terms);
- the resampled set: equal n_active and cluster count, >= 99.9% equal
  picks within atol 1e-5 (the motion update's trig differs in the last
  ulp), statistics to rtol 1e-4 against the JAX statistics of the same set.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badger_amcl_tpu.maps import OctoMap3D as JaxOctoMap
from badger_amcl_tpu.ops import pc_kernel as jpk
from badger_amcl_tpu.ops import pc_spread_kernel as jps
from badger_amcl_tpu.pf import cluster as jcluster
from badger_amcl_tpu.pf import filter as jfilter
from badger_amcl_tpu.pf.types import PFParams as JaxPFParams
from badger_amcl_tpu.sensors import odom as jodom
from badger_amcl_tpu.sensors import point_cloud as jpc
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch.ops import pc_kernel as tpk
from badger_amcl_tpu_torch.ops import pc_spread_kernel as tps
from badger_amcl_tpu_torch.pf import filter as tfilter
from badger_amcl_tpu_torch.sensors import odom as todom
from badger_amcl_tpu_torch.sensors import point_cloud as tpc
from badger_amcl_tpu_torch.utils.numerics import SYNCS

torch.set_num_threads(1)
MODELS = ("likelihood_field", "likelihood_field_gompertz")
RES, MAXD = 0.05, 0.4


@pytest.fixture(scope="module")
def maps():
    """tests/test_pc_kernel.py's 20 x 20 x 1 m scene, carried over."""
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
    jmap = JaxOctoMap.from_occupied_points(
        np.array(pts), RES, MAXD, metric_min=(0, 0, 0), metric_max=(20, 20, 1.0)
    ).with_distance_field()
    return jmap, convert.octomap_from_numpy(jmap, device="cpu")


def _cloud(b=32, seed=3, z_lo=0.3, z_hi=0.45):
    """A cloud within a few z-slabs: the JAX spread kernel's point-slot
    budget (2B slots, slab runs padded to 8) holds it."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, b)
    r = rng.uniform(0.5, 3.0, b)
    z = rng.uniform(z_lo, z_hi, b)
    return np.stack([r * np.cos(ang), r * np.sin(ang), z], axis=1).astype(np.float32)


def _tight_poses(n=512, seed=5):
    rng = np.random.default_rng(seed)
    noise = np.concatenate([0.12 * rng.standard_normal((n, 2)),
                            0.05 * rng.standard_normal((n, 1))], axis=1)
    return (np.array([10.0, 10.0, 0.7]) + noise).astype(np.float32)


def _spread_poses(n=1024, seed=7, half=1.5):
    rng = np.random.default_rng(seed)
    return np.concatenate([10.0 + rng.uniform(-half, half, (n, 2)),
                           rng.uniform(-3.14, 3.14, (n, 1))], axis=1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_sums_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.abs(got - want) / np.abs(want)
    assert np.mean(rel <= 1e-5) >= 0.99, np.mean(rel <= 1e-5)
    assert rel.max() <= 0.05, rel.max()


def test_pc_distances_plain_matches_windowed_kernel(maps):
    jmap, tmap = maps
    pts, poses = _cloud(), _tight_poses()
    jr0, jc0, jkz, jfits = jpk.window_origins(jmap, jnp.asarray(pts), jnp.asarray(poses))
    tr0, tc0, tkz, tfits = tpk.window_origins(tmap, _t(pts), _t(poses))
    assert bool(jfits) and bool(tfits)
    for a, b in ((tr0, jr0), (tc0, jc0), (tkz, jkz)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(jpk.pc_distances_t(jmap, jnp.asarray(pts), jnp.asarray(poses),
                                         interpret=True))
    launches = tpk.pc_distances.launches
    got = tpk.pc_distances(tmap, _t(pts), _t(poses)).numpy()
    assert tpk.pc_distances.launches == launches  # CPU: the plain version
    assert got.shape == (32, 512)
    assert np.mean(got == want) >= 0.999, np.mean(got == want)
    assert np.abs(got - want).max() <= RES * np.sqrt(2.0) + MAXD / 255


def test_pc_distances_off_map_and_out_of_band(maps):
    """Off the footprint: ratio 255 times the quantization step (the TPU
    kernel's value); outside the z band: max_distance_to_object."""
    _, tmap = maps
    pts = _cloud(8)
    pts[:2, 2] = 5.0  # above the band
    poses = np.array([[0.5, 0.5, 3.0], [10.0, 10.0, 0.0]], np.float32)  # near a corner
    got = tpk.pc_distances(tmap, _t(pts), _t(poses)).numpy()
    assert (got[:2] == np.float32(MAXD)).all()
    off = np.float32(255.0) * np.float32(MAXD / 255.0)
    assert (got[2:, 0] == off).any()
    cloud = tpc.transform_cloud_to_map(_t(pts), _t(poses))
    exact = tmap.distance_at(tmap.world_to_map(cloud)).T.numpy()
    on = got[2:] != off
    np.testing.assert_allclose(got[2:][on], exact[2:][on], atol=RES * np.sqrt(2.0))


def _tracking_poses(n=512, seed=23):
    rng = np.random.default_rng(seed)
    noise = np.concatenate([0.6 * rng.standard_normal((n, 2)),
                            0.1 * rng.standard_normal((n, 1))], axis=1)
    return (np.array([10.0, 10.0, 0.7]) + noise).astype(np.float32)


@pytest.mark.parametrize("cloud", ["tight", "tracking", "spread", "off_map"])
def test_window_prepass_matches_jax_window_origins(maps, cloud):
    """The extents' plain version plus `window_finish` give the JAX
    package's window origins, slabs and fits flag: on a converged cloud
    (fits), a wider tracking cloud and a spread one (neither fits), and
    with every point off the map (no extents: fits)."""
    jmap, tmap = maps
    pts = _cloud()
    poses = {"tight": _tight_poses, "tracking": _tracking_poses,
             "spread": _spread_poses}.get(cloud, _tight_poses)()
    if cloud == "off_map":
        poses = poses + np.float32([40.0, 0.0, 0.0])
    jr0, jc0, jkz, jfits = jpk.window_origins(jmap, jnp.asarray(pts), jnp.asarray(poses))
    tp, tq = _t(poses), _t(pts)
    launches = tpk.pc_extents.launches
    ext = tpk.pc_extents(tmap, tq, tp)
    assert tpk.pc_extents.launches == launches  # CPU: the plain version
    assert ext.shape == (4, 32) and ext.dtype == torch.int32
    assert torch.equal(ext, tpk.pc_extents_plain(tmap, tq, tp))
    no_cell = ext[0] == tpk.BIG
    assert bool(no_cell.all()) == (cloud == "off_map")
    assert bool((ext[1][no_cell] == -tpk.BIG).all() and (ext[2][no_cell] == tpk.BIG).all())
    for r0, c0, kz, fits in (tpk.window_finish(tmap, ext, tpk.point_slabs(tmap, tq)),
                             tpk.window_origins(tmap, tq, tp)):
        for a, b in ((r0, jr0), (c0, jc0), (kz, jkz)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert fits.dim() == 0 and bool(fits) == bool(jfits)
    assert bool(jfits) == (cloud in ("tight", "off_map"))


def test_window_finish_z_band(maps):
    """A point outside the z band fails the window test in both packages,
    whatever its cells."""
    jmap, tmap = maps
    pts, poses = _cloud(), _tight_poses()
    pts[5, 2] = 5.0
    _, _, _, jfits = jpk.window_origins(jmap, jnp.asarray(pts), jnp.asarray(poses))
    _, _, kz, fits = tpk.window_origins(tmap, _t(pts), _t(poses))
    assert not bool(jfits) and not bool(fits) and int(kz[5]) >= tmap.size[2]


@pytest.mark.parametrize("model", MODELS)
def test_pc_term_sums_matches_windowed_kernel(maps, model):
    """The fused sums (CPU tensors: the plain version) against the JAX
    combine over the windowed interpret kernel's (B, M) distances: the
    per-particle sums, and the likelihood through each package's
    finalize."""
    jmap, tmap = maps
    pts, poses = _cloud(), _tight_poses()
    jr0, jc0, jkz, jfits = jpk.window_origins(jmap, jnp.asarray(pts), jnp.asarray(poses))
    assert bool(jfits)
    jz = jpk.windowed_distances(jmap, jnp.asarray(pts), jnp.asarray(poses), jr0, jc0, jkz,
                                interpret=True)
    jterm, _, jcombine = jpc._model_term_finalize(jmap, jpc.PointCloudParams(), model, 32)
    tterm, tfinalize, _ = tpc._model_term_finalize(tmap, tpc.PointCloudParams(), model, 32)
    launches = tpk.pc_term_sums.launches
    got = tpk.pc_term_sums(tmap, _t(pts), _t(poses), tterm)
    assert tpk.pc_term_sums.launches == launches  # CPU: the plain version
    assert got.shape == (512,) and got.dtype == torch.float32
    _assert_sums_close(got, jnp.sum(jterm(jz), axis=0))
    _assert_sums_close(tfinalize(got), jcombine(jz))


@pytest.mark.parametrize("model", MODELS)
def test_pc_term_sums_table_form_equals_plain(maps, model):
    """The kernel's formulation on the CPU: per (point, particle) the
    term table's entry at the voxel's ratio (255 off the map, 256 outside
    the z band), summed in double, is the plain version's sum to within
    f32 rounding, on particles partly off the map and points partly above
    the band."""
    _, tmap = maps
    pts = _cloud()
    pts[:3, 2] = 5.0
    poses = _tight_poses()
    poses[:40, 0] += 9.0  # 19 m: some endpoints off the 20 m map
    tq, tp = _t(pts), _t(poses)
    term, _, _ = tpc._model_term_finalize(tmap, tpc.PointCloudParams(), model, 32)
    ci, cj = tpk._cells(tmap, tq, tp)
    kz = tpk.point_slabs(tmap, tq)[:, None].expand_as(ci)
    ratio = tmap.tex_zyx.reshape(-1)[tmap.flat_index(ci, cj, kz)].long()
    idx = torch.where(tpk._on_map(tmap, ci, cj), ratio, 255)
    idx = torch.where((kz >= 0) & (kz < tmap.size[2]), idx, 256)
    assert bool((idx == 255).any()) and bool((idx == 256).any())
    table = tpk.term_table(term, tmap.max_distance_ratio, tmap.max_distance_to_object,
                           torch.device("cpu"))
    want = tpk.pc_term_sums_plain(tmap, tq, tp, term)
    got = table.double()[idx].sum(dim=0).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    assert torch.equal(tpk.pc_term_sums(tmap, tq, tp, term), want)


def test_windowed_wrappers_check_inputs(maps):
    _, tmap = maps
    pts, poses = _t(_cloud(4)), _t(_tight_poses(8))
    term = tps.PCTerm(1.0, 1.0, 0.0, True)
    for fn in (tpk.pc_extents, tpk.window_origins, tpk.pc_distances):
        with pytest.raises(ValueError):
            fn(tmap, pts, poses[:, :2])
        with pytest.raises(ValueError):
            fn(tmap, pts.double(), poses)
        with pytest.raises(ValueError):
            fn(dataclasses.replace(tmap, tex_zyx=None), pts, poses)
    with pytest.raises(ValueError):
        tpk.pc_term_sums(tmap, pts, poses.double(), term)
    assert tpk.pc_term_sums(tmap, pts[:0], poses, term).shape == (8,)
    assert tpk.pc_extents(tmap, pts[:0], poses).shape == (4, 0)


@pytest.mark.parametrize("model", MODELS)
def test_pc_spread_plain_matches_pallas_interpret(maps, model):
    jmap, tmap = maps
    pts, poses = _cloud(), _spread_poses()
    pre = jps.pc_spread_prepass(jmap, jnp.asarray(poses), jnp.asarray(pts))
    assert bool(pre["fits"])
    jterm, _, _ = jpc._model_term_finalize(jmap, jpc.PointCloudParams(), model, 32)
    tterm, _, _ = tpc._model_term_finalize(tmap, tpc.PointCloudParams(), model, 32)
    s = jps.pc_spread_term_sums(jmap, jnp.asarray(poses), jnp.asarray(pts), pre, jterm,
                                interpret=True)
    want = jps.unsort(s, pre)
    launches = tps.pc_spread_term_sums.launches
    got = tps.pc_spread_term_sums(tmap, _t(poses), _t(pts), tterm)
    assert tps.pc_spread_term_sums.launches == launches
    assert got.shape == (1024,) and got.dtype == torch.float32
    _assert_sums_close(got, want)


def test_pc_spread_z_out_of_band_constant(maps):
    """Points above the voxel band add term(max_distance_to_object) for
    every particle (pc_spread_kernel.py:595-597)."""
    jmap, tmap = maps
    pts, poses = _cloud(), _spread_poses(seed=9)
    pts[:6, 2] = 5.0
    pre = jps.pc_spread_prepass(jmap, jnp.asarray(poses), jnp.asarray(pts))
    assert bool(pre["fits"]) and int(pre["pts"]["n_oob"]) == 6
    term = tps.PCTerm(z_hit=0.95, denom=0.08, zr=0.05, cube=False)
    s = jps.pc_spread_term_sums(jmap, jnp.asarray(poses), jnp.asarray(pts), pre,
                                lambda z: 0.95 * jnp.exp(-(z * z) / 0.08) + 0.05,
                                interpret=True)
    want = np.asarray(jps.unsort(s, pre))
    got = tps.pc_spread_term_sums(tmap, _t(poses), _t(pts), term).numpy()
    _assert_sums_close(got, want)
    # the six out-of-band points contribute the same constant to every sum
    band = tps.pc_spread_term_sums(tmap, _t(poses), _t(pts[6:]), term).numpy()
    const = 6 * float(term(torch.tensor(MAXD)))
    np.testing.assert_allclose(got - band, const, rtol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_term_table_equals_plain_terms(maps, model):
    """`term_table` holds the plain version's term bit for bit at every
    uint8 ratio, off the map (ratio 255) and outside the z band
    (max_distance_to_object): one-point sums of the plain version over
    particles whose endpoint is a voxel of each ratio, or off the map, or
    whose point lies above the band."""
    _, tmap = maps
    term, _, _ = tpc._model_term_finalize(tmap, tpc.PointCloudParams(), model, 1)
    nx, ny, nz = tmap.size
    levels = np.arange(256)
    rng = np.random.default_rng(9)
    tex = rng.integers(0, 256, (nz, ny, nx), dtype=np.uint8)
    cells = rng.choice(nx * ny, levels.size, replace=False)
    tex[0].reshape(-1)[cells] = levels
    omap = dataclasses.replace(tmap, tex_zyx=torch.from_numpy(tex))
    # endpoint = the particle's own voxel (the point at the sensor); then 3
    # particles off the map
    pxc = torch.tensor(np.concatenate([cells % nx + 0.5, [-3.5, nx + 2.5, 7.5]]),
                       dtype=torch.float32)
    pyc = torch.tensor(np.concatenate([cells // nx + 0.5, [4.5, 9.5, -0.5]]),
                       dtype=torch.float32)
    one, zero = torch.ones(pxc.shape[0]), torch.zeros(1)
    in_band, above = torch.zeros(1, dtype=torch.int32), torch.full((1,), nz + 2, dtype=torch.int32)
    s = tps.pc_spread_term_sums_plain(omap, pxc, pyc, one, 0 * one, zero, zero, in_band, term)
    s_above = tps.pc_spread_term_sums_plain(omap, pxc, pyc, one, 0 * one, zero, zero, above,
                                            term)
    table = tps.term_table(term, tmap.max_distance_ratio, tmap.max_distance_to_object,
                           torch.device("cpu"))
    assert table.shape == (257,) and table.dtype == torch.float32
    assert torch.equal(s, torch.cat([table[:256], table[255:256].repeat(3)]))
    assert torch.equal(s_above, table[256:].repeat(pxc.shape[0]))
    assert float(table[256]) == float(term(torch.tensor(MAXD)))


def _arm_jax(jmap, pts, poses):
    _, _, _, fits = jpk.window_origins(jmap, pts, poses)
    if bool(fits):
        return "windowed"
    return "spread" if bool(jps.pc_spread_prepass(jmap, poses, pts)["fits"]) else "exact"


def _arm_port(tmap, pts, poses):
    if tpk.tex_fits(tmap) and bool(tpk.window_origins(tmap, pts, poses)[3]):
        return "windowed"
    return "spread" if tps.tex_fits(tmap) else "exact"


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("case", ["exact", "windowed", "spread", "small_map"])
def test_point_cloud_likelihood_matches(maps, model, case):
    jmap, tmap = maps
    pts = _cloud()
    poses = _spread_poses(seed=11) if case == "spread" else _tight_poses(seed=13)
    if case == "small_map":
        # under both kernels' texture gates: the cascade's exact gather
        jmap = jmap.set_map_bounds((7.0, 7.0), (13.0, 13.0))
        tmap = convert.octomap_from_numpy(jmap, device="cpu")
        assert not tpk.tex_fits(tmap) and not tps.tex_fits(tmap)
    backend_j, backend_t = ("xla", "exact") if case == "exact" else (
        "pallas_interpret", "corr")
    jparams = jpc.PointCloudParams(off_map_factor=0.5)
    tparams = convert.pc_params_from_numpy(jparams)
    if case in ("windowed", "spread"):
        assert _arm_jax(jmap, jnp.asarray(pts), jnp.asarray(poses)) == case
        assert _arm_port(tmap, _t(pts), _t(poses)) == case
    p_j, mf_j = jpc.point_cloud_likelihood(jmap, jparams, jnp.asarray(pts),
                                           jnp.asarray(poses), model, backend_j)
    p_t, mf_t = tpc.point_cloud_likelihood(tmap, tparams, _t(pts), _t(poses), model,
                                           backend_t)
    _assert_sums_close(p_t, p_j)
    np.testing.assert_array_equal(mf_t.numpy(), np.asarray(mf_j))


def test_likelihood_host_syncs(maps):
    """The cascade reads one predicate from the device (the windowed fits
    flag); the spread gate is static and the exact arm reads none."""
    _, tmap = maps
    pts = _t(_cloud())
    for poses, backend, syncs in ((_tight_poses(), "corr", 1), (_spread_poses(), "lf", 1),
                                  (_tight_poses(), "exact", 0)):
        before = SYNCS.count
        tpc.point_cloud_likelihood(tmap, tpc.PointCloudParams(), pts, _t(poses),
                                   backend=backend)
        assert SYNCS.count - before == syncs, backend


def test_likelihood_rejects_bad_inputs(maps):
    _, tmap = maps
    pts, poses = _t(_cloud(4)), _t(_tight_poses(8))
    with pytest.raises(ValueError):
        tpc.point_cloud_likelihood(tmap, tpc.PointCloudParams(), pts, poses, backend="xla")
    with pytest.raises(ValueError):
        tpc.point_cloud_likelihood(tmap, tpc.PointCloudParams(), pts, poses, model="beam")
    with pytest.raises(ValueError):
        tpk.pc_distances(tmap, pts, poses[:, :2])
    with pytest.raises(ValueError):
        tps.pc_spread_term_sums(tmap, poses.double(), pts, tps.PCTerm(1.0, 1.0, 0.0, True))


# --- one whole 3D step --------------------------------------------------------

ALPHAS = (0.1, 0.1, 0.1, 0.1, 0.1)
ODOM_POSE = np.array([0.1, 0.0, 0.02], np.float32)
ODOM_DELTA = np.array([0.1, 0.0, 0.02], np.float32)


@functools.partial(jax.jit, static_argnames=("params", "model"))
def _jax_step(state, omap, pc_params, cloud, pool, params, model):
    """node_3d's composition: motion update, cloud likelihood, sensor
    update, KLD resample."""
    state = jodom.motion_update(state, jodom.OdomModel.DIFF, ALPHAS,
                                jnp.asarray(ODOM_POSE), jnp.asarray(ODOM_DELTA))
    p, mf = jpc.point_cloud_likelihood(omap, pc_params, cloud, state.poses, model,
                                       "pallas_interpret")
    state = jfilter.sensor_update(state, p, mf)
    return p, jfilter.resample(state, params, pool)


def _replayed_step_draws(key, m):
    key, sub = jax.random.split(key)
    normals = torch.tensor(np.stack([np.asarray(jax.random.normal(k, (m,)))
                                     for k in jax.random.split(sub, 3)]))
    _, sub = jax.random.split(key)
    k1, k2 = jax.random.split(sub)
    return (normals, torch.tensor(np.asarray(jax.random.uniform(k1, (m,)))),
            torch.tensor(np.asarray(jax.random.uniform(k2, (m,)))))


@pytest.mark.parametrize("regime,model", [("tight", "likelihood_field"),
                                          ("spread", "likelihood_field_gompertz")])
def test_3d_step_matches(maps, regime, model):
    jmap, tmap = maps
    m = 1024
    poses = _tight_poses(m, seed=17) if regime == "tight" else _spread_poses(m, seed=19)
    jparams = JaxPFParams(min_samples=m // 4, max_samples=m)
    jstate = jfilter.init_with_poses(jparams, jax.random.PRNGKey(3), jnp.asarray(poses))
    pool = np.random.default_rng(5).uniform([1.0, 1.0, -3.1], [19.0, 19.0, 3.1],
                                            (m, 3)).astype(np.float32)
    pts = _cloud()
    jpcp = jpc.PointCloudParams()
    p_j, j = _jax_step(jstate, jmap, jpcp, jnp.asarray(pts), jnp.asarray(pool),
                       params=jparams, model=model)

    tparams = convert.pf_params_from_jax(jparams)
    tstate = convert.state_from_numpy(jstate, device="cpu")
    normals, u_inject, u_pick = _replayed_step_draws(jstate.key, m)
    tstate = todom.motion_update(tstate, todom.OdomModel.DIFF, ALPHAS, ODOM_POSE,
                                 ODOM_DELTA, normals)
    assert _arm_port(tmap, _t(pts), tstate.poses) == (
        "windowed" if regime == "tight" else "spread")
    p_t, mf_t = tpc.point_cloud_likelihood(tmap, convert.pc_params_from_numpy(jpcp),
                                           _t(pts), tstate.poses, model, "corr")
    _assert_sums_close(p_t, p_j)
    tstate = tfilter.sensor_update(tstate, p_t, mf_t)
    t = tfilter.resample(tstate, tparams, _t(pool), u_inject, u_pick)

    n = int(j.n_active)
    assert int(t.n_active) == n
    same = (np.abs(t.poses.numpy() - np.asarray(j.poses)) <= 1e-5).all(axis=1)
    assert same.mean() >= 0.999, same.mean()
    assert int(t.stats.cluster_count) == int(j.stats.cluster_count)
    js = jcluster.compute_cluster_stats(
        jnp.asarray(t.poses.numpy()), jnp.asarray(t.weights.numpy()),
        jnp.arange(m) < n, jparams)
    np.testing.assert_allclose(t.stats.mean.numpy(), np.asarray(js.mean), rtol=1e-4,
                               atol=1e-5)
    assert bool(t.converged) == bool(j.converged)
