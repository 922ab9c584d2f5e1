"""PyTorch port: the cell-space resampling contract (`corr_kernel.corr_cells`,
`planar.planar_likelihood_cells`, `pf.filter.sensor_resample_cells`,
`mcl.sensor_resample_step(resample_contract="cell")`) held against the JAX
package on the same inputs, its corr kernel in interpret mode
(`pallas_corr_interpret`), and its distribution claims checked on the
port's own draws.

The JAX cell arm draws from split(split(state.key)[1]) (filter.py:830-833),
as the pick path does; the tests replay those draws.

Tolerances:
- the cell table: max |diff| <= 1e-6 x the table's max (the plain
  correlation table sums a bin's taps in another order than the TPU
  kernel's sequential loop); keys and ok equal;
- the resample: >= 99.9% of picks on the same particle (XLA's cumsum over
  the cell masses associates differently from torch.cumsum, which can move
  a draw to the neighbouring cell), n_active equal, w_slow and w_fast
  within 1e-6, the statistics within 1e-5 (rtol and atol);
- the distribution: chi-square p > 1e-3, moments within the Monte Carlo
  tolerance of tests/test_resample_cells.py, KLD stop means within 5
  pooled standard errors;
- every precondition violation: the pick step, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as scipy_stats

from badger_amcl_tpu import mcl as jmcl
from badger_amcl_tpu.maps import CellState
from badger_amcl_tpu.maps import OccupancyMap2D as JaxMap
from badger_amcl_tpu.ops import corr_kernel as jck
from badger_amcl_tpu.pf import filter as jfilter
from badger_amcl_tpu.pf.types import PFParams as JaxPFParams
from badger_amcl_tpu.sensors import planar as jplanar
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch import mcl as tmcl
from badger_amcl_tpu_torch.ops import corr_kernel as tck
from badger_amcl_tpu_torch.pf import filter as tfilter
from badger_amcl_tpu_torch.pf.types import PFParams
from badger_amcl_tpu_torch.sensors import planar as tplanar

torch.set_num_threads(1)
M, B = 2048, 64
RANGE_MAX = 6.0
BACKEND_J = "pallas_corr_interpret"
MODELS = tplanar.CELL_MODELS


@pytest.fixture(scope="module")
def world():
    """The 448^2 map of tests/test_torch_corr.py with non-trivial map
    factors (the fold matters), the likelihood field baked on both sides,
    and a 64-beam scan."""
    rng = np.random.default_rng(23)
    n = 448
    cells = np.full((n, n), int(CellState.FREE), np.int8)
    cells[0:2, :] = cells[-2:, :] = int(CellState.OCCUPIED)
    cells[:, 0:2] = cells[:, -2:] = int(CellState.OCCUPIED)
    for _ in range(12):
        cx, cy = rng.integers(20, n - 28, 2)
        cells[cy:cy + 6, cx:cx + 6] = int(CellState.OCCUPIED)
    jparams = jplanar.PlanarScanParams(
        non_free_space_factor=jnp.float32(0.6),
        non_free_space_radius=jnp.float32(0.5), off_map_factor=jnp.float32(0.3))
    jmap = JaxMap.from_cells(cells, 0.05).with_distance_field(2.0)
    jmap = jplanar.bake_factor_texture(
        jplanar.bake_corr_texture(jmap, jparams, RANGE_MAX, "likelihood_field"), jparams)
    angles = jnp.linspace(-2.2, 2.2, B).astype(jnp.float32)
    ranges = jnp.clip(2.0 + jnp.sin(angles * 5.0), 0.3, RANGE_MAX - 0.1)
    jscan = jplanar.PlanarScan(ranges=ranges, angles=angles, range_max=jnp.float32(RANGE_MAX))
    return (jmap, jparams, jscan, convert.map_from_numpy(jmap, device="cpu"),
            convert.scan_params_from_numpy(jparams), convert.scan_from_numpy(jscan, "cpu"))


def _cloud(name):
    """(M, 3) poses: a tracking cloud, one straddling the map's right edge
    (inside the lattice envelope, some particles off the map) and a spread
    cloud (outside the envelope)."""
    center, sig, ysig, seed = {"tracking": ((0.3, -0.2), 0.03, 0.01, 1),
                               "off_map": ((11.18, 0.0), 0.03, 0.01, 2),
                               "spread": ((0.0, 0.0), 2.0, 1.0, 3)}[name]
    rng = np.random.default_rng(seed)
    p = np.concatenate([np.asarray(center) + sig * rng.standard_normal((M, 2)),
                        ysig * rng.standard_normal((M, 1))], axis=1)
    return p.astype(np.float32)


_jax_cells = jax.jit(jplanar.planar_likelihood_cells, static_argnames=("model", "backend"))


@pytest.mark.parametrize("model", MODELS)
def test_corr_cells_matches_pallas_interpret(world, model):
    """planar_likelihood_cells (corr_cells over the plain corr_table) against
    JAX's through pallas_corr_interpret: the table, the keys and ok on a
    tracking cloud; ok False on a cloud with off-map particles and on one
    outside the envelope, whose table is built all the same, as JAX builds
    it before ok is known. The table read at the keys is the pick path's
    folded p, bit for bit."""
    jmap, jparams, jscan, tmap, tparams, tscan = world
    for name in ("tracking", "off_map", "spread"):
        poses = _cloud(name)
        tbl_j, key_j, ok_j = _jax_cells(jmap, jparams, jscan, jnp.asarray(poses), model,
                                        BACKEND_J)
        before = tck.corr_table.launches
        tbl_t, key_t, ok_t = tplanar.planar_likelihood_cells(tmap, tparams, tscan,
                                                             torch.from_numpy(poses), model)
        assert tck.corr_table.launches == before  # CPU tensors: the plain version
        assert ok_t is bool(ok_j), name
        assert tbl_t.shape == (tck.T_FLAT_CELLS,) and tbl_t.dtype == torch.float32
        assert key_t.shape == (M,) and int(key_t.max()) < tck.T_FLAT_CELLS
        if not ok_t:
            continue
        want = np.asarray(tbl_j)
        assert np.abs(tbl_t.numpy() - want).max() <= 1e-6 * np.abs(want).max(), name
        np.testing.assert_array_equal(key_t.numpy(), np.asarray(key_j))
        pt = torch.from_numpy(poses)
        p, mf = tplanar.planar_likelihood(tmap, tparams, tscan, pt,
                                          torch.ones(M, dtype=torch.bool), torch.tensor(M),
                                          model, backend="corr", fold_factors=True)
        assert mf is None
        assert torch.equal(tbl_t[key_t], p)
    # the off-map cloud fits the lattice: ok is False for its particles alone
    spose = tplanar.coord_add(tparams.scanner_pose, torch.from_numpy(_cloud("off_map")))
    pre = tck.corr_prepass(tmap, spose, tscan.ranges, tscan.angles, tscan.valid())
    assert bool(pre["fits"])


def _replayed(key, m):
    """The JAX cell arm's draws: key, sub = split(key); k1, k2 = split(sub)."""
    _, sub = jax.random.split(key)
    k1, k2 = jax.random.split(sub)
    return (torch.from_numpy(np.array(jax.random.uniform(k1, (m,)))),
            torch.from_numpy(np.array(jax.random.uniform(k2, (m,)))))


def _cell_world(m, seed, n_active=None, zero=False):
    """A synthetic cell structure (as tests/test_resample_cells.py builds
    them): a Gaussian cloud of distinct poses, its cells a 0.25 m / 0.35
    rad lattice, a random p per cell (all 0 with `zero`); the first
    n_active particles active with equal weights. Returns the JAX and
    port (state, params, pool, tbl, key_m)."""
    rng = np.random.default_rng(seed)
    poses = (rng.standard_normal((m, 3)) * [0.8, 0.8, 0.3]).astype(np.float32)
    cell = (np.floor(poses[:, 0] / 0.25).astype(np.int64) * 100_003
            + np.floor(poses[:, 1] / 0.25).astype(np.int64) * 101
            + np.floor(poses[:, 2] / 0.35).astype(np.int64))
    _, key_m = np.unique(cell, return_inverse=True)
    tbl = np.zeros((tck.T_FLAT_CELLS,), np.float32)
    if not zero:
        tbl[:key_m.max() + 1] = rng.uniform(0.2, 3.0, key_m.max() + 1)
    jparams = JaxPFParams(min_samples=32, max_samples=m, pop_err=0.05)
    js = jfilter.init_with_poses(jparams, jax.random.PRNGKey(seed), jnp.asarray(poses))
    if n_active is not None:
        w = np.where(np.arange(m) < n_active, np.float32(1.0) / np.float32(n_active), 0.0)
        js = js.replace(n_active=jnp.int32(n_active), weights=jnp.asarray(w, jnp.float32))
    pool = rng.uniform(-4.0, 4.0, (m, 3)).astype(np.float32)
    key_m = key_m.astype(np.int32)
    return ((js, jparams, jnp.asarray(pool), jnp.asarray(tbl), jnp.asarray(key_m)),
            (convert.state_from_numpy(js, device="cpu"), convert.pf_params_from_jax(jparams),
             torch.from_numpy(pool), torch.from_numpy(tbl), torch.from_numpy(key_m).long()))


@functools.partial(jax.jit, static_argnames=("params",))
def _jax_resample_cells(state, params, pool, tbl, key_m):
    return jfilter.sensor_resample_cells(
        state, params, pool, tbl, key_m, jnp.array(True),
        lambda: jax.tree.map(jnp.zeros_like, state))


def _assert_close_resample(got, want, label):
    same = (got.poses.numpy() == np.asarray(want.poses)).all(axis=1)
    assert same.mean() >= 0.999, (label, same.mean())
    assert int(got.n_active) == int(want.n_active), label
    for f in ("w_slow", "w_fast"):
        np.testing.assert_allclose(float(getattr(got, f)), float(getattr(want, f)), rtol=0,
                                   atol=1e-6, err_msg=f"{label} {f}")
    assert int(got.stats.cluster_count) == int(want.stats.cluster_count), label
    for f in ("mean", "cov", "cluster_weights", "cluster_means"):
        np.testing.assert_allclose(getattr(got.stats, f).numpy(),
                                   np.asarray(getattr(want.stats, f)), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{label} {f}")
    assert bool(got.converged) == bool(want.converged), label


@pytest.mark.parametrize("m,n_active,w,zero", [
    (M, None, None, False),        # every particle active
    (M, 1500, None, False),        # a partial active set: the last cell ends at n_active
    (1000, None, (0.4, 0.12), False),  # u = 1024 > M (padded cells); pool injection
    (1000, 700, None, True),       # every p 0: the uniform reset
])
def test_sensor_resample_cells_matches_jax(m, n_active, w, zero):
    """sensor_resample_cells against JAX's on synthetic cells, the draws
    replayed; with w, w_slow/w_fast set (tiny alphas) so w_diff ~ 0.7."""
    (js, jparams, jpool, jtbl, jkey), (ts, tparams, tpool, ttbl, tkey) = _cell_world(
        m, 11, n_active, zero)
    if w is not None:
        upd = dict(w_slow=jnp.float32(w[0]), w_fast=jnp.float32(w[1]),
                   alpha_slow=jnp.float32(1e-9), alpha_fast=jnp.float32(1e-9))
        js = js.replace(**upd)
        ts = ts.replace(**{k: torch.tensor(float(v)) for k, v in upd.items()})
    want = _jax_resample_cells(js, jparams, jpool, jtbl, jkey)
    u_inject, u_pick = _replayed(js.key, m)
    arms = dict(tfilter.CELL_ARMS)
    got = tfilter.sensor_resample_cells(ts, tparams, tpool, ttbl, tkey, True,
                                        lambda: pytest.fail("classic arm taken"),
                                        u_inject, u_pick)
    assert tfilter.CELL_ARMS["cell"] == arms.get("cell", 0) + 1
    _assert_close_resample(got, want, f"m={m} n_active={n_active} w={w} zero={zero}")
    if w is not None:
        injected = (got.poses.numpy()[:, None, :] == tpool.numpy()[None]).all(-1).any(-1)
        assert 0.6 < injected.mean() < 0.8
        assert float(got.w_slow) == 0.0 and float(got.w_fast) == 0.0
    if zero:
        assert float(got.w_slow) == float(ts.w_slow)


def _pick_step(state, params, pool, tbl, key_m, u_inject, u_pick):
    """The pick contract's step on a cell table: sensor_update with each
    particle's cell value, then the multinomial resample."""
    s2 = tfilter.sensor_update(state, tbl[key_m], None)
    return tfilter.resample(s2, params, pool, u_inject, u_pick)


def _port_cells(state, params, pool, tbl, key_m, gen):
    u_inject = torch.rand(params.max_samples, generator=gen)
    u_pick = torch.rand(params.max_samples, generator=gen)
    cells = tfilter.sensor_resample_cells(
        state, params, pool, tbl, key_m, True, lambda: pytest.fail("classic arm taken"),
        u_inject, u_pick)
    return cells, _pick_step(state, params, pool, tbl, key_m, u_inject, u_pick)


def test_pick_counts_chi_square():
    """Per-particle pick counts of the cell contract over many draws follow
    the multinomial weights w_i = p_c / sum (chi-square p > 1e-3), as the
    pick contract's do (the control); the two contracts' counts are
    homogeneous (tests/test_resample_cells.py:50-98)."""
    m, n_cells, runs = 512, 37, 60
    params = PFParams(min_samples=16, max_samples=m)
    poses = torch.zeros((m, 3))
    poses[:, 0] = torch.arange(m, dtype=torch.float32)  # x encodes the particle
    state = tfilter.init_with_poses(params, poses)
    rng = np.random.default_rng(0)
    key_m = torch.from_numpy(rng.integers(0, n_cells, m)).long()
    tbl = torch.zeros(tck.T_FLAT_CELLS)
    tbl[:n_cells] = torch.from_numpy(rng.uniform(0.2, 3.0, n_cells).astype(np.float32))
    p_i = tbl[key_m].double().numpy()
    w = p_i / p_i.sum()
    gen = torch.Generator().manual_seed(0)
    counts = {"cell": np.zeros(m), "pick": np.zeros(m)}
    for _ in range(runs):
        for name, out in zip(("cell", "pick"), _port_cells(state, params, torch.zeros(m, 3),
                                                           tbl, key_m, gen)):
            np.add.at(counts[name], out.poses[:, 0].long().clamp(0, m - 1).numpy(), 1)
    for name, c in counts.items():
        _, p = scipy_stats.chisquare(c, runs * m * w)
        assert p > 1e-3, (name, p)
    table = np.stack([counts["cell"], counts["pick"]])
    _, p, _, _ = scipy_stats.chi2_contingency(table[:, table.sum(0) > 0])
    assert p > 1e-3, p


def test_posterior_moments():
    """The resampled set's mean and variance reproduce the weighted input
    moments within Monte Carlo tolerance (tests/test_resample_cells.py
    :150-179)."""
    m = 4096
    rng = np.random.default_rng(11)
    poses = np.stack([rng.normal(2.0, 0.5, m), rng.normal(-1.0, 0.3, m),
                      rng.normal(0.2, 0.1, m)], axis=1).astype(np.float32)
    params = PFParams(min_samples=16, max_samples=m)
    state = tfilter.init_with_poses(params, torch.from_numpy(poses))
    kx = np.floor(poses[:, 0] / 0.2).astype(np.int64)
    ky = np.floor(poses[:, 1] / 0.2).astype(np.int64)
    _, key_m = np.unique(kx * 7919 + ky, return_inverse=True)
    p_c = rng.uniform(0.5, 2.0, key_m.max() + 1).astype(np.float32)
    tbl = torch.zeros(tck.T_FLAT_CELLS)
    tbl[:p_c.size] = torch.from_numpy(p_c)
    w = p_c[key_m] / p_c[key_m].sum()
    out, _ = _port_cells(state, params, torch.zeros(m, 3), tbl,
                         torch.from_numpy(key_m).long(), torch.Generator().manual_seed(3))
    new = out.poses.numpy()[:int(out.n_active)]
    ref_mean = (w[:, None] * poses).sum(0)
    np.testing.assert_allclose(new.mean(0)[:2], ref_mean[:2], atol=0.05)
    ref_var = (w[:, None] * (poses - ref_mean) ** 2).sum(0)
    np.testing.assert_allclose(new.var(0)[:2], ref_var[:2], rtol=0.25, atol=5e-3)


def test_kld_stop_count_distribution():
    """The mid-stream KLD stop consumes the draws' bin sequence: with draws
    distributed alike, the cell and pick contracts' stop counts have equal
    means within 5 pooled standard errors (tests/test_resample_cells.py
    :101-147)."""
    m, runs = 2048, 40
    rng = np.random.default_rng(5)
    poses = np.stack([rng.uniform(-1.5, 1.5, m), rng.uniform(-1.5, 1.5, m),
                      rng.uniform(-0.5, 0.5, m)], axis=1).astype(np.float32)
    params = PFParams(min_samples=32, max_samples=m, pop_err=0.2, pop_z=3.0)
    state = tfilter.init_with_poses(params, torch.from_numpy(poses))
    cell = (np.floor(poses[:, 0] / 0.25).astype(np.int64) * 10_000_019
            + np.floor(poses[:, 1] / 0.25).astype(np.int64) * 101
            + np.floor(poses[:, 2] / 0.35).astype(np.int64))
    _, key_m = np.unique(cell, return_inverse=True)
    tbl = torch.zeros(tck.T_FLAT_CELLS)
    tbl[:key_m.max() + 1] = torch.from_numpy(
        rng.uniform(0.5, 2.0, key_m.max() + 1).astype(np.float32))
    gen = torch.Generator().manual_seed(7)
    nc, np_ = [], []
    for _ in range(runs):
        cells, pick = _port_cells(state, params, torch.zeros(m, 3), tbl,
                                  torch.from_numpy(key_m).long(), gen)
        nc.append(int(cells.n_active))
        np_.append(int(pick.n_active))
    nc, np_ = np.array(nc), np.array(np_)
    assert nc.min() > params.min_samples and nc.max() < m, nc
    se = np.sqrt(nc.var() / runs + np_.var() / runs)
    assert abs(nc.mean() - np_.mean()) < 5 * max(se, 1.0), (nc.mean(), np_.mean(), se)


@pytest.mark.parametrize("violation", ["cells_not_ok", "too_many_cells", "non_uniform",
                                       "no_active"])
def test_precondition_violation_takes_pick_step(violation):
    """Each precondition violation takes classic_fn, here the pick step, and
    equals it bit for bit: ok False; more than CELL_U_MAX cells (M = 8200
    particles, every key distinct); unequal active weights; n_active 0."""
    m = 8200 if violation == "too_many_cells" else 1024
    params = PFParams(min_samples=16, max_samples=m)
    rng = np.random.default_rng(4)
    state = tfilter.init_with_poses(params, torch.from_numpy(
        (rng.standard_normal((m, 3)) * [0.5, 0.5, 0.2]).astype(np.float32)))
    key_m = (torch.arange(m) if violation == "too_many_cells"
             else torch.from_numpy(rng.integers(0, 29, m))).long()
    tbl = torch.zeros(tck.T_FLAT_CELLS)
    tbl[:m] = torch.from_numpy(rng.uniform(0.2, 3.0, m).astype(np.float32))
    if violation == "non_uniform":
        w = torch.full((m,), 1.0 / m)
        w[0] *= 1.5
        state = state.replace(weights=w / w.sum())
    if violation == "no_active":
        state = state.replace(n_active=torch.tensor(0, dtype=torch.int32),
                              weights=torch.zeros(m))
    pool = torch.from_numpy(rng.uniform(-2, 2, (m, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(9)
    u_inject, u_pick = torch.rand(m, generator=gen), torch.rand(m, generator=gen)

    def classic():
        return _pick_step(state, params, pool, tbl, key_m, u_inject, u_pick)

    arms = dict(tfilter.CELL_ARMS)
    got = tfilter.sensor_resample_cells(state, params, pool, tbl, key_m,
                                        violation != "cells_not_ok", classic, u_inject, u_pick)
    assert tfilter.CELL_ARMS["classic"] == arms.get("classic", 0) + 1
    assert tfilter.CELL_ARMS["cell"] == arms.get("cell", 0)
    want = classic()
    for f in ("poses", "weights", "n_active", "w_slow", "w_fast", "converged"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.stats.mean, want.stats.mean)


def _step_world(world, cloud):
    """(JAX (state, params, pool), port (state, params, pool)) at M x B on
    the world's map: `cloud` poses, uniform weights."""
    jparams = JaxPFParams(min_samples=256, max_samples=M)
    js = jfilter.init_with_poses(jparams, jax.random.PRNGKey(5), jnp.asarray(_cloud(cloud)))
    pool = np.random.default_rng(6).uniform(-3.0, 3.0, (M, 3)).astype(np.float32)
    return ((js, jparams, jnp.asarray(pool)),
            (convert.state_from_numpy(js, device="cpu"), convert.pf_params_from_jax(jparams),
             torch.from_numpy(pool)))


@pytest.mark.parametrize("model", ["likelihood_field", "likelihood_field_gompertz"])
def test_sensor_resample_step_cell_matches_jax(world, model):
    """mcl.sensor_resample_step(resample_contract="cell") on "corr" against
    JAX's on pallas_corr_interpret, the cell arm taken on both sides, the
    draws replayed."""
    jmap, jparams, jscan, tmap, tparams, tscan = world
    (js, jpf, jpool), (ts, tpf, tpool) = _step_world(world, "tracking")
    want = jmcl.sensor_resample_step_jit(js, jmap, jparams, jscan, jpool, jpf,
                                         laser_model=model, backend=BACKEND_J,
                                         resample_contract="cell")
    u_inject, u_pick = _replayed(js.key, M)
    arms = dict(tfilter.CELL_ARMS)
    got = tmcl.sensor_resample_step(ts, tmap, tparams, tscan, tpool, tpf, laser_model=model,
                                    backend="corr", resample_contract="cell",
                                    noise=tmcl.StepNoise(None, u_inject, u_pick))
    assert tfilter.CELL_ARMS["cell"] == arms.get("cell", 0) + 1
    _assert_close_resample(got, want, model)


def test_sensor_resample_step_cell_classic_arm(world):
    """A spread cloud leaves the envelope: the cell contract's step is the
    pick contract's on the same variates, bit for bit."""
    _, _, _, tmap, tparams, tscan = world
    _, (ts, tpf, tpool) = _step_world(world, "spread")
    noise = tmcl.StepNoise.draw(torch.Generator().manual_seed(2), M, "cpu", odom=False)
    got, want = (tmcl.sensor_resample_step(ts, tmap, tparams, tscan, tpool, tpf,
                                           backend="corr", resample_contract=c, noise=noise)
                 for c in ("cell", "pick"))
    for f in ("poses", "weights", "n_active", "w_slow", "w_fast"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("kw", [
    dict(resample_model=tfilter.ResampleModel.SYSTEMATIC),
    dict(laser_model="beam"),
    dict(backend="corr_q"),
    dict(backend="exact"),
    dict(resample_contract="grid"),
])
def test_cell_contract_raises(world, kw):
    """The cell contract needs multinomial resampling, a model of
    CELL_MODELS and the corr backend; an unknown contract raises too."""
    _, _, _, tmap, tparams, tscan = world
    _, (ts, tpf, tpool) = _step_world(world, "tracking")
    args = dict(backend="corr", resample_contract="cell",
                generator=torch.Generator().manual_seed(0))
    args.update(kw)
    with pytest.raises(ValueError):
        tmcl.sensor_resample_step(ts, tmap, tparams, tscan, tpool, tpf, **args)
    if kw.get("backend") in ("corr_q", "exact"):
        with pytest.raises(ValueError):
            tplanar.planar_likelihood_cells(tmap, tparams, tscan, ts.poses,
                                            "likelihood_field", kw["backend"])
    assert jck.T_FLAT_CELLS == tck.T_FLAT_CELLS and jfilter.CELL_U_MAX == tfilter.CELL_U_MAX
