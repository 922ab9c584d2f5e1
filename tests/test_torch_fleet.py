"""PyTorch port: the fleet layer (batched prepass, fleet corr table, fleet
likelihood, composite-key KLD flags and cluster ranks, fleet resample,
fleet step) held against the JAX package on the same inputs, its fleet
kernel in interpret mode (`pallas_corr_interpret`).

The JAX functions draw from each robot's key; the tests replay those draws
(filter.py:585-596 for the resample head, odom.py:144 and the three-way
split for the motion normals, filter.py:77-78 for fleet_init) and pass
them to the port.

Tolerances:
- packed taps >= 99.9% equal (a last-ulp difference between XLA's and
  PyTorch's f32 cos can flip a round); every other prepass field exact;
- the fleet table: max |diff| <= 1e-5 x its max (the plain version sums a
  bin's taps in another order than the kernel's sequential loop);
- likelihoods: rtol 1e-5 for the same reason, map factors exact;
- KLD flags and cluster ranks: integers, exact;
- the resample: poses, n_active, cluster counts and `converged` exact,
  cluster weights atol 1e-6 and set means atol 1e-5 (per-cluster sums
  accumulate in another order: an index_add_ against a one-hot matmul);
- the motion update: atol 1e-5 (f32 trig differs in the last ulp);
- two fleet steps: n_active exact, >= 99% of poses within 1e-4 (the
  steps feed last-ulp likelihood and trig differences into the picks),
  set means within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badger_amcl_tpu.fleet import fleet as jfleet
from badger_amcl_tpu.maps import CellState
from badger_amcl_tpu.maps import OccupancyMap2D as JaxMap
from badger_amcl_tpu.ops import corr_kernel as jck
from badger_amcl_tpu.pf import cluster as jcluster
from badger_amcl_tpu.pf import filter as jfilter
from badger_amcl_tpu.pf import kld as jkld
from badger_amcl_tpu.pf.types import PFParams as JaxPFParams
from badger_amcl_tpu.sensors import odom as jodom
from badger_amcl_tpu.sensors import planar as jplanar
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch import fleet as tfleet
from badger_amcl_tpu_torch.ops import corr_kernel as tck
from badger_amcl_tpu_torch.pf import cluster as tcluster
from badger_amcl_tpu_torch.pf import filter as tfilter
from badger_amcl_tpu_torch.pf import kld as tkld
from badger_amcl_tpu_torch.sensors import odom as todom
from badger_amcl_tpu_torch.sensors import planar as tplanar
from badger_amcl_tpu_torch.utils.numerics import SYNCS

torch.set_num_threads(1)
R, M, B = 4, 256, 48
RANGE_MAX = 6.0
MEANS = np.array([[0.0, 0.0, 0.1], [2.5, -1.5, 1.2], [-3.0, 2.0, -0.7], [1.0, 4.0, 2.9]],
                 np.float32)
TIGHT = (0.02, 0.02, 0.002)
JPARAMS = JaxPFParams(min_samples=16, max_samples=M, hist_x=32, hist_y=32,
                      stats_max_clusters=64)
ALPHAS = (0.05,) * 5
DELTAS = np.tile(np.array([0.05, 0.0, 0.01], np.float32), (R, 1))


@pytest.fixture(scope="module")
def maps():
    """The 448^2 map of tests/test_fleet.py's batched-corr test, baked for
    the likelihood field on both sides."""
    rng = np.random.default_rng(7)
    n = 448
    cells = np.full((n, n), int(CellState.FREE), np.int8)
    cells[0:2, :] = cells[-2:, :] = int(CellState.OCCUPIED)
    cells[:, 0:2] = cells[:, -2:] = int(CellState.OCCUPIED)
    for _ in range(12):
        cx, cy = rng.integers(20, n - 28, 2)
        cells[cy:cy + 6, cx:cx + 6] = int(CellState.OCCUPIED)
    jmap = JaxMap.from_cells(cells, 0.05).with_distance_field(2.0)
    jsp = jplanar.PlanarScanParams()
    jmap = jplanar.bake_corr_texture(jmap, jsp, RANGE_MAX, "likelihood_field")
    return jmap, jsp, convert.map_from_numpy(jmap, device="cpu"), \
        convert.scan_params_from_numpy(jsp)


def _scans(all_max_robot=None):
    angles = jnp.linspace(-2.0, 2.0, B)
    ranges = jnp.stack([jnp.clip(1.2 + 0.5 * jnp.sin(angles * (2.0 + i)), 0.3, 2.5)
                        for i in range(R)])
    if all_max_robot is not None:
        ranges = ranges.at[all_max_robot].set(RANGE_MAX)
    jscans = jplanar.PlanarScan(ranges=ranges.astype(jnp.float32),
                                angles=jnp.tile(angles, (R, 1)).astype(jnp.float32),
                                range_max=jnp.full((R,), RANGE_MAX, jnp.float32))
    return jscans, convert.fleet_scan_from_numpy(jscans, device="cpu")


@functools.lru_cache(maxsize=None)
def _fleet(spread_robot=None, seed=1):
    """(JAX fleet state, port fleet state): JAX fleet_init at MEANS, robot
    `spread_robot` with a 1 m cloud (outside the lattice envelope)."""
    covs = np.tile(np.diag(TIGHT).astype(np.float32), (R, 1, 1))
    if spread_robot is not None:
        covs[spread_robot] = np.diag([1.0, 1.0, 0.1])
    js = jfleet.fleet_init(JPARAMS, jax.random.PRNGKey(seed), jnp.asarray(MEANS),
                           jnp.asarray(covs))
    return js, convert.state_from_numpy(js, device="cpu")


@jax.jit
def _jax_prepass(jmap, jsp, jscans, poses):
    """The JAX fleet's vmapped prepass (fleet.py:158-162)."""
    spose = jplanar.coord_add(jsp.scanner_pose, poses)
    valid = (jscans.ranges < jscans.range_max[:, None]) & ~jnp.isnan(jscans.ranges)
    return jax.vmap(lambda sp, r, a, v: jck.corr_prepass(jmap, sp, r, a, v))(
        spose, jscans.ranges, jscans.angles, valid)


def test_fleet_prepass_matches(maps):
    jmap, jsp, tmap, tsp = maps
    jscans, tscans = _scans()
    js, ts = _fleet()
    jpre = _jax_prepass(jmap, jsp, jscans, js.poses)
    spose = tplanar.coord_add(tsp.scanner_pose, ts.poses)
    tpre = tck.corr_prepass(tmap, spose, tscans.ranges, tscans.angles, tscans.valid())
    assert tpre["off"].shape == (R, tck.T_MAX * B)
    assert (tpre["off"].numpy() == np.asarray(jpre["off"])).mean() >= 0.999
    for k in ("nu", "t_slot", "ci", "cj", "t_n", "nv", "i0", "j0", "j0_narrow",
              "j0_tight", "fits", "narrow", "tight"):
        np.testing.assert_array_equal(tpre[k].numpy(), np.asarray(jpre[k]), err_msg=k)


_PALLAS_TABLES = {}


def _pallas_fleet_table(jmap, jsp, rows, j0_key):
    """fleet_corr_call in interpret mode fed JAX's own vmapped prepass (its
    per-robot slices and metas built as fleet.py:174-193 builds them), and
    the port's table inputs: (want, (tex_pad, off, nv, t_n, org)), once per
    window for the module's one map."""
    if (rows, j0_key) in _PALLAS_TABLES:
        return _PALLAS_TABLES[rows, j0_key]
    jscans, _ = _scans()
    js, _ = _fleet()
    jpre = _jax_prepass(jmap, jsp, jscans, js.poses)
    j0 = jpre[j0_key]
    tex_pad = jmap.corr_psi_pad
    sj, si = jax.vmap(lambda j, i: jck.slice_origin(tex_pad, j, i))(j0, jpre["i0"])
    slices = jax.vmap(lambda a, b: jax.lax.dynamic_slice(
        tex_pad, (a, b), (jck.SLICE_R, jck.SLICE_C)))(sj, si)
    metas = jnp.stack([jpre["t_n"], j0 + jck.PAD_R - sj, jpre["i0"] + jck.PAD_C - si,
                       jnp.maximum(jpre["nv"], 1)], axis=1).astype(jnp.int32)
    want = np.asarray(jck.fleet_corr_call(slices, metas, jpre["off"], n_beams=B, rows=rows,
                                          interpret=True))
    org = np.stack([np.asarray(j0) + tck.PAD_R, np.asarray(jpre["i0"]) + tck.PAD_C], 1)
    args = tuple(torch.from_numpy(np.array(a)) for a in (
        tex_pad, jpre["off"], jpre["nv"], jpre["t_n"], org.astype(np.int32)))
    _PALLAS_TABLES[rows, j0_key] = want, args
    return want, args


@pytest.mark.parametrize("rows,j0_key", [(24, "j0_tight"), (64, "j0")])
def test_fleet_table_plain_matches_pallas_interpret(maps, rows, j0_key):
    """The plain fleet table fed JAX's own vmapped prepass against
    fleet_corr_call in interpret mode."""
    jmap, jsp, _, _ = maps
    want, args = _pallas_fleet_table(jmap, jsp, rows, j0_key)
    got = tck.fleet_corr_table(*args, B, rows).numpy()
    assert got.shape == want.shape == (R, tck.T_MAX, rows, tck.PWIN_C)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("rows,j0_key", [(24, "j0_tight"), (64, "j0")])
def test_fleet_table_in_order_bit_equal_to_pallas_interpret(maps, rows, j0_key):
    """`_table_in_order`, the sum order of the CUDA fleet kernel, equals
    fleet_corr_call in interpret mode bit for bit on every live bin: both
    add each cell's unit taps one at a time in tap order."""
    jmap, jsp, _, _ = maps
    want, (tex_pad, off, nv, t_n, org) = _pallas_fleet_table(jmap, jsp, rows, j0_key)
    got = tck._table_in_order(tex_pad, off, nv[:, None].expand(-1, tck.T_MAX), t_n, org, B,
                              rows).numpy()
    assert got.shape == want.shape
    live = np.arange(tck.T_MAX)[None, :] < t_n.numpy()[:, None]
    assert live.sum() > R
    np.testing.assert_array_equal(got[live], want[live])
    assert not got[~live].any()


@pytest.mark.parametrize("spread_robot", [None, 2])
def test_fleet_likelihood_matches(maps, spread_robot):
    """fleet_likelihood against the JAX _fleet_likelihood: all robots in the
    envelope (one fleet table), and one robot outside it (every robot
    through planar_likelihood)."""
    jmap, jsp, tmap, tsp = maps
    jscans, tscans = _scans()
    js, ts = _fleet(spread_robot)
    jpre = _jax_prepass(jmap, jsp, jscans, js.poses)
    assert bool(jnp.all(jpre["fits"])) == (spread_robot is None)
    p_j, mf_j = jfleet._fleet_likelihood(jmap, jsp, jscans, js, "likelihood_field",
                                         "pallas_corr_interpret")
    before = tck.fleet_corr_table.launches
    p_t, mf_t = tfleet.fleet_likelihood(tmap, tsp, tscans, ts, "likelihood_field", "corr")
    assert tck.fleet_corr_table.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5)
    np.testing.assert_array_equal(mf_t.numpy(), np.asarray(mf_j))


def test_nv_zero_robot_divergence(maps):
    """A robot whose scan has no valid beam: the port gives p == 1 (zero
    taps), as the JAX single-robot path does; the JAX fleet kernel runs
    max(nv, 1) taps and gives 1 + psi at the robot's own cell."""
    jmap, jsp, tmap, tsp = maps
    jscans, tscans = _scans(all_max_robot=1)
    js, ts = _fleet()
    p_j, _ = jfleet._fleet_likelihood(jmap, jsp, jscans, js, "likelihood_field",
                                      "pallas_corr_interpret")
    p_t, _ = tfleet.fleet_likelihood(tmap, tsp, tscans, ts, "likelihood_field", "corr")
    single, _ = jplanar.planar_likelihood(
        jmap, jsp, jplanar.PlanarScan(ranges=jscans.ranges[1], angles=jscans.angles[1],
                                      range_max=jscans.range_max[1]),
        js.poses[1], js.active_mask[1], js.n_active[1], "likelihood_field",
        backend="pallas_corr_interpret")
    assert (np.asarray(single) == 1.0).all()
    assert (p_t[1].numpy() == 1.0).all()
    assert (np.asarray(p_j[1]) > 1.0).all()  # the JAX fleet path's extra tap
    keep = [0, 2, 3]
    np.testing.assert_allclose(p_t[keep].numpy(), np.asarray(p_j)[keep], rtol=1e-5)


def test_mixed_range_max_runs_robot_by_robot(maps):
    """A fleet whose robots have different range_max leaves the batched
    table: each robot runs planar_likelihood with its own range_max, as the
    JAX single-robot path does; FleetScan.valid refuses such a fleet."""
    jmap, jsp, tmap, tsp = maps
    jscans, tscans = _scans()
    js, ts = _fleet()
    rmax = (RANGE_MAX,) * (R - 1) + (2.0,)
    mixed = tfleet.FleetScan(tscans.ranges, tscans.angles, rmax)
    with pytest.raises(ValueError):
        mixed.valid()
    p_t, _ = tfleet.fleet_likelihood(tmap, tsp, mixed, ts, "likelihood_field", "corr")
    i = R - 1
    want, _ = jplanar.planar_likelihood(
        jmap, jsp, jplanar.PlanarScan(ranges=jscans.ranges[i], angles=jscans.angles[i],
                                      range_max=jnp.float32(rmax[i])),
        js.poses[i], js.active_mask[i], js.n_active[i], "likelihood_field",
        backend="pallas_corr_interpret")
    np.testing.assert_allclose(p_t[i].numpy(), np.asarray(want), rtol=1e-5)


def _flat_clouds(seed, n_active):
    """(R, M) bins of R clouds spread over a few bins each (some robots
    wider), active the first n_active[i] entries of each."""
    rng = np.random.default_rng(seed)
    sig = np.array([[0.3, 0.3, 0.1], [1.5, 1.5, 0.8], [0.2, 0.2, 0.05], [2.5, 2.5, 1.0]])
    poses = (rng.normal(0.0, 1.0, (R, M, 3)) * sig[:, None, :]).astype(np.float32)
    active = np.arange(M)[None, :] < np.asarray(n_active)[:, None]
    jflat = jax.vmap(lambda p, a: jkld.grid_cells(jkld.bin_keys(p), a, JPARAMS.hist_shape)[1])(
        jnp.asarray(poses), jnp.asarray(active))
    tflat = tkld.grid_cells(tkld.bin_keys(torch.from_numpy(poses)), torch.from_numpy(active),
                            JPARAMS.hist_shape)[1]
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    return jflat, tflat, active


def test_first_occurrence_flags_and_ranks_fleet():
    jflat, tflat, active = _flat_clouds(3, [M, M - 40, 17, M])
    ja, ta = jnp.asarray(active), torch.from_numpy(active)
    shape = JPARAMS.hist_shape
    np.testing.assert_array_equal(
        tkld.first_occurrence_flags_fleet(tflat, ta, shape).numpy(),
        np.asarray(jkld.first_occurrence_flags_fleet(jflat, ja, shape)))
    jrank, jcc, jfits = jcluster._ranks_fleet(jflat, ja, shape)
    assert bool(jfits)
    trank, tcc = tcluster._ranks_fleet(tflat, ta, shape)
    np.testing.assert_array_equal(tcc.numpy(), np.asarray(jcc))
    np.testing.assert_array_equal(trank.numpy()[active], np.asarray(jrank)[active])


def _replayed_resample_draws(keys, m):
    """Per robot: key, sub = split(key); k1, k2 = split(sub) (filter.py:585-596)."""
    u1, u2 = [], []
    for k in keys:
        _, sub = jax.random.split(k)
        k1, k2 = jax.random.split(sub)
        u1.append(np.asarray(jax.random.uniform(k1, (m,))))
        u2.append(np.asarray(jax.random.uniform(k2, (m,))))
    return torch.from_numpy(np.stack(u1)), torch.from_numpy(np.stack(u2))


@pytest.mark.parametrize("u_max", [None, 8])
def test_fleet_resample_matches(monkeypatch, u_max):
    """fleet_resample with replayed draws against the JAX fleet_resample;
    with FLEET_U_MAX patched low on both sides every robot takes the
    per-robot grid rank path."""
    if u_max is not None:
        monkeypatch.setattr(jcluster, "FLEET_U_MAX", u_max)
        monkeypatch.setattr(tcluster, "FLEET_U_MAX", u_max)
    rng = np.random.default_rng(1)
    means = rng.uniform(-3, 3, (R, 3)).astype(np.float32)
    covs = np.tile(np.diag([0.3, 0.3, 0.1]).astype(np.float32), (R, 1, 1))
    js = jfleet.fleet_init(JPARAMS, jax.random.PRNGKey(0), jnp.asarray(means),
                           jnp.asarray(covs))
    w = rng.uniform(0.5, 2.0, (R, M)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    js = js.replace(weights=jnp.asarray(w), w_slow=jnp.full((R,), 0.4, jnp.float32),
                    w_fast=jnp.full((R,), 0.3, jnp.float32))
    ts = convert.state_from_numpy(js, device="cpu")
    pools = rng.uniform(-4, 4, (R, M, 3)).astype(np.float32)
    want = jax.jit(lambda s, p: jfilter.fleet_resample(s, JPARAMS, p))(js, jnp.asarray(pools))
    u_inject, u_pick = _replayed_resample_draws(js.key, M)
    got = tfilter.fleet_resample(ts, convert.pf_params_from_jax(JPARAMS),
                                 torch.from_numpy(pools), u_inject, u_pick)
    np.testing.assert_array_equal(got.poses.numpy(), np.asarray(want.poses))
    np.testing.assert_array_equal(got.n_active.numpy(), np.asarray(want.n_active))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    np.testing.assert_array_equal(got.stats.cluster_count.numpy(),
                                  np.asarray(want.stats.cluster_count))
    np.testing.assert_array_equal(got.stats.particle_cluster.numpy(),
                                  np.asarray(want.stats.particle_cluster))
    np.testing.assert_allclose(got.stats.cluster_weights.numpy(),
                               np.asarray(want.stats.cluster_weights), atol=1e-6)
    np.testing.assert_allclose(got.stats.mean.numpy(), np.asarray(want.stats.mean), atol=1e-5)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    for f in ("w_slow", "w_fast"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("model", list(jodom.OdomModel))
def test_fleet_motion_matches(model):
    """The motion update with a robot axis against the JAX vmap, normals
    replayed per robot (odom.py:144 and the three-way split)."""
    js, ts = _fleet()
    odom_poses = np.tile(np.array([0.4, -0.2, 0.3], np.float32), (R, 1))
    absolute = DELTAS + np.float32(0.01)
    want = jax.vmap(lambda st, p, d, a: jodom.motion_update(st, model, ALPHAS, p, d, a))(
        js, jnp.asarray(odom_poses), jnp.asarray(DELTAS), jnp.asarray(absolute))
    normals = []
    for k in js.key:
        _, sub = jax.random.split(k)
        normals.append(np.stack([np.asarray(jax.random.normal(kk, (M,), dtype=jnp.float32))
                                 for kk in jax.random.split(sub, 3)]))
    got = todom.motion_update(ts, todom.OdomModel(int(model)), ALPHAS,
                              torch.from_numpy(odom_poses), torch.from_numpy(DELTAS),
                              torch.from_numpy(np.stack(normals)), torch.from_numpy(absolute))
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), rtol=0, atol=1e-5)


def _step_noise(keys):
    """The JAX fleet step's draws per robot: the motion split (odom.py:144)
    then the resample head's (filter.py:585-596); returns (noise, keys
    after the step)."""
    normals, after = [], []
    for k in keys:
        k1, sub = jax.random.split(k)
        normals.append(np.stack([np.asarray(jax.random.normal(kk, (M,), dtype=jnp.float32))
                                 for kk in jax.random.split(sub, 3)]))
        after.append(jax.random.split(k1)[0])
    inject, pick = _replayed_resample_draws([jax.random.split(k)[0] for k in keys], M)
    return tfleet.FleetNoise(odom=torch.from_numpy(np.stack(normals)), inject=inject,
                             pick=pick), after


def test_fleet_step_init_reinit_health(maps):
    """fleet_init with replayed normals, two fleet steps with replayed
    noise against JAX's fleet_step on pallas_corr_interpret (the port's
    host syncs per step equal at R = 2 and R = 4), fleet_reinit_masked and
    fleet_health."""
    jmap, jsp, tmap, tsp = maps
    jscans, tscans = _scans()
    js, ts0 = _fleet()
    tparams = convert.pf_params_from_jax(JPARAMS)
    # fleet_init: keys = split(key, R); per robot sub = split(k)[1] draws (M, 3)
    normals = np.stack([np.asarray(jax.random.normal(jax.random.split(k)[1], (M, 3),
                                                     dtype=jnp.float32))
                        for k in jax.random.split(jax.random.PRNGKey(1), R)])
    covs = np.tile(np.diag(TIGHT).astype(np.float32), (R, 1, 1))
    ts = tfleet.fleet_init(tparams, MEANS, covs, normals=torch.from_numpy(normals),
                           device="cpu")
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ts.stats.cluster_count.numpy(),
                                  np.asarray(js.stats.cluster_count))

    jstep = jfleet.make_fleet_step(JPARAMS, backend="pallas_corr_interpret")
    zeros = np.zeros((R, 3), np.float32)
    pools = np.random.default_rng(4).uniform(-3, 3, (R, M, 3)).astype(np.float32)
    keys = list(js.key)
    syncs = []
    for _ in range(2):
        js = jstep(js, jmap, jsp, jscans, jnp.asarray(pools), jnp.asarray(zeros),
                   jnp.asarray(DELTAS), jnp.asarray(DELTAS), jnp.full((5,), 0.05))
        noise, keys = _step_noise(keys)
        s0 = SYNCS.count
        ts = tfleet.fleet_step(ts, tmap, tsp, tscans, torch.from_numpy(pools),
                               torch.from_numpy(zeros), torch.from_numpy(DELTAS),
                               torch.from_numpy(DELTAS), ALPHAS, tparams, noise=noise)
        syncs.append(SYNCS.count - s0)
    np.testing.assert_array_equal(ts.n_active.numpy(), np.asarray(js.n_active))
    close = (np.abs(ts.poses.numpy() - np.asarray(js.poses)) <= 1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(ts.stats.mean.numpy()[:, :2], np.asarray(js.stats.mean)[:, :2],
                               atol=1e-4)

    # host syncs per step do not grow with R: the first two robots alone
    half = tfleet.FleetScan(tscans.ranges[:2], tscans.angles[:2], tscans.range_max[:2])
    sub = tfleet.fleet_init(tparams, MEANS[:2], covs[:2], normals=torch.from_numpy(normals[:2]),
                            device="cpu")
    s0 = SYNCS.count
    tfleet.fleet_step(sub, tmap, tsp, half, torch.from_numpy(pools[:2]), torch.zeros(2, 3),
                      torch.from_numpy(DELTAS[:2]), torch.from_numpy(DELTAS[:2]), ALPHAS,
                      tparams, generator=torch.Generator().manual_seed(0))
    assert SYNCS.count - s0 == syncs[0]

    mask = np.array([True, False, True, False])
    pose_pools = np.random.default_rng(5).uniform(-2, 2, (R, M, 3)).astype(np.float32)
    jre = jfleet.fleet_reinit_masked(js, jnp.asarray(mask), jnp.asarray(pose_pools), JPARAMS)
    tre = tfleet.fleet_reinit_masked(ts, torch.from_numpy(mask), torch.from_numpy(pose_pools),
                                     tparams)
    np.testing.assert_array_equal(tre.poses.numpy()[mask], np.asarray(jre.poses)[mask])
    np.testing.assert_array_equal(tre.poses.numpy()[~mask], ts.poses.numpy()[~mask])
    np.testing.assert_array_equal(tre.n_active.numpy(), np.asarray(jre.n_active))
    np.testing.assert_array_equal(tre.stats.cluster_count.numpy()[mask],
                                  np.asarray(jre.stats.cluster_count)[mask])
    for k, v in jfleet.fleet_health(jre).items():
        np.testing.assert_allclose(float(tfleet.fleet_health(tre)[k]), float(v), rtol=1e-5,
                                   err_msg=k)
