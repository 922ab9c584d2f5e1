"""PyTorch port: the whole 2D likelihood-field step on the "corr" backend,
held against the JAX package's `pallas_corr_interpret` backend on the same
inputs, in a tight, a narrow and a spread regime.

The JAX step draws from `state.key`; its draws are replayed (odom.py:144,
filter.py:502 and :351-353) and passed to the port as StepNoise.

Tolerances:
- likelihoods: rtol 1e-5 where the corr table runs (f32 tap sums in
  another order); in the spread regime >= 99% of particles to rtol 1e-5
  and all to 2% — the JAX spread arm evaluates pairs that fit none of its
  windows with the exact endpoint formula, whose cell can differ by one
  from the kernel formula's that the port uses throughout (a one-cell
  shift moves pz^3 by a few percent on that beam);
- the resampled set: equal n_active and cluster count, >= 99.9% equal
  picks (a weight's last-ulp change can move a pick boundary; after the
  motion update "equal" means within atol 1e-5), statistics to rtol 1e-4
  against the JAX statistics of the same set, atol 1e-5 — the yaw variance
  is -2 log r with r ~ 1 summed in f32 over the set, so a summation-order
  change of r by a few ulp moves it by ~1e-6 each.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_setup
from badger_amcl_tpu import mcl as jmcl
from badger_amcl_tpu.pf import cluster as jcluster
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch import mcl as tmcl
from badger_amcl_tpu_torch.ops import corr_kernel, spread_kernel
from badger_amcl_tpu_torch.sensors.planar import coord_add

torch.set_num_threads(1)
BACKEND_J = "pallas_corr_interpret"

# regime -> pose cov; one shape for all three so the JAX side compiles once:
# 8192 particles (the smallest cloud the spread gate admits,
# planar.py:376-379) x 64 beams on a 448^2 map (corr, spread and lf all
# eligible). The 720-beam dedup path is covered by test_torch_corr.py.
REGIMES = {
    "tight": (0.004, 0.004, 0.0004),
    "narrow": (0.03, 0.03, 0.002),
    "spread": (2.0, 2.0, 1.0),
}
N_PARTICLES, N_BEAMS, MAP_CELLS = 8192, 64, 448
ODOM = dict(odom_pose=[0.1, 0.0, 0.02], odom_delta=[0.1, 0.0, 0.02],
            absolute_motion=[0.1, 0.0, 0.02], alphas=[0.1] * 5)


@functools.lru_cache(maxsize=None)
def _setup(regime):
    j = _build_setup(N_PARTICLES, N_BEAMS, MAP_CELLS, pose_cov=REGIMES[regime],
                     min_particles=N_PARTICLES // 4)
    omap, params, state, scan, sp, pool = j
    t = (convert.map_from_numpy(omap, device="cpu"), convert.pf_params_from_jax(params),
         convert.state_from_numpy(state, device="cpu"),
         convert.scan_from_numpy(scan, device="cpu"),
         convert.scan_params_from_numpy(sp), torch.tensor(np.asarray(pool)))
    return j, t


def _uniforms(key, m):
    k1, k2 = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.uniform(k1, (m,)))),
            torch.tensor(np.asarray(jax.random.uniform(k2, (m,)))))


def _resample_noise(key, m, odom=None):
    _, sub = jax.random.split(key)
    inject, pick = _uniforms(sub, m)
    return tmcl.StepNoise(odom=odom, inject=inject, pick=pick)


def _step_noise(key, m):
    key, sub = jax.random.split(key)
    normals = torch.tensor(np.stack([np.asarray(jax.random.normal(k, (m,)))
                                     for k in jax.random.split(sub, 3)]))
    return _resample_noise(key, m, odom=normals)


def _check_state(t, j, params, pose_atol=0.0):
    m = params.max_samples
    n = int(j.n_active)
    assert int(t.n_active) == n
    same = (np.abs(t.poses.numpy() - np.asarray(j.poses)) <= pose_atol).all(axis=1)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    assert int(t.stats.cluster_count) == int(j.stats.cluster_count)
    js = jcluster.compute_cluster_stats(
        jnp.asarray(t.poses.numpy()), jnp.asarray(t.weights.numpy()),
        jnp.arange(m) < n, params)
    np.testing.assert_allclose(t.stats.mean.numpy(), np.asarray(js.mean), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t.stats.cov.numpy(), np.asarray(js.cov), rtol=1e-4,
                               atol=1e-5)
    assert bool(t.converged) == bool(j.converged)


def _check_likelihood(p_t, p_j, regime):
    p_t, p_j = p_t.numpy(), np.asarray(p_j)
    if regime == "spread":
        close = np.abs(p_t - p_j) <= 1e-5 * np.abs(p_j)
        assert close.mean() >= 0.99, close.mean()
        np.testing.assert_allclose(p_t, p_j, rtol=2e-2)
    else:
        np.testing.assert_allclose(p_t, p_j, rtol=1e-5)


def _arm(tmap, tstate, tscan, tsp):
    """Which arm of the corr dispatch the port's cloud takes."""
    spose = coord_add(tsp.scanner_pose, tstate.poses)
    pre = corr_kernel.corr_prepass(tmap, spose, tscan.ranges, tscan.angles,
                                   tscan.valid(), dedup=tscan.ranges.shape[0] >= 360)
    if not bool(pre["fits"]):
        return "spread"
    return "tight" if bool(pre["tight"]) else ("narrow" if bool(pre["narrow"]) else "wide")


@functools.partial(jax.jit, static_argnames=("params",))
def _jax_like_and_step(state, omap, sp, scan, pool, params):
    """JAX likelihood and sensor_resample_step in one compile."""
    p = jmcl.likelihood_only(state, omap, sp, scan, backend=BACKEND_J)
    return p, jmcl.sensor_resample_step(state, omap, sp, scan, pool, params,
                                        backend=BACKEND_J)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_sensor_resample_step_matches(regime):
    (jmap, jparams, jstate, jscan, jsp, jpool), (tmap, tparams, tstate, tscan, tsp,
                                                 tpool) = _setup(regime)
    assert _arm(tmap, tstate, tscan, tsp) == regime
    p_j, j = _jax_like_and_step(jstate, jmap, jsp, jscan, jpool, params=jparams)
    launches = spread_kernel.spread_term_sums.launches
    p_t = tmcl.likelihood_only(tstate, tmap, tsp, tscan, backend="corr")
    assert spread_kernel.spread_term_sums.launches == launches  # CPU: plain version
    _check_likelihood(p_t, p_j, regime)

    noise = _resample_noise(jstate.key, jparams.max_samples)
    t = tmcl.sensor_resample_step(tstate, tmap, tsp, tscan, tpool, tparams,
                                  backend="corr", noise=noise)
    _check_state(t, j, jparams)


@pytest.mark.parametrize("regime", ["narrow"])
def test_mcl_step_2d_matches(regime):
    (jmap, jparams, jstate, jscan, jsp, jpool), (tmap, tparams, tstate, tscan, tsp,
                                                 tpool) = _setup(regime)
    j = jax.jit(jmcl.mcl_step_2d, static_argnames=("params", "backend"))(
        jstate, jmap, jsp, jscan, jpool, *(jnp.asarray(v, jnp.float32)
                                           for v in ODOM.values()),
        params=jparams, backend=BACKEND_J)
    noise = _step_noise(jstate.key, jparams.max_samples)
    t = tmcl.mcl_step_2d(tstate, tmap, tsp, tscan, tpool, *ODOM.values(), tparams,
                         backend="corr", noise=noise)
    # the motion update's trig differs in the last ulp between XLA and
    # PyTorch, so picked poses agree to the odometry tolerance of
    # test_torch_filter.py rather than bitwise
    _check_state(t, j, jparams, pose_atol=1e-5)


def test_noise_or_generator_required():
    _, (tmap, tparams, tstate, tscan, tsp, tpool) = _setup("tight")
    with pytest.raises(ValueError):
        tmcl.sensor_resample_step(tstate, tmap, tsp, tscan, tpool, tparams,
                                  backend="corr")
    gen = torch.Generator().manual_seed(0)
    t = tmcl.sensor_resample_step(tstate, tmap, tsp, tscan, tpool, tparams,
                                  backend="corr", generator=gen)
    assert torch.isfinite(t.weights).all()
    assert tmcl.default_backend("cpu") == "exact"
    assert tmcl.default_backend("cuda") == "corr"
