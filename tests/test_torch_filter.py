"""PyTorch port: sensor update, KLD multinomial resample, cluster statistics
and the odometry models, held against the JAX package on the same inputs.

The JAX functions draw from `state.key`; the tests replay those draws
(filter.py:502 and :351-353 for the resample, odom.py:144 and the
per-model three-way split for odometry) and pass them to the port.

Tolerances:
- weights and averages: rtol 1e-6 (identical f32 formulas);
- resample: equal n_active and cluster_count, >= 99.9% equal picks (a
  cumulative-sum reassociation can move a pick boundary), statistics to
  rtol 1e-4 (per-cluster sums accumulate in another order) and atol 1e-5
  (the yaw variance is -2 log r with r ~ 1, so a few ulp of r move it by
  ~1e-6 each);
- odometry: atol 1e-5 (f32 trig differs between XLA and PyTorch in the
  last ulp, and the poses are O(1)).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badger_amcl_tpu.pf import cluster as jcluster
from badger_amcl_tpu.pf import filter as jfilter
from badger_amcl_tpu.pf import kld as jkld
from badger_amcl_tpu.pf.types import PFParams as JaxPFParams
from badger_amcl_tpu.sensors import odom as jodom
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch.pf import cluster as tcluster
from badger_amcl_tpu_torch.pf import filter as tfilter
from badger_amcl_tpu_torch.pf import kld as tkld
from badger_amcl_tpu_torch.sensors import odom as todom

torch.set_num_threads(1)


def _cloud(case, m, seed):
    rng = np.random.default_rng(seed)
    if case == "tight":
        p = rng.normal(0.0, [0.15, 0.15, 0.05], (m, 3))
    elif case == "gauss_spread":
        p = rng.normal(0.0, [2.0, 2.0, 1.0], (m, 3))
    else:  # uniform: more occupied bins than the sorted path's capacity
        p = rng.uniform([-10.0, -10.0, -3.14], [10.0, 10.0, 3.14], (m, 3))
    return p.astype(np.float32)


CASES = {"tight": 2000, "gauss_spread": 2000, "uniform": 10000}


@functools.lru_cache(maxsize=None)
def _states(case, seed=0):
    m = CASES[case]
    jparams = JaxPFParams(min_samples=max(16, m // 50), max_samples=m)
    jstate = jfilter.init_with_poses(jparams, jax.random.PRNGKey(seed),
                                     jnp.asarray(_cloud(case, m, seed)))
    rng = np.random.default_rng(seed + 1)
    p = rng.uniform(0.1, 2.0, m).astype(np.float32)
    jstate = jfilter.sensor_update(jstate, jnp.asarray(p), None)
    # w_diff = 0.2: random-pose injection runs
    jstate = jstate.replace(w_slow=jnp.float32(0.5), w_fast=jnp.float32(0.4))
    return jparams, jstate, convert.pf_params_from_jax(jparams), convert.state_from_numpy(jstate, device="cpu")


def test_sensor_update_matches():
    jparams, jstate, _, tstate = _states("tight")
    m = jparams.max_samples
    rng = np.random.default_rng(7)
    p = rng.uniform(0.0, 3.0, m).astype(np.float32)
    mf = rng.uniform(0.0, 1.0, m).astype(np.float32)
    jstate = jstate.replace(n_active=jnp.int32(m - 300), w_slow=jnp.float32(0.0))
    tstate = tstate.replace(n_active=torch.tensor(m - 300, dtype=torch.int32),
                            w_slow=torch.tensor(0.0))
    for mf_j, mf_t in ((None, None), (jnp.asarray(mf), torch.from_numpy(mf))):
        a = jfilter.sensor_update(jstate, jnp.asarray(p), mf_j)
        b = tfilter.sensor_update(tstate, torch.from_numpy(p), mf_t)
        np.testing.assert_allclose(b.weights.numpy(), np.asarray(a.weights), rtol=1e-6)
        for f in ("w_slow", "w_fast"):
            np.testing.assert_allclose(float(getattr(b, f)), float(getattr(a, f)),
                                       rtol=1e-6)
    # zero total: uniform reset over the active set, averages untouched
    z = tfilter.sensor_update(tstate, torch.zeros(m))
    assert float(z.weights[: m - 300].sum()) == pytest.approx(1.0, rel=1e-5)
    assert float(z.weights[m - 300:].abs().sum()) == 0.0
    assert float(z.w_fast) == float(tstate.w_fast)


_jax_resample = jax.jit(jfilter.resample, static_argnames=("params", "model",
                                                         "log_averages"))


def _replayed_resample_draws(key, m):
    _, sub = jax.random.split(key)
    k1, k2 = jax.random.split(sub)
    return (torch.from_numpy(np.array(jax.random.uniform(k1, (m,)))),
            torch.from_numpy(np.array(jax.random.uniform(k2, (m,)))))


def _assert_stats_close(ts, js):
    assert int(ts.cluster_count) == int(js.cluster_count)
    for f in ("mean", "cov"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    order = np.argsort(-np.asarray(js.cluster_weights), kind="stable")[:5]
    np.testing.assert_allclose(ts.cluster_weights.numpy()[order],
                               np.asarray(js.cluster_weights)[order], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ts.cluster_means.numpy()[order],
                               np.asarray(js.cluster_means)[order], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_resample_matches(case):
    jparams, jstate, tparams, tstate = _states(case)
    m = jparams.max_samples
    rng = np.random.default_rng(3)
    pool = rng.uniform(-3.0, 3.0, (m, 3)).astype(np.float32)
    j = _jax_resample(jstate, jparams, jnp.asarray(pool))
    u_inject, u_pick = _replayed_resample_draws(jstate.key, m)
    t = tfilter.resample(tstate, tparams, torch.from_numpy(pool), u_inject, u_pick)
    n = int(j.n_active)
    assert int(t.n_active) == n
    same = (t.poses.numpy() == np.asarray(j.poses)).all(axis=1)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    assert bool(t.converged) == bool(j.converged)
    assert float(t.w_slow) == float(j.w_slow) and float(t.w_fast) == float(j.w_fast)
    assert int(t.stats.cluster_count) == int(j.stats.cluster_count)
    # statistics held against the JAX statistics of the SAME new set: a
    # moved pick boundary in a uniform cloud moves the mean far more than
    # the statistics' own rounding
    js = jcluster.compute_cluster_stats(
        jnp.asarray(t.poses.numpy()), jnp.asarray(t.weights.numpy()),
        jnp.arange(m) < n, jparams)
    _assert_stats_close(t.stats, js)


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_stats_match(case):
    """compute_cluster_stats without precomputed ranks: the sorted path
    (small and full grid) and, past MAX_UNIQUE_BINS, the grid path."""
    jparams, jstate, tparams, tstate = _states(case)
    m = jparams.max_samples
    n = m - m // 7
    ja = jnp.arange(m) < n
    js = jcluster.compute_cluster_stats(jstate.poses, jstate.weights, ja, jparams)
    ts = tcluster.compute_cluster_stats(tstate.poses, tstate.weights, torch.arange(m) < n,
                                        tparams)
    np.testing.assert_array_equal(ts.particle_cluster.numpy(),
                                  np.asarray(js.particle_cluster))
    np.testing.assert_array_equal(ts.cluster_counts.numpy(), np.asarray(js.cluster_counts))
    _assert_stats_close(ts, js)


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_stats_independent_of_particle_order(case):
    """The statistics of a cloud 25 m from the origin, with random weights,
    equal bit for bit after the particles are permuted: the segment sums
    may land in any order (a card's atomic adds do), and a float32 sum of
    x ~ 25 m moved with its order."""
    jparams, _, tparams, _ = _states(case)
    m = jparams.max_samples
    rng = np.random.default_rng(5)
    poses = _cloud(case, m, 0) + np.array([25.0, -25.0, 0.0], np.float32)
    w = rng.uniform(0.1, 1.0, m).astype(np.float32)
    active = np.arange(m) < m - m // 7
    perm = rng.permutation(m)
    a, b = (tcluster.compute_cluster_stats(torch.from_numpy(poses[p]),
                                           torch.from_numpy(w[p] / w.sum()),
                                           torch.from_numpy(active[p]), tparams)
            for p in (np.arange(m), perm))
    assert int(a.cluster_count) == int(b.cluster_count)
    for f in ("cluster_weights", "cluster_means", "cluster_covs", "mean", "cov"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.particle_cluster[perm], b.particle_cluster)


@pytest.mark.parametrize("case", list(CASES))
def test_kld_binning_matches(case):
    """Bin keys, grid cells, first-occurrence flags and the population
    bound: integer results, so bit-equal."""
    jparams, jstate, _, tstate = _states(case)
    m = jparams.max_samples
    active = np.arange(m) < m - 5
    jkeys = jkld.bin_keys(jstate.poses)
    tkeys = tkld.bin_keys(tstate.poses)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    _, jflat = jkld.grid_cells(jkeys, jnp.asarray(active), jparams.hist_shape)
    _, tflat = tkld.grid_cells(tkeys, torch.from_numpy(active), jparams.hist_shape)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(
        tkld.first_occurrence_flags_sorted(tflat, torch.from_numpy(active)).numpy(),
        np.asarray(jkld.first_occurrence_flags_sorted(jflat, jnp.asarray(active))))
    k = np.arange(0, 3000, dtype=np.int32)
    np.testing.assert_array_equal(
        tkld.resample_limit(torch.from_numpy(k), 16, m, 0.01, 3.0).numpy(),
        np.asarray(jkld.resample_limit(jnp.asarray(k), 16, m, 0.01, 3.0)))


@pytest.mark.parametrize("model", list(jodom.OdomModel))
def test_odometry_matches(model):
    _, jstate, _, tstate = _states("tight")
    m = jstate.poses.shape[0]
    alphas = (0.2, 0.1, 0.15, 0.05, 0.1)
    pose = jnp.array([0.4, -0.2, 0.3], jnp.float32)
    delta = jnp.array([0.12, 0.03, 0.05], jnp.float32)
    absolute = jnp.array([0.13, 0.04, 0.06], jnp.float32)
    j = jodom.motion_update(jstate, model, alphas, pose, delta, absolute)
    _, sub = jax.random.split(jstate.key)
    keys = jax.random.split(sub, 3)
    normals = torch.from_numpy(np.stack(
        [np.asarray(jax.random.normal(k, (m,), dtype=jnp.float32)) for k in keys]))
    t = todom.motion_update(tstate, todom.OdomModel(int(model)), alphas, np.asarray(pose),
                            np.asarray(delta), normals, np.asarray(absolute))
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses), rtol=0, atol=1e-5)


def test_diff_rotation_guard():
    """Translation under 1 cm: no first rotation (odom.cpp:134-138)."""
    _, jstate, _, tstate = _states("tight")
    m = jstate.poses.shape[0]
    zeros = torch.zeros((3, m))
    t = todom.motion_update(tstate, todom.OdomModel.DIFF, (0.0,) * 5, [0.0, 0.0, 0.3],
                            [0.005, 0.0, 0.3], zeros)
    want = tstate.poses.clone()
    want[:, 0] += 0.005 * torch.cos(tstate.poses[:, 2])
    want[:, 1] += 0.005 * torch.sin(tstate.poses[:, 2])
    want[:, 2] += 0.3
    np.testing.assert_allclose(t.poses.numpy(), want.numpy(), atol=1e-6)
