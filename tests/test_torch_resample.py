"""PyTorch port: systematic resampling, the capped multinomial arm, the
grid and sorted leaf counts and the systematic fleet, held against the JAX
package on the same inputs.

The JAX functions draw from `state.key`; the tests replay those draws
(filter.py:476 for the comb start, filter.py:319-321 for the capped arm's
injection and pick uniforms, odom.py:144 and its three-way split for the
fleet's motion normals) and pass them to the port.

Tolerances:
- leaf counts, first-occurrence flags, counts, weights, averages and
  `converged`: integers or identical f32 formulas, so exact; the comb's
  picks exact but where XLA's cumulative sum, associated otherwise than
  torch.cumsum, moves a tooth to the neighbouring particle (<= 1 in 1000);
- the multinomial picks >= 99.9% equal (a cumulative-sum reassociation can
  move a pick boundary), as tests/test_torch_filter.py;
- statistics: rtol 1e-4 and atol 1e-5, as tests/test_torch_filter.py
  (per-cluster sums accumulate in another order);
- the fleet step: n_active exact, >= 99% of poses within 1e-4 and set
  means within 1e-4, as tests/test_torch_fleet.py (the motion update's
  f32 trig differs in the last ulp).
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
from badger_amcl_tpu.pf import cluster as jcluster
from badger_amcl_tpu.pf import filter as jfilter
from badger_amcl_tpu.pf import kld as jkld
from badger_amcl_tpu.pf.types import PFParams as JaxPFParams
from badger_amcl_tpu.sensors import planar as jplanar
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch import fleet as tfleet
from badger_amcl_tpu_torch.pf import filter as tfilter
from badger_amcl_tpu_torch.pf import kld as tkld
from badger_amcl_tpu_torch.pf.types import map_tensors

torch.set_num_threads(1)

CASES = {"tight": ((0.15, 0.15, 0.05), 2000), "gauss_spread": ((2.0, 2.0, 1.0), 2000),
         "uniform": (None, 10000)}


@functools.lru_cache(maxsize=None)
def _states(case, cap=0, w_diff=True):
    """(jparams, jstate, tparams, tstate): a cloud after one sensor update
    with seeded likelihoods; w_slow 0.5, w_fast 0.4 (w_diff 0.2) unless
    w_diff is False."""
    sd, m = CASES[case]
    rng = np.random.default_rng(0)
    if sd is None:
        poses = rng.uniform([-10.0, -10.0, -3.14], [10.0, 10.0, 3.14], (m, 3))
    else:
        poses = rng.normal(0.0, sd, (m, 3))
    jparams = JaxPFParams(min_samples=max(16, m // 50), max_samples=m,
                          stats_max_clusters=cap)
    jstate = jfilter.init_with_poses(jparams, jax.random.PRNGKey(1),
                                     jnp.asarray(poses.astype(np.float32)))
    p = np.random.default_rng(1).uniform(0.1, 2.0, m).astype(np.float32)
    jstate = jfilter.sensor_update(jstate, jnp.asarray(p), None)
    if w_diff:
        jstate = jstate.replace(w_slow=jnp.float32(0.5), w_fast=jnp.float32(0.4))
    return (jparams, jstate, convert.pf_params_from_jax(jparams),
            convert.state_from_numpy(jstate, device="cpu"))


_jax_resample = jax.jit(jfilter.resample, static_argnames=("params", "model",
                                                         "log_averages"))


def _pool(m):
    return np.random.default_rng(3).uniform(-3.0, 3.0, (m, 3)).astype(np.float32)


def _start(key):
    """The comb start `resample` draws (filter.py:476 after :502)."""
    return torch.tensor(float(jax.random.uniform(jax.random.split(key)[1], ())))


def _assert_stats_close(ts, js):
    assert int(ts.cluster_count) == int(js.cluster_count)
    for f in ("mean", "cov"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    order = np.argsort(-np.asarray(js.cluster_weights), kind="stable")[:5]
    np.testing.assert_allclose(ts.cluster_weights.numpy()[order],
                               np.asarray(js.cluster_weights)[order], rtol=1e-4, atol=1e-6)


def _source_index(new_poses, poses, pool):
    """Each new pose's index among the old poses (the pool's as -1 - k)."""
    where = {p.tobytes(): i for i, p in enumerate(poses)}
    where.update({p.tobytes(): -1 - k for k, p in enumerate(pool)})
    return np.array([where[p.tobytes()] for p in new_poses])


def _assert_same_set(t, j, old_poses, pool):
    """New sets equal: count, weights, averages, convergence, and the picks:
    the same particle in every slot but where the JAX package's cumulative
    sum, associated otherwise than torch.cumsum, moves a comb tooth across
    one boundary (the neighbour is picked; at most 1 slot in 1000)."""
    n = int(j.n_active)
    assert int(t.n_active) == n
    it = _source_index(t.poses.numpy()[:n], old_poses, pool)
    ij = _source_index(np.asarray(j.poses)[:n], old_poses, pool)
    diff = it != ij
    assert diff.mean() <= 1e-3, diff.mean()
    assert (np.abs(it - ij)[diff] == 1).all() and (it[diff] >= 0).all()
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    assert float(t.w_slow) == float(j.w_slow) and float(t.w_fast) == float(j.w_fast)
    assert bool(t.converged) == bool(j.converged)


@pytest.mark.parametrize("case,cap,w_diff", [("tight", 0, True), ("tight", 0, False),
                                             ("gauss_spread", 0, True),
                                             ("gauss_spread", 64, True)])
def test_systematic_resample_matches(case, cap, w_diff):
    """The comb replayed from JAX's start: equal count (leaf count of the
    previous set, inflated by w_diff), equal picks, the pool in the first
    w_diff * count slots; uncapped (sorted leaf count) and capped (grid)."""
    jparams, jstate, tparams, tstate = _states(case, cap, w_diff)
    m = jparams.max_samples
    pool = _pool(m)
    j = _jax_resample(jstate, jparams, jnp.asarray(pool), jfilter.ResampleModel.SYSTEMATIC)
    t = tfilter.resample(tstate, tparams, torch.from_numpy(pool),
                         model=tfilter.ResampleModel.SYSTEMATIC, u_start=_start(jstate.key))
    _assert_same_set(t, j, tstate.poses.numpy(), pool)
    n = int(j.n_active)
    w = np.float32(1.0) - np.float32(0.4) / np.float32(0.5)  # w_diff in f32: 0.19999999
    n_random = int(w * np.float32(n)) if w_diff else 0
    np.testing.assert_array_equal(t.poses.numpy()[:n_random], pool[:n_random])
    # statistics against the JAX statistics of the same new set
    js = jcluster.compute_cluster_stats(jnp.asarray(t.poses.numpy()),
                                        jnp.asarray(t.weights.numpy()), jnp.arange(m) < n,
                                        jparams)
    _assert_stats_close(t.stats, js)


def test_capped_multinomial_matches():
    """stats_max_clusters > 0 takes `_resample_multinomial`: the grid
    scatter-min flags for the KLD stop and the cluster cap in the
    statistics."""
    jparams, jstate, tparams, tstate = _states("gauss_spread", cap=16)
    m = jparams.max_samples
    pool = _pool(m)
    j = _jax_resample(jstate, jparams, jnp.asarray(pool))
    _, sub = jax.random.split(jstate.key)
    k1, k2 = jax.random.split(sub)
    t = tfilter.resample(tstate, tparams, torch.from_numpy(pool),
                         torch.from_numpy(np.array(jax.random.uniform(k1, (m,)))),
                         torch.from_numpy(np.array(jax.random.uniform(k2, (m,)))))
    n = int(j.n_active)
    assert int(t.n_active) == n
    same = (t.poses.numpy() == np.asarray(j.poses)).all(axis=1)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    assert int(t.stats.cluster_count) == int(j.stats.cluster_count)
    assert int(t.stats.cluster_valid.sum()) <= 16
    js = jcluster.compute_cluster_stats(jnp.asarray(t.poses.numpy()),
                                        jnp.asarray(t.weights.numpy()), jnp.arange(m) < n,
                                        jparams)
    _assert_stats_close(t.stats, js)


@pytest.mark.parametrize("case", list(CASES))
def test_leaf_counts_and_grid_flags_match(case):
    """leaf_count (grid), leaf_count_sorted and the grid scatter-min
    first_occurrence_flags against the JAX package, bit for bit; the
    uniform cloud clamps into the grid's border bins."""
    jparams, jstate, _, tstate = _states(case)
    m = jparams.max_samples
    active = np.arange(m) < m - 37
    ja, ta = jnp.asarray(active), torch.from_numpy(active)
    shape = jparams.hist_shape
    want = int(jkld.leaf_count(jstate.poses, ja, shape))
    assert int(jkld.leaf_count_sorted(jstate.poses, ja, shape)) == want
    assert int(tkld.leaf_count(tstate.poses, ta, shape)) == want
    assert int(tkld.leaf_count_sorted(tstate.poses, ta, shape)) == want
    _, jflat = jkld.grid_cells(jkld.bin_keys(jstate.poses), ja, shape)
    _, tflat = tkld.grid_cells(tkld.bin_keys(tstate.poses), ta, shape)
    np.testing.assert_array_equal(
        tkld.first_occurrence_flags(tflat, ta, shape).numpy(),
        np.asarray(jkld.first_occurrence_flags(jflat, ja, shape)))
    # the fleet count: this cloud and a shifted copy as two robots
    flat2 = torch.stack([tflat, torch.roll(tflat, 5)])
    act2 = torch.stack([ta, torch.roll(ta, 5)])
    np.testing.assert_array_equal(tkld.leaf_count_fleet(flat2, act2, shape).numpy(),
                                  [want, want])


# --- the systematic fleet -------------------------------------------------

R, FM, FB = 3, 512, 32
FPARAMS = JaxPFParams(min_samples=16, max_samples=FM, hist_x=32, hist_y=32,
                      stats_max_clusters=64)
MEANS = np.array([[0.0, 0.0, 0.1], [1.5, -1.0, 1.2], [-1.2, 1.3, -0.7]], np.float32)
DELTAS = np.tile(np.array([0.05, 0.0, 0.01], np.float32), (R, 1))
ALPHAS = (0.05,) * 5


def _fleet_map():
    rng = np.random.default_rng(7)
    n = 112
    cells = np.full((n, n), int(CellState.FREE), np.int8)
    cells[0:2, :] = cells[-2:, :] = int(CellState.OCCUPIED)
    cells[:, 0:2] = cells[:, -2:] = int(CellState.OCCUPIED)
    for _ in range(6):
        cx, cy = rng.integers(10, n - 16, 2)
        cells[cy:cy + 5, cx:cx + 5] = int(CellState.OCCUPIED)
    jmap = JaxMap.from_cells(cells, 0.05).with_distance_field(1.0)
    return jmap, convert.map_from_numpy(jmap, device="cpu")


def test_systematic_fleet_step_matches_vmapped_resample():
    """fleet_step with resample_model SYSTEMATIC (the batched comb,
    `fleet_resample_systematic`) against the JAX fleet step on "xla", which
    vmaps mcl_step_2d and so `resample`; then the batched comb alone on
    one state, picks exact."""
    jmap, tmap = _fleet_map()
    jsp = jplanar.PlanarScanParams()
    tsp = convert.scan_params_from_numpy(jsp)
    angles = np.linspace(-2.0, 2.0, FB).astype(np.float32)
    ranges = np.tile((1.0 + 0.3 * np.sin(3 * angles)).astype(np.float32), (R, 1))
    jscans = jplanar.PlanarScan(ranges=jnp.asarray(ranges),
                                angles=jnp.asarray(np.tile(angles, (R, 1))),
                                range_max=jnp.full((R,), 4.0, jnp.float32))
    tscans = convert.fleet_scan_from_numpy(jscans, device="cpu")
    covs = np.tile(np.diag([0.02, 0.02, 0.002]).astype(np.float32), (R, 1, 1))
    js = jfleet.fleet_init(FPARAMS, jax.random.PRNGKey(2), MEANS, covs)
    # w_diff 0.2 for every robot: the comb injects pool poses
    js = js.replace(w_slow=jnp.full((R,), 0.5, jnp.float32),
                    w_fast=jnp.full((R,), 0.4, jnp.float32))
    ts = convert.state_from_numpy(js, device="cpu")
    tparams = convert.pf_params_from_jax(FPARAMS)
    pools = np.random.default_rng(4).uniform(-2, 2, (R, FM, 3)).astype(np.float32)
    zeros = np.zeros((R, 3), np.float32)

    normals, starts = [], []
    for k in js.key:
        k1, sub = jax.random.split(k)
        normals.append(np.stack([np.asarray(jax.random.normal(kk, (FM,), dtype=jnp.float32))
                                 for kk in jax.random.split(sub, 3)]))
        starts.append(float(_start(k1)))
    noise = tfleet.FleetNoise(odom=torch.from_numpy(np.stack(normals)), inject=None,
                              pick=None, start=torch.tensor(starts))
    j = jfleet.fleet_step(js, jmap, jsp, jscans, jnp.asarray(pools), jnp.asarray(zeros),
                          jnp.asarray(DELTAS), jnp.asarray(DELTAS), jnp.asarray(ALPHAS),
                          FPARAMS, resample_model=jfilter.ResampleModel.SYSTEMATIC,
                          backend="xla")
    t = tfleet.fleet_step(ts, tmap, tsp, tscans, torch.from_numpy(pools),
                          torch.from_numpy(zeros), torch.from_numpy(DELTAS),
                          torch.from_numpy(DELTAS), ALPHAS, tparams,
                          resample_model=tfilter.ResampleModel.SYSTEMATIC, backend="exact",
                          noise=noise)
    np.testing.assert_array_equal(t.n_active.numpy(), np.asarray(j.n_active))
    close = (np.abs(t.poses.numpy() - np.asarray(j.poses)) <= 1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(t.stats.mean.numpy()[:, :2], np.asarray(j.stats.mean)[:, :2],
                               atol=1e-4)
    np.testing.assert_array_equal(t.w_slow.numpy(), np.asarray(j.w_slow))

    # the batched comb alone, on the same state: exact against the vmap
    vres = jax.vmap(lambda st, pool: jfilter.resample(st, FPARAMS, pool,
                                                      jfilter.ResampleModel.SYSTEMATIC))
    jr = vres(js, jnp.asarray(pools))
    tr = tfilter.fleet_resample_systematic(
        ts, tparams, torch.from_numpy(pools),
        torch.tensor([float(_start(k)) for k in js.key]))
    for i in range(R):
        _assert_same_set(map_tensors(lambda a: a[i], tr),
                         jax.tree_util.tree_map(lambda a: a[i], jr), ts.poses[i].numpy(),
                         pools[i])
    np.testing.assert_array_equal(tr.stats.cluster_count.numpy(),
                                  np.asarray(jr.stats.cluster_count))
    np.testing.assert_allclose(tr.stats.mean.numpy(), np.asarray(jr.stats.mean), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n", [0, 1, 1024, 1025, 50_000, 2_100_000])
def test_blocked_cumsum(n):
    """The resampling picks' scan (`numerics.cumsum_det`, one association
    on every call and every device): exact where the partial sums are
    exact, and within f32 rounding of torch.cumsum otherwise; a single row
    takes the blocked scan, several rows take torch.cumsum."""
    from badger_amcl_tpu_torch.utils.numerics import blocked_cumsum, cumsum_det

    ints = torch.arange(n, dtype=torch.float64) % 7
    assert torch.equal(blocked_cumsum(ints), torch.cumsum(ints, 0))
    w = torch.from_numpy(np.random.default_rng(n).random(n).astype(np.float32))
    w = w / w.sum()
    np.testing.assert_allclose(blocked_cumsum(w).numpy(), torch.cumsum(w, 0).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(cumsum_det(w), blocked_cumsum(w))
    rows = torch.stack([w, w.flip(0)])
    assert torch.equal(cumsum_det(rows), torch.cumsum(rows, -1))
