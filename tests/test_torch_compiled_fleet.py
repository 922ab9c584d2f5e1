"""PyTorch port: the last compiled entries on the CPU — the fleet step
(`fleet.make_fleet_step`), the cell contract
(`mcl.sensor_resample_step_jit(resample_contract="cell")`) and the capped
statistics (`PFParams.stats_max_clusters`) — each held against the JAX
package's jit on the same numpy-seeded inputs, the JAX draws replayed. A
graph_jit entry runs its function eagerly on CPU tensors, so every case
runs under `control.StrictHostReads`: no host read but the named cond
predicates (SYNCS counts every read), and the named arms of the case
taken.

- The fleet step: tests/test_torch_fleet.py's 448^2 map and fleet (R = 4,
  M = 256, B = 48), against JAX's `make_fleet_step` on
  "pallas_corr_interpret", two chained steps, both resamplers, on three
  fleets: every robot tight (the batched table, "fleet.fits:true"), one
  spread robot ("fleet.fits:false", the robots one by one), and the tight
  fleet over FLEET_U_MAX, patched low on both sides as
  test_fleet_resample_matches patches it ("cluster.fleet_u:false", the
  batched grid ranks). Tolerances of test_torch_fleet.py's fleet step:
  n_active exact, >= 99% of poses within 1e-4, set means within 1e-4.
- The batched grid-rank arm, `cluster._ranks_grid_fleet`, against the
  per-robot `_ranks_grid_path`: equal ranks and counts, robot by robot;
  the true arm of "cluster.fleet_u" equal to it on every active particle.
- `control.fori_loop` on the CPU: the Python loop, each body counted.
- The cell step: tests/test_torch_resample_cells.py's world at 2048 x 64
  against JAX's `sensor_resample_step_jit(resample_contract="cell")` on
  "pallas_corr_interpret": the cell arm, and each classic trigger of
  test_precondition_violation_takes_pick_step (particles off the map,
  more than CELL_U_MAX cells with the cap patched to 128 on both sides,
  unequal weights, no active particle): the cell arm at that file's
  resample tolerances (>= 99.9% of picks equal, n_active and the cluster
  count equal, w_slow / w_fast within 1e-6, statistics within 1e-5), the
  pick step at test_torch_compiled.py's (`_check_state`: n_active, the
  weights and the cluster count equal, >= 99.9% of picks equal, the
  statistics against JAX's of the same set within rtol 1e-4 / atol
  1e-5).
- The capped statistics: `sensor_resample_step_jit` (multinomial and
  systematic) and `mcl_step_2d_jit` with stats_max_clusters=8 against the
  JAX jits (tests/test_torch_compiled.py's setup and `_check_state`, the
  exact arms), and `compute_cluster_stats` of a capped cloud of many
  clusters through both arms of "cluster.sorted" against JAX's grid path:
  equal ranks.

The JAX jits come from `functools.lru_cache`d builders, one per static
case (a patched module constant needs its own trace).
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_compiled as tc
import test_torch_fleet as tf
import test_torch_resample_cells as trc
from badger_amcl_tpu import mcl as jmcl
from badger_amcl_tpu.fleet import fleet as jfleet
from badger_amcl_tpu.pf import cluster as jcluster
from badger_amcl_tpu.pf import filter as jfilter
from badger_amcl_tpu.pf.filter import ResampleModel as JaxResampleModel
from badger_amcl_tpu.pf.types import PFParams as JaxPFParams
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch import fleet as tfleet
from badger_amcl_tpu_torch import mcl as tmcl
from badger_amcl_tpu_torch.pf import cluster as tcluster
from badger_amcl_tpu_torch.pf import filter as tfilter
from badger_amcl_tpu_torch.pf.filter import ResampleModel
from badger_amcl_tpu_torch.utils import control
from badger_amcl_tpu_torch.utils.numerics import SYNCS

torch.set_num_threads(1)
maps = tf.maps
world = trc.world
R, M = tf.R, tf.M


def _strict(fn):
    """fn() under StrictHostReads (collecting): (its value, the arms it
    took); no read outside a predicate, and SYNCS counts every read."""
    arms0, s0 = collections.Counter(control.ARMS), SYNCS.count
    with control.StrictHostReads(raise_on_read=False) as mode:
        out = fn()
    assert mode.untracked == []
    assert SYNCS.count - s0 == mode.reads
    return out, +(collections.Counter(control.ARMS) - arms0)


def _taken(arms, want):
    for arm in want:
        assert arms[arm] >= 1, (arm, dict(arms))


# --- the fleet step ---------------------------------------------------------------

FLEETS = {
    # fleet: (spread robot, FLEET_U_MAX patch, arms taken)
    "tight": (None, None, ["fleet.fits:true", "cluster.fleet_u:true"]),
    "spread_robot": (2, None, ["fleet.fits:false", "fleet.robot:body", "corr.fits:false",
                               "corr.fits:true"]),
    "over_fleet_u": (None, 8, ["fleet.fits:true", "cluster.fleet_u:false"]),
}


@functools.lru_cache(maxsize=None)
def _jax_fleet_step(resample_model, u_max):
    """JAX's make_fleet_step, one jit per resampler and FLEET_U_MAX (traced
    at its first call, under the test's patch)."""
    return jfleet.make_fleet_step(tf.JPARAMS, resample_model=resample_model,
                                  backend="pallas_corr_interpret")


def _fleet_noise(keys, resample_model):
    """The JAX fleet step's draws per robot (test_torch_fleet._step_noise);
    the systematic comb's start from the resample key's split
    (filter.py:476, 496)."""
    noise, after = tf._step_noise(keys)
    if resample_model == ResampleModel.SYSTEMATIC:
        starts = [np.asarray(jax.random.uniform(jax.random.split(jax.random.split(k)[0])[1],
                                                ())) for k in keys]
        noise = dataclasses.replace(noise, start=torch.from_numpy(np.stack(starts)))
    return noise, after


@pytest.mark.parametrize("resample_model", list(ResampleModel))
@pytest.mark.parametrize("fleet", list(FLEETS))
def test_compiled_fleet_step_matches_jax(maps, fleet, resample_model, monkeypatch):
    spread_robot, u_max, want_arms = FLEETS[fleet]
    if resample_model == ResampleModel.SYSTEMATIC:  # the comb reads no composite key
        want_arms = [a for a in want_arms if a != "cluster.fleet_u:true"]
    if u_max is not None:
        monkeypatch.setattr(jcluster, "FLEET_U_MAX", u_max)
        monkeypatch.setattr(tcluster, "FLEET_U_MAX", u_max)
    jmap, jsp, tmap, tsp = maps
    jscans, tscans = tf._scans()
    js, ts = tf._fleet(spread_robot)
    tparams = convert.pf_params_from_jax(tf.JPARAMS)
    jstep = _jax_fleet_step(JaxResampleModel(int(resample_model)),
                            u_max if resample_model == ResampleModel.MULTINOMIAL else None)
    tstep = tfleet.make_fleet_step(tparams, resample_model=resample_model, backend="corr")
    assert tstep.graph is tfleet.make_fleet_step(tparams).graph  # one graph_jit wrapper
    zeros = np.zeros((R, 3), np.float32)
    pools = np.random.default_rng(4).uniform(-3, 3, (R, M, 3)).astype(np.float32)
    # the odometry as tensors: host data would be copied in before a replay
    args = [torch.from_numpy(x) for x in (pools, zeros, tf.DELTAS, tf.DELTAS)]
    keys = list(js.key)
    arms = collections.Counter()
    for _ in range(2):
        js = jstep(js, jmap, jsp, jscans, jnp.asarray(pools), jnp.asarray(zeros),
                   jnp.asarray(tf.DELTAS), jnp.asarray(tf.DELTAS), jnp.full((5,), 0.05))
        noise, keys = _fleet_noise(keys, resample_model)
        ts, taken = _strict(lambda: tstep(ts, tmap, tsp, tscans, *args, tf.ALPHAS,
                                          noise=noise))
        arms.update(taken)
    _taken(arms, want_arms)
    np.testing.assert_array_equal(ts.n_active.numpy(), np.asarray(js.n_active))
    close = (np.abs(ts.poses.numpy() - np.asarray(js.poses)) <= 1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(ts.stats.mean.numpy()[:, :2], np.asarray(js.stats.mean)[:, :2],
                               atol=1e-4)


def test_sharded_fleet_step_is_the_compiled_step(maps):
    """A one-rank gloo group: the sharded step's local step is the compiled
    one (the same graph_jit wrapper) and equals it on the same draws;
    fleet_health without a group is three means, with no host read."""
    import os
    import tempfile

    _, _, tmap, tsp = maps
    tparams = convert.pf_params_from_jax(tf.JPARAMS)
    _, ts = tf._fleet()
    _, tscans = tf._scans()
    zeros = torch.zeros((R, 3))
    deltas = torch.from_numpy(tf.DELTAS)
    pools = torch.from_numpy(np.random.default_rng(4).uniform(-3, 3, (R, M, 3))
                             .astype(np.float32))
    noise = tfleet.FleetNoise.draw(torch.Generator().manual_seed(1), R, M, "cpu")
    want = tfleet.make_fleet_step(tparams)(ts, tmap, tsp, tscans, pools, zeros, deltas,
                                          deltas, tf.ALPHAS, noise=noise)
    with tempfile.TemporaryDirectory() as d:
        group = tfleet.init_fleet_group("file://" + os.path.join(d, "store"), 1, 0,
                                        device="cpu")
        try:
            step = tfleet.make_sharded_fleet_step(group, tparams, device="cpu", n_robots=R)
            assert step.graph is tfleet.make_fleet_step(tparams).graph
            got, _ = _strict(lambda: step(ts, tmap, tsp, tscans, pools, zeros, deltas, deltas,
                                          tf.ALPHAS, noise=noise))
        finally:
            torch.distributed.destroy_process_group()
    for f in ("poses", "weights", "n_active", "converged"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    health, _ = _strict(lambda: tfleet.fleet_health(got))
    assert float(health["mean_active"]) == float(got.n_active.float().mean())


def test_fori_loop_eager_is_a_python_loop():
    """control.fori_loop on CPU tensors: body(i, carry) for i = 0..n-1, i a
    Python int, the carry updated in place or replaced, each execution
    counted as "name:body", no host read; the warm-up counts none."""
    table = torch.arange(5, dtype=torch.float32)

    def body(i, carry):
        acc, rows = carry
        rows[i] = table[i] * 2
        return acc + table[i], rows

    (acc, rows), arms = _strict(lambda: control.fori_loop(
        5, body, (torch.zeros(()), torch.zeros(5)), name="probe"))
    assert float(acc) == 10.0 and torch.equal(rows, table * 2)
    assert arms == {"probe:body": 5}
    arms0 = collections.Counter(control.ARMS)
    with control.all_arms():
        control.fori_loop(3, body, (torch.zeros(()), torch.zeros(5)), name="probe")
    assert control.ARMS == arms0


# --- the batched grid-rank arm ----------------------------------------------------

@pytest.mark.parametrize("seed,n_active", [(3, [M, M - 40, 17, M]), (8, [M, M, M, M]),
                                           (5, [1, 0, M // 2, M - 1])])
def test_batched_grid_ranks_equal_per_robot(seed, n_active):
    _, tflat, active = tf._flat_clouds(seed, n_active)
    act = torch.from_numpy(active)
    flat_act = torch.where(act, tflat, 0)
    (rank_p, count), _ = _strict(lambda: tcluster._ranks_grid_fleet(flat_act, act,
                                                                     tf.JPARAMS.hist_shape))
    assert rank_p.shape == (R, M) and count.shape == (R,)
    for i in range(R):
        want_p, want_c = tcluster._ranks_grid_path(flat_act[i], act[i], tf.JPARAMS.hist_shape)
        assert torch.equal(rank_p[i], want_p), i
        assert int(count[i]) == int(want_c), i
    # and the cond's true arm, where the fleet fits its capacity, agrees on
    # every active particle
    (ranks_u, count_u), arms = _strict(lambda: tcluster._ranks_fleet(flat_act, act,
                                                                     tf.JPARAMS.hist_shape))
    _taken(arms, ["cluster.fleet_u:true"])
    assert torch.equal(count_u, count)
    assert torch.equal(ranks_u[act], rank_p[act])


# --- the cell contract ------------------------------------------------------------

CELL_CASES = {
    # case: (cloud, CELL_U_MAX patch, state change, arms taken)
    "cell": ("tracking", None, None, ["cells.ok:true", "resample.u_count:true"]),
    "off_map": ("off_map", None, None,
                ["cells.ok:false", "corr.fits:true", "corr.all_on_map:false"]),
    # ~320 cells, against a cap of 128 (JAX's cell arm needs 128 | CELL_U_MAX)
    "too_many_cells": ("wide", 128, None, ["cells.ok:false", "corr.fits:true"]),
    "non_uniform": ("tracking", None, "non_uniform", ["cells.ok:false", "corr.fits:true"]),
    "no_active": ("tracking", None, "no_active", ["cells.ok:false"]),
}


# the wide cloud's ~320 lattice cells give its particles as many distinct
# likelihoods, each a sum whose order differs between the plain table and
# the JAX interpret kernel in the last ulp, and a pick flips where such a
# difference moves a cumulative weight across its draw: 3 of 2048 (0.15%)
WIDE_PICKS = 0.998
# the off-map cloud's set lies 11.2 m from the origin: its one-pass f32
# covariance E[x^2] - E[x]^2 cancels two ~125 m^2 terms whose f32 ulp is
# 7.6e-6, in either package (3.4e-5 apart on the same set)
FAR_COV_ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_cell_step(u_max):
    """JAX's sensor_resample_step under the cell contract on
    pallas_corr_interpret, one jit per CELL_U_MAX (traced at its first
    call, under the test's patch)."""
    if u_max is None:
        return functools.partial(jmcl.sensor_resample_step_jit, backend=trc.BACKEND_J,
                                 resample_contract="cell")
    return jax.jit(lambda *a, params: jmcl.sensor_resample_step(
        *a, params, backend=trc.BACKEND_J, resample_contract="cell"),
        static_argnames=("params",))


def _cell_world(world, cloud):
    """test_torch_resample_cells._step_world's states, or for "wide" the
    tracking cloud at 0.1 m (in the lattice envelope, over 128 cells)."""
    if cloud != "wide":
        return trc._step_world(world, cloud)
    rng = np.random.default_rng(1)
    poses = np.concatenate([np.asarray((0.3, -0.2)) + 0.1 * rng.standard_normal((trc.M, 2)),
                            0.01 * rng.standard_normal((trc.M, 1))], axis=1).astype(np.float32)
    jpf = JaxPFParams(min_samples=256, max_samples=trc.M)
    js = jfilter.init_with_poses(jpf, jax.random.PRNGKey(5), jnp.asarray(poses))
    pool = np.random.default_rng(6).uniform(-3.0, 3.0, (trc.M, 3)).astype(np.float32)
    return ((js, jpf, jnp.asarray(pool)),
            (convert.state_from_numpy(js, device="cpu"), convert.pf_params_from_jax(jpf),
             torch.from_numpy(pool)))


def _changed(js, ts, change):
    """Both states with unequal active weights or no active particle."""
    if change == "non_uniform":
        w = np.full((trc.M,), 1.0, np.float32)
        w[:7] = 1.5
        w = (w / w.sum()).astype(np.float32)
        return js.replace(weights=jnp.asarray(w)), ts.replace(weights=torch.from_numpy(w))
    if change == "no_active":
        return (js.replace(n_active=jnp.int32(0), weights=jnp.zeros((trc.M,), jnp.float32)),
                ts.replace(n_active=torch.tensor(0, dtype=torch.int32),
                           weights=torch.zeros(trc.M)))
    return js, ts


@pytest.mark.parametrize("case", list(CELL_CASES))
def test_compiled_cell_step_matches_jax(world, case, monkeypatch):
    cloud, u_max, change, want_arms = CELL_CASES[case]
    if u_max is not None:
        monkeypatch.setattr(jfilter, "CELL_U_MAX", u_max)
        monkeypatch.setattr(tfilter, "CELL_U_MAX", u_max)
    jmap, jparams, jscan, tmap, tparams, tscan = world
    (js, jpf, jpool), (ts, tpf, tpool) = _cell_world(world, cloud)
    js, ts = _changed(js, ts, change)
    want = _jax_cell_step(u_max)(js, jmap, jparams, jscan, jpool, params=jpf)
    noise = tmcl.StepNoise(None, *trc._replayed(js.key, trc.M))
    cell_arms = collections.Counter(tfilter.CELL_ARMS)
    got, arms = _strict(lambda: tmcl.sensor_resample_step_jit(
        ts, tmap, tparams, tscan, tpool, tpf, backend="corr", resample_contract="cell",
        noise=noise))
    _taken(arms, want_arms)
    # the eager step's own counter agrees with the cond's
    took = "cell" if case == "cell" else "classic"
    assert tfilter.CELL_ARMS[took] == cell_arms[took] + 1
    if case == "cell":
        trc._assert_close_resample(got, want, case)
        return
    # the pick contract's step, at test_torch_compiled.py's tolerances but
    # for two: the wide cloud's picks and the far cloud's covariance
    same = (got.poses.numpy() == np.asarray(want.poses)).all(axis=1)
    assert same.mean() >= (WIDE_PICKS if cloud == "wide" else 0.999), same.mean()
    tc._check_state(got, want, jpf, pose_atol=np.inf,  # the picks are held above
                    cov_atol=FAR_COV_ATOL if cloud == "off_map" else 1e-5)


# --- the capped statistics ---------------------------------------------------------

CAP = 8


def _capped():
    (jmap, jparams, jstate, jscan, jsp, jpool), t = tc._setup()
    jp = dataclasses.replace(jparams, stats_max_clusters=CAP)
    tp = dataclasses.replace(t[1], stats_max_clusters=CAP)
    return (jmap, jp, jstate, jscan, jsp, jpool), (t[0], tp, *t[2:])


@pytest.mark.parametrize("resample_model", list(ResampleModel))
def test_capped_sensor_resample_step_jit_matches(resample_model):
    """The capped statistics through sensor_resample_step_jit, the exact
    arms (JAX "xla"): the capped multinomial arm, or the systematic comb
    from the grid leaf count."""
    (jmap, jp, jstate, jscan, jsp, jpool), (tmap, tp, tstate, tscan, tsp, tpool) = _capped()
    m = jp.max_samples
    j = jmcl.sensor_resample_step_jit(jstate, jmap, jsp, jscan, jpool, params=jp,
                                      resample_model=JaxResampleModel(int(resample_model)),
                                      backend="xla")
    noise = tc._resample_noise(jstate.key, m)
    if resample_model == ResampleModel.SYSTEMATIC:
        _, sub = jax.random.split(jstate.key)
        noise = tmcl.StepNoise(odom=None, inject=torch.zeros(m), pick=torch.zeros(m),
                               start=torch.tensor(np.asarray(jax.random.uniform(sub, ()))))
    t, arms = _strict(lambda: tmcl.sensor_resample_step_jit(
        tstate, tmap, tsp, tscan, tpool, tp, resample_model=resample_model, backend="exact",
        noise=noise))
    _taken(arms, ["cluster.sorted:true"])
    assert "resample.u_count:true" not in arms  # the capped arm, not the fused one
    tc._check_state(t, j, jp)
    assert t.stats.cluster_weights.shape == (m,)
    assert not t.stats.cluster_valid[CAP:].any()


def test_capped_mcl_step_2d_jit_matches():
    (jmap, jp, jstate, jscan, jsp, jpool), (tmap, tp, tstate, tscan, tsp, tpool) = _capped()
    j = jmcl.mcl_step_2d_jit(jstate, jmap, jsp, jscan, jpool,
                             *(jnp.asarray(v, jnp.float32) for v in (*tc.ODOM, tc.ALPHAS)),
                             params=jp, backend="xla")
    noise = tc._step_noise(jstate.key, jp.max_samples)
    odom = [torch.tensor(v) for v in tc.ODOM]
    t, arms = _strict(lambda: tmcl.mcl_step_2d_jit(tstate, tmap, tsp, tscan, tpool, *odom,
                                                   tc.ALPHAS, tp, backend="exact",
                                                   noise=noise))
    _taken(arms, ["cluster.sorted:true"])
    tc._check_state(t, j, jp, pose_atol=1e-5)


_jax_capped_stats = jax.jit(jcluster.compute_cluster_stats, static_argnames=("params",))


@pytest.mark.parametrize("max_unique", [None, 16])
def test_capped_cluster_stats_ranks_equal_jax_grid_path(max_unique, monkeypatch):
    """A cloud of 24 separate blobs (more clusters than the cap): the port's
    capped compute_cluster_stats ranks through "cluster.sorted" (its true
    arm, or with MAX_UNIQUE_BINS patched low its grid arm); JAX's capped
    one goes straight to the grid path. Equal ranks, counts and validity;
    the clusters past the cap drop out of both."""
    if max_unique is not None:
        monkeypatch.setattr(tcluster, "MAX_UNIQUE_BINS", max_unique)
    rng = np.random.default_rng(17)
    m = 1024
    centers = rng.uniform(-8.0, 8.0, (24, 2))
    blob = rng.integers(0, 24, m)
    poses = np.concatenate([centers[blob] + 0.05 * rng.standard_normal((m, 2)),
                            0.05 * rng.standard_normal((m, 1))], axis=1).astype(np.float32)
    w = rng.uniform(0.5, 1.5, m).astype(np.float32)
    w /= w.sum()
    active = np.arange(m) < m - 100
    jp = dataclasses.replace(tf.JPARAMS, max_samples=m, stats_max_clusters=CAP)
    tp = convert.pf_params_from_jax(jp)
    want = _jax_capped_stats(jnp.asarray(poses), jnp.asarray(w), jnp.asarray(active), params=jp)
    args = [torch.from_numpy(x) for x in (poses, w, active)]
    got, arms = _strict(lambda: tcluster.compute_cluster_stats(*args, tp))
    _taken(arms, [f"cluster.sorted:{str(max_unique is None).lower()}"])
    assert int(want.cluster_count) > CAP
    assert int(got.cluster_count) == int(want.cluster_count)
    np.testing.assert_array_equal(got.particle_cluster.numpy(),
                                  np.asarray(want.particle_cluster))
    np.testing.assert_array_equal(got.cluster_valid.numpy(), np.asarray(want.cluster_valid))
    np.testing.assert_array_equal(got.cluster_counts.numpy(), np.asarray(want.cluster_counts))
    np.testing.assert_allclose(got.cluster_weights.numpy(), np.asarray(want.cluster_weights),
                               atol=1e-6)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=1e-5)
