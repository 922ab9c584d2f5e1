"""PyTorch port: the compiled step's last 2D models on the CPU — corr_q, the
prob model in linear and in log space, beam skipping and the beam model —
each held against the JAX package's jit on the same numpy-seeded inputs,
the JAX draws replayed. The port's `*_jit` entries run eagerly here (a
graph_jit entry runs its function on CPU tensors), under
`control.StrictHostReads`: no host read but the dispatch predicates, every
dispatch arm named in a case taken.

- corr_q (narrow and standard window), `sensor_resample_step_jit` on
  "corr_q" against the JAX step on "pallas_corr_q_interpret" compiled with
  the scan and its parameters closed over: the JAX package's own
  `sensor_resample_step_jit` traces them, so its psi fingerprint is None
  and it rebuilds the f32 table (ROADMAP.md, faults of the reference);
  closed over, its compiled step reads the int8 table, as the port's does.
  tests/test_torch_corr_q.py's 448^2 map with its baked int8 texture.
- The prob model in linear space with its factors folded,
  `mcl_step_2d_jit` against the JAX `mcl_step_2d_jit` on
  "pallas_corr_interpret" (tests/test_torch_compiled.py's 448^2 setup at
  2048 x 64, the tight cloud: the corr table).
- The prob model in log space, the node's `_sensor_update_jit(log_space=
  True)` and `_resample_jit(log_averages=True)` against the JAX node's
  (the same setup, log-domain averages).
- Beam skipping, the node's `_sensor_update_jit(do_beamskip=True)` in both
  weight domains on tests/test_torch_node_2d.py's recorded stream (1000 x
  40, its scans raycast on its map): not converged (every valid beam), converged
  (some beams skipped) and converged past the error threshold (every beam).
- The beam model, `sensor_resample_step_jit` on "corr" against
  "pallas_corr_interpret" on tests/test_torch_beam.py's 320^2 map and range
  image: the lattice table (tight cloud), the spread kernel (spread cloud)
  and the exact raycast (spread cloud, no transposed image).

Tolerances, each as the eager parity tests of these paths: the weights
and w_slow / w_fast updated from a sum of log pz (the prob model with beam
skipping or in log space) rtol 2e-4 (LOG_P_RTOL: log p within 1e-4, as
tests/test_torch_lf_models.py holds it, twice) and atol 1e-12 (XLA's CPU
flushes denormals); after a resample n_active and
the cluster count equal, >= 99.9% of picks equal (after a motion update
within 1e-5), weights equal, statistics rtol 1e-4 / atol 1e-5 against the
JAX statistics of the same set (tests/test_torch_compiled.py's
`_check_state`; the covariance of the log-space resample's 4-pose set
atol 1e-4, COV_ATOL_DEGENERATE).
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_beam as tb
import test_torch_compiled as tc
import test_torch_corr_q as tq
import test_torch_node_2d as n2
from badger_amcl_tpu import mcl as jmcl
from badger_amcl_tpu.node import node as jnode
from badger_amcl_tpu.node import node_2d as jnode2
from badger_amcl_tpu.node.transforms import Transform as JaxTransform
from badger_amcl_tpu.pf import filter as jfilter
from badger_amcl_tpu.pf.filter import ResampleModel as JaxResampleModel
from badger_amcl_tpu.pf.types import PFParams as JaxPFParams
from badger_amcl_tpu.sensors import planar as jplanar
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch import mcl as tmcl
from badger_amcl_tpu_torch.node import node as tnode
from badger_amcl_tpu_torch.node import node_2d as tnode2
from badger_amcl_tpu_torch.node.transforms import Transform
from badger_amcl_tpu_torch.ops import lf_kernel
from badger_amcl_tpu_torch.pf.filter import ResampleModel
from badger_amcl_tpu_torch.sensors import planar as tplanar
from badger_amcl_tpu_torch.utils import control
from badger_amcl_tpu_torch.utils.numerics import SYNCS

torch.set_num_threads(1)
M = 2048
PROB = "likelihood_field_prob"
# a weight out of a sum of log pz over the beams: log p is known to 1e-4
# (test_torch_lf_models.py: the sums run in another order, |sum log pz| up
# to ~300 at 64 beams, where an f32 ulp is 3e-5), and a normalized weight
# exp(log p - log-sum-exp) carries that error twice, relative
LOG_P_RTOL = 2e-4
# XLA's CPU flushes a denormal product (a tiny prior weight times a tiny p)
# to zero where PyTorch keeps it: a weight under 1e-12 may be 0 on one side
# (tests/test_torch_lf_models.py's atol)
DENORMAL_ATOL = 1e-12
# the log-space resample picks 4 distinct poses 0.27 m from the origin out of
# the peaked log weights: the one-pass f32 moments of that set lose up to
# 3e-5 to cancellation in either package (float64: 6.1e-6 where the port
# has 2.8e-6 and JAX 7.3e-6), so its covariance is held to 1e-4, as
# tests/test_torch_node_compiled.py holds the node's
COV_ATOL_DEGENERATE = 1e-4
stream = n2.stream
beam_maps = tb.beam_maps


def _t(x):
    return torch.from_numpy(np.array(x))


def _strict(fn):
    """fn() under StrictHostReads (raising at a host read outside a
    predicate): (its value, the arms it took); SYNCS counts every read."""
    arms0, s0 = collections.Counter(control.ARMS), SYNCS.count
    with control.StrictHostReads() as mode:
        out = fn()
    assert SYNCS.count - s0 == mode.reads
    return out, +(collections.Counter(control.ARMS) - arms0)


def _taken(arms, want):
    for arm in want:
        assert arms[arm] >= 1, (arm, dict(arms))


def _resample_uniforms(key, m):
    _, sub = jax.random.split(key)
    k1, k2 = jax.random.split(sub)
    return _t(jax.random.uniform(k1, (m,))), _t(jax.random.uniform(k2, (m,)))


def _jax_state(jparams, poses, seed=3):
    return jfilter.init_with_poses(jparams, jax.random.PRNGKey(seed), jnp.asarray(poses))


def _box_poses(hx, hy, ha, m=M, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-hx, hx, m), rng.uniform(-hy, hy, m),
                     rng.uniform(-ha, ha, m)], axis=1).astype(np.float32)


# --- corr_q -----------------------------------------------------------------------

# window: (y half-width in m, the corr_q window arm): 24 or 56 rows of 0.05 m
Q_WINDOWS = {"narrow": (0.6, "corr_q.window.narrow:true"),
             "standard": (1.4, "corr_q.window.narrow:false")}


@functools.lru_cache(maxsize=None)
def _jax_q_step():
    """The JAX step on the int8 table, compiled with the map, scan and
    parameters closed over (module docstring)."""
    jmap, jsp, _, _ = tq._maps("likelihood_field")
    jscan, _ = tq._scan()
    jparams = JaxPFParams(min_samples=256, max_samples=M)
    return jparams, jax.jit(lambda state, pool: jmcl.sensor_resample_step(
        state, jmap, jsp, jscan, pool, jparams, backend="pallas_corr_q_interpret"))


@pytest.mark.parametrize("window", list(Q_WINDOWS))
def test_corr_q_step_jit_matches(window):
    hy, arm = Q_WINDOWS[window]
    _, _, tmap, tsp = tq._maps("likelihood_field")
    _, tscan = tq._scan()
    jparams, jstep = _jax_q_step()
    jstate = _jax_state(jparams, _box_poses(0.4, hy, 0.1, seed=4))
    pool = np.random.default_rng(2).uniform(-3.0, 3.0, (M, 3)).astype(np.float32)
    want = jstep(jstate, jnp.asarray(pool))
    inject, pick = _resample_uniforms(jstate.key, M)
    tstate, tpool = convert.state_from_numpy(jstate, device="cpu"), _t(pool)
    got, arms = _strict(lambda: tmcl.sensor_resample_step_jit(
        tstate, tmap, tsp, tscan, tpool, convert.pf_params_from_jax(jparams),
        backend="corr_q", noise=tmcl.StepNoise(odom=None, inject=inject, pick=pick)))
    # the corr_q window arms lie on the int8 table's path alone
    _taken(arms, ["corr.fits:true", arm, "corr.all_on_map:true"])
    tc._check_state(got, want, jparams)


# --- the prob model ---------------------------------------------------------------


def test_prob_linear_mcl_step_jit_matches():
    """mcl_step_2d_jit on the prob model: linear space, the factors folded
    into the corr table's read."""
    (jmap, jparams, jstate, jscan, jsp, jpool), (tmap, tparams, tstate, tscan, tsp,
                                                 tpool) = tc._setup()
    want = jmcl.mcl_step_2d_jit(jstate, jmap, jsp, jscan, jpool,
                                *(jnp.asarray(v, jnp.float32) for v in (*tc.ODOM, tc.ALPHAS)),
                                params=jparams, laser_model=PROB,
                                backend="pallas_corr_interpret")
    noise = tc._step_noise(jstate.key, M)
    odom = [torch.tensor(v) for v in tc.ODOM]
    got, arms = _strict(lambda: tmcl.mcl_step_2d_jit(
        tstate, tmap, tsp, tscan, tpool, *odom, tc.ALPHAS, tparams, laser_model=PROB,
        backend="corr", noise=noise))
    _taken(arms, ["corr.fits:true", "corr.all_on_map:true", "corr.window.tight:true",
                  "resample.u_count:true"])
    tc._check_state(got, want, jparams, pose_atol=1e-5)


def test_prob_log_space_node_jits_match():
    """The node's log-space pipeline: `_sensor_update_jit(log_space=True)`
    (log p into sensor_update_log over log-domain averages) on the corr
    table, then `_resample_jit(log_averages=True)`, each against the JAX
    node's jit."""
    (jmap, jparams, jstate, jscan, jsp, jpool), (tmap, tparams, tstate, tscan, tsp,
                                                 tpool) = tc._setup()
    jstate = jfilter.init_log_averages(jstate)
    tstate = convert.state_from_numpy(jstate, device="cpu")
    ju = jnode2._sensor_update_jit(jstate, jmap, jsp, jscan, PROB, False,
                                   "pallas_corr_interpret", log_space=True)
    tu, arms = _strict(lambda: tnode2._sensor_update_jit(tstate, tmap, tsp, tscan, PROB,
                                                         False, "corr", log_space=True))
    _taken(arms, ["corr.fits:true", "corr.window.tight:true"])
    np.testing.assert_allclose(tu.weights.numpy(), np.asarray(ju.weights), rtol=LOG_P_RTOL,
                               atol=DENORMAL_ATOL)
    for f in ("w_slow", "w_fast"):
        np.testing.assert_allclose(float(getattr(tu, f)), float(getattr(ju, f)),
                                   rtol=LOG_P_RTOL)
    # the resample over log-domain averages, from the JAX node's updated state
    tu = convert.state_from_numpy(ju, device="cpu")
    want = jnode._resample_jit(ju, jparams, jpool, JaxResampleModel.MULTINOMIAL, True)
    inject, pick = _resample_uniforms(ju.key, M)
    got, arms = _strict(lambda: tnode._resample_jit(
        tu, tparams, tpool, model=ResampleModel.MULTINOMIAL, log_averages=True,
        u_inject=inject, u_pick=pick))
    _taken(arms, ["resample.u_count:true", "cluster.stats_width:true"])
    tc._check_state(got, want, jparams, cov_atol=COV_ATOL_DEGENERATE)
    for f in ("w_slow", "w_fast"):
        assert float(getattr(got, f)) == float(getattr(want, f)), f


# --- beam skipping ----------------------------------------------------------------


@pytest.fixture(scope="module")
def skip_nodes(stream):
    """(jax node, port node) after four scans of the recorded stream, the
    port's state converted from the JAX node's."""
    grid, steps = stream
    jn, jtf, tn, ttf = n2._nodes(grid, {"resample_interval": 1000})
    for step in steps[:5]:
        n2._feed(jn, jtf, JaxTransform, step, False)
        n2._feed(tn, ttf, Transform, step, True)
    return jn, tn


# state: (converged, beam_skip_distance): at the default 0.5 m the tracked
# cloud agrees on 23 of the 40 beams (the 10 invalid ones among the 17
# skipped), at 1e-4 m (an endpoint on an occupied cell) on none, past the
# error threshold: every beam counts and the invalid ones give log 0
SKIP_STATES = {"not_converged": (False, 0.5), "converged": (True, 0.5),
               "error": (True, 1e-4)}


def _skipped(tn, tstate, params):
    """How many beams the skip rule drops for tstate's cloud."""
    scan = tn.latest_scan
    spose = tplanar.coord_add(params.scanner_pose, tstate.poses)
    counts = lf_kernel.lf_obs_counts(tn.map, tn.map.distances, spose, scan.ranges,
                                     scan.angles, scan.valid(), tstate.active_mask,
                                     params.beam_skip_distance)
    kept = counts.float() / tstate.n_active.float() > params.beam_skip_threshold
    return int((~kept).sum()), int(scan.ranges.shape[0])


@pytest.mark.parametrize("log_space", [False, True], ids=["linear", "log"])
@pytest.mark.parametrize("state", list(SKIP_STATES))
def test_beamskip_sensor_update_jit_matches(skip_nodes, state, log_space):
    jn, tn = skip_nodes
    converged, distance = SKIP_STATES[state]
    jstate = jn.state.replace(converged=jnp.asarray(converged))
    if log_space:
        jstate = jfilter.init_log_averages(jstate)
    jsp = jn.scanner_params[0].replace(beam_skip_distance=jnp.float32(distance))
    tsp = dataclasses.replace(tn.scanner_params[0],
                              beam_skip_distance=float(np.float32(distance)))
    tstate = convert.state_from_numpy(jstate, device="cpu")
    skipped, beams = _skipped(tn, tstate, tsp)
    error = skipped >= beams * tsp.beam_skip_error_threshold
    assert error == (state == "error") and (state != "converged" or skipped > 0)
    want = jnode2._sensor_update_jit(jstate, jn.map, jsp, jn.latest_scan, PROB, True,
                                     "pallas_corr_interpret", log_space=log_space)
    got, arms = _strict(lambda: tnode2._sensor_update_jit(
        tstate, tn.map, tsp, tn.latest_scan, PROB, True, "corr", log_space=log_space))
    assert set(arms) <= {"lf.window_fits:true", "lf.window_fits:false"}
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=LOG_P_RTOL, atol=DENORMAL_ATOL)
    for f in ("w_slow", "w_fast"):
        np.testing.assert_allclose(float(getattr(got, f)), float(getattr(want, f)),
                                   rtol=LOG_P_RTOL)
    if state == "error":
        # every beam counts and the invalid ones give log 0 for every
        # particle: the zero-total reset to uniform weights
        uniform = torch.where(tstate.active_mask, 1.0 / tstate.n_active.float(), 0.0)
        assert torch.equal(got.weights, uniform)
    else:  # skipping moves the weights once the filter has converged
        unskipped = tnode2._sensor_update_jit(tstate.replace(converged=torch.tensor(False)),
                                              tn.map, tsp, tn.latest_scan, PROB, True, "corr",
                                              log_space=log_space)
        assert torch.equal(got.weights, unskipped.weights) == (state == "not_converged")


# --- the beam model ---------------------------------------------------------------

# arm: (cloud of tests/test_torch_beam.py, the transposed image kept, arms)
BEAM_ARMS = {"table": ("tight", True, ["beam.fits:true", "beam.window.tight:true"]),
             "spread": ("spread", True, ["beam.fits:false"]),
             "exact": ("spread", False, ["beam.fits:false"])}


@functools.lru_cache(maxsize=None)
def _jax_beam_step():
    return jax.jit(functools.partial(jmcl.sensor_resample_step, laser_model="beam",
                                     backend="pallas_corr_interpret"),
                   static_argnames=("params",))


@pytest.mark.parametrize("arm", list(BEAM_ARMS))
def test_beam_step_jit_matches(beam_maps, arm):
    cloud, rows_kept, want_arms = BEAM_ARMS[arm]
    jmap, tmap, _ = beam_maps
    if not rows_kept:
        jmap = dataclasses.replace(jmap, range_rows=None)
        tmap = dataclasses.replace(tmap, range_rows=None)
    jscan, tscan = tb._scan()
    jsp = jplanar.PlanarScanParams()
    jparams = JaxPFParams(min_samples=256, max_samples=M)
    jstate = _jax_state(jparams, tb._poses(cloud, seed=1))
    pool = np.random.default_rng(5).uniform(-3.0, 3.0, (M, 3)).astype(np.float32)
    assert tplanar.beam_arm(tmap, tscan, _t(jstate.poses)) == arm
    want = _jax_beam_step()(jstate, jmap, jsp, jscan, jnp.asarray(pool), params=jparams)
    inject, pick = _resample_uniforms(jstate.key, M)
    tstate, tpool = convert.state_from_numpy(jstate, device="cpu"), _t(pool)
    got, arms = _strict(lambda: tmcl.sensor_resample_step_jit(
        tstate, tmap, tplanar.PlanarScanParams(), tscan, tpool,
        convert.pf_params_from_jax(jparams), laser_model="beam", backend="corr",
        noise=tmcl.StepNoise(odom=None, inject=inject, pick=pick)))
    _taken(arms, want_arms)
    tc._check_state(got, want, jparams)
