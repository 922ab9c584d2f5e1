"""PyTorch port: the compiled 2D step's contract on the CPU.

- `utils.control`: `cond` both ways, nested and on read bools, one counted
  host sync per tensor predicate and none per bool; `read`, several
  predicates in one sync; `while_loop` against a Python loop; `all_arms`.
- `StrictHostReads` traps every host read (and every tensor made from host
  data) outside a predicate read, and the slice's step, run under it on
  inputs that drive each arm of its dispatch tree, makes none: the eager
  step's `SYNCS` count equals the strict mode's count of predicate reads,
  so it counts every host read.
- `utils.tree`, the one walker of nested tensor structures, and
  `corr_kernel.window_variant`, which reads `window_cond`'s choice.
- `ops.cluster_kernel.cluster_labels` (its plain version here) against the
  JAX package's `_cluster_grid`: equal labels.
- `mcl_step_2d_jit`, `sensor_resample_step_jit` and `likelihood_only_jit`
  against the JAX package's same-named jits at 2048 x 64 on a 448^2 map
  (the CPU runs the port's jits eagerly; the resampling step on "corr"
  against "pallas_corr_interpret", the other two on the exact arms, whose
  JAX compiles are quick), with tests/test_torch_slice.py's tolerances:
  likelihoods rtol 1e-5; equal n_active, weights and cluster count,
  >= 99.9% equal picks (after the motion update within atol 1e-5),
  statistics rtol 1e-4 / atol 1e-5 against the JAX statistics of the same
  set; `sensor_resample_step_jit` with the systematic resampler (the comb's
  start replayed from the JAX key) likewise, on the exact arms. Every
  static configuration runs.
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_setup
from badger_amcl_tpu import mcl as jmcl
from badger_amcl_tpu.pf import cluster as jcluster
from badger_amcl_tpu_torch import convert, scenario
from badger_amcl_tpu_torch import mcl as tmcl
from badger_amcl_tpu_torch.ops import cluster_kernel, corr_kernel
from badger_amcl_tpu_torch.pf import cluster as tcluster
from badger_amcl_tpu_torch.pf.filter import ResampleModel
from badger_amcl_tpu_torch.sensors.planar import PlanarScan
from badger_amcl_tpu_torch.utils import control, tree
from badger_amcl_tpu_torch.utils.numerics import SYNCS

torch.set_num_threads(1)
BACKEND_J = "pallas_corr_interpret"
N_PARTICLES, N_BEAMS, MAP_CELLS = 2048, 64, 448
ODOM = ([0.1, 0.0, 0.02], [0.1, 0.0, 0.02], [0.1, 0.0, 0.02])
ALPHAS = [0.1] * 5


def _syncs_and_arms(fn):
    """(fn's value, host syncs it took, arms it took)."""
    before, arms = SYNCS.count, collections.Counter(control.ARMS)
    out = fn()
    return out, SYNCS.count - before, +(collections.Counter(control.ARMS) - arms)


# --- the helpers ---------------------------------------------------------------


@pytest.mark.parametrize("pred", [True, False])
def test_cond_both_ways(pred):
    x = torch.arange(4.0)
    out, syncs, arms = _syncs_and_arms(lambda: control.cond(
        torch.tensor(pred), lambda v: v * 2, lambda v: v + 100, x, name="t"))
    assert torch.equal(out, x * 2 if pred else x + 100)
    assert syncs == 1 and arms == {f"t:{str(pred).lower()}": 1}
    # a read bool takes its arm with no host read
    out, syncs, arms = _syncs_and_arms(lambda: control.cond(
        pred, lambda: x * 2, lambda: x + 100, name="t"))
    assert torch.equal(out, x * 2 if pred else x + 100) and syncs == 0


def test_cond_nested_and_read():
    x = torch.arange(4.0)

    def f(p, q):
        return control.cond(p, lambda: control.cond(q, lambda: x * 2, lambda: x * 3,
                                                    name="inner"),
                            lambda: x + 100, name="outer")

    for p, q, want in ((True, True, x * 2), (True, False, x * 3), (False, True, x + 100)):
        out, syncs, arms = _syncs_and_arms(lambda: f(torch.tensor(p), torch.tensor(q)))
        assert torch.equal(out, want)
        assert syncs == (2 if p else 1)
        assert arms["outer:" + str(p).lower()] == 1
        assert sum(v for k, v in arms.items() if k.startswith("inner")) == (1 if p else 0)
    # several predicates in one sync, handed back as bools
    flags, syncs, _ = _syncs_and_arms(lambda: control.read(
        torch.tensor(True), torch.tensor(False), torch.tensor(3) > 2))
    assert flags == [True, False, True] and syncs == 1
    assert all(isinstance(f, bool) for f in flags)


def test_all_arms_runs_both():
    ran = []

    def arm(name, v):
        ran.append(name)
        return v

    with control.all_arms():
        out = control.cond(torch.tensor(False), lambda: arm("t", 1), lambda: arm("f", 2),
                           name="w")
    assert out == 2 and ran == ["t", "f"]


def test_while_loop_matches_python_loop():
    def body(c):
        n, v = c
        return n + 1, torch.where(v % 2 == 0, v // 2, 3 * v + 1)

    start = torch.tensor(27)
    (n, v), syncs, _ = _syncs_and_arms(lambda: control.while_loop(
        lambda c: c[1] != 1, body, (0, start)))
    steps, w = 0, 27
    while w != 1:
        w = w // 2 if w % 2 == 0 else 3 * w + 1
        steps += 1
    assert n == steps and int(v) == 1
    assert syncs == steps + 1  # one read per check
    # a bool carry is checked without a read
    out, syncs, _ = _syncs_and_arms(lambda: control.while_loop(
        lambda c: c < 3, lambda c: c + 1, 0))
    assert out == 3 and syncs == 0


Pair = collections.namedtuple("Pair", "a b")


@dataclasses.dataclass(frozen=True)
class Holder:
    x: torch.Tensor
    pair: Pair
    extra: dict
    label: str = "h"


def test_tree_round_trip_and_map():
    """utils.tree: one flatten/unflatten pair over dataclasses, named and
    plain tuples, lists and dicts; non-tensor values stay in the structure
    (and in its spec, which keys a graph); map_tensors zips several."""
    def make(k):
        t = torch.arange(6, dtype=torch.float32) + k
        return Holder(t[:2], Pair(t[2:3], [t[3:4], 7]), {"u": (t[4:5],), "v": t[5:]})

    obj = make(0)
    spec, leaves = tree.flatten(obj)
    assert [float(t[0]) for t in leaves] == [0.0, 2.0, 3.0, 4.0, 5.0]
    back = tree.unflatten(spec, leaves)
    assert back == obj and type(back.pair) is Pair and back.pair.b[1] == 7
    assert hash(tree.flatten(make(1))[0]) == hash(spec)  # same structure, same spec
    assert tree.flatten(dataclasses.replace(obj, label="g"))[0] != spec
    summed = tree.map_tensors(lambda a, b: a + b, obj, make(10))
    assert torch.equal(tree.leaves(summed)[4], torch.tensor([20.0]))
    assert summed.label == "h" and summed.pair.b[1] == 7
    assert torch.equal(tree.map_tensors(torch.neg, torch.ones(2)), -torch.ones(2))


@pytest.mark.parametrize("tight,narrow,rows", [(True, True, 24), (True, False, 24),
                                               (False, True, 32), (False, False, 64)])
def test_window_variant_is_window_cond(tight, narrow, rows):
    """corr_kernel.window_variant reads its choice off window_cond's tree."""
    pre = {"j0_tight": "tight", "j0_narrow": "narrow", "j0": "standard"}
    got = corr_kernel.window_variant(pre, tight, narrow)
    assert got == corr_kernel.window_cond(pre, tight, narrow, lambda r, j0: (r, j0))
    assert got[0] == rows and got[1] == {24: "tight", 32: "narrow", 64: "standard"}[rows]


@pytest.mark.parametrize("op", ["item", "bool", "mask_index", "mask_assign", "nonzero",
                                "masked_select", "equal", "from_host"])
def test_strict_mode_traps_host_reads(op):
    x = torch.arange(6.0)
    mask = x > 2
    fn = {"item": lambda: x.sum().item(), "bool": lambda: bool(x.sum() > 0),
          "mask_index": lambda: x[mask], "mask_assign": lambda: x.clone().__setitem__(mask, 0),
          "nonzero": lambda: torch.nonzero(x), "masked_select": lambda: x.masked_select(mask),
          "equal": lambda: torch.equal(x, x), "from_host": lambda: torch.tensor([1.0, 2.0])}[op]
    with pytest.raises(RuntimeError, match="host read"):
        with control.StrictHostReads():
            fn()
    with control.StrictHostReads(raise_on_read=False) as mode:
        fn()
    assert len(mode.untracked) >= 1 and mode.reads == 0
    # a predicate read passes and is counted
    with control.StrictHostReads() as mode:
        control.cond(x.sum() > 0, lambda: x, lambda: -x, name="s")
    assert mode.reads == 1 and mode.untracked == []


def test_cluster_labels_match_jax():
    rng = np.random.default_rng(0)
    for shape, p in (((32, 32, 40), 0.02), ((20, 16, 12), 0.3)):
        gx, gy, ga = shape
        occ = rng.random((ga, gx, gy)) < p
        occ[0], occ[-1], occ[:, 0], occ[:, -1], occ[:, :, 0], occ[:, :, -1] = (False,) * 6
        flat = occ.reshape(-1)
        want = np.asarray(jcluster._cluster_grid(jnp.asarray(flat), shape))
        got = cluster_kernel.cluster_labels(torch.from_numpy(flat), shape)
        np.testing.assert_array_equal(got.numpy(), want)
        # a batch of grids labels each grid alone
        two = cluster_kernel.cluster_labels(torch.from_numpy(np.stack([flat, flat])), shape)
        np.testing.assert_array_equal(two.numpy(), np.stack([want, want]))
    with pytest.raises(ValueError):
        cluster_kernel.cluster_labels(torch.zeros(10, dtype=torch.bool), (4, 4, 4))


# --- the slice's step under the strict mode --------------------------------------

STRICT_CASES = {
    # case: (pose cov, particles, backend, pose shift (m), invalid scan, patches, arms)
    "corr_tight": ((0.004, 0.004, 0.0004), 2048, "corr", 0.0, False, {},
                   ["corr.fits:true", "corr.window.tight:true", "corr.all_on_map:true",
                    "resample.u_count:true", "cluster.small_grid:true",
                    "cluster.stats_width:true"]),
    "corr_narrow": ((0.03, 0.03, 0.002), 2048, "corr", 0.0, False, {},
                    ["corr.window.tight:false", "corr.window.narrow:true"]),
    "corr_standard": ((0.1, 0.1, 0.002), 2048, "corr", 0.0, False, {},
                      ["corr.window.narrow:false"]),
    "corr_off_map": ((0.004, 0.004, 0.0004), 2048, "corr", 11.2, False, {},
                     ["corr.fits:true", "corr.all_on_map:false"]),
    "spread": ((2.0, 2.0, 1.0), 8192, "corr", 0.0, False, {}, ["corr.fits:false"]),
    "corr_to_lf": ((2.0, 2.0, 1.0), 2048, "corr", 0.0, False, {},
                   ["corr.fits:false", "lf.window_fits:false"]),
    "lf_bf16": ((0.004, 0.004, 0.0004), 2048, "lf", 0.0, False, {}, ["lf.window_fits:true"]),
    "exact": ((0.02, 0.02, 0.002), 2048, "exact", 0.0, False, {}, ["resample.u_count:true"]),
    # a scan without a valid beam keeps the weights uniform, so the new set
    # stays as wide as the prior: the full grid, the prefix scan and the
    # wide statistics
    "grid_cluster": ((8.0, 8.0, 1.0), 2048, "corr", 0.0, True, {},
                     ["cluster.small_grid:false"]),
    "u_count_prefix": ((8.0, 8.0, 1.0), 2048, "corr", 0.0, True,
                       {"MAX_UNIQUE_BINS": 256}, ["resample.u_count:false"]),
    "stats_wide": ((8.0, 8.0, 1.0), 2048, "exact", 0.0, True, {"MAX_FAST_CLUSTERS": 1},
                   ["cluster.stats_width:false"]),
}


@functools.lru_cache(maxsize=None)
def _port_setup(cov, n):
    return scenario.build_setup(n, N_BEAMS, MAP_CELLS, pose_cov=cov, min_particles=n // 4,
                                device="cpu")


# every case through sensor_resample_step; the motion update adds no
# branch, so three cases cover mcl_step_2d
STRICT_RUNS = ([(case, "sensor_resample_step") for case in STRICT_CASES]
               + [(case, "mcl_step_2d") for case in ("corr_tight", "spread", "u_count_prefix")])


@pytest.mark.parametrize("case,path", STRICT_RUNS)
def test_step_has_no_host_read_outside_predicates(case, path, monkeypatch):
    cov, n, backend, shift, invalid, patches, want_arms = STRICT_CASES[case]
    for name, value in patches.items():
        monkeypatch.setattr(tcluster, name, value)
    omap, params, state, scan, sp, pool = _port_setup(cov, n)
    state = state.replace(poses=state.poses + torch.tensor([shift, 0.0, 0.0]))
    if invalid:
        scan = PlanarScan(torch.full_like(scan.ranges, scan.range_max), scan.angles,
                          scan.range_max)
    noise = tmcl.StepNoise.draw(torch.Generator().manual_seed(3), n, "cpu",
                                odom=path == "mcl_step_2d")
    odom = [torch.tensor(v) for v in ODOM]

    def step():
        if path == "mcl_step_2d":
            return tmcl.mcl_step_2d(state, omap, sp, scan, pool, *odom, ALPHAS, params,
                                    backend=backend, noise=noise)
        return tmcl.sensor_resample_step(state, omap, sp, scan, pool, params, backend=backend,
                                         noise=noise)

    with control.StrictHostReads(raise_on_read=False) as mode:
        out, syncs, arms = _syncs_and_arms(step)
    assert mode.untracked == []
    assert syncs == mode.reads  # SYNCS counts every host read of the step
    for arm in want_arms:
        assert arms[arm] >= 1, (arm, dict(arms))
    assert torch.isfinite(out.weights).all()
    # the compiled entry point runs the same step on the CPU
    jit = (tmcl.mcl_step_2d_jit(state, omap, sp, scan, pool, *odom, ALPHAS, params,
                                backend=backend, noise=noise) if path == "mcl_step_2d"
           else tmcl.sensor_resample_step_jit(state, omap, sp, scan, pool, params,
                                              backend=backend, noise=noise))
    assert torch.equal(jit.poses, out.poses) and torch.equal(jit.n_active, out.n_active)


# --- the three jits against the JAX package's ------------------------------------

@functools.lru_cache(maxsize=None)
def _setup():
    """The JAX package's tight-cloud setup (the corr table's arm) and the
    port's copy of it."""
    j = _build_setup(N_PARTICLES, N_BEAMS, MAP_CELLS, pose_cov=STRICT_CASES["corr_tight"][0],
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


# one compile serves both steps' checks
_jax_stats = jax.jit(jcluster.compute_cluster_stats, static_argnames=("params",))


def _check_state(t, j, params, pose_atol=0.0, cov_atol=1e-5):
    m = params.max_samples
    n = int(j.n_active)
    assert int(t.n_active) == n
    same = (np.abs(t.poses.numpy() - np.asarray(j.poses)) <= pose_atol).all(axis=1)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    assert int(t.stats.cluster_count) == int(j.stats.cluster_count)
    js = _jax_stats(jnp.asarray(t.poses.numpy()), jnp.asarray(t.weights.numpy()),
                    jnp.arange(m) < n, params=params)
    np.testing.assert_allclose(t.stats.mean.numpy(), np.asarray(js.mean), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t.stats.cov.numpy(), np.asarray(js.cov), rtol=1e-4,
                               atol=cov_atol)
    assert bool(t.converged) == bool(j.converged)


def test_sensor_resample_step_jit_matches():
    (jmap, jparams, jstate, jscan, jsp, jpool), (tmap, tparams, tstate, tscan, tsp,
                                                 tpool) = _setup()
    j = jmcl.sensor_resample_step_jit(jstate, jmap, jsp, jscan, jpool, params=jparams,
                                      backend=BACKEND_J)
    noise = _resample_noise(jstate.key, jparams.max_samples)
    t = tmcl.sensor_resample_step_jit(tstate, tmap, tsp, tscan, tpool, tparams,
                                      backend="corr", noise=noise)
    _check_state(t, j, jparams)


def test_likelihood_only_jit_matches():
    """The exact arms (JAX "xla", the port's "exact")."""
    (jmap, _, jstate, jscan, jsp, _), (tmap, _, tstate, tscan, tsp, _) = _setup()
    p_j = jmcl.likelihood_only_jit(jstate, jmap, jsp, jscan, backend="xla")
    p_t = tmcl.likelihood_only_jit(tstate, tmap, tsp, tscan, backend="exact")
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5)


def test_mcl_step_2d_jit_matches():
    (jmap, jparams, jstate, jscan, jsp, jpool), (tmap, tparams, tstate, tscan, tsp,
                                                 tpool) = _setup()
    j = jmcl.mcl_step_2d_jit(jstate, jmap, jsp, jscan, jpool,
                             *(jnp.asarray(v, jnp.float32) for v in (*ODOM, ALPHAS)),
                             params=jparams, backend="xla")
    noise = _step_noise(jstate.key, jparams.max_samples)
    t = tmcl.mcl_step_2d_jit(tstate, tmap, tsp, tscan, tpool, *ODOM, ALPHAS, tparams,
                             backend="exact", noise=noise)
    # the motion update's trig differs in the last ulp between XLA and
    # PyTorch (test_torch_slice.py)
    _check_state(t, j, jparams, pose_atol=1e-5)


def test_sensor_resample_step_jit_systematic_matches():
    """The systematic resampler inside the compiled step's slice: the JAX
    package's jit on "xla" against the port's on "exact", the comb's start
    the JAX resample's uniform from its key."""
    (jmap, jparams, jstate, jscan, jsp, jpool), (tmap, tparams, tstate, tscan, tsp,
                                                 tpool) = _setup()
    j = jmcl.sensor_resample_step_jit(jstate, jmap, jsp, jscan, jpool, params=jparams,
                                      resample_model=ResampleModel.SYSTEMATIC, backend="xla")
    _, sub = jax.random.split(jstate.key)
    start = torch.tensor(np.asarray(jax.random.uniform(sub, ())))
    m = jparams.max_samples
    noise = tmcl.StepNoise(odom=None, inject=torch.zeros(m), pick=torch.zeros(m), start=start)
    t = tmcl.sensor_resample_step_jit(tstate, tmap, tsp, tscan, tpool, tparams,
                                      resample_model=ResampleModel.SYSTEMATIC,
                                      backend="exact", noise=noise)
    _check_state(t, j, jparams)


@pytest.mark.parametrize("kw", [
    dict(laser_model="beam"), dict(laser_model="likelihood_field_prob"),
    dict(backend="corr_q"), dict(resample_contract="cell"), dict(stats_max_clusters=8),
    dict(do_beamskip=True)])
def test_jits_run_every_static_configuration(kw):
    """Every static argument compiles: the beam and prob models, corr_q,
    beam skipping, the cell contract and the capped statistics run
    (tests/test_torch_compiled_models.py and
    tests/test_torch_compiled_fleet.py hold them against the JAX package's
    jits)."""
    _, (tmap, tparams, tstate, tscan, tsp, tpool) = _setup()
    kw = dict(kw)
    if "stats_max_clusters" in kw:
        tparams = dataclasses.replace(tparams, stats_max_clusters=kw.pop("stats_max_clusters"))
    gen = torch.Generator().manual_seed(0)

    def step():
        if "do_beamskip" in kw or "resample_contract" not in kw and "laser_model" in kw:
            kw.setdefault("laser_model", "likelihood_field_prob")
            return tmcl.mcl_step_2d_jit(tstate, tmap, tsp, tscan, tpool, *ODOM, ALPHAS,
                                        tparams, generator=gen, **{"backend": "corr", **kw})
        return tmcl.sensor_resample_step_jit(tstate, tmap, tsp, tscan, tpool, tparams,
                                             generator=gen, **{"backend": "corr", **kw})

    out = step()
    assert torch.isfinite(out.weights).all()
    if tparams.stats_max_clusters:
        assert int(out.stats.cluster_count) >= 1
        assert out.stats.cluster_weights.shape == (tparams.max_samples,)
    if "laser_model" in kw or "backend" in kw:
        p = tmcl.likelihood_only_jit(tstate, tmap, tsp, tscan,
                                     **{"backend": "corr", **{k: v for k, v in kw.items()
                                                             if k != "do_beamskip"}})
        assert p.shape == tstate.weights.shape and not torch.isnan(p).any()
