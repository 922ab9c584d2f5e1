"""PyTorch port: the Gompertz and prob likelihood-field models on every
backend, beam skipping, the prob model's log space and the log-space
filter pipeline, held against the JAX package on the same inputs: the
448^2 scenario map (corr, spread and lf all eligible), 8192 particles (the
smallest cloud the spread gate admits, planar.py:376-379) x 16 beams.

Backends: the port's "corr" / "lf" / "exact" against the JAX package's
`pallas_corr_interpret` / `pallas_interpret` / `xla`.

Tolerances:
- the corr table (tight clouds): rtol 1e-5 on the Gompertz p — f32 sums
  in another order and exp in the last ulp — and atol 1e-4 on the prob
  model's log p (|sum log pz| ~ 60 at 16 beams, where one f32 ulp is 4e-6);
- every other arm: >= 99% of particles to those tolerances and all to 2%
  (Gompertz p) or 1.0 (prob log p: log pz falls by at most 11 per meter,
  so a shift of one cell diagonal, 0.07 m, moves one beam's log pz by at
  most 0.78). The endpoint cells come from f32
  cos/sin, which differ between XLA and PyTorch in the last ulp, so a few
  endpoints on a cell boundary land one cell over (test_torch_spread_lf.py:
  >= 99.9% bit-equal distances); and the JAX spread arm evaluates the
  pairs that fit none of its windows with the exact endpoint formula,
  whose cell can differ by one from the kernel formula the port uses
  throughout (test_torch_slice.py has the same bound for likelihood_field);
- the log-space filter: log-sum-exp and logaddexp in another order, rtol
  1e-5 on weights and the log-domain averages, equal n_active and >=
  99.9% equal picks (a weight's last-ulp change can move a pick boundary).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_setup
from badger_amcl_tpu.ops import spread_kernel as jsk
from badger_amcl_tpu.pf import filter as jfilter
from badger_amcl_tpu.sensors import planar as jplanar
from badger_amcl_tpu.sensors.raycast import calc_range as jax_calc_range
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch import mcl as tmcl
from badger_amcl_tpu_torch.ops import corr_kernel, spread_kernel as tsk
from badger_amcl_tpu_torch.pf import filter as tfilter
from badger_amcl_tpu_torch.sensors import planar as tplanar

torch.set_num_threads(1)
M, B, MAP_CELLS = 8192, 16, 448
J_BACKEND = {"corr": "pallas_corr_interpret", "lf": "pallas_interpret", "exact": "xla"}
MODELS = ("likelihood_field_gompertz", "likelihood_field_prob")
CLOUDS = {"tight": (0.004, 0.004, 0.0004), "spread": (2.0, 2.0, 1.0)}


@functools.lru_cache(maxsize=None)
def _setup():
    """JAX setup (map, params, state, scan, scan params, pool) and its port
    twin; the psi textures baked per model on each side."""
    jmap, jparams, jstate, jscan, jsp, jpool = _build_setup(
        M, B, MAP_CELLS, pose_cov=CLOUDS["tight"], min_particles=M // 4)
    tmap = convert.map_from_numpy(jmap, device="cpu")
    jmaps = {m: jplanar.bake_corr_texture(jmap, jsp, 8.0, m) for m in MODELS}
    tmaps = {m: tplanar.bake_corr_texture(tmap, tplanar.PlanarScanParams(), 8.0, m)
             for m in MODELS}
    return (jmaps, jparams, jstate, jscan, jsp, jpool), (
        tmaps, convert.pf_params_from_jax(jparams), convert.state_from_numpy(jstate, "cpu"),
        convert.scan_from_numpy(jscan, "cpu"), convert.scan_params_from_numpy(jsp),
        torch.tensor(np.asarray(jpool)))


def _poses(cloud, seed=0):
    cov = np.asarray(CLOUDS[cloud])
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, 3)) * np.sqrt(cov)).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("model", "backend", "log_space", "beamskip"))
def _jax_p(omap, sp, scan, poses, converged, model, backend, log_space=False,
           beamskip=False, active=None):
    """Every particle active unless `active` (a bool mask) is given."""
    n = poses.shape[0]
    if active is None:
        active = jax.numpy.ones((n,), bool)
    p, mf = jplanar.planar_likelihood(
        omap, sp, scan, poses, active, jax.numpy.sum(active).astype(jax.numpy.int32), model,
        converged=converged, do_beamskip=beamskip, backend=backend, fold_factors=True,
        prob_log_space=log_space)
    return p if mf is None else (p + jax.numpy.log(mf) if log_space else p * mf)


def _port_p(tmap, sp, scan, poses, model, backend, converged=False, log_space=False,
            beamskip=False, active=None):
    n = poses.shape[0]
    if active is None:
        active = torch.ones(n, dtype=torch.bool)
    p, mf = tplanar.planar_likelihood(
        tmap, sp, scan, poses, active, active.sum().to(torch.int32), model,
        converged=torch.tensor(converged), do_beamskip=beamskip, backend=backend,
        fold_factors=True, prob_log_space=log_space)
    return p if mf is None else (p + torch.log(mf) if log_space else p * mf)


def _compare(got, want, exact_arm):
    """Gompertz p or prob log p (see the module docstring)."""
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    log_p = bool((want < 0).any())
    err = np.abs(got - want) / (1.0 if log_p else np.abs(want))
    close = err <= (1e-4 if log_p else 1e-5)
    if exact_arm:
        assert close.all(), err.max()
        return
    assert close.mean() >= 0.99, close.mean()
    assert err.max() <= (1.0 if log_p else 2e-2), err.max()


@pytest.mark.parametrize("cloud", list(CLOUDS))
@pytest.mark.parametrize("backend", ["corr", "lf", "exact"])
@pytest.mark.parametrize("model", MODELS)
def test_lf_model_matches_jax(model, backend, cloud):
    """The prob model runs in log space (prob_log_space), the form the
    filter uses at real beam counts; its exp form is checked against it."""
    (jmaps, _, _, jscan, jsp, _), (tmaps, _, _, tscan, tsp, _) = _setup()
    prob = model == "likelihood_field_prob"
    poses = _poses(cloud)
    want = _jax_p(jmaps[model], jsp, jscan, jax.numpy.asarray(poses), False, model,
                  J_BACKEND[backend], log_space=prob)
    got = _port_p(tmaps[model], tsp, tscan, torch.from_numpy(poses), model, backend,
                  log_space=prob)
    pre = corr_kernel.corr_prepass(tmaps[model], torch.from_numpy(poses), tscan.ranges,
                                   tscan.angles, tscan.valid())
    assert bool(pre["fits"]) == (cloud == "tight")
    _compare(got, want, exact_arm=backend == "corr" and cloud == "tight")
    if prob:
        assert float(got.max()) < -20.0  # far below f32's exp range at 720 beams
        p = _port_p(tmaps[model], tsp, tscan, torch.from_numpy(poses), model, backend)
        np.testing.assert_allclose(p.numpy(), torch.exp(got).numpy(), rtol=1e-6)


# facing the map's lower-left corner, so most beams hit its walls. (Not the
# upper-right one: on a 448-wide map the JAX lf kernel aligns its clamped
# window origin down to column 128, so in-map endpoints past column 383
# read max_distance there — lf_kernel.py:126-133 — and the port reads the
# texture.)
SKIP_TRUTH = (-8.5, -8.5, -2.356)


def _skip_scan(kind):
    """A scan raycast from SKIP_TRUTH (most beams agree with the map), three
    beams shortened ("few_bad": those are skipped once converged) or every
    beam shortened ("all_bad": the error fallback integrates all beams);
    with "_max" beam 12 reads range_max, with "_invalid" also beam 2 NaN."""
    (jmaps, *_), _ = _setup()
    jmap = jmaps["likelihood_field_prob"]
    angles = np.linspace(-2.35, 2.35, B).astype(np.float32)
    x, y, yaw = (jax.numpy.float32(v) for v in SKIP_TRUTH)
    r = np.asarray(jax_calc_range(jmap, x, y, jax.numpy.asarray(angles) + yaw, 8.0))
    r = np.minimum(r, np.float32(7.5)).astype(np.float32)
    bad = [4, 7, 9] if kind.startswith("few_bad") else list(range(B))
    r[bad] *= np.float32(0.4)
    if kind.endswith(("_max", "_invalid")):
        r[12] = np.float32(8.0)
    if kind.endswith("_invalid"):
        r[2] = np.float32(np.nan)
    jscan = jplanar.PlanarScan(ranges=jax.numpy.asarray(r), angles=jax.numpy.asarray(angles),
                               range_max=jax.numpy.float32(8.0))
    return jscan, convert.scan_from_numpy(jscan, "cpu")


@pytest.mark.parametrize("kind", ["few_bad", "all_bad"])
@pytest.mark.parametrize("converged", [True, False])
def test_prob_beam_skipping_matches_jax(kind, converged):
    model = "likelihood_field_prob"
    (jmaps, _, _, _, jsp, _), (tmaps, _, _, _, tsp, _) = _setup()
    jscan, tscan = _skip_scan(kind)
    poses = _poses("tight", seed=2) + np.float32(SKIP_TRUTH)
    want = _jax_p(jmaps[model], jsp, jscan, jax.numpy.asarray(poses), converged, model,
                  J_BACKEND["corr"], log_space=True, beamskip=True)
    got = _port_p(tmaps[model], tsp, tscan, torch.from_numpy(poses), model, "corr",
                  converged=converged, log_space=True, beamskip=True)
    _compare(got, want, exact_arm=False)
    no_skip = _port_p(tmaps[model], tsp, tscan, torch.from_numpy(poses), model, "lf",
                      log_space=True)
    skipped = converged and kind == "few_bad"
    assert bool((got > no_skip).all() if skipped else (got == no_skip).all())
    # the exp output is the same pipeline without the log
    p = _port_p(tmaps[model], tsp, tscan, torch.from_numpy(poses), model, "corr",
                converged=converged, beamskip=True)
    np.testing.assert_allclose(p.numpy(), torch.exp(got).numpy(), rtol=1e-6)


@pytest.mark.parametrize("case", ["all_bad_max", "half_inactive"])
def test_prob_beam_skipping_edge_cases_match_jax(case):
    """Converged, every beam bad and one at range_max: the error fallback
    integrates the invalid beam's log 0, -inf for every particle in both
    packages (compared for equality); converged with half the particles
    inactive and n_active to match: the counts see only the active half."""
    model = "likelihood_field_prob"
    (jmaps, _, _, _, jsp, _), (tmaps, _, _, _, tsp, _) = _setup()
    jscan, tscan = _skip_scan("all_bad_max" if case == "all_bad_max" else "few_bad")
    poses = _poses("tight", seed=2) + np.float32(SKIP_TRUTH)
    active = np.ones(M, bool)
    if case == "half_inactive":
        active[np.random.default_rng(5).permutation(M)[:M // 2]] = False
    want = np.asarray(_jax_p(jmaps[model], jsp, jscan, jax.numpy.asarray(poses), True, model,
                             J_BACKEND["corr"], log_space=True, beamskip=True,
                             active=jax.numpy.asarray(active)))
    got = _port_p(tmaps[model], tsp, tscan, torch.from_numpy(poses), model, "corr",
                  converged=True, log_space=True, beamskip=True,
                  active=torch.from_numpy(active))
    if case == "all_bad_max":
        assert np.isneginf(want).all()
        assert bool(torch.isneginf(got).all())
        p = _port_p(tmaps[model], tsp, tscan, torch.from_numpy(poses), model, "corr",
                    converged=True, beamskip=True)
        assert bool((p == 0.0).all())
        return
    _compare(got, want, exact_arm=False)
    no_skip = _port_p(tmaps[model], tsp, tscan, torch.from_numpy(poses), model, "lf",
                      log_space=True)
    assert bool((got > no_skip).all())  # the three bad beams are still skipped


def _beamskip_bm_reference(omap, params, scan, spose, active, n_active, converged,
                           backend):
    """Beam skipping over the (B, M) distances, as the port computed it
    before the counts kernel: every endpoint's distance, in-map test and
    log pz in memory."""
    from badger_amcl_tpu_torch.ops import lf_kernel

    tex = (lf_kernel.lf_texture(omap, spose, scan.ranges, scan.angles) if backend == "lf"
           else omap.distances)
    zt = lf_kernel.lf_distances(omap, tex, spose, scan.ranges, scan.angles)
    valid = scan.valid()
    term = tplanar.model_term("likelihood_field_prob", params, scan.range_max)
    pz = tsk.BeamTerm(term.z_hit, term.denom, term.zr, form="pz")(zt)
    logpz = torch.log(pz)
    b = scan.ranges.shape[0]
    th = spose[None, :, 2] + scan.angles[:, None]
    hx = spose[None, :, 0] + scan.ranges[:, None] * torch.cos(th)
    hy = spose[None, :, 1] + scan.ranges[:, None] * torch.sin(th)
    in_map = omap.is_valid(omap.world_to_map(torch.stack([hx, hy], dim=-1)))
    agrees = in_map & (zt < params.beam_skip_distance) & valid[:, None] & active[None, :]
    obs_count = agrees.sum(dim=1).to(torch.float32)
    obs_mask = obs_count / n_active.to(torch.float32).clamp(min=1.0) > \
        params.beam_skip_threshold
    skipped = (~obs_mask).sum()
    error = skipped >= b * params.beam_skip_error_threshold
    pz_temp = torch.where(valid[:, None], pz, 0.0)
    use_beam = error | obs_mask[:, None]
    log_p = torch.where(use_beam, torch.log(pz_temp), 0.0).sum(dim=0)
    log_p_all = torch.where(valid[:, None], logpz, 0.0).sum(dim=0)
    return torch.where(torch.as_tensor(converged), log_p, log_p_all)


@pytest.mark.parametrize("backend", ["lf", "exact"])
@pytest.mark.parametrize("kind", ["few_bad", "all_bad", "few_bad_invalid", "all_bad_invalid"])
@pytest.mark.parametrize("converged", [True, False])
def test_beam_skipping_matches_bm_reference(converged, kind, backend):
    """The two-pass beam skipping (per-beam counts, then the fused log pz
    sums over the beams kept) equals the (B, M) formulation bit for bit on
    the CPU, -inf included, with a third of the particles inactive."""
    model = "likelihood_field_prob"
    _, (tmaps, _, _, _, tsp, _) = _setup()
    _, tscan = _skip_scan(kind)
    tmap = tmaps[model]
    spose = tplanar.coord_add(tsp.scanner_pose,
                              torch.from_numpy(_poses("tight", seed=2) + np.float32(SKIP_TRUTH)))
    active = torch.ones(M, dtype=torch.bool)
    active[::3] = False
    n_active = active.sum().to(torch.int32)
    conv = torch.tensor(converged)
    got = tplanar._lf_prob_beamskip(tmap, tsp, tscan, spose, active, n_active, conv, backend)
    want = _beamskip_bm_reference(tmap, tsp, tscan, spose, active, n_active, conv, backend)
    assert torch.equal(got, want)
    assert bool(torch.isneginf(got).all()) == (converged and kind == "all_bad_invalid")
    assert bool(torch.isfinite(got).all()) == (not converged or kind != "all_bad_invalid")


def test_lf_models_without_valid_beams():
    """No valid beam: Gompertz gives p = 1 (planar.py:458-459), prob exp(0)."""
    _, (tmaps, _, _, tscan, tsp, _) = _setup()
    scan = tplanar.PlanarScan(ranges=torch.full_like(tscan.ranges, 8.0),
                              angles=tscan.angles, range_max=8.0)
    poses = torch.from_numpy(_poses("tight"))
    for model in MODELS:
        for backend in ("corr", "exact"):
            p = _port_p(tmaps[model], tsp, scan, poses, model, backend)
            assert (p == 1.0).all(), (model, backend)


@pytest.mark.parametrize("form", ["pz", "log"])
def test_spread_term_forms_match_pallas(form):
    model = {"pz": "likelihood_field_gompertz", "log": "likelihood_field_prob"}[form]
    (jmaps, _, _, jscan, jsp, _), (tmaps, _, _, tscan, tsp, _) = _setup()
    jmap = jmaps[model]
    poses = _poses("spread", seed=3)
    if form == "pz":
        def jterm(z):
            return jsp.z_hit * jax.numpy.exp(-(z * z) / (2.0 * jsp.sigma_hit ** 2)) + jsp.z_rand
    else:
        def jterm(z):
            pz = (jsp.z_hit * jax.numpy.exp(-(z * z) / (2.0 * jsp.sigma_hit ** 2))
                  + jsp.z_rand / jscan.range_max)
            return jax.numpy.log(pz)
    valid = jscan.ranges < jscan.range_max
    jp = jax.numpy.asarray(poses)
    pre = jsk.spread_prepass(jmap, jp, jscan.ranges, jscan.angles, valid)
    s = jsk.spread_term_sums(jmap, jp, jscan.ranges, jscan.angles, valid, pre, jterm,
                             interpret=True)
    want = np.asarray(jsk.unsort(s, pre), np.float64)
    term = tplanar.model_term(model, tsp, tscan.range_max)
    assert term.form == form
    got = tsk.spread_term_sums(tmaps[model], torch.from_numpy(poses), tscan.ranges,
                               tscan.angles, tscan.valid(), term).numpy()
    close = np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6
    assert close.mean() >= 0.99, close.mean()
    # a one-cell shift moves one beam's term by at most its range
    span = 1.0 if form == "pz" else 5.1
    assert np.abs(got - want).max() <= 3 * span
    with pytest.raises(ValueError):
        tsk.BeamTerm(1.0, 1.0, 0.0, form="square")


def _resample_noise(key, m):
    _, sub = jax.random.split(key)
    k1, k2 = jax.random.split(sub)
    return tmcl.StepNoise(odom=None,
                          inject=torch.tensor(np.asarray(jax.random.uniform(k1, (m,)))),
                          pick=torch.tensor(np.asarray(jax.random.uniform(k2, (m,)))))


@functools.partial(jax.jit, static_argnames=("params",))
def _jax_log_step(state, logp, mf, pool, params):
    s = jfilter.sensor_update_log(state, logp, mf)
    return s, jfilter.resample(s, params, pool, log_averages=True)


def test_log_space_update_and_resample_match_jax():
    (jmaps, jparams, jstate, jscan, jsp, jpool), (tmaps, tparams, tstate, tscan, tsp,
                                                  tpool) = _setup()
    model = "likelihood_field_prob"
    jstate = jfilter.init_log_averages(jstate)
    tstate = tfilter.init_log_averages(tstate)
    assert float(tstate.w_slow) == float(jstate.w_slow) == float("inf")
    for step, seed in enumerate((4, 5)):
        poses = _poses("tight", seed=seed)
        logp, mf = tplanar.planar_likelihood(
            tmaps[model], tsp, tscan, torch.from_numpy(poses), tstate.active_mask,
            tstate.n_active, model, backend="corr", fold_factors=True,
            prob_log_space=True)
        assert mf is not None  # log p is never folded
        jstate = jstate.replace(poses=jax.numpy.asarray(poses))
        tstate = tstate.replace(poses=torch.from_numpy(poses))
        j_upd, j_res = _jax_log_step(jstate, jax.numpy.asarray(logp.numpy()),
                                     jax.numpy.asarray(mf.numpy()), jpool, params=jparams)
        t_upd = tfilter.sensor_update_log(tstate, logp, mf)
        np.testing.assert_allclose(t_upd.weights.numpy(), np.asarray(j_upd.weights),
                                   rtol=1e-5, atol=1e-12)
        for f in ("w_slow", "w_fast"):
            np.testing.assert_allclose(float(getattr(t_upd, f)), float(getattr(j_upd, f)),
                                       rtol=1e-5)
        noise = _resample_noise(jstate.key, tparams.max_samples)
        t_res = tfilter.resample(t_upd, tparams, tpool, noise.inject, noise.pick,
                                 log_averages=True)
        assert int(t_res.n_active) == int(j_res.n_active)
        same = (t_res.poses.numpy() == np.asarray(j_res.poses)).all(axis=1)
        assert same.mean() >= 0.999, same.mean()
        for f in ("w_slow", "w_fast"):
            a, b = float(getattr(t_res, f)), float(getattr(j_res, f))
            assert (a == b == float("inf")) or abs(a - b) <= 1e-5 * abs(b), (step, f, a, b)
        jstate, tstate = j_res, convert.state_from_numpy(j_res, "cpu")
    # the log-domain sentinel comes across convert unchanged
    j_inf = jfilter.init_log_averages(jstate)
    assert float(convert.state_from_numpy(j_inf, "cpu").w_fast) == float("inf")


def test_log_space_step_entry_points():
    """The log-space pipeline composed as the node composes it:
    `sensor_update_2d(log_space=True)`, then a resample over log-domain
    averages, runs end to end; other models refuse log_space."""
    _, (tmaps, tparams, tstate, tscan, tsp, tpool) = _setup()
    model = "likelihood_field_prob"
    gen = torch.Generator().manual_seed(0)
    state = tfilter.init_log_averages(tstate)
    for _ in range(2):
        noise = tmcl.StepNoise.draw(gen, M, "cpu", odom=False)
        upd = tmcl.sensor_update_2d(state, tmaps[model], tsp, tscan, model, backend="corr",
                                    log_space=True)
        assert torch.isfinite(upd.w_slow)  # a finite total: no reset
        state = tfilter.resample(upd, tparams, tpool, noise.inject, noise.pick,
                                 log_averages=True)
    assert torch.isfinite(state.weights).all() and int(state.n_active) >= tparams.min_samples
    assert not torch.isnan(state.w_slow)
    with pytest.raises(ValueError):
        tmcl.sensor_update_2d(state, tmaps[model], tsp, tscan, "likelihood_field",
                              backend="corr", log_space=True)
