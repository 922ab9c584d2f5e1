"""PyTorch port: the int8 corr backend ("corr_q", JAX "pallas_corr_q") —
the quantized texture bake, the int32 table and the likelihood and step
through it — held against the JAX package, its q kernel in interpret mode.

Tolerances:
- the quantized texture and its scale: bit-equal (both divide in IEEE
  f32 and round half to even);
- the int32 table: exact (integer sums of w * q are exact in any order);
- likelihoods: rtol 1e-5 (the table is exact; the dequantization and the
  model's combine round alike up to XLA's and PyTorch's last ulp);
- the step (2048 x 64, replayed draws, filter.py:502 and :351-353):
  n_active equal, >= 99.9% of picks equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badger_amcl_tpu import mcl as jmcl
from badger_amcl_tpu.maps import CellState
from badger_amcl_tpu.maps import OccupancyMap2D as JaxMap
from badger_amcl_tpu.ops import corr_kernel as jck
from badger_amcl_tpu.pf import filter as jfilter
from badger_amcl_tpu.pf.types import PFParams as JaxPFParams
from badger_amcl_tpu.sensors import planar as jplanar
from badger_amcl_tpu_torch import convert, mcl
from badger_amcl_tpu_torch.ops import corr_kernel as tck
from badger_amcl_tpu_torch.sensors import planar as tplanar

torch.set_num_threads(1)
RANGE_MAX = 6.0


def _cells():
    """The 448^2 map of tests/test_corr_q.py."""
    rng = np.random.default_rng(11)
    n = 448
    c = np.full((n, n), int(CellState.FREE), np.int8)
    c[0:2, :] = c[-2:, :] = int(CellState.OCCUPIED)
    c[:, 0:2] = c[:, -2:] = int(CellState.OCCUPIED)
    for _ in range(12):
        cx, cy = rng.integers(20, n - 28, 2)
        c[cy:cy + 6, cx:cx + 6] = int(CellState.OCCUPIED)
    return c


@functools.lru_cache(maxsize=None)
def _maps(model):
    """(JAX map, JAX params, the port's own bake of the same cells, port
    params) for `model`."""
    jsp = jplanar.PlanarScanParams(non_free_space_factor=jnp.float32(0.6),
                                   non_free_space_radius=jnp.float32(0.5))
    jmap = JaxMap.from_cells(_cells(), 0.05).with_distance_field(2.0)
    jmap = jplanar.bake_factor_texture(
        jplanar.bake_corr_texture(jmap, jsp, RANGE_MAX, model), jsp)
    tsp = convert.scan_params_from_numpy(jsp)
    tmap = convert.map_from_numpy(jmap, device="cpu")
    tmap = tplanar.bake_factor_texture(
        tplanar.bake_corr_texture(tmap, tsp, RANGE_MAX, model), tsp)
    return jmap, jsp, tmap, tsp


def _scan(b=64):
    angles = jnp.linspace(-2.2, 2.2, b).astype(jnp.float32)
    ranges = jnp.clip(2.0 + jnp.sin(angles * 5.0), 0.3, RANGE_MAX - 0.1)
    jscan = jplanar.PlanarScan(ranges=ranges, angles=angles,
                               range_max=jnp.float32(RANGE_MAX))
    return jscan, convert.scan_from_numpy(jscan, device="cpu")


def _poses(n, seed, xy_sig=0.15, yaw_sig=0.04):
    rng = np.random.default_rng(seed)
    return np.concatenate([xy_sig * rng.standard_normal((n, 2)),
                           yaw_sig * rng.standard_normal((n, 1))], axis=1).astype(np.float32)


@pytest.mark.parametrize("model", ["likelihood_field", "likelihood_field_gompertz"])
def test_q_texture_bit_equal(model):
    """The port's own bake of the int8 texture and its scale equal JAX's."""
    jmap, _, tmap, _ = _maps(model)
    assert tmap.corr_psi_pad_q.dtype == torch.int8
    np.testing.assert_array_equal(tmap.corr_psi_pad_q.numpy(), np.asarray(jmap.corr_psi_pad_q))
    np.testing.assert_array_equal(tmap.corr_psi_q.numpy(), np.asarray(jmap.corr_psi_q))


def test_q_texture_uniform():
    """hi == lo: qstep 1, every q = -127 (tests/test_corr_q.py:193)."""
    free = np.full((256, 448), int(CellState.FREE), np.int8)
    jmap = JaxMap.from_cells(free, 0.05).with_distance_field(2.0)
    tmap = convert.map_from_numpy(jmap, device="cpu")
    want_pad, want_scale = jck.build_tex_pad_q(
        jmap, jnp.full((256, 448), 0.625, jnp.float32), jnp.float32(0.625))
    pad, scale = tck.build_tex_pad_q(tmap, torch.full((256, 448), 0.625),
                                     torch.tensor(0.625))
    assert pad.shape == (256 + 2 * tck.PAD_RQ, 448 + 2 * tck.PAD_C)
    np.testing.assert_array_equal(pad.numpy(), np.asarray(want_pad))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want_scale))
    assert (pad.numpy() == -127).all() and float(scale[0]) == 1.0


@pytest.mark.parametrize("xy_sig,narrow", [(0.15, True), (0.55, False)])
def test_q_table_plain_matches_pallas_interpret(xy_sig, narrow):
    """corr_table_q_plain fed JAX's own prepass and q texture against
    _corr_call_q in interpret mode (its quad slices and meta built as
    corr_values_q builds them): int32, exact."""
    jmap, jsp, _, _ = _maps("likelihood_field")
    jscan, _ = _scan()
    poses = jnp.asarray(_poses(300, 5, xy_sig))
    valid = (jscan.ranges < jscan.range_max) & ~jnp.isnan(jscan.ranges)
    pre = jck.corr_prepass(jmap, poses, jscan.ranges, jscan.angles, valid)
    assert bool(pre["fits"]) and bool(pre["narrow"]) == narrow
    rows, j0 = (32, pre["j0_narrow"]) if narrow else (64, pre["j0"])
    tex_q = jmap.corr_psi_pad_q
    sj, si = jck.slice_origin_q(tex_q, j0, pre["i0"])
    meta = jnp.concatenate([jnp.stack([pre["t_n"], j0 + jck.PAD_RQ - sj,
                                       pre["i0"] + jck.PAD_C - si, pre["nv"]]).astype(jnp.int32),
                            pre["nu"]])
    want = np.asarray(jck._corr_call_q(jck.quad_slices(tex_q, sj, si), meta, pre["off"],
                                       n_beams=64, rows=rows, interpret=True))
    org = torch.tensor([int(j0) + tck.PAD_RQ, int(pre["i0"]) + tck.PAD_C], dtype=torch.int32)
    got = tck.corr_table_q(torch.from_numpy(np.array(tex_q)),
                           torch.from_numpy(np.array(pre["off"])),
                           torch.from_numpy(np.array(pre["nu"])),
                           torch.tensor(int(pre["t_n"]), dtype=torch.int32), org, 64, rows)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["corner", "t_n_1", "nu_zero"])
def test_q_table_edge_cases_vs_pallas_interpret(case):
    """The edge cases the int8 table kernel must get right, held on the CPU
    between corr_table_q's plain version and _corr_call_q in interpret mode
    at the narrow 32-row window: a cloud at the map's (0, 0) corner (window
    origin j0 = i0 = 0), one live bin, a live bin without taps. int32,
    exact; bins past t_n and the bin without taps are zero."""
    jmap, _, _, _ = _maps("likelihood_field")
    jscan, _ = _scan()
    half = 448 * 0.05 / 2.0
    poses = _poses(300, 5, 0.15)
    if case == "corner":
        poses[:, :2] += np.float32(-half + 0.2)
    valid = (jscan.ranges < jscan.range_max) & ~jnp.isnan(jscan.ranges)
    pre = dict(jck.corr_prepass(jmap, jnp.asarray(poses), jscan.ranges, jscan.angles, valid))
    assert bool(pre["narrow"]) and int(pre["t_n"]) > 2
    if case == "corner":
        assert int(pre["i0"]) == 0 and int(pre["j0_narrow"]) == 0
    elif case == "t_n_1":
        pre["t_n"] = jnp.int32(1)
    else:
        pre["nu"] = pre["nu"].at[1].set(0)
    rows, j0 = 32, pre["j0_narrow"]
    tex_q = jmap.corr_psi_pad_q
    sj, si = jck.slice_origin_q(tex_q, j0, pre["i0"])
    meta = jnp.concatenate([jnp.stack([pre["t_n"], j0 + jck.PAD_RQ - sj,
                                       pre["i0"] + jck.PAD_C - si, pre["nv"]]).astype(jnp.int32),
                            pre["nu"]])
    want = np.asarray(jck._corr_call_q(jck.quad_slices(tex_q, sj, si), meta, pre["off"],
                                       n_beams=64, rows=rows, interpret=True))
    org = torch.tensor([int(j0) + tck.PAD_RQ, int(pre["i0"]) + tck.PAD_C], dtype=torch.int32)
    got = tck.corr_table_q(torch.from_numpy(np.array(tex_q)),
                           torch.from_numpy(np.array(pre["off"])),
                           torch.from_numpy(np.array(pre["nu"])),
                           torch.tensor(int(pre["t_n"]), dtype=torch.int32), org, 64, rows)
    np.testing.assert_array_equal(got.numpy(), want)
    n = int(pre["t_n"])
    assert not want[n:].any() and want[:n].any()
    if case == "nu_zero":
        assert not want[1].any() and want[0].any()


@pytest.mark.parametrize("model,fold", [("likelihood_field", True),
                                        ("likelihood_field_gompertz", False)])
def test_q_likelihood_matches(monkeypatch, model, fold):
    """planar_likelihood on "corr_q" against "pallas_corr_q_interpret",
    folded and not, and it reads the int8 table."""
    jmap, jsp, tmap, tsp = _maps(model)
    jscan, tscan = _scan()
    poses = _poses(400, 7)
    n = poses.shape[0]
    p_j, mf_j = jplanar.planar_likelihood(
        jmap, jsp, jscan, jnp.asarray(poses), jnp.ones((n,), bool), jnp.int32(n), model,
        backend="pallas_corr_q_interpret", fold_factors=fold)
    calls = []
    plain = tck.corr_table_q_plain
    monkeypatch.setattr(tck, "corr_table_q_plain", lambda *a: calls.append(1) or plain(*a))
    p_t, mf_t = tplanar.planar_likelihood(
        tmap, tsp, tscan, torch.from_numpy(poses), torch.ones(n, dtype=torch.bool),
        torch.tensor(n, dtype=torch.int32), model, backend="corr_q", fold_factors=fold)
    assert calls == [1]
    assert (mf_t is None) == (mf_j is None) == fold
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5)
    if not fold:
        np.testing.assert_array_equal(mf_t.numpy(), np.asarray(mf_j))


def test_prob_model_takes_the_f32_table(monkeypatch):
    """The prob model bakes no q texture, and under "corr_q" reads the f32
    table (#1), equal to "corr"."""
    _, _, tmap, tsp = _maps("likelihood_field_prob")
    assert tmap.corr_psi_pad is not None and tmap.corr_psi_pad_q is None
    assert tmap.corr_psi_q is None
    _, tscan = _scan()
    poses = torch.from_numpy(_poses(400, 8))
    n = poses.shape[0]
    args = (tmap, tsp, tscan, poses, torch.ones(n, dtype=torch.bool),
            torch.tensor(n, dtype=torch.int32), "likelihood_field_prob")
    monkeypatch.setattr(tck, "corr_table_q", None)  # any q call would fail
    f32_calls = []
    table = tck.corr_table
    monkeypatch.setattr(tck, "corr_table", lambda *a: f32_calls.append(1) or table(*a))
    p_q, _ = tplanar.planar_likelihood(*args, backend="corr_q")
    p_c, _ = tplanar.planar_likelihood(*args, backend="corr")
    assert f32_calls == [1, 1]
    np.testing.assert_array_equal(p_q.numpy(), p_c.numpy())


def test_q_sensor_resample_step_matches():
    """sensor_resample_step on "corr_q" at 2048 x 64 with the JAX draws
    replayed, against the JAX step on "pallas_corr_q_interpret"."""
    jmap, jsp, tmap, tsp = _maps("likelihood_field")
    jscan, tscan = _scan()
    m = 2048
    jparams = JaxPFParams(min_samples=256, max_samples=m)
    jstate = jfilter.init_with_poses(jparams, jax.random.PRNGKey(3), jnp.asarray(_poses(m, 9)))
    pool = np.random.default_rng(2).uniform(-3.0, 3.0, (m, 3)).astype(np.float32)
    # eager: under jit XLA fuses the weight arithmetic into other roundings
    want = jmcl.sensor_resample_step(jstate, jmap, jsp, jscan, jnp.asarray(pool), jparams,
                                     backend="pallas_corr_q_interpret")
    _, sub = jax.random.split(jstate.key)
    k1, k2 = jax.random.split(sub)
    noise = mcl.StepNoise(odom=None,
                          inject=torch.from_numpy(np.array(jax.random.uniform(k1, (m,)))),
                          pick=torch.from_numpy(np.array(jax.random.uniform(k2, (m,)))))
    got = mcl.sensor_resample_step(convert.state_from_numpy(jstate, device="cpu"), tmap, tsp,
                                   tscan, torch.from_numpy(pool),
                                   convert.pf_params_from_jax(jparams), backend="corr_q",
                                   noise=noise)
    assert int(got.n_active) == int(want.n_active)
    same = (got.poses.numpy() == np.asarray(want.poses)).all(axis=1)
    assert same.mean() >= 0.999, same.mean()
    assert int(got.stats.cluster_count) == int(want.stats.cluster_count)
