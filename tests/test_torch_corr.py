"""PyTorch port: stencil-correlation prepass, table and fused read, held
against the JAX package (its Pallas kernels in interpret mode) on the same
inputs.

Tolerances:
- packed taps: >= 99.9% equal — oi/oj = round(r cos(theta) / res), and a
  last-ulp difference between XLA's and PyTorch's f32 cos can flip a round;
- the table: max |diff| <= 1e-5 x the table's max — the plain version sums
  a bin's taps in another order than the TPU kernel's sequential loop;
- per-particle p: rtol 1e-5 for the same reason (p = (1 + s) * factor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badger_amcl_tpu.maps import CellState
from badger_amcl_tpu.maps import OccupancyMap2D as JaxMap
from badger_amcl_tpu.ops import corr_kernel as jck
from badger_amcl_tpu.sensors import planar as jplanar
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch.ops import corr_kernel as tck
from badger_amcl_tpu_torch.sensors import planar as tplanar

torch.set_num_threads(1)
RANGE_MAX = 6.0


@pytest.fixture(scope="module")
def maps():
    """The 448^2 map of tests/test_factor_fold.py, baked on both sides."""
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
    tparams = convert.scan_params_from_numpy(jparams)
    tmap = convert.map_from_numpy(jmap, device="cpu")
    # the port's own bakes from the same cells
    tmap_own = tplanar.bake_factor_texture(
        tplanar.bake_corr_texture(tmap, tparams, RANGE_MAX, "likelihood_field"), tparams)
    return jmap, jparams, tmap, tmap_own, tparams


def _scan(b):
    angles = jnp.linspace(-2.2, 2.2, b).astype(jnp.float32)
    ranges = jnp.clip(2.0 + jnp.sin(angles * 5.0), 0.3, RANGE_MAX - 0.1)
    return jplanar.PlanarScan(ranges=ranges, angles=angles,
                              range_max=jnp.float32(RANGE_MAX))


def _poses(n, seed, xy_sig, yaw_sig, center=(0.0, 0.0)):
    rng = np.random.default_rng(seed)
    p = np.concatenate([np.asarray(center) + xy_sig * rng.standard_normal((n, 2)),
                        yaw_sig * rng.standard_normal((n, 1))], axis=1)
    return p.astype(np.float32)


_jax_prepass = jax.jit(jck.corr_prepass, static_argnames=("dedup",))


def _prepasses(jmap, tmap, poses, b, dedup):
    jscan = _scan(b)
    tscan = convert.scan_from_numpy(jscan, device="cpu")
    jvalid = (jscan.ranges < jscan.range_max) & ~jnp.isnan(jscan.ranges)
    jpre = _jax_prepass(jmap, jnp.asarray(poses), jscan.ranges, jscan.angles, jvalid,
                        dedup=dedup)
    tpre = tck.corr_prepass(tmap, torch.from_numpy(poses), tscan.ranges, tscan.angles,
                            tscan.valid(), dedup=dedup)
    return jpre, tpre


@pytest.mark.parametrize("b,dedup,yaw_sig", [(64, False, 0.04), (400, True, 0.01)])
def test_prepass_matches(maps, b, dedup, yaw_sig):
    jmap, _, tmap, _, _ = maps
    poses = _poses(600, 1, 0.15, yaw_sig)
    jpre, tpre = _prepasses(jmap, tmap, poses, b, dedup)
    off_j, off_t = np.asarray(jpre["off"]), tpre["off"].numpy()
    assert (off_j == off_t).mean() >= 0.999
    for k in ("nu", "t_slot", "ci", "cj"):
        np.testing.assert_array_equal(tpre[k].numpy(), np.asarray(jpre[k]), err_msg=k)
    for k in ("t_n", "nv", "i0", "j0", "j0_narrow", "j0_tight", "fits", "narrow",
              "tight"):
        assert int(tpre[k]) == int(jpre[k]), k


@pytest.fixture(scope="module")
def pallas_tables(maps):
    """Both TPU call variants (baked-texture DMA and per-call slices) in
    interpret mode at every window height, fed JAX's own 400-beam dedup
    prepass, with the port's table inputs: [(rows, org, [want, ...])] and
    (tex_pad, off, nu, t_n)."""
    jmap, _, tmap, _, _ = maps
    b = 400
    jpre, _ = _prepasses(jmap, tmap, _poses(300, 2, 0.1, 0.02), b, True)
    inputs = (torch.from_numpy(np.array(jmap.corr_psi_pad)),
              torch.from_numpy(np.array(jpre["off"])), torch.from_numpy(np.array(jpre["nu"])),
              torch.tensor(int(jpre["t_n"]), dtype=torch.int32))
    tables = []
    for rows, j0 in ((24, jpre["j0_tight"]), (32, jpre["j0_narrow"]), (64, jpre["j0"])):
        org = torch.tensor([int(j0) + tck.PAD_R, int(jpre["i0"]) + tck.PAD_C],
                           dtype=torch.int32)
        tables.append((rows, org, [np.asarray(jck._corr_table(
            jmap.corr_psi_pad, jpre, b, rows, j0, True, tex_pre))
            for tex_pre in (jmap.corr_psi_pre, None)]))
    return b, tables, inputs


def test_table_plain_matches_pallas_interpret(pallas_tables):
    """The plain table fed JAX's own prepass against both TPU call variants
    at every window height."""
    b, tables, (tex_pad, off, nu, t_n) = pallas_tables
    for rows, org, wants in tables:
        got = tck.corr_table(tex_pad, off, nu, t_n, org, b, rows).numpy()
        for want, variant in zip(wants, ("baked", "slices")):
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (rows, variant)


def _fused_in_order(tex, off, nu, t_n, org, n_beams, rows):
    """The tap-order sum with each `acc + w * g` rounded ONCE (a fused
    multiply-add: the product is exact in float64, the sum rounds to f32)."""
    hp, wp = tex.shape
    w, oj, oi = tck._unpack(off.reshape(tck.T_MAX, n_beams))
    n = int(t_n)
    acc = torch.zeros((n, rows, tck.PWIN_C), dtype=torch.float32)
    dj, di = torch.arange(rows), torch.arange(tck.PWIN_C)
    for k in range(int(nu[:n].max())):
        r = (org[0] + oj[:n, k, None] + dj).clamp(0, hp - 1)
        c = (org[1] + oi[:n, k, None] + di).clamp(0, wp - 1)
        g = tex.reshape(-1)[r[..., None] * wp + c[:, None, :]].double()
        step = (acc.double() + w[:n, k, None, None].double() * g).float()
        acc = torch.where((k < nu[:n])[:, None, None], step, acc)
    return acc.numpy()


def test_table_in_order_vs_pallas_interpret(pallas_tables):
    """The single-robot kernels with dedup weights: XLA's CPU compile of the
    TPU tap loop fuses `acc + w * block` (corr_kernel.py:130, :143) into one
    multiply-add, so the interpret-mode table equals the tap-order sum with
    one rounding per tap bit for bit. `_table_in_order` and the CUDA kernel
    round the product first (the weighted taps' products are rounded; the
    fleet's unit taps have none to round and agree everywhere,
    test_torch_fleet.py): about 1% of live cells differ, by an ulp or two."""
    b, tables, (tex_pad, off, nu, t_n) = pallas_tables
    n = int(t_n)
    assert n > 1 and int(off.numpy().view(np.uint32).max() >> 20) > 1  # weights > 1
    for rows, org, wants in tables:
        got = tck._table_in_order(tex_pad, off[None], nu[None], t_n.reshape(1), org[None], b,
                                  rows)[0].numpy()[:n]
        fused = _fused_in_order(tex_pad, off, nu, t_n, org, b, rows)
        for want in wants:
            np.testing.assert_array_equal(fused, want[:n], err_msg=str(rows))
            np.testing.assert_allclose(got, want[:n], rtol=1e-6, atol=0, err_msg=str(rows))
            assert (got == want[:n]).mean() >= 0.98


def _edge_case(maps, pallas_tables, case):
    """JAX's 400-beam dedup prepass for one edge case of the table kernels:
    "corner", a cloud at the map's (0, 0) corner (window origin j0 = i0 = 0,
    the taps reaching into the padding); "t_n_1", one live bin; "nu_zero",
    a live bin without taps. Returns (jpre, the port's table inputs)."""
    jmap, _, tmap, _, _ = maps
    b, _, (tex_pad, off, nu, t_n) = pallas_tables
    if case == "corner":
        half = 448 * 0.05 / 2.0
        jpre, _ = _prepasses(jmap, tmap, _poses(300, 6, 0.1, 0.02, (-half + 0.2, -half + 0.2)),
                             b, True)
        assert int(jpre["i0"]) == 0 and int(jpre["j0_tight"]) == 0
        off = torch.from_numpy(np.array(jpre["off"]))
    else:
        jpre, _ = _prepasses(jmap, tmap, _poses(300, 2, 0.1, 0.02), b, True)
        jpre = dict(jpre)
        assert int(jpre["t_n"]) > 2
        if case == "t_n_1":
            jpre["t_n"] = jnp.int32(1)
        else:
            jpre["nu"] = jpre["nu"].at[1].set(0)
    return jpre, (tex_pad, off, torch.from_numpy(np.array(jpre["nu"])),
                  torch.tensor(int(jpre["t_n"]), dtype=torch.int32))


@pytest.mark.parametrize("case", ["corner", "t_n_1", "nu_zero"])
def test_table_edge_cases_vs_pallas_interpret(maps, pallas_tables, case):
    """The edge cases the CUDA table kernel must get right, held on the CPU
    between the port's table (its plain version and the tap-order sum) and
    the TPU kernel in interpret mode at the 24-row window: bins past t_n
    and a bin without taps are exactly zero; live cells within the file's
    tolerances, the fused tap-order emulation bit for bit."""
    jmap = maps[0]
    b = pallas_tables[0]
    jpre, (tex_pad, off, nu, t_n) = _edge_case(maps, pallas_tables, case)
    rows, j0 = 24, jpre["j0_tight"]
    org = torch.tensor([int(j0) + tck.PAD_R, int(jpre["i0"]) + tck.PAD_C], dtype=torch.int32)
    want = np.asarray(jck._corr_table(jmap.corr_psi_pad, jpre, b, rows, j0, True,
                                      jmap.corr_psi_pre))
    got = tck.corr_table(tex_pad, off, nu, t_n, org, b, rows).numpy()
    in_order = tck._table_in_order(tex_pad, off[None], nu[None], t_n.reshape(1), org[None], b,
                                   rows)[0].numpy()
    n = int(t_n)
    assert not got[n:].any() and not want[n:].any() and not in_order[n:].any()
    if case == "nu_zero":
        assert not got[1].any() and not want[1].any() and not in_order[1].any()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(_fused_in_order(tex_pad, off, nu, t_n, org, b, rows),
                                  want[:n])
    np.testing.assert_allclose(in_order, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("q", [False, True])
def test_single_table_input_checks(q):
    """corr_table / corr_table_q take a 0-dim t_n of any integer type and
    raise on a texture, tap, tap-count or origin of the wrong type or
    shape, on more than one t_n and on a window height they lack."""
    fn = tck.corr_table_q if q else tck.corr_table
    tex = torch.zeros((600, 800), dtype=torch.int8 if q else torch.float32)
    off = torch.zeros(tck.T_MAX * 8, dtype=torch.int32)
    nu = torch.ones(tck.T_MAX, dtype=torch.int32)
    org = torch.tensor([200, 300], dtype=torch.int32)
    good = (tex, off, nu, torch.tensor(2, dtype=torch.int32), org, 8, 32)
    assert fn(*good).shape == (tck.T_MAX, 32, tck.PWIN_C)
    assert fn(*good[:3], torch.tensor(2), *good[4:]).shape == (tck.T_MAX, 32, tck.PWIN_C)
    bad = [(tex.double(), *good[1:]), (tex[None], *good[1:]),
           (tex, off[:-1], *good[2:]), (tex, off.long(), *good[2:]),
           (*good[:2], nu[:-1], *good[3:]), (*good[:2], nu.long(), *good[3:]),
           (*good[:3], torch.tensor([2, 2], dtype=torch.int32), *good[4:]),
           (*good[:4], org[:1], *good[5:]), (*good[:4], org.long(), *good[5:]),
           (*good[:6], 48), (*good[:6], 24 if q else 16)]
    for args in bad:
        with pytest.raises(ValueError):
            fn(*args)


@pytest.mark.parametrize("case", ["on_map", "edge"])
def test_folded_likelihood_matches(maps, case):
    """planar_likelihood on the corr backend with folded factors: the fused
    arm (every particle on the map) and the generic arm (some off)."""
    jmap, jparams, tmap, tmap_own, tparams = maps
    if case == "on_map":
        poses = _poses(600, 3, 0.15, 0.04)
    else:
        half = 448 * 0.05 / 2.0
        poses = _poses(600, 4, 0.15, 0.04, center=(half - 0.7, 0.0))
        poses[:5, 0] = half + 0.3
    n = poses.shape[0]
    jscan = _scan(64)
    p_j, mf_j = jplanar.planar_likelihood(
        jmap, jparams, jscan, jnp.asarray(poses), jnp.ones((n,), bool), jnp.int32(n),
        "likelihood_field", backend="pallas_corr_interpret", fold_factors=True)
    assert mf_j is None
    tscan = convert.scan_from_numpy(jscan, device="cpu")
    for omap in (tmap, tmap_own):
        p_t, mf_t = tplanar.planar_likelihood(
            omap, tparams, tscan, torch.from_numpy(poses), torch.ones(n, dtype=torch.bool),
            torch.tensor(n, dtype=torch.int32), "likelihood_field", backend="corr",
            fold_factors=True)
        assert mf_t is None
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5)
