"""The plain reference against cases worked out by hand."""

import math

import numpy as np
import pytest
import torch

from perfbench.reference import amcl

P = {"laser_z_hit": 0.5, "laser_z_rand": 0.5, "laser_sigma_hit": 0.05,
     "laser_gompertz_a": 0.941, "laser_gompertz_b": 5.0, "laser_gompertz_c": 3.0,
     "laser_gompertz_input_shift": -0.97, "laser_gompertz_input_scale": 2.0,
     "laser_gompertz_output_shift": 0.25}


def _brute(occ: np.ndarray) -> np.ndarray:
    pts = np.argwhere(occ)
    idx = np.indices(occ.shape).reshape(occ.ndim, -1).T
    d2 = ((idx[:, None, :] - pts[None]) ** 2).sum(-1).min(1)
    return d2.reshape(occ.shape)


def test_capped_field_is_the_exact_distance_within_the_cap():
    rng = np.random.default_rng(0)
    occ = rng.random((23, 31)) < 0.03
    occ[5, 7] = True
    d = amcl.capped_field_2d(torch.as_tensor(occ), 0.05, 0.36, torch.float64).numpy()
    d2 = _brute(occ)
    want = np.where(d2 <= 7 * 7, np.sqrt(d2) * 0.05, 0.36)  # cell radius floor(7.2) = 7
    assert np.allclose(d, want, rtol=0, atol=1e-12)


def test_voxel_levels_quantize_the_distance():
    occ = np.zeros((9, 8, 7), bool)
    occ[4, 3, 2] = True
    lv = amcl.voxel_levels(torch.as_tensor(occ), 0.05, 0.3).numpy()
    d = np.sqrt(_brute(occ)) * 0.05
    assert np.array_equal(lv, np.floor(np.minimum(d, 0.3) / 0.3 * 255).astype(np.uint8))
    assert lv[4, 3, 2] == 0 and lv[8, 7, 6] == 255


def test_gompertz_by_hand():
    s = 0.75
    x = s * 2.0 - 0.97
    want = 0.941 * math.exp(-5.0 * math.exp(-3.0 * x)) + 0.25
    assert float(amcl.gompertz(P, torch.tensor(s, dtype=torch.float64))) == pytest.approx(want)


def test_planar_gompertz_one_pose_one_beam_by_hand():
    # a 2 x 2 grid supersampled to 4 x 4 at 0.025 m, the top-right cell occupied:
    # cells (2..3, 2..3); world (0, 0) is the centre of cell (0, 0)
    data = np.array([0, 0, 0, 100], np.int8)
    m = amcl.PlanarMap(data, 2, 2, 0.05, (0.0, 0.0), 2, 0.36, torch.float64, "cpu")
    # a pose at (0, 0), a beam of 0.025 m along x: its endpoint is cell (1, 0),
    # sqrt(5) cells from the occupied (2, 2)
    pose = torch.tensor([[0.0, 0.0, 0.0]], dtype=torch.float64)
    r, a, v = (torch.tensor([0.025], dtype=torch.float64), torch.tensor([0.0], dtype=torch.float64),
               torch.tensor([True]))
    got = float(amcl.planar_gompertz(m, P, (0.95, 0.95, 0.3), r, a, v, pose)[0])
    d_end = 0.025 * math.sqrt(5)
    pz = 0.5 * math.exp(-(d_end ** 2) / (2 * 0.05 ** 2)) + 0.5
    lik = 0.941 * math.exp(-5 * math.exp(-3 * (pz * 2 - 0.97))) + 0.25
    # the pose's own cell (0, 0) is free and sqrt(8) cells from the obstacle:
    # within the 0.3 m radius, the factor 0.95 + d / 0.3 * 0.05
    d = 0.025 * math.sqrt(8)
    assert got == pytest.approx(lik * (0.95 + d / 0.3 * 0.05), rel=1e-12)
    off = torch.tensor([[5.0, 5.0, 0.0]], dtype=torch.float64)
    got_off = float(amcl.planar_gompertz(m, P, (0.95, 0.95, 0.3), r, a, v, off)[0])
    pz_off = 0.5 * math.exp(-(0.36 ** 2) / (2 * 0.05 ** 2)) + 0.5
    lik_off = 0.941 * math.exp(-5 * math.exp(-3 * (pz_off * 2 - 0.97))) + 0.25
    assert got_off == pytest.approx(lik_off * 0.95, rel=1e-12)


def test_planar_beams_decimate_and_clamp():
    ranges = np.full(541, 5.0, np.float32)
    ranges[9] = 0.01  # below range_min: reads range_max, an invalid beam
    r, a, v = amcl.planar_beams(ranges, -1.0, 0.01, 0.05, 20.0, 60, torch.float64)
    assert r.shape == (61,) and a[1] == pytest.approx(-1.0 + 9 * 0.01)
    assert not bool(v[1]) and int(v.sum()) == 60


def test_cloud_gompertz_by_hand():
    cells = np.array([[10, 10, 0], [20, 20, 5]])
    m = amcl.VoxelMap(cells, 0.05, 0.3, torch.float64, "cpu")
    pts = torch.tensor([[0.0, 0.0, 0.0]], dtype=torch.float64)
    pose = torch.tensor([[0.5, 0.5, 0.3]], dtype=torch.float64)  # on voxel (10, 10, 0)
    got = float(amcl.cloud_gompertz(m, P, 0.95, pts, pose)[0])
    pz = 0.5 + 0.5
    assert got == pytest.approx(0.941 * math.exp(-5 * math.exp(-3 * (pz * 2 - 0.97))) + 0.25)
    outside = torch.tensor([[3.0, 0.5, 0.0]], dtype=torch.float64)
    pz = 0.5 * math.exp(-(0.3 ** 2) / (2 * 0.05 ** 2)) + 0.5
    want = (0.941 * math.exp(-5 * math.exp(-3 * (pz * 2 - 0.97))) + 0.25) * 0.95
    assert float(amcl.cloud_gompertz(m, P, 0.95, pts, outside)[0]) == pytest.approx(want)


def test_normalize():
    w = amcl.normalize(torch.tensor([0.5, 0.25, 0.25, 0.0]), torch.tensor([1.0, 2.0, 2.0, 9.0]), 3)
    assert torch.allclose(w, torch.tensor([0.5, 0.25, 0.25]) * torch.tensor([1.0, 2.0, 2.0]) / 1.5)


def test_fox_limit_by_hand():
    k, err, z = 10, 0.0025, 0.9975
    b = 2 / (9 * 9)
    want = math.ceil(9 / (2 * err) * (1 - b + math.sqrt(b) * z) ** 3)
    assert amcl.fox_limit(k, 2000, 8000, err, z) == {want}
    assert amcl.fox_limit(1, 2000, 8000, err, z) == {8000}
    assert amcl.fox_limit(2, 2000, 8000, err, z) == {2000}
    # a bound within float32 rounding of an integer may round either way
    err = (7 / 9) ** 3 / 200  # k = 2, z = 0: the bound is 100, up to rounding
    assert amcl.fox_limit(2, 1, 10 ** 6, err, 0.0, rel=1e-6) == {100, 101}


def _fox(j):
    (v,) = amcl.fox_limit(j, 1, 100, 0.25, 1.0)
    return v


def test_kld_counts_tolerate_only_bin_edges():
    poses = torch.tensor([[0.1, 0.1, 0.05], [0.2, 0.1, 0.05], [1.1, 0.1, 0.05]],
                         dtype=torch.float64)
    assert amcl.kld_counts(poses, 3, 0.0, 0.0, 1, 100, 0.25, 1.0, torch.float64) == {_fox(2)}
    edge = poses.clone()
    edge[2, 0] = 1.0 + 1e-9  # on the edge of bin 2: one or two bins of x
    assert amcl.kld_counts(edge, 3, 0.0, 0.0, 1, 100, 0.25, 1.0, torch.float64) == {
        _fox(j) for j in (1, 2, 3)}
    # w_diff 0.5: the count 4 * 1.5 = 6 exactly, which float32 may truncate to 5
    inflated = amcl.kld_counts(poses, 3, 2.0, 1.0, 1, 100, 0.25, 1.0, torch.float64)
    assert _fox(2) == 4 and inflated == {5, 6}


def test_cluster_stats_by_hand():
    # two clusters: three particles around (1, 1), one at (10, 10), equal weights
    poses = torch.tensor([[1.0, 1.0, 0.1], [1.2, 1.0, 0.1], [1.1, 1.3, -0.1],
                          [10.0, 10.0, 3.0]], dtype=torch.float64)
    w = torch.full((4,), 0.25, dtype=torch.float64)
    s = amcl.cluster_stats(poses, w, torch.float64)
    order = torch.argsort(s["weights"])
    assert torch.allclose(s["weights"][order], torch.tensor([0.25, 0.75], dtype=torch.float64))
    heavy = s["means"][order[1]]
    assert torch.allclose(heavy[:2], torch.tensor([1.1, 1.1], dtype=torch.float64))
    # the circular mean of 0.1, 0.1 and -0.1
    assert float(heavy[2]) == pytest.approx(math.atan2(math.sin(0.1), 3 * math.cos(0.1)))
    mx = poses[:, 0].mean()
    assert float(s["cov"][0]) == pytest.approx(float((poses[:, 0] ** 2).mean() - mx ** 2))
    r = math.hypot(float(torch.cos(poses[:, 2]).mean()), float(torch.sin(poses[:, 2]).mean()))
    assert float(s["cov"][3]) == pytest.approx(-2 * math.log(r))


def test_odometry_motion_by_hand():
    # three steps of 0.1 m straight ahead along +y, the robot facing +y
    odom = np.array([[1.0, 2.0, math.pi / 2], [1.0, 2.1, math.pi / 2], [1.0, 2.2, math.pi / 2],
                     [1.0, 2.3, math.pi / 2]])
    pose, delta, absolute = amcl.odometry_motion(odom, 0.25, 0.5)
    assert torch.allclose(pose, torch.tensor(odom[-1]))
    assert torch.allclose(delta, torch.tensor([0.0, 0.3, 0.0], dtype=torch.float64), atol=1e-12)
    assert torch.allclose(absolute, torch.tensor([0.3, 0.0, 0.0], dtype=torch.float64), atol=1e-12)
    # past twice update_min_d the odometry's own delta stands in
    _, delta, absolute = amcl.odometry_motion(odom, 0.1, 0.5)
    assert torch.equal(absolute, delta)


def test_gaussian_motion_by_hand():
    poses = torch.tensor([[0.0, 0.0, 0.0], [5.0, 1.0, math.pi / 2]], dtype=torch.float64)
    f64 = torch.float64
    pose, delta = torch.tensor([3.0, 4.0, 0.2], dtype=f64), torch.tensor([0.2, 0.0, 0.2], dtype=f64)
    absolute = delta.clone()
    alphas = (0.01, 0.0025, 0.015, 0.001, 0.015)
    still = amcl.gaussian_motion(poses, torch.zeros(3, 2), pose, delta, absolute, alphas,
                                 torch.float64)
    # no noise: 0.2 m along the bearing atan2(0, 0.2) - (0.2 - 0.2) + yaw = yaw
    want = torch.tensor([[0.2, 0.0, 0.2], [5.0, 1.2, math.pi / 2 + 0.2]], dtype=torch.float64)
    assert torch.allclose(still, want, atol=1e-12)
    normals = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    moved = amcl.gaussian_motion(poses, normals, pose, delta, absolute, alphas, torch.float64)
    trans_sd = math.sqrt(0.015 * 0.04 + 0.001 * 0.04)
    strafe_sd = math.sqrt(0.001 * 0.04)
    rot_sd = math.sqrt(0.01 * 0.04 + 0.0025 * 0.04)
    h0 = 0.1  # mid-heading of particle 0
    assert moved[0, 0].item() == pytest.approx(0.2 + trans_sd * math.cos(h0), abs=1e-12)
    assert moved[0, 1].item() == pytest.approx(trans_sd * math.sin(h0), abs=1e-12)
    assert moved[0, 2].item() == pytest.approx(0.2 + rot_sd, abs=1e-12)
    h1 = math.pi / 2 + 0.1
    assert moved[1, 0].item() == pytest.approx(5.0 + strafe_sd * math.sin(h1), abs=1e-12)
    assert moved[1, 1].item() == pytest.approx(1.2 - strafe_sd * math.cos(h1), abs=1e-12)


def test_comb_draw_and_its_gap_by_hand():
    poses = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    weights = torch.tensor([0.5, 0.0, 0.25, 0.25])
    pool = torch.full((4, 3), 9.0)
    # four comb points 0.1, 0.35, 0.6, 0.85: particles 0, 0, 2, 3
    drawn = amcl.comb_draw(poses, weights, pool, 0.1, 4, 0, torch.float64)
    assert torch.equal(drawn, poses[[0, 0, 2, 3]])
    assert amcl.draw_gap(poses, weights, pool, drawn, 0.1, 0) == 0.0
    # particle 3 in the third slot: its interval [0.75, 1) lies 0.15 above 0.6
    wrong = poses[[0, 0, 3, 3]]
    assert amcl.draw_gap(poses, weights, pool, wrong, 0.1, 0) == pytest.approx(0.15)
    # a pose the set does not hold, or a pool slot not from the pool: 1
    odd = drawn.clone()
    odd[1, 0] = 0.5
    assert amcl.draw_gap(poses, weights, pool, odd, 0.1, 0) == 1.0
    with_pool = amcl.comb_draw(poses, weights, pool, 0.1, 4, 1, torch.float64)
    assert torch.equal(with_pool, torch.cat([pool[:1], poses[[0, 0, 3]]]))  # 0.1, 0.43, 0.77
    assert amcl.draw_gap(poses, weights, pool, with_pool, 0.1, 1) == 0.0
    assert amcl.draw_gap(poses, weights, pool, drawn, 0.1, 1) == 1.0
    # round the circle: a comb point at 0.999 drawing particle 0 of [0, 0.5)
    # is 0.001 off, not 0.499
    late = poses[[0, 0, 2, 0]]
    assert amcl.draw_gap(poses, weights, pool, late, 0.249, 0) == pytest.approx(0.001)


def test_a_float32_comb_that_wraps_is_no_gap():
    # with 8,000 slots from u = 0.9815 (float32), slot 148's comb point is
    # 1 - 3e-8 in float64 but rounds to 1.0, so 0.0, in float32: a float32
    # draw takes the first particle where float64 takes the last
    n = 8000
    g = torch.Generator().manual_seed(3)
    poses = torch.rand((n, 3), generator=g)
    w = torch.rand(n, generator=g)
    weights = w / w.sum()
    u = torch.tensor(0.981499969959259, dtype=torch.float32)
    t = torch.remainder(u + torch.arange(n).float() * (1.0 / torch.tensor(float(n))), 1.0)
    assert t[148] == 0.0
    idx = torch.searchsorted(torch.cumsum(weights, 0), t, right=True).clamp(max=n - 1)
    drawn = poses[idx]
    assert torch.equal(drawn[148], poses[0])
    want = amcl.comb_draw(poses, weights, poses, float(u), n, 0, torch.float64)
    assert torch.equal(want[148], poses[n - 1])
    assert amcl.draw_gap(poses, weights, poses, drawn, float(u), 0) < 1e-6
