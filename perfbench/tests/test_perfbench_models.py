"""The node's other models in the output check: the plain and prob
likelihood fields (with beam skipping), the diff odometry and multinomial
resampling, each reference function against a case worked by hand; the
check's choice of model by the configuration; and the 2D node run on
each combination at a size a CPU test can hold, correct under the track
cell's limits, its control and a broken path not."""

import copy
import math

import numpy as np
import pytest
import torch

from perfbench import core
from perfbench.reference import amcl, check
from perfbench.tests.conftest import SMALL_2D

F64 = torch.float64
P = {"laser_z_hit": 0.95, "laser_z_rand": 0.05, "laser_sigma_hit": 0.2}
NO_FACTORS = (1.0, 1.0, 0.0)


def _pz(d, range_max=10.0):
    return 0.95 * math.exp(-d * d / (2 * 0.2 ** 2)) + 0.05 / range_max


def _corner_map(max_dist=0.36):
    # a 2 x 2 grid supersampled to 4 x 4 at 0.025 m, the top-right cell
    # occupied: cells (2..3, 2..3); world (0, 0) is the centre of cell (0, 0)
    return amcl.PlanarMap(np.array([0, 0, 0, 100], np.int8), 2, 2, 0.05, (0.0, 0.0), 2,
                          max_dist, F64, "cpu")


def _one_beam(r):
    return (torch.tensor([r], dtype=F64), torch.tensor([0.0], dtype=F64),
            torch.tensor([True]))


def _field(m, p, fac, beams, poses, model, **kw):
    """The likelihood of `amcl.planar_field` with no slack: its one
    alternative's two ends, which meet."""
    (lo, hi), = amcl.planar_field(m, p, fac, *beams, 10.0, poses, model, **kw)
    assert torch.equal(lo, hi)
    return lo.tolist()


LF, PROB = "likelihood_field", "likelihood_field_prob"


def test_one_beam_at_a_known_distance_by_hand():
    m = _corner_map()
    pose = torch.tensor([[0.0, 0.0, 0.0]], dtype=F64)
    # a beam of 0.025 m along x ends in cell (1, 0), sqrt(5) cells from (2, 2)
    beam = _one_beam(0.025)
    pz = _pz(0.025 * math.sqrt(5))
    # the pose's own cell is free and sqrt(8) cells from the obstacle
    factor = 0.95 + 0.025 * math.sqrt(8) / 0.3 * 0.05
    fac = (0.95, 0.95, 0.3)
    assert _field(m, P, fac, beam, pose, LF) == [pytest.approx((1.0 + pz ** 3) * factor,
                                                               rel=1e-12)]
    assert _field(m, P, fac, beam, pose, PROB) == [pytest.approx(pz * factor, rel=1e-12)]
    # an endpoint off the map reads max_dist; a pose off the map takes off_map
    off = torch.tensor([[5.0, 5.0, 0.0]], dtype=F64)
    assert _field(m, P, fac, beam, off, PROB) == [pytest.approx(_pz(0.36) * 0.95, rel=1e-12)]
    # a beam at range_max is no reading: p = 1 and exp(0)
    none = beam[:2] + (torch.tensor([False]),)
    assert _field(m, P, NO_FACTORS, none, pose, LF) == [1.0]
    assert _field(m, P, NO_FACTORS, none, pose, PROB) == [1.0]


def test_an_endpoint_on_a_cell_edge_may_read_either_cell():
    m = _corner_map()
    pose = torch.tensor([[0.0, 0.0, 0.0]], dtype=F64)
    # 0.0125 m along x is the edge of cells (0, 0) and (1, 0)
    (lo, hi), = amcl.planar_field(m, P, NO_FACTORS, *_one_beam(0.0125), 10.0, pose, PROB,
                                  slack=amcl.EDGE_SLACK)
    want = sorted([_pz(0.025 * math.sqrt(8)), _pz(0.025 * math.sqrt(5))])
    assert [float(lo[0]), float(hi[0])] == pytest.approx(want, rel=1e-12)
    # well inside a cell the bounds meet
    (lo, hi), = amcl.planar_field(m, P, NO_FACTORS, *_one_beam(0.025), 10.0, pose, LF,
                                  slack=amcl.EDGE_SLACK)
    assert float(lo[0]) == float(hi[0]) == pytest.approx(1.0 + _pz(0.025 * math.sqrt(5)) ** 3)


def _wall_map():
    """2 x 2 m at 0.05 m (cell i's centre at x = 0.05 i), a wall in column
    30 (x = 1.5), max_dist 2.0."""
    data = np.zeros((40, 40), np.int8)
    data[:, 30] = 100
    return amcl.PlanarMap(data.ravel(), 40, 40, 0.05, (0.0, 0.0), 1, 2.0, F64, "cpu")


# three particles facing +x at y = 1; beam A 1 m ahead, beam B 0.5 m to the left
WALL_POSES = torch.tensor([[0.5, 1.0, 0.0], [0.6, 1.0, 0.0], [0.0, 1.0, 0.0]], dtype=F64)
WALL_BEAMS = (torch.tensor([1.0, 0.5], dtype=F64), torch.tensor([0.0, math.pi / 2], dtype=F64),
              torch.tensor([True, True]))
# beam A ends on the wall, 0.1 m past it and 0.5 m short of it; beam B
# 1.0, 0.9 and 1.5 m from the wall
PZ_A = [_pz(0.0), _pz(0.1), _pz(0.5)]
BOTH = [_pz(0.0) * _pz(1.0), _pz(0.1) * _pz(0.9), _pz(0.5) * _pz(1.5)]


def test_beam_skipping_keeps_a_beam_two_of_three_particles_agree_on():
    m, p = _wall_map(), dict(P, beam_skip_distance=0.5, beam_skip_threshold=0.5)
    # beam A: particles 0 and 1 end within 0.5 m of the wall, 2 / 3 > 0.5;
    # beam B: none does. One of two slots skipped, under 2 * 0.9
    got = _field(m, p, NO_FACTORS, WALL_BEAMS, WALL_POSES, PROB, skip_slots=2)
    assert got == pytest.approx(PZ_A, rel=1e-12)
    # without the skip (not converged) every valid beam counts
    assert _field(m, p, NO_FACTORS, WALL_BEAMS, WALL_POSES, PROB) == pytest.approx(BOTH,
                                                                                 rel=1e-12)


def test_the_beam_skip_error_fallback_integrates_every_slot():
    m = _wall_map()
    p = dict(P, beam_skip_distance=0.5, beam_skip_threshold=0.5, beam_skip_error_threshold_=0.5)
    # one of two slots skipped reaches 2 * 0.5: every beam counts
    got = _field(m, p, NO_FACTORS, WALL_BEAMS, WALL_POSES, PROB, skip_slots=2)
    assert got == pytest.approx(BOTH, rel=1e-12)
    # so do both skipped, above 2 / 3 agreeing, under 2 * 0.9
    p = dict(P, beam_skip_distance=0.5, beam_skip_threshold=0.7)
    got = _field(m, p, NO_FACTORS, WALL_BEAMS, WALL_POSES, PROB, skip_slots=2)
    assert got == pytest.approx(BOTH, rel=1e-12)
    # three slots for two beams: the empty slot holds no pz, so every weight is 0
    got = _field(m, p, NO_FACTORS, WALL_BEAMS, WALL_POSES, PROB, skip_slots=3)
    assert got == [0.0, 0.0, 0.0]
    w = amcl.normalize(torch.full((3,), 1 / 3, dtype=F64), torch.tensor(got, dtype=F64), 3)
    assert w.tolist() == [1 / 3] * 3


ODOM = (torch.tensor([1.1, 2.05, 0.5], dtype=F64), torch.tensor([0.1, 0.05, 0.2], dtype=F64))
ALPHAS = (0.2, 0.1, 0.3, 0.05, 0.2)


@pytest.mark.parametrize("corrected", [False, True])
def test_diff_motion_without_noise_moves_by_the_odometry(corrected):
    # the odometry went from (1, 2, 0.3) to (1.1, 2.05, 0.5); a particle with
    # the odometry's old heading moves by its delta, one turned a quarter
    # more by the delta turned a quarter
    poses = torch.tensor([[0.0, 0.0, 0.3], [5.0, 5.0, 0.3 + math.pi / 2]], dtype=F64)
    got = amcl.diff_motion(poses, torch.zeros(3, 2), *ODOM, ALPHAS, F64, corrected)
    want = [[0.1, 0.05, 0.5], [4.95, 5.1, 0.5 + math.pi / 2]]
    assert got.tolist() == [pytest.approx(w, abs=1e-12) for w in want]


def test_diff_and_diff_corrected_differ_by_the_square_root():
    pose, delta = ODOM
    trans = math.hypot(0.1, 0.05)
    rot1 = math.atan2(0.05, 0.1) - 0.3
    rot2 = 0.2 - rot1
    v = [0.2 * rot1 ** 2 + 0.1 * trans ** 2,
         0.3 * trans ** 2 + 0.05 * rot1 ** 2 + 0.05 * rot2 ** 2,
         0.2 * rot2 ** 2 + 0.1 * trans ** 2]
    still = torch.tensor([[0.0, 0.0, 0.3]], dtype=F64)
    for k in range(3):
        normals = torch.zeros(3, 1)
        normals[k] = 1.0
        for corrected, sd in ((False, v[k]), (True, math.sqrt(v[k]))):
            x, y, th = amcl.diff_motion(still, normals, pose, delta, ALPHAS, F64,
                                        corrected)[0].tolist()
            # upstream subtracts each draw: the first turn, the translation, the second turn
            r1 = rot1 - sd if k == 0 else rot1
            t = trans - sd if k == 1 else trans
            r2 = rot2 - sd if k == 2 else rot2
            want = [t * math.cos(0.3 + r1), t * math.sin(0.3 + r1), 0.3 + r1 + r2]
            assert [x, y, th] == pytest.approx(want, abs=1e-12)


def test_diff_motion_turns_in_place_below_a_centimetre():
    pose = torch.tensor([1.005, 2.0, 1.0], dtype=F64)
    delta = torch.tensor([0.005, 0.0, 0.7], dtype=F64)
    got = amcl.diff_motion(torch.tensor([[0.0, 0.0, 0.3]], dtype=F64), torch.zeros(3, 1),
                           pose, delta, ALPHAS, F64, False)[0].tolist()
    # no first turn: the 5 mm go along the particle's own heading
    assert got == pytest.approx([0.005 * math.cos(0.3), 0.005 * math.sin(0.3), 1.0], abs=1e-12)


SET = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
WEIGHTS = torch.tensor([0.5, 0.0, 0.25, 0.25])
POOL = torch.full((4, 3), 9.0)


def test_a_multinomial_gap_is_0_for_the_exact_pick_and_not_for_a_moved_one():
    u_pick = torch.tensor([0.1, 0.6, 0.9, 0.3])
    no_inject = torch.ones(4)
    drawn = amcl.multinomial_draw(SET, WEIGHTS, POOL, no_inject, u_pick, 0.0, F64)
    assert torch.equal(drawn, SET[[0, 2, 3, 0]])
    assert amcl.multinomial_gap(SET, WEIGHTS, POOL, drawn, no_inject, u_pick, 0.0) == 0.0
    # slot 1's pick moved one particle on: 0.6 lies 0.15 below particle 3's [0.75, 1)
    moved = SET[[0, 3, 3, 0]]
    assert amcl.multinomial_gap(SET, WEIGHTS, POOL, moved, no_inject, u_pick,
                                0.0) == pytest.approx(0.15)
    # a pose the set does not hold
    odd = drawn.clone()
    odd[2, 1] = 0.5
    assert amcl.multinomial_gap(SET, WEIGHTS, POOL, odd, no_inject, u_pick, 0.0) == 1.0


def test_a_multinomial_slot_below_w_diff_holds_its_pool_pose():
    u_pick = torch.tensor([0.1, 0.6, 0.9, 0.3])
    u_inject = torch.tensor([0.2, 0.7, 0.9, 0.1])
    pool = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 10.0
    drawn = amcl.multinomial_draw(SET, WEIGHTS, pool, u_inject, u_pick, 0.5, F64)
    # slots 0 and 3 inject their own pool poses
    assert torch.equal(drawn, torch.stack([pool[0], SET[2], SET[3], pool[3]]))
    assert amcl.multinomial_gap(SET, WEIGHTS, pool, drawn, u_inject, u_pick, 0.5) == 0.0
    # slot 3 holding the pool's first pose, or the pick, is wrong
    for wrong in (pool[0], SET[0]):
        bad = drawn.clone()
        bad[3] = wrong
        assert amcl.multinomial_gap(SET, WEIGHTS, pool, bad, u_inject, u_pick, 0.5) == 1.0
    # a uniform within rounding of w_diff may fall either way
    near = u_inject.clone()
    near[3] = 0.5 - 1e-8
    picked = drawn.clone()
    picked[3] = SET[0]
    assert amcl.multinomial_gap(SET, WEIGHTS, pool, picked, near, u_pick, 0.5) == 0.0


def _fox(j):
    (v,) = amcl.fox_limit(j, 1, 100, 0.25, 1.0)
    return v


def test_multinomial_counts_stop_where_the_draws_pass_the_bound():
    assert (_fox(2), _fox(3)) == (4, 8)
    a, b, c = [0.1, 0.1, 0.05], [1.1, 0.1, 0.05], [2.1, 0.1, 0.05]
    kld = (1, 100, 0.25, 1.0)
    # two bins from the second draw: the bound 4, passed by the fifth
    seq = torch.tensor([a, b] + [a] * 10, dtype=F64)
    assert torch.nonzero(amcl.multinomial_counts(seq, *kld, F64)).flatten().tolist() == [4]
    # a third bin at the fifth draw raises the bound to 8: the ninth stops
    seq = torch.tensor([a, b, a, a, c] + [a] * 10, dtype=F64)
    assert torch.nonzero(amcl.multinomial_counts(seq, *kld, F64)).flatten().tolist() == [8]
    # one bin all along: the bound is max_samples, where the draws end
    seq = torch.tensor([a] * 12, dtype=F64)
    assert amcl.multinomial_counts(seq, 1, 12, 0.25, 1.0, F64).tolist() == [False] * 11 + [True]
    # the fifth draw on a bin's edge may land in the third bin or the first
    edge = [1.0 + 1e-9, 0.1, 0.05]
    seq = torch.tensor([a, b, a, a, edge] + [a] * 10, dtype=F64)
    allowed = torch.nonzero(amcl.multinomial_counts(seq, *kld, F64)).flatten() + 1
    assert 5 in allowed.tolist() and 9 in allowed.tolist()


def _grid_input():
    return dict(kind="occupancy_grid", data=np.zeros(16, np.int8), width=4, height=4,
                resolution=0.05, origin=(0.0, 0.0))


def _config(**params):
    base = core.load_json(core.ROOT, "perfbench", "configs", "amcl_2d_store.json")
    base["params"].update(params)
    return base


@pytest.mark.parametrize("key,name", [("laser_model_type", "beam"),
                                      ("odom_model_type", "omni"),
                                      ("odom_model_type", "omni-corrected"),
                                      ("resample_model_type", "stratified")])
def test_the_check_names_a_model_it_lacks(key, name):
    with pytest.raises(ValueError, match=repr(name)):
        check.Model(_config(**{key: name}), _grid_input(), None, F64, "cpu")


def test_the_check_takes_only_the_gompertz_point_cloud_model():
    cfg = core.load_json(core.ROOT, "perfbench", "configs", "amcl_3d_store.json")
    cells = np.array([[0, 0, 0], [3, 3, 3]])
    octomap = dict(kind="octomap", cells=cells, resolution=0.05)
    assert check.Model(cfg, octomap, (0, 0, 0), F64, "cpu").laser == "likelihood_field_gompertz"
    cfg["params"]["laser_model_type"] = "likelihood_field"
    with pytest.raises(ValueError, match="point-cloud model 'likelihood_field'"):
        check.Model(cfg, octomap, (0, 0, 0), F64, "cpu")


@pytest.mark.parametrize("params,want", [
    ({}, ("likelihood_field_gompertz", "gaussian", "systematic", False)),
    ({"laser_model_type": "likelihood_field_prob", "do_beamskip": True,
      "odom_model_type": "diff-corrected"},
     ("likelihood_field_prob", "diff-corrected", "systematic", True)),
])
def test_the_check_chooses_its_models_by_the_configuration(params, want):
    m = check.Model(_config(**params), _grid_input(), None, F64, "cpu")
    assert (m.laser, m.odom, m.resample, m.beamskip) == want
    # upstream's defaults where the configuration is silent
    cfg = _config()
    for key in ("laser_model_type", "odom_model_type", "resample_model_type"):
        del cfg["params"][key]
    m = check.Model(cfg, _grid_input(), None, F64, "cpu")
    assert (m.laser, m.odom, m.resample) == ("likelihood_field", "diff", "multinomial")


# the two combinations of the node's other models, over the 2D track cell:
# (a) ROS amcl's defaults, (b) the prob model with beam skipping; both
# at ROS's likelihood_max_dist of 2 m
COMBOS = {
    "a": {"laser_model_type": "likelihood_field", "odom_model_type": "diff",
          "resample_model_type": "multinomial", "laser_likelihood_max_dist": 2.0},
    "b": {"laser_model_type": "likelihood_field_prob", "do_beamskip": True,
          "odom_model_type": "diff-corrected", "resample_model_type": "systematic",
          "laser_likelihood_max_dist": 2.0},
}
SEED = 2 ** 31 + 5
LIMITS = core.load_json(core.HERE, "limits", "amcl_2d_store.track.json")


def _overrides(combo):
    ov = copy.deepcopy(SMALL_2D)
    ov["config"]["params"].update(COMBOS[combo])
    return ov


@pytest.fixture(scope="module")
def combo_run():
    """A combination's run on the small store, control included, once a
    module, with what the check was handed."""
    runs = {}

    def run(combo):
        if combo not in runs:
            seen = {}
            real = check.readings

            def readings(records, *args, **kwargs):
                seen["records"] = records
                return real(records, *args, **kwargs)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(check, "readings", readings)
                runs[combo] = core.run_cell("amcl_2d_store.track", SEED, 2.0, False,
                                            device="cpu", overrides=_overrides(combo),
                                            control=True) + (seen["records"],)
        return runs[combo]
    return run


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_a_combination_is_correct_under_the_track_limits_and_its_control_is_not(combo_run,
                                                                                 combo):
    result, log, read, records = combo_run(combo)
    assert result["correct"], log
    ok, rows = check.verdict(read["control"], LIMITS)
    assert not ok, rows
    assert all(read["counts"][k] >= 1 for k in check.NAMES), read["counts"]
    resample = records["resamples"][0]["resample"]
    variates = {"a": ("u_inject", "u_pick"), "b": ("u_start",)}[combo]
    assert sorted(k for k in resample if k.startswith("u_")) == sorted(variates)


def test_a_multinomial_draw_that_injects_pool_poses_is_correct(monkeypatch):
    """With w_diff held at 0.3 at every resample (w_fast 0.7 of w_slow), a
    third of the drawn slots take their pool pose: the check follows
    them, and the stop rule over the injected poses."""
    from badger_amcl_tpu_torch.node import node as node_mod

    real = node_mod.Node.resample_particles

    def resample_particles(self):
        self.state = self.state.replace(w_slow=torch.ones_like(self.state.w_slow),
                                        w_fast=torch.full_like(self.state.w_fast, 0.7))
        return real(self)
    monkeypatch.setattr(node_mod.Node, "resample_particles", resample_particles)
    seen = {}
    real_readings = check.readings

    def readings(records, *args, **kwargs):
        seen["records"] = records
        return real_readings(records, *args, **kwargs)
    monkeypatch.setattr(check, "readings", readings)
    result, log, read = core.run_cell("amcl_2d_store.track", SEED, 2.0, False, device="cpu",
                                      overrides=_overrides("a"))
    assert result["correct"], log
    injected = 0
    for rec in seen["records"]["resamples"]:
        r = rec["resample"]
        injected += int((r["u_inject"][:int(r["state_out"].n_active)] < 0.3).sum())
    assert injected > 100 and read["counts"]["draw_gap"] >= 1


def _flat_weights(real):
    def resample(state, *args, **kwargs):
        n = state.n_active
        w = torch.where(torch.arange(state.weights.shape[0]) < n, 1.0 / n.float(), 0.0)
        return real(state.replace(weights=w), *args, **kwargs)
    return resample


def _no_odometry(real):
    def motion(state, model, alphas, pose, delta, normals, absolute):
        return real(state, model, alphas, pose, torch.zeros_like(delta), normals, absolute)
    return motion


def _unchanged(state, *args, **kwargs):
    return state


@pytest.mark.parametrize("combo,fault", [("a", "resample_flat_weights"),
                                         ("a", "motion_no_odometry"),
                                         ("b", "update_unchanged"),
                                         ("b", "resample_unchanged")])
def test_a_broken_path_of_a_combination_is_not_correct(monkeypatch, combo, fault):
    from badger_amcl_tpu_torch.node import node as node_mod
    from badger_amcl_tpu_torch.node import node_2d

    if fault == "resample_flat_weights":
        monkeypatch.setattr(node_mod, "_resample_jit", _flat_weights(node_mod._resample_jit))
    elif fault == "motion_no_odometry":
        monkeypatch.setattr(node_mod, "_motion_update_jit",
                            _no_odometry(node_mod._motion_update_jit))
    elif fault == "update_unchanged":
        monkeypatch.setattr(node_2d, "_sensor_update_jit", _unchanged)
    else:
        monkeypatch.setattr(node_mod, "_resample_jit", _unchanged)
    result, log, read = core.run_cell("amcl_2d_store.track", SEED, 2.0, False, device="cpu",
                                      overrides=_overrides(combo))
    assert not result["correct"], log
