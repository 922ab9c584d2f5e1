"""The output check on the CPU at a size a test can hold: a sound run comes
out correct; its control (the reference in bfloat16 in the program's
place) and a run with the timed path broken underneath come out not
correct: a step that returns its state unchanged, half of the particles
left out of the likelihood with the mean of the rest in their place, an
answer altered where it is produced (the published pose moved, the
motion model blind to odometry, the resample blind to the weights). The
cells run on one card, so no exchange between cards can be left out."""

import numpy as np
import pytest
import torch

from perfbench import core
from perfbench.reference import check
from perfbench.tests.conftest import SMALL_2D, SMALL_3D

CELLS = {"amcl_2d_store.track": SMALL_2D, "amcl_3d_store.track": SMALL_3D}
SEED = 2 ** 31 + 5


def _run(workload, control=False, seconds=2.0):
    return core.run_cell(workload, SEED, seconds, False, device="cpu",
                         overrides=CELLS[workload], control=control)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct_and_its_control_is_not(workload):
    result, log, read = _run(workload, control=True)
    assert result["correct"], log
    assert list(result)[-1] == "checks" and log[-1].startswith("check ")
    limits = core.load_json(core.HERE, "limits", workload + ".json")
    ok, rows = check.verdict(read["control"], limits)
    assert not ok, rows
    for name in check.NAMES:
        if read["program"][name] is not None and read["control"][name] is not None:
            assert read["program"][name] <= limits[name]


def _unchanged(state, *args, **kwargs):
    return state


def _half_left_out(real):
    def step(state, *args, **kwargs):
        out = real(state, *args, **kwargs)
        n = int(state.n_active)
        ratio = torch.where(state.weights > 0, out.weights / state.weights, 0.0)
        w = out.weights.clone()
        w[n // 2:n] = state.weights[n // 2:n] * ratio[:n // 2].mean()
        return out.replace(weights=w / w[:n].sum())
    return step


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("fault", ["update_unchanged", "resample_unchanged", "motion_unchanged",
                                   "half_left_out", "pose_altered", "motion_no_odometry",
                                   "resample_flat_weights"])
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault):
    from badger_amcl_tpu_torch.node import node as node_mod
    from badger_amcl_tpu_torch.node import node_2d, node_3d

    sensor = node_2d if "2d" in workload else node_3d
    if fault == "update_unchanged":
        monkeypatch.setattr(sensor, "_sensor_update_jit", _unchanged)
    elif fault == "resample_unchanged":
        monkeypatch.setattr(node_mod, "_resample_jit", _unchanged)
    elif fault == "motion_unchanged":
        monkeypatch.setattr(node_mod, "_motion_update_jit", _unchanged)
    elif fault == "motion_no_odometry":
        real = node_mod._motion_update_jit

        def no_odometry(state, model, alphas, pose, delta, normals, absolute):
            return real(state, model, alphas, pose, torch.zeros_like(delta), normals, absolute)
        monkeypatch.setattr(node_mod, "_motion_update_jit", no_odometry)
    elif fault == "resample_flat_weights":
        real = node_mod._resample_jit

        def flat(state, *args, **kwargs):
            n = state.n_active
            w = torch.where(torch.arange(state.weights.shape[0]) < n, 1.0 / n.float(), 0.0)
            return real(state.replace(weights=w), *args, **kwargs)
        monkeypatch.setattr(node_mod, "_resample_jit", flat)
    elif fault == "half_left_out":
        monkeypatch.setattr(sensor, "_sensor_update_jit",
                            _half_left_out(sensor._sensor_update_jit))
    else:
        real = node_mod.Node.update_pose

        def update_pose(self, max_pose, stamp):
            return real(self, np.asarray(max_pose) + np.array([0.05, 0.0, 0.0]), stamp)

        monkeypatch.setattr(node_mod.Node, "update_pose", update_pose)
    result, log, read = _run(workload)
    assert not result["correct"], log
