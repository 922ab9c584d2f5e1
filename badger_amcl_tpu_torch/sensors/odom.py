"""Odometry motion models over the particle axis (counterpart of
badger_amcl_tpu.sensors.odom; reference Odom::updateAction,
odom.cpp:74-311).

All five models take their noise as (3, M) standard normals, which the
caller draws from a torch.Generator or replays from the JAX package
(its three normal draws per model, odom.py:144 and the per-model splits).
A fleet state (poses (R, M, 3)) takes odometry (R, 3) and normals
(R, 3, M): the JAX package's vmap as a leading robot axis.

Faithfully preserved quirks:
- DIFF and OMNI pass *variances* directly as the Gaussian sigma (no sqrt)
  (odom.cpp:98-103,156-162); only the *_CORRECTED variants and GAUSSIAN
  apply sqrt (odom.cpp:181-186,239-247,276-278).
- Particle yaw is NOT re-normalized after the update.
- DIFF's in-place-rotation guard: delta_rot1 = 0 when translation < 1 cm
  (odom.cpp:134-138,217-222).
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from badger_amcl_tpu_torch.pf.types import MCLState
from badger_amcl_tpu_torch.utils.angles import angle_diff


class OdomModel(enum.IntEnum):
    """OdomModelType (odom.h:33-40)."""

    DIFF = 0
    OMNI = 1
    DIFF_CORRECTED = 2
    OMNI_CORRECTED = 3
    GAUSSIAN = 4


def _apply_omni(poses, normals, delta, old_theta, t_std, r_std, s_std):
    delta_trans = torch.sqrt(delta[0] ** 2 + delta[1] ** 2)
    turn_angle = torch.atan2(delta[1], delta[0])
    bearing = angle_diff(turn_angle, old_theta) + poses[..., 2]
    cs, sn = torch.cos(bearing), torch.sin(bearing)
    trans_hat = delta_trans + normals[0] * t_std
    rot_hat = delta[2] + normals[1] * r_std
    strafe_hat = normals[2] * s_std
    x = poses[..., 0] + trans_hat * cs + strafe_hat * sn
    y = poses[..., 1] + trans_hat * sn - strafe_hat * cs
    th = poses[..., 2] + rot_hat
    return torch.stack([x, y, th], dim=-1)


def _apply_diff(poses, normals, delta, old_theta, a1, a2, a3, a4, corrected):
    delta_trans = torch.sqrt(delta[0] ** 2 + delta[1] ** 2)
    rot1 = torch.where(delta_trans < 0.01, 0.0,
                       angle_diff(torch.atan2(delta[1], delta[0]), old_theta))
    rot2 = angle_diff(delta[2], rot1)
    # symmetric fwd/bwd noise (odom.cpp:144-149)
    rot1_noise = torch.minimum(torch.abs(angle_diff(rot1, 0.0)),
                               torch.abs(angle_diff(rot1, math.pi)))
    rot2_noise = torch.minimum(torch.abs(angle_diff(rot2, 0.0)),
                               torch.abs(angle_diff(rot2, math.pi)))
    v1 = a1 * rot1_noise ** 2 + a2 * delta_trans ** 2
    v2 = a3 * delta_trans ** 2 + a4 * rot1_noise ** 2 + a4 * rot2_noise ** 2
    v3 = a1 * rot2_noise ** 2 + a2 * delta_trans ** 2
    if corrected:
        v1, v2, v3 = torch.sqrt(v1), torch.sqrt(v2), torch.sqrt(v3)
    rot1_hat = angle_diff(rot1, normals[0] * v1)
    trans_hat = delta_trans - normals[1] * v2
    rot2_hat = angle_diff(rot2, normals[2] * v3)
    x = poses[..., 0] + trans_hat * torch.cos(poses[..., 2] + rot1_hat)
    y = poses[..., 1] + trans_hat * torch.sin(poses[..., 2] + rot1_hat)
    th = poses[..., 2] + rot1_hat + rot2_hat
    return torch.stack([x, y, th], dim=-1)


def _apply_gaussian(poses, normals, delta, old_theta, absolute_motion,
                    a1, a2, a3, a4, a5):
    """ODOM_MODEL_GAUSSIAN (odom.cpp:257-308)."""
    delta_trans = torch.sqrt(delta[0] ** 2 + delta[1] ** 2)
    at2 = absolute_motion[0] ** 2
    as2 = absolute_motion[1] ** 2
    ar2 = absolute_motion[2] ** 2
    rot_std = torch.sqrt(a1 * ar2 + a2 * at2)
    trans_std = torch.sqrt(a3 * at2 + a4 * ar2)
    strafe_std = torch.sqrt(a4 * ar2 + a5 * as2)
    heading = poses[..., 2] + delta[2] / 2.0
    csh, snh = torch.cos(heading), torch.sin(heading)
    bearing = angle_diff(torch.atan2(delta[1], delta[0]), old_theta) + poses[..., 2]
    csb, snb = torch.cos(bearing), torch.sin(bearing)
    trans_hat = normals[0] * trans_std
    strafe_hat = normals[1] * strafe_std
    rot_hat = normals[2] * rot_std
    x = poses[..., 0] + delta_trans * csb + trans_hat * csh + strafe_hat * snh
    y = poses[..., 1] + delta_trans * snb + trans_hat * snh - strafe_hat * csh
    th = poses[..., 2] + delta[2] + rot_hat
    return torch.stack([x, y, th], dim=-1)


def motion_update(state: MCLState, model: OdomModel, alphas, pose, delta,
                  normals: torch.Tensor, absolute_motion=None) -> MCLState:
    """Odom::updateAction. `pose` is the current odom pose, `delta` the odom
    delta since the last update; old_pose = pose - delta (odom.cpp:81-84).
    normals: (3, M) standard normals (the model's three noise draws). For
    a fleet state: pose, delta, absolute_motion (R, 3), normals (R, 3, M)."""
    dev = state.poses.device

    def vec(v):
        if isinstance(v, torch.Tensor):
            v = v.to(device=dev, dtype=torch.float32)
        else:
            v = torch.tensor(v, dtype=torch.float32).to(dev)
        # components first, each (R, 1) for a fleet so it broadcasts over M
        return v.movedim(-1, 0)[..., None] if v.dim() == 2 else v

    pose, delta = vec(pose), vec(delta)
    absolute_motion = delta if absolute_motion is None else vec(absolute_motion)
    normals = normals.movedim(-2, 0)
    a1, a2, a3, a4, a5 = [float(np.float32(a)) for a in alphas]
    old_theta = pose[2] - delta[2]
    model = OdomModel(model)
    poses = state.poses
    if model in (OdomModel.OMNI, OdomModel.OMNI_CORRECTED):
        t = a3 * (delta[0] ** 2 + delta[1] ** 2) + a1 * delta[2] ** 2
        r = a4 * delta[2] ** 2 + a2 * (delta[0] ** 2 + delta[1] ** 2)
        s = a1 * delta[2] ** 2 + a5 * (delta[0] ** 2 + delta[1] ** 2)
        if model == OdomModel.OMNI_CORRECTED:
            t, r, s = torch.sqrt(t), torch.sqrt(r), torch.sqrt(s)
        new_poses = _apply_omni(poses, normals, delta, old_theta, t, r, s)
    elif model in (OdomModel.DIFF, OdomModel.DIFF_CORRECTED):
        new_poses = _apply_diff(poses, normals, delta, old_theta, a1, a2, a3, a4,
                                corrected=model == OdomModel.DIFF_CORRECTED)
    else:
        new_poses = _apply_gaussian(poses, normals, delta, old_theta,
                                    absolute_motion, a1, a2, a3, a4, a5)
    return state.replace(poses=new_poses.to(torch.float32))
