"""Synthetic world harness: a room map, scripted kinematics, simulated
odometry and raycast scans or sampled clouds (counterpart of
badger_amcl_tpu.sim)."""

from badger_amcl_tpu_torch.sim.simulator import Sim2D, Sim3D, make_room_grid  # noqa: F401
