"""badger_amcl_tpu_torch — the PyTorch/CUDA port of badger_amcl_tpu.

The 2D MCL step (odometry -> any of the four planar laser models ->
KLD multinomial or systematic resample with cluster statistics ->
convergence) and the 2D node around it, the 3D point-cloud path (voxel
EDT, both cloud models) and the 3D node around it, the fleet step (R
robots batched on one card, or split over torch.distributed ranks) and
the entry layer (command line,
simulator, ROS mapping) as eager PyTorch on plain tensors, with
hand-written CUDA kernels for Hopper (``csrc/``) where the JAX package
runs Pallas TPU kernels. Module paths, public function names and array layouts follow
``badger_amcl_tpu`` so each counterpart is easy to find; the package never
imports JAX or ``badger_amcl_tpu``.

- ``maps``     — occupancy map, voxel map, capped EDT, baked textures,
  OctoMap .bt/.ot reader and writers
- ``pf``       — particle filter core (state, KLD, clustering, resampling)
- ``sensors``  — odometry, planar likelihood-field and point-cloud models
- ``ops``      — kernel wrappers, their plain PyTorch versions, the builder
- ``mcl``      — the fused step entry points (the pick and the cell-space
  resampling contracts)
- ``node``     — the 2D and 3D localization nodes (messages in -> pose/TF
  out) and the ROS message mapping
- ``config``   — the node's typed configuration
- ``fleet``    — many robots' filters stepped as one batch, or sharded
  over a process group
- ``scenario`` — seeded 2D flagship and 3D scene builders
- ``convert``  — JAX-package objects (as numpy) -> port objects
- ``sim``      — the synthetic world: room map, scripted kinematics, scans
- ``cli``      — ``python -m badger_amcl_tpu_torch`` (sim, replay, ROS)
"""

__version__ = "0.1.0"
