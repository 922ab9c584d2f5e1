"""Shared localization node: lifecycle, update gating, odometry integration,
pose publication, persistence, global localization (counterpart of
badger_amcl_tpu.node.node; reference src/amcl/node/node.cpp).

ROS plumbing becomes:

- pub/sub topics  -> an output-callback registry (`subscribe_output`)
- tf2 buffer      -> node.transforms.TransformBuffer owned by the app
- timers/spinners -> the app drives `spin_once(now)`
- dynamic_reconfigure -> `reconfigure(new_config)`, which rebuilds the
                     filter (node.cpp:188-293)

The filter state lives on the node's device (`device="cuda"` unless the
caller asks for the CPU); this layer gates, packs and publishes on the
host. Every variate comes from one torch.Generator on that device, seeded
with `seed` (the JAX node splits a PRNG key). Each host read of device
values is one counted sync (`utils/numerics.host_arrays`): the published
pose, its covariance and the particle cloud are read per update, and the
convergence flag only while global localization is active (the JAX node
reads it after every resample; it acts on it only then).

The device work goes through the JAX node's `jax.jit` helpers, here
`utils.graph.graph_jit` entries of the same names: `_motion_update_jit`,
`_resample_jit` and `_uniform_pool_jit` (this module), `_sensor_update_jit`
and `_score_poses_jit` (node_2d.py, node_3d.py). On the card each static
key is captured once into a CUDA graph and replayed, so a scan reads to
the host only where the JAX node reads. Every configuration runs them
compiled (`compiled`; a caller that sets it False calls the same
functions eagerly, as an eager twin does). A compiled call that fails
raises; nothing falls back at run time. A map or free-cell table the node replaces takes the graph
entries holding it along (`release_graphs`), and `shutdown` or the
node's collection those holding its map and free cells (a module-level
helper never keeps a dropped node's map alive). The entries keyed on its
alphas and PFParams go when it replaces them (`reconfigure`) or is
collected, unless another live node holds the same values.

Tracing (`utils.profiling`): a scan is the root region `scan`; the host
phases `scan_prep`, `motion_update`, `sensor_update`, `resample` and
`publish` are `timers` (`PhaseTimer`) phases, each a span under a
profiler; each round of the uniform pool's score rejection is a span
`pool_round`.
"""

from __future__ import annotations

import collections
import logging
import math
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from badger_amcl_tpu_torch.config import (
    AMCLConfig, OdomModelType, PlanarModelType, ResampleModelType,
)
from badger_amcl_tpu_torch.node import persistence
from badger_amcl_tpu_torch.node.messages import (
    COVARIANCE_AA,
    COVARIANCE_XX,
    COVARIANCE_YY,
    Odometry,
    Pose2D,
    PoseArray,
    PoseWithCovarianceStamped,
    TransformStamped,
)
from badger_amcl_tpu_torch.node.transforms import (
    Transform,
    TransformBuffer,
    TransformLookupError,
)
from badger_amcl_tpu_torch.pf import filter as pf_filter
from badger_amcl_tpu_torch.pf.filter import ResampleModel
from badger_amcl_tpu_torch.pf.types import PFParams
from badger_amcl_tpu_torch.sensors import odom as odom_models
from badger_amcl_tpu_torch.utils import profiling
from badger_amcl_tpu_torch.utils.angles import shortest_angular_distance
from badger_amcl_tpu_torch.utils.graph import graph_jit
from badger_amcl_tpu_torch.utils.numerics import host_arrays, host_bool

log = logging.getLogger("badger_amcl_tpu_torch")

_ODOM_MODEL_MAP = {
    OdomModelType.DIFF: odom_models.OdomModel.DIFF,
    OdomModelType.OMNI: odom_models.OdomModel.OMNI,
    OdomModelType.DIFF_CORRECTED: odom_models.OdomModel.DIFF_CORRECTED,
    OdomModelType.OMNI_CORRECTED: odom_models.OdomModel.OMNI_CORRECTED,
    OdomModelType.GAUSSIAN: odom_models.OdomModel.GAUSSIAN,
}

_RESAMPLE_MODEL_MAP = {
    ResampleModelType.MULTINOMIAL: ResampleModel.MULTINOMIAL,
    ResampleModelType.SYSTEMATIC: ResampleModel.SYSTEMATIC,
}

# default initial covariance (node.cpp:147-150)
DEFAULT_COV = (0.5 * 0.5, 0.5 * 0.5, (math.pi / 12.0) ** 2)


def node_device(device) -> torch.device:
    """The node's device; a CUDA device without a card raises (a node
    never carries on on the CPU unless the caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the node runs on CUDA by default and no CUDA device is "
                           "available; pass device=\"cpu\" to run it on the CPU")
    return device


def pool_index(u: torch.Tensor, n_free: int) -> torch.Tensor:
    """Free-cell index of uniforms u in [0, 1): (u * F) truncated in f32
    (node.py:90), clamped to F - 1 where the f32 product rounds up to F
    (the JAX gather clamps out-of-range indices; a CUDA index must be in
    range)."""
    return (u * n_free).to(torch.int32).clamp(max=n_free - 1)


def uniform_poses(u_idx: torch.Tensor, u_yaw: torch.Tensor, fsi: torch.Tensor,
                  origin: torch.Tensor, half: torch.Tensor, res: torch.Tensor):
    """Batched randomFreeSpacePose (node.cpp:822-839, node.py:85-94): a
    uniform free cell's centre and a uniform yaw in [-pi, pi). fsi: (F, 2)
    int32 free cells; origin (2,) f32, half (2,) int32, res 0-dim f32."""
    ij = fsi[pool_index(u_idx, fsi.shape[0]).long()]
    xy = origin + (ij - half).to(torch.float32) * res
    yaw = u_yaw * 2.0 * math.pi - math.pi
    return torch.cat([xy, yaw[:, None]], dim=1)


# the JAX node's jits (node.py:74-94): the motion model (static model and
# alphas, its (3, M) normals an argument), the resampler (static params,
# model and weight domain, its uniforms arguments) and the uniform pool
# (the free cells held by reference, like a map)
_motion_update_jit = graph_jit(odom_models.motion_update, static_argnames=("model", "alphas"))
_resample_jit = graph_jit(pf_filter.resample,
                          static_argnames=("params", "model", "log_averages"))
_uniform_pool_jit = graph_jit(uniform_poses, static_argnames=())
# the helpers keyed on the configuration, by its alphas and by its PFParams
_CONFIG_JITS = (_motion_update_jit, _resample_jit)
# the live nodes holding each configuration value, ("alphas" | "params",
# value) -> count: a value's entries go when its last holder lets it go
_HOLDERS = collections.Counter()


def _hold(alphas, params) -> None:
    """One holder more of alphas and params."""
    _HOLDERS.update((("alphas", alphas), ("params", params)))


def _let_go(alphas, params) -> int:
    """One holder fewer of alphas and params; drop the entries keyed on a
    value that no live node holds any more (the motion model's on its
    alphas, the resampler's on its PFParams, which carry max_samples).
    Returns how many."""
    dropped = 0
    for jit, name, value in zip(_CONFIG_JITS, ("alphas", "params"), (alphas, params)):
        _HOLDERS[name, value] -= 1
        if _HOLDERS[name, value] <= 0:
            del _HOLDERS[name, value]
            dropped += jit.release_where(lambda st, name=name, value=value: st[name] == value)
    return dropped


def _release_references(jits, held: dict) -> int:
    """Drop every entry of the helpers `jits` holding the map or the free
    cells that `held` names. Returns how many."""
    return sum(jit.release(obj) for obj in (held["map"], held["fsi"]) if obj is not None
               for jit in jits)


def _release_held(jits, held: dict) -> None:
    """A node's finalizer (it refers to the node's dict, never to the
    node): drop the entries holding its map and free cells, and let go of
    its alphas and PFParams."""
    _release_references(jits, held)
    _let_go(held["alphas"], held["params"])


def _alphas(config: AMCLConfig) -> tuple:
    """The motion model's alphas as `_motion_update_jit` keys them."""
    return tuple(float(a) for a in (config.odom_alpha1, config.odom_alpha2,
                                    config.odom_alpha3, config.odom_alpha4,
                                    config.odom_alpha5))


class Node:
    """Shared node logic; Node2D and Node3D add the sensor pipelines."""

    # the graph_jit helpers the node calls (subclasses add their sensor's)
    JITS = _CONFIG_JITS + (_uniform_pool_jit,)

    def __init__(self, config: AMCLConfig, tf_buffer: Optional[TransformBuffer] = None,
                 seed: int = 0, device="cuda"):
        self.device = node_device(device)
        # what the node's graph entries are keyed on: its map and free cells
        # by reference, released at shutdown and collection, and its alphas
        # and PFParams, which it holds until it is reconfigured or collected
        self.params = self._pf_params(config)
        self._held = {"map": None, "fsi": None, "alphas": _alphas(config),
                      "params": self.params}
        _hold(self._held["alphas"], self.params)
        weakref.finalize(self, _release_held, type(self).JITS, self._held)
        self.config = config
        # restore_defaults snapshot (reference default_config_, node.cpp:192-197)
        self.default_config = config
        self.tf = tf_buffer if tf_buffer is not None else TransformBuffer()
        self._outputs: Dict[str, List[Callable]] = {}
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.timers = profiling.PhaseTimer()

        self.state = None  # MCLState, created on the first map (node.cpp:670-709)
        self.map = None
        self.compiled = True

        # odometry bookkeeping (node.cpp:716-793,1019-1112)
        self.odom_init = False
        self.pf_odom_pose = np.zeros(3)
        self.odom_integrator_ready = False
        self.odom_integrator_last_pose = np.zeros(3)
        self.odom_integrator_absolute_motion = np.zeros(3)
        self.latest_odom_pose: Optional[Transform] = None

        # pose outputs (node.cpp:359-444,885-963)
        self.latest_tf: Optional[Transform] = None
        self.latest_tf_valid = False
        self.sent_first_transform = False
        self.last_published_pose: Optional[PoseWithCovarianceStamped] = None
        self.latest_pose: Optional[PoseWithCovarianceStamped] = None

        self.global_localization_active = False
        self.free_space_indices: Optional[torch.Tensor] = None
        self._fsi_geom = None  # (origin (2,), half (2,), resolution), on the device

        self.resample_count = 0
        self.force_update = False

        # init pose from file or defaults (loadPose, node.cpp:460-478)
        self.default_cov = np.array(DEFAULT_COV)
        loaded = persistence.load_pose_from_file(config.saved_pose_filepath, DEFAULT_COV)
        if loaded is not None:
            self.init_pose, self.init_cov = loaded
            log.info("Loaded saved pose (%.3f, %.3f)", *self.init_pose[:2])
        else:
            self.init_pose = np.zeros(3)
            self.init_cov = self.default_cov.copy()

        self._last_save_time: Optional[float] = None
        self._last_tf_publish_time: Optional[float] = None

    @staticmethod
    def _pf_params(config: AMCLConfig) -> PFParams:
        return PFParams(
            min_samples=config.min_particles,
            max_samples=config.max_particles,
            pop_err=config.kld_err,
            pop_z=config.kld_z,
            convergence_threshold=config.global_localization_convergence_threshold,
        )

    # ------------------------------------------------------- compiled slice

    @property
    def map(self):
        return self._map

    @map.setter
    def map(self, new_map):
        """A map the node replaces (a receipt, a bake, new bounds) takes its
        graph entries along."""
        old, self._map = getattr(self, "_map", None), new_map
        self._held["map"] = new_map
        if old is not None and old is not new_map:
            self.release_graphs(old)

    def release_graphs(self, obj) -> int:
        """Drop the entries of the node's graph_jit helpers that hold obj by
        reference (a map, a free-cell table): their graphs, buffers and
        pools. Returns how many."""
        return sum(jit.release(obj) for jit in self.JITS)

    def _call(self, helper, *args, **kwargs):
        """A graph_jit helper where the node runs compiled, the function it
        wraps otherwise."""
        return (helper if self.compiled else helper.__wrapped__)(*args, **kwargs)

    # ------------------------------------------------------------------ I/O

    def subscribe_output(self, topic: str, callback: Callable) -> None:
        """Register a consumer for an output topic: amcl_pose, particlecloud,
        tf, amcl_map_odom_transform, amcl_absolute_motion (+ alt-frame
        variants when global_alt_frame_id is set). amcl_pose is latched
        (newInitialPoseSubscriber, node.cpp:1004-1017)."""
        self._outputs.setdefault(topic, []).append(callback)
        if topic == "amcl_pose" and self.latest_pose is not None:
            if self.latest_pose.frame_id == "map":
                callback(self.latest_pose)

    def _publish(self, topic: str, msg) -> None:
        for cb in self._outputs.get(topic, []):
            cb(msg)

    # -------------------------------------------------------- pf lifecycle

    def _init_gaussian(self, mean, cov3, alpha_slow, alpha_fast) -> None:
        """initWithGaussian from the node's generator, then the log-space
        contract's reset (`_after_pf_init`)."""
        self.state = pf_filter.init_with_gaussian(
            self.params, self.generator, np.asarray(mean, np.float32),
            np.asarray(cov3, np.float32), alpha_slow=alpha_slow, alpha_fast=alpha_fast,
            device=self.device)
        self._after_pf_init()

    def init_from_new_map(self, new_map, use_initial_pose: bool) -> None:
        """initFromNewMap (node.cpp:670-709): build the filter around the
        saved/default initial pose."""
        self.map = new_map
        if not use_initial_pose:
            return
        self._init_gaussian(self.init_pose, np.diag(self.init_cov),
                            self.config.recovery_alpha_slow, self.config.recovery_alpha_fast)
        self.odom_init = False

    def set_pf_decay_rate_normal(self) -> None:
        """setPfDecayRateNormal (node.cpp:295-298)."""
        if self.state is not None:
            self.state = self.state.replace(
                alpha_slow=torch.full_like(self.state.alpha_slow,
                                           self.config.recovery_alpha_slow),
                alpha_fast=torch.full_like(self.state.alpha_fast,
                                           self.config.recovery_alpha_fast))

    def update_free_space_indices(self, fsi: np.ndarray, origin_xy, half_xy, resolution):
        """updateFreeSpaceIndices (node.cpp:711-714) + the geometry of
        on-device pose generation."""
        dev = self.device
        if self.free_space_indices is not None:
            self.release_graphs(self.free_space_indices)
        self.free_space_indices = torch.as_tensor(np.asarray(fsi, np.int32), device=dev)
        self._held["fsi"] = self.free_space_indices
        self._fsi_geom = (
            torch.as_tensor(np.asarray(origin_xy, np.float32), device=dev),
            torch.as_tensor(np.asarray(half_xy, np.int32), device=dev),
            torch.full((), resolution, dtype=torch.float32, device=dev),
        )

    @property
    def _log_space(self) -> bool:
        """The log-space weight pipeline (config knob; likelihood_field_prob
        only — pf.filter.sensor_update_log)."""
        return bool(self.config.laser_likelihood_log_space
                    and self.config.laser_model_type == PlanarModelType.LIKELIHOOD_FIELD_PROB)

    def _after_pf_init(self) -> None:
        """The log-space contract stores w_slow/w_fast in log domain, whose
        'uninitialized' sentinel differs (node.py:236-242)."""
        if self._log_space and self.state is not None:
            self.state = pf_filter.init_log_averages(self.state)

    # ------------------------------------------------ random pose generation

    def _draw_pool(self, m: int) -> torch.Tensor:
        gen, dev = self.generator, self.device
        u_idx = torch.rand((m,), generator=gen, device=dev)
        u_yaw = torch.rand((m,), generator=gen, device=dev)
        return self._call(_uniform_pool_jit, u_idx, u_yaw, self.free_space_indices,
                          *self._fsi_geom)

    def random_pose_pool(self, m: Optional[int] = None) -> torch.Tensor:
        """Batched uniformPoseGenerator (node.cpp:847-868): uniform
        free-space poses, optionally score-rejected against the latest scan
        with a per-slot decaying threshold (at most 100 rounds, one host
        sync each)."""
        if m is None:
            m = self.params.max_samples
        if self.free_space_indices is None:
            return torch.zeros((m, 3), dtype=torch.float32, device=self.device)
        poses = self._draw_pool(m)
        thr0 = self.config.uniform_pose_starting_weight_threshold
        mult = self.config.uniform_pose_deweight_multiplier
        if thr0 > 0.0 and 0.0 <= mult < 1.0:
            thr = torch.full((m,), thr0, dtype=torch.float32, device=self.device)
            accepted = torch.zeros((m,), dtype=torch.bool, device=self.device)
            for _ in range(100):
                with profiling.span("pool_round"):
                    accepted = accepted | (self.score_poses(poses) >= thr)
                    if host_bool(accepted.all()):
                        break
                    poses = torch.where(accepted[:, None], poses, self._draw_pool(m))
                    thr = torch.where(accepted, thr, thr * mult)
        return poses

    def score_poses(self, poses: torch.Tensor) -> torch.Tensor:
        """scorePose batched — the subclass supplies the sensor model; no
        scan data -> perfect score (node_2d.cpp:298-316)."""
        return torch.ones((poses.shape[0],), dtype=torch.float32, device=self.device)

    # ----------------------------------------------------- odometry / gating

    def integrate_odom(self, msg: Odometry) -> None:
        """integrateOdom (node.cpp:726-793): accumulate absolute
        |trans|/|strafe|/|rot| between filter updates."""
        if not self.config.odom_integrator_enabled:
            return
        pose = np.asarray(msg.pose, float)
        if not self.odom_integrator_ready:
            self.odom_integrator_absolute_motion = np.zeros(3)
            self.odom_integrator_ready = True
        else:
            last = self.odom_integrator_last_pose
            delta = np.array([pose[0] - last[0], pose[1] - last[1],
                              shortest_angular_distance(last[2], pose[2])])
            delta_trans = math.hypot(delta[0], delta[1])
            delta_rot = delta[2]
            if delta_trans < 1e-6:
                delta_bearing = 0.0
            else:
                angle_a = math.atan2(delta[1], delta[0])
                angle_b = last[2] + delta_rot / 2.0
                delta_bearing = shortest_angular_distance(angle_b, angle_a)
            cs, sn = math.cos(delta_bearing), math.sin(delta_bearing)
            self.odom_integrator_absolute_motion += np.abs(
                [delta_trans * cs, delta_trans * sn, delta_rot])
        self.odom_integrator_last_pose = pose

    def get_odom_pose(self, t: float) -> Optional[np.ndarray]:
        """getOdomPose (node.cpp:795-820): odom->base at time t."""
        try:
            tf = self.tf.lookup(self.config.odom_frame_id, self.config.base_frame_id, t)
        except TransformLookupError as e:
            log.info("Failed to compute odom pose, skipping scan (%s)", e)
            return None
        self.latest_odom_pose = tf
        return tf.to_pose2d()

    def update_pf(self, t: float, scanners_update: List[bool], scanner_index: int):
        """updatePf (node.cpp:300-328). Mutates scanners_update; returns
        (success, force_publication)."""
        pose = self.get_odom_pose(t)
        if pose is None:
            return False, False
        force_publication = False
        if self.odom_init:
            delta = np.array([pose[0] - self.pf_odom_pose[0], pose[1] - self.pf_odom_pose[1],
                              shortest_angular_distance(self.pf_odom_pose[2], pose[2])])
            self._set_scanners_update_flags(delta, scanners_update)
            if scanners_update[scanner_index]:
                self._update_odom(pose, delta)
        else:
            # initOdom (node.cpp:1099-1112)
            self.pf_odom_pose = pose
            self.odom_init = True
            for i in range(len(scanners_update)):
                scanners_update[i] = True
            force_publication = True
            self.resample_count = 0
            self.odom_integrator_ready = False
        return True, force_publication

    def _set_scanners_update_flags(self, delta, scanners_update):
        """setScannersUpdateFlags (node.cpp:1027-1051)."""
        cfg = self.config
        if cfg.odom_integrator_enabled:
            m = self.odom_integrator_absolute_motion
            update = math.hypot(m[0], m[1]) >= cfg.update_min_d or m[2] >= cfg.update_min_a
        else:
            update = (abs(delta[0]) > cfg.update_min_d or abs(delta[1]) > cfg.update_min_d
                      or abs(delta[2]) > cfg.update_min_a)
        update = update or self.force_update
        self.force_update = False
        if update:
            for i in range(len(scanners_update)):
                scanners_update[i] = True

    def _update_odom(self, pose, delta):
        """updateOdom (node.cpp:1053-1097): pick absolute motion vs delta,
        publish it, run the motion model on the device (the phase
        motion_update)."""
        with self.timers.phase("motion_update"):
            cfg = self.config
            if cfg.odom_integrator_enabled:
                m = self.odom_integrator_absolute_motion
                if (math.hypot(m[0], m[1]) >= 2 * cfg.update_min_d
                        or m[2] >= 2 * cfg.update_min_a):
                    absolute_motion = delta  # too much accumulation: fall back
                else:
                    absolute_motion = m.copy()
                self._publish("amcl_absolute_motion", Pose2D(
                    absolute_motion[0], absolute_motion[1], absolute_motion[2]))
            else:
                absolute_motion = delta
            normals = torch.randn((3, self.params.max_samples), generator=self.generator,
                                  device=self.device)

            def f32(v):
                return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

            self.state = self._call(
                _motion_update_jit, self.state, _ODOM_MODEL_MAP[cfg.odom_model_type],
                _alphas(cfg), f32(pose), f32(delta), normals,
                f32(absolute_motion))
            self.odom_integrator_absolute_motion = np.zeros(3)
            self.pf_odom_pose = np.asarray(pose, float)

    # ------------------------------------------------------------ resampling

    def resample_particles(self) -> None:
        """updateResample through the node (resampleParticles,
        node_2d.cpp:562-570)."""
        with self.timers.phase("resample"):
            pool = self.random_pose_pool()
            model = _RESAMPLE_MODEL_MAP[self.config.resample_model_type]
            m, gen, dev = self.params.max_samples, self.generator, self.device
            if model == ResampleModel.SYSTEMATIC:
                kw = dict(u_start=torch.rand((), generator=gen, device=dev))
            else:
                kw = dict(u_inject=torch.rand((m,), generator=gen, device=dev),
                          u_pick=torch.rand((m,), generator=gen, device=dev))
            self.state = self._call(_resample_jit, self.state, self.params, pool, model=model,
                                    log_averages=self._log_space, **kw)
        if self.global_localization_active and host_bool(self.state.converged):
            log.info("Global localization converged!")
            self.global_localization_active = False

    # -------------------------------------------------------- pose outputs

    def publish_particle_cloud(self, stamp: float) -> None:
        """publishParticleCloud (node.cpp:335-357): the active poses, read
        in one host sync (the phase publish)."""
        with self.timers.phase("publish"):
            n, poses = host_arrays(self.state.n_active, self.state.poses)
            poses = poses[:int(n)]
            self._publish("particlecloud", PoseArray(stamp, self.config.global_frame_id, poses))
            if self.config.global_alt_frame_id:
                alt = PoseArray(stamp, self.config.global_alt_frame_id, poses)
                self._publish("particlecloud_in_" + self.config.global_alt_frame_id, alt)

    def get_max_weight_pose(self):
        """getMaxWeightPose (node_2d.cpp:588-617): argmax-weight cluster
        mean, with its weight (one host sync)."""
        w, mean = host_arrays(*pf_filter.max_weight_cluster(self.state.stats))
        return float(w), np.asarray(mean, float)

    def resample_pose(self, stamp: float) -> bool:
        """resamplePose (node_2d.cpp:572-586): the phase publish."""
        with self.timers.phase("publish"):
            max_weight, max_pose = self.get_max_weight_pose()
            if max_weight > 0.0:
                return self.update_pose(max_pose, stamp)
            log.error("No pose!")
            return False

    def update_pose(self, max_pose: np.ndarray, stamp: float) -> bool:
        """updatePose (node.cpp:359-433): publish amcl_pose with the overall
        filter covariance, derive the map->odom transform."""
        if self.state is None:
            return False
        cov6 = np.zeros(36)
        (set_cov,) = host_arrays(self.state.stats.cov)
        for i in range(2):
            for j in range(2):
                cov6[6 * i + j] = set_cov[i, j]
        cov6[COVARIANCE_AA] = set_cov[2, 2]
        p = PoseWithCovarianceStamped(stamp, self.config.global_frame_id,
                                      np.asarray(max_pose, float), cov6)
        self._publish("amcl_pose", p)
        if self.config.global_alt_frame_id:
            alt = PoseWithCovarianceStamped(stamp, self.config.global_alt_frame_id,
                                            p.pose.copy(), p.covariance.copy())
            self._publish("amcl_pose_in_" + self.config.global_alt_frame_id, alt)
        self.last_published_pose = p

        base_to_map = Transform.from_pose2d(max_pose).inverse()
        try:
            t_odom_base = self.tf.lookup(self.config.odom_frame_id,
                                         self.config.base_frame_id, stamp)
        except TransformLookupError:
            log.warning("Failed to lookup base to odom transform, unable to update pose")
            return False
        # odom->map = T(odom<-base) * T(base<-map)  (node.cpp:401-431)
        self.latest_tf = t_odom_base.compose(base_to_map)
        self.latest_tf_valid = True
        return True

    def get_latest_tf(self, now: float) -> Optional[Transform]:
        """getLatestTf (node.cpp:923-943) with the initial-pose bootstrap."""
        if not self.latest_tf_valid:
            self.update_pose(self.init_pose, now)
        return self.latest_tf if self.latest_tf_valid else None

    def publish_transform(self, now: float) -> None:
        """publishTransform (node.cpp:885-921): future-dated map->odom TF
        (or reversed) + the Odometry mirror."""
        if not self.config.tf_broadcast:
            return
        tf = self.get_latest_tf(now)
        if tf is None:
            return
        expiration = now + self.config.transform_tolerance
        if self.config.tf_reverse:
            frame, child = self.config.odom_frame_id, self.config.global_frame_id
        else:
            frame, child = self.config.global_frame_id, self.config.odom_frame_id
            tf = tf.inverse()
        msg = TransformStamped(expiration, frame, child, tf.translation.copy(),
                               tf.rotation.copy())
        self._publish("amcl_map_odom_transform", Odometry(now, tf.to_pose2d()))
        self._publish("tf", msg)
        self.sent_first_transform = True

    # ------------------------------------------------------------ persistence

    def attempt_save_pose(self, now: float, exiting: bool = False) -> None:
        """attemptSavePose (node.cpp:446-458) + savePoseToFile gating."""
        if not self.config.save_pose:
            return
        tf = self.get_latest_tf(now)
        if tf is None or not self.latest_tf_valid:
            return
        if self.latest_odom_pose is None or self.last_published_pose is None:
            return
        # getLatestPose (node.cpp:945-963): map pose = latest_tf^-1 * odom pose
        map_pose = tf.inverse().compose(self.latest_odom_pose)
        pose = PoseWithCovarianceStamped(now, "map", map_pose.to_pose2d(), np.zeros(36))
        for idx in (COVARIANCE_XX, COVARIANCE_YY, COVARIANCE_AA):
            pose.covariance[idx] = self.last_published_pose.covariance[idx]
        self.latest_pose = pose
        persistence.save_pose_to_file(self.config.saved_pose_filepath, pose, exiting)

    # -------------------------------------------------------- initial pose

    def initial_pose_received(self, msg: PoseWithCovarianceStamped, now: float) -> None:
        """initialPoseReceived (node.cpp:965-1002): frame checks, NaN
        rejection, covariance fallback, odometric forward-integration of
        stale poses."""
        cfg = self.config
        frame_id = msg.frame_id
        if frame_id == cfg.global_alt_frame_id and frame_id:
            frame_id = cfg.global_frame_id  # resolveFrameId (node.cpp:1114-1123)
        if frame_id == "":
            log.warning("Received initial pose with empty frame_id")
            return
        if frame_id != cfg.global_frame_id:
            log.warning("Ignoring initial pose in frame %r", frame_id)
            return
        if np.isnan(msg.pose).any():
            log.warning("Received initial pose with NAN; ignoring")
            return
        cov = np.where(np.isnan(msg.covariance), self._default_cov6(), msg.covariance)

        # transformMsgToTfPose (node.cpp:1172-1201): integrate the odometric
        # change between the message stamp and now
        pose_old = Transform.from_pose2d(msg.pose)
        try:
            t_old = self.tf.lookup(cfg.odom_frame_id, cfg.base_frame_id, msg.stamp)
            t_now = self.tf.lookup(cfg.odom_frame_id, cfg.base_frame_id, now)
            tx_odom = t_old.inverse().compose(t_now)
        except TransformLookupError:
            if self.sent_first_transform:
                log.warning("Failed to transform initial pose in time")
            tx_odom = Transform.identity()
        self._set_initial_pose(pose_old.compose(tx_odom), cov)

    def _default_cov6(self):
        cov = np.zeros(36)
        cov[COVARIANCE_XX] = self.default_cov[0]
        cov[COVARIANCE_YY] = self.default_cov[1]
        cov[COVARIANCE_AA] = self.default_cov[2]
        return cov

    def _set_initial_pose(self, pose: Transform, cov6: np.ndarray) -> None:
        """setInitialPoseHyp + applyInitialPose (node.cpp:980-1002,1203-1230)."""
        if self.map is None:
            return
        mean = pose.to_pose2d()
        cov3 = np.zeros((3, 3))
        for i in range(2):
            for j in range(2):
                cov3[i, j] = cov6[6 * i + j]
            cov3[i, 2] = cov6[6 * i + 5]
            cov3[2, i] = cov6[6 * 5 + i]
        cov3[2, 2] = cov6[35]
        self._init_gaussian(mean, cov3, self.config.recovery_alpha_slow,
                            self.config.recovery_alpha_fast)
        self.odom_init = False
        self.global_localization_active = False
        log.info("Initial pose received: (%.3f, %.3f)", mean[0], mean[1])

    # ------------------------------------------------- global localization

    def global_localization(self) -> None:
        """globalLocalizationCallback (node.cpp:870-883): gl decay rates, gl
        map factors (subclass), re-init from the uniform pose generator."""
        if self.map is None:
            return
        self.global_localization_active = True
        self._apply_global_localization_factors()
        pool = self.random_pose_pool(self.params.max_samples)
        self.state = pf_filter.init_with_poses(
            self.params, pool, alpha_slow=self.config.global_localization_alpha_slow,
            alpha_fast=self.config.global_localization_alpha_fast)
        self._after_pf_init()
        self.odom_init = False

    def _apply_global_localization_factors(self) -> None:
        """Subclass: push gl off-map/non-free factors into scanner params."""

    def deactivate_global_localization_params(self) -> None:
        """deactivateGlobalLocalizationParams (node_2d.cpp:414-426)."""
        self.set_pf_decay_rate_normal()
        self._apply_normal_factors()

    def _apply_normal_factors(self) -> None:
        """Subclass: restore normal map factors."""

    # ------------------------------------------------------------- reconfigure

    def reconfigure(self, new_config: Optional[AMCLConfig] = None,
                    restore_defaults: bool = False) -> None:
        """reconfigureCB (node.cpp:188-293): adopt the new config and rebuild
        the filter around the last published pose; `restore_defaults=True`
        reverts to the construction-time config (node.cpp:201-206)."""
        if restore_defaults:
            new_config = self.default_config
        if new_config is None:
            raise ValueError("reconfigure needs new_config or restore_defaults=True")
        self.config = new_config
        self.params = self._pf_params(new_config)
        old = self._held["alphas"], self._held["params"]
        if (_alphas(new_config), self.params) != old:
            # the entries keyed on the values it replaces go, unless another
            # live node holds them
            _hold(_alphas(new_config), self.params)
            _let_go(*old)
            self._held.update(alphas=_alphas(new_config), params=self.params)
        if self.last_published_pose is not None:
            mean = self.last_published_pose.pose
            cov = self.last_published_pose.covariance
            cov3 = np.diag([cov[COVARIANCE_XX], cov[COVARIANCE_YY], cov[COVARIANCE_AA]])
        else:
            mean = self.init_pose
            cov3 = np.diag(self.init_cov)
        self._init_gaussian(mean, cov3, new_config.recovery_alpha_slow,
                            new_config.recovery_alpha_fast)
        self.odom_init = False
        # and the sensor entries, keyed on its scanner parameters, hold the map
        for held in (self.map, self.free_space_indices):
            if held is not None:
                self.release_graphs(held)
        self._reconfigure_sensors()

    def _reconfigure_sensors(self) -> None:
        """Subclass: rebuild scanner params from the new config."""

    # ------------------------------------------------------------- spin

    def spin_once(self, now: float) -> None:
        """The timer equivalents: TF publication at transform_publish_rate
        (node.cpp:173-178) and periodic pose saving (node.cpp:183-185)."""
        cfg = self.config
        tf_period = 1.0 / max(cfg.transform_publish_rate, 1e-6)
        if self._last_tf_publish_time is None or now - self._last_tf_publish_time >= tf_period:
            self.publish_transform(now)
            self._last_tf_publish_time = now
        if cfg.save_pose and cfg.save_pose_to_file_rate > 0:
            save_period = 1.0 / cfg.save_pose_to_file_rate
            if self._last_save_time is None or now - self._last_save_time >= save_period:
                self.attempt_save_pose(now)
                self._last_save_time = now

    def shutdown(self, now: float) -> None:
        """main.cpp:51: save the pose once more with on_exit=True; then
        release the graph entries holding the node's map and free cells
        (its collection lets go of its alphas and PFParams too)."""
        self.attempt_save_pose(now, exiting=True)
        _release_references(type(self).JITS, self._held)

    # ------------------------------------------------- full-state checkpoint

    def save_full_state(self, path: str) -> bool:
        """Snapshot the complete particle set, its weight domain and the
        node's generator (node/checkpoint.py)."""
        if self.state is None:
            return False
        from badger_amcl_tpu_torch.node import checkpoint

        checkpoint.save_state(path, self.state, self._log_space, self.generator)
        return True

    def restore_full_state(self, path: str, log_domain: Optional[bool] = None) -> bool:
        """Resume from a full snapshot; requires a map to be loaded. A JAX
        package (version 1) snapshot records no weight domain: pass
        `log_domain`. Returns False and keeps the current state on a
        missing or corrupt file, a capacity mismatch, or a weight domain
        other than this node's pipeline. A generator saved on another
        device type (a CUDA snapshot on a CPU node) cannot be resumed: the
        rest restores, the stream goes on fresh, and a warning says so."""
        from badger_amcl_tpu_torch.node import checkpoint

        loaded = checkpoint.load_state(path, self.params, self.device, log_domain)
        if loaded is None or loaded.log_domain != self._log_space:
            return False
        self.state = loaded.state
        if loaded.generator_state is not None and not checkpoint.restore_generator(
                self.generator, loaded.generator_state):
            log.warning("The snapshot's generator state was saved on %s and this node's "
                        "generator is on %s: the particles are restored, the random "
                        "stream is not", loaded.generator_state[0], self.generator.device.type)
        self.odom_init = False
        return True
