"""Fused single-robot MCL step (counterpart of badger_amcl_tpu.mcl).

motion update -> measurement update -> KLD resample -> cluster statistics
-> convergence, as eager PyTorch. Random variates come in as `noise`
(StepNoise: the odometry normals and the injection and pick uniforms, the
draws the JAX package makes from its key), or are drawn from `generator`
when `noise` is absent; nothing draws from a global RNG.

Every planar model runs through these entry points. The prob model's
log-space pipeline is the node's to compose (node/node_2d.py:39-56):
`sensor_update_2d(..., log_space=True)` (log p into `sensor_update_log`),
then `pf.filter.resample(..., log_averages=True)` over log-domain
w_slow/w_fast (start from `pf.filter.init_log_averages`).

`mcl_step_2d_jit`, `sensor_resample_step_jit` and `likelihood_only_jit`
are the JAX package's compiled entry points (mcl.py:62,123,147), with its
static arguments: on CUDA tensors each captures its step into a CUDA
graph once per static key (`utils.graph.graph_jit`; every branch of the
dispatch tree a conditional node) and replays it after that, with no host
read inside a replay; on CPU tensors they run the step eagerly. Every
static configuration compiles: every planar model (the prob model also
with beam skipping) on every backend, both resampling contracts,
multinomial or systematic resampling, with or without a cluster cap.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from badger_amcl_tpu_torch.pf import filter as pf_filter
from badger_amcl_tpu_torch.pf.filter import ResampleModel
from badger_amcl_tpu_torch.pf.types import MCLState, PFParams
from badger_amcl_tpu_torch.sensors import odom as odom_models
from badger_amcl_tpu_torch.sensors.planar import (
    CELL_MODELS, planar_likelihood, planar_likelihood_cells,
)
from badger_amcl_tpu_torch.utils.graph import device_tensor, graph_jit


@dataclasses.dataclass
class StepNoise:
    """Variates of one step: odom (3, M) standard normals (None without a
    motion update), inject and pick (M,) uniforms in [0, 1) (multinomial),
    start the 0-dim uniform start of the systematic comb. `draw` takes the
    start from pick[0], which the comb does not otherwise read: a step
    draws the same variates under either model."""

    odom: Optional[torch.Tensor]
    inject: torch.Tensor
    pick: torch.Tensor
    start: Optional[torch.Tensor] = None

    @staticmethod
    def draw(gen: torch.Generator, m: int, device, odom: bool = True) -> "StepNoise":
        normals = torch.randn((3, m), generator=gen, device=device) if odom else None
        inject = torch.rand((m,), generator=gen, device=device)
        pick = torch.rand((m,), generator=gen, device=device)
        return StepNoise(odom=normals, inject=inject, pick=pick, start=pick[0])


def _noise(noise, generator, state, odom):
    if noise is not None:
        return noise
    if generator is None:
        raise ValueError("pass noise or a torch.Generator")
    return StepNoise.draw(generator, state.poses.shape[0], state.poses.device, odom)


def sensor_update_2d(state: MCLState, omap, scan_params, scan,
                     laser_model: str = "likelihood_field", do_beamskip: bool = False,
                     backend: str = "exact", log_space: bool = False) -> MCLState:
    """The measurement update (node_2d.py:39-56): the model's likelihood
    into the weights, factors folded where the model allows; with
    log_space (likelihood_field_prob only) log p into sensor_update_log."""
    if log_space:
        if laser_model != "likelihood_field_prob":
            raise ValueError("log_space is the likelihood_field_prob pipeline")
        logp, mf = planar_likelihood(
            omap, scan_params, scan, state.poses, state.active_mask, state.n_active,
            laser_model, converged=state.converged, do_beamskip=do_beamskip,
            backend=backend, fold_factors=False, prob_log_space=True)
        return pf_filter.sensor_update_log(state, logp, mf)
    p, mf = planar_likelihood(
        omap, scan_params, scan, state.poses, state.active_mask, state.n_active,
        laser_model, converged=state.converged, do_beamskip=do_beamskip,
        backend=backend, fold_factors=True)
    return pf_filter.sensor_update(state, p, mf)


def mcl_step_2d(state: MCLState, omap, scan_params, scan, random_pose_pool,
                odom_pose, odom_delta, absolute_motion, alphas, params: PFParams,
                odom_model=odom_models.OdomModel.DIFF,
                laser_model: str = "likelihood_field",
                resample_model=ResampleModel.MULTINOMIAL, do_resample: bool = True,
                do_beamskip: bool = False, backend: str = "exact",
                noise: Optional[StepNoise] = None,
                generator: Optional[torch.Generator] = None) -> MCLState:
    """One full 2D MCL step."""
    noise = _noise(noise, generator, state, odom=True)
    state = odom_models.motion_update(state, odom_model, alphas, odom_pose,
                                      odom_delta, noise.odom, absolute_motion)
    state = sensor_update_2d(state, omap, scan_params, scan, laser_model, do_beamskip,
                             backend)
    if do_resample:
        state = pf_filter.resample(state, params, random_pose_pool, noise.inject,
                                   noise.pick, resample_model, u_start=noise.start)
    return state


def sensor_resample_step(state: MCLState, omap, scan_params, scan, random_pose_pool,
                         params: PFParams, laser_model: str = "likelihood_field",
                         resample_model=ResampleModel.MULTINOMIAL,
                         backend: str = "exact", resample_contract: str = "pick",
                         noise: Optional[StepNoise] = None,
                         generator: Optional[torch.Generator] = None) -> MCLState:
    """Sensor update + KLD resample without the motion model (the unit the
    JAX bench times, mcl.py:72-113).

    resample_contract "pick": the reference-exact per-particle picks.
    "cell": the cell-space multinomial contract
    (`pf.filter.sensor_resample_cells` over `planar_likelihood_cells`,
    kernel #1/#2 without the per-particle take): distributed as the pick
    contract, not pick-equal. It needs multinomial resampling, a model in
    CELL_MODELS and the "corr" backend (raises otherwise), and runs the
    pick contract's step on the same variates wherever the cloud leaves
    the cell envelope: one `control.cond` ("cells.ok") between the two."""
    if resample_contract not in ("pick", "cell"):
        raise ValueError(f"resample_contract must be 'pick' or 'cell', got "
                         f"{resample_contract!r}")
    if resample_contract == "cell":
        if resample_model != ResampleModel.MULTINOMIAL:
            raise ValueError("the cell contract needs multinomial resampling")
        if laser_model not in CELL_MODELS or backend != "corr":
            raise ValueError(f"the cell contract needs a model of {CELL_MODELS} on the corr "
                             f"backend, got {laser_model!r} on {backend!r}")
    noise = _noise(noise, generator, state, odom=False)

    def pick():
        s = sensor_update_2d(state, omap, scan_params, scan, laser_model, False, backend)
        return pf_filter.resample(s, params, random_pose_pool, noise.inject, noise.pick,
                                  resample_model, u_start=noise.start)

    if resample_contract == "pick":
        return pick()
    tbl, key_m, ok = planar_likelihood_cells(omap, scan_params, scan, state.poses,
                                             laser_model, backend)
    return pf_filter.sensor_resample_cells(state, params, random_pose_pool, tbl, key_m, ok,
                                           pick, noise.inject, noise.pick)


def likelihood_only(state: MCLState, omap, scan_params, scan,
                    laser_model: str = "likelihood_field", backend: str = "exact"):
    """The particle x beam likelihood evaluation alone: p * map factor
    (the beam model's factor comes back separately and is applied here)."""
    p, mf = planar_likelihood(
        omap, scan_params, scan, state.poses, state.active_mask, state.n_active,
        laser_model, converged=state.converged, do_beamskip=False,
        backend=backend, fold_factors=True)
    return p if mf is None else p * mf


def default_backend(device) -> str:
    """"corr" (the stencil-correlation kernel with its exact fallbacks) on
    CUDA, "exact" elsewhere."""
    return "corr" if torch.device(device).type == "cuda" else "exact"


# --- the compiled entry points (the JAX package's jax.jit wrappers) ----------

_mcl_step_graph = graph_jit(mcl_step_2d, static_argnames=(
    "params", "odom_model", "laser_model", "resample_model", "do_resample", "do_beamskip",
    "backend"))
_sensor_resample_graph = graph_jit(sensor_resample_step, static_argnames=(
    "params", "laser_model", "resample_model", "backend", "resample_contract"))
_likelihood_graph = graph_jit(likelihood_only, static_argnames=("laser_model", "backend"))


def mcl_step_2d_jit(state: MCLState, omap, scan_params, scan, random_pose_pool,
                    odom_pose, odom_delta, absolute_motion, alphas, params: PFParams,
                    odom_model=odom_models.OdomModel.DIFF,
                    laser_model: str = "likelihood_field",
                    resample_model=ResampleModel.MULTINOMIAL, do_resample: bool = True,
                    do_beamskip: bool = False, backend: str = "exact",
                    noise: Optional[StepNoise] = None,
                    generator: Optional[torch.Generator] = None) -> MCLState:
    """`mcl_step_2d` compiled (the JAX package's mcl_step_2d_jit, static
    params, odom_model, laser_model, resample_model, do_resample,
    do_beamskip, backend). The variates are drawn before the replay; the
    alphas are part of the key (Python floats, as the motion model takes
    them)."""
    dev = state.poses.device
    noise = _noise(noise, generator, state, odom=True)
    return _mcl_step_graph(
        state, omap, scan_params, scan, random_pose_pool, device_tensor(odom_pose, dev),
        device_tensor(odom_delta, dev), device_tensor(absolute_motion, dev),
        tuple(float(a) for a in alphas), params, odom_models.OdomModel(odom_model),
        laser_model, ResampleModel(resample_model), do_resample, do_beamskip, backend,
        noise=noise)


def sensor_resample_step_jit(state: MCLState, omap, scan_params, scan, random_pose_pool,
                             params: PFParams, laser_model: str = "likelihood_field",
                             resample_model=ResampleModel.MULTINOMIAL,
                             backend: str = "exact", resample_contract: str = "pick",
                             noise: Optional[StepNoise] = None,
                             generator: Optional[torch.Generator] = None) -> MCLState:
    """`sensor_resample_step` compiled (the JAX package's
    sensor_resample_step_jit, the unit bench.py times; static params,
    laser_model, resample_model, backend, resample_contract)."""
    return _sensor_resample_graph(
        state, omap, scan_params, scan, random_pose_pool, params, laser_model,
        ResampleModel(resample_model), backend, resample_contract,
        noise=_noise(noise, generator, state, odom=False))


def likelihood_only_jit(state: MCLState, omap, scan_params, scan,
                        laser_model: str = "likelihood_field", backend: str = "exact"):
    """`likelihood_only` compiled (the JAX package's likelihood_only_jit,
    static laser_model, backend)."""
    return _likelihood_graph(state, omap, scan_params, scan, laser_model, backend)


# the compiled wrappers (utils.graph.graph_jit: `.entries` per static key,
# `.captures`), for diagnostics
mcl_step_2d_jit.graph = _mcl_step_graph
sensor_resample_step_jit.graph = _sensor_resample_graph
likelihood_only_jit.graph = _likelihood_graph
