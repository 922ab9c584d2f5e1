"""Particle filter state and static parameters (counterpart of
badger_amcl_tpu.pf.types).

Dense pose/weight tensors at a static `max_samples` capacity with an
`n_active` count held as a 0-dim int32 tensor on the device (KLD adapts the
count, never the shape; entries at index >= n_active are inactive). The
JAX state's PRNG key has no counterpart: random variates come from a
`torch.Generator` or are passed in (mcl.StepNoise).

A fleet of R robots is one MCLState with a leading robot axis on every
tensor (the JAX package's vmapped pytree): poses (R, M, 3), n_active and
the other scalars (R,), cluster arrays (R, M, ...). `stack_states` builds
one from R single-robot states.
"""

from __future__ import annotations

import dataclasses

import torch

from badger_amcl_tpu_torch.utils.tree import map_tensors


@dataclasses.dataclass(frozen=True)
class PFParams:
    """Static filter parameters (ParticleFilter ctor args +
    setPopulationSizeParameters, particle_filter.cpp:38-98,651-655)."""

    min_samples: int = 100
    max_samples: int = 5000
    pop_err: float = 0.01
    pop_z: float = 3.0
    dist_threshold: float = 0.5
    convergence_threshold: float = 95.0
    hist_x: int = 128
    hist_y: int = 128
    hist_a: int = 40
    # > 0 caps the clusters in the statistics (the JAX fleet setting); the
    # single-robot slice runs with 0 (exact, uncapped)
    stats_max_clusters: int = 0

    @property
    def hist_shape(self):
        return (self.hist_x, self.hist_y, self.hist_a)


@dataclasses.dataclass
class ClusterStats:
    """Per-cluster and whole-set statistics (PFCluster / PFSampleSet,
    particle_filter.h:52-87); cluster arrays have capacity max_samples."""

    cluster_count: torch.Tensor  # int32 0-dim
    cluster_valid: torch.Tensor  # (M,) bool
    cluster_weights: torch.Tensor  # (M,) f32
    cluster_counts: torch.Tensor  # (M,) int32
    cluster_means: torch.Tensor  # (M, 3) f32 (x, y, circular-mean yaw)
    cluster_covs: torch.Tensor  # (M, 3, 3) f32
    mean: torch.Tensor  # (3,) f32 whole-set mean
    cov: torch.Tensor  # (3, 3) f32 whole-set covariance
    particle_cluster: torch.Tensor  # (M,) int32 segment id per particle


@dataclasses.dataclass
class MCLState:
    """The filter state; tensors sized to params.max_samples (behind a
    leading robot axis for a fleet)."""

    poses: torch.Tensor  # (M, 3) f32 (x, y, yaw)
    weights: torch.Tensor  # (M,) f32, normalized over active, 0 inactive
    n_active: torch.Tensor  # int32 0-dim
    w_slow: torch.Tensor  # f32 0-dim augmented-MCL slow average
    w_fast: torch.Tensor  # f32 0-dim augmented-MCL fast average
    alpha_slow: torch.Tensor  # f32 0-dim
    alpha_fast: torch.Tensor  # f32 0-dim
    converged: torch.Tensor  # bool 0-dim
    stats: ClusterStats

    @property
    def active_mask(self) -> torch.Tensor:
        """(..., M) bool: index < n_active (per robot for a fleet)."""
        m = self.poses.shape[-2]
        return torch.arange(m, device=self.poses.device) < self.n_active[..., None]

    def replace(self, **changes) -> "MCLState":
        return dataclasses.replace(self, **changes)


def stack_states(states) -> MCLState:
    """R single-robot states -> one fleet state with a leading robot axis."""
    return map_tensors(lambda *ts: torch.stack(ts), *states)


def select_states(mask: torch.Tensor, new: MCLState, old: MCLState) -> MCLState:
    """Per robot, `new` where mask (R,) is set and `old` elsewhere."""
    def sel(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)

    return map_tensors(sel, new, old)
