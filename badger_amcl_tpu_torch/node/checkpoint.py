"""Full filter-state checkpointing (counterpart of
badger_amcl_tpu.node.checkpoint).

The reference checkpoints only the pose estimate (saved-pose YAML,
node.cpp:608-668); this snapshots the whole MCLState (poses, weights,
recovery averages, convergence) as one .npz with a crash-safe write, so a
restart resumes the exact particle distribution.

Format version 2 records two things the JAX package's version 1 lacks:
- `log_domain`: whether w_slow/w_fast are log-domain averages (the
  log-space pipeline's sentinel is +inf, the linear one's 0), so a
  snapshot never resumes in the other pipeline;
- the node's torch.Generator state and its device type, in place of the
  JAX PRNG key (`key_data`).
A version-1 file loads when the caller states its weight domain; its key
is dropped.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from badger_amcl_tpu_torch.pf import cluster
from badger_amcl_tpu_torch.pf.types import MCLState, PFParams

FORMAT_VERSION = 2
JAX_FORMAT_VERSION = 1


@dataclasses.dataclass
class Loaded:
    state: MCLState
    log_domain: bool
    generator_state: Optional[tuple]  # (device type, uint8 state), version 2 only


def save_state(path: str, state: MCLState, log_domain: bool,
               generator: Optional[torch.Generator] = None) -> None:
    """Crash-safe snapshot of the full filter state (tmp file + fsync +
    atomic rename)."""
    arrays = dict(
        version=FORMAT_VERSION,
        poses=state.poses.cpu().numpy(),
        weights=state.weights.cpu().numpy(),
        n_active=state.n_active.cpu().numpy(),
        w_slow=state.w_slow.cpu().numpy(),
        w_fast=state.w_fast.cpu().numpy(),
        alpha_slow=state.alpha_slow.cpu().numpy(),
        alpha_fast=state.alpha_fast.cpu().numpy(),
        converged=state.converged.cpu().numpy(),
        log_domain=np.bool_(log_domain),
    )
    if generator is not None:
        arrays["generator_state"] = generator.get_state().numpy()
        arrays["generator_device"] = np.str_(generator.device.type)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".amcl_state_", suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_state(path: str, params: PFParams, device="cuda",
               log_domain: Optional[bool] = None) -> Optional[Loaded]:
    """Restore a snapshot on `device`; None on a missing, corrupt or
    capacity-mismatched file, on a version-1 (JAX package) file without
    `log_domain`, and on a version-2 file whose recorded domain differs
    from a given `log_domain`. Cluster statistics are recomputed (derived
    state)."""
    try:
        with np.load(path) as z:
            version = int(z["version"])
            if version == FORMAT_VERSION:
                domain = bool(z["log_domain"])
                if log_domain is not None and log_domain != domain:
                    return None
                gen_state = None
                if "generator_state" in z:
                    gen_state = (str(z["generator_device"]),
                                 torch.from_numpy(np.array(z["generator_state"])))
            elif version == JAX_FORMAT_VERSION and log_domain is not None:
                domain, gen_state = bool(log_domain), None
            else:
                return None
            poses = z["poses"]
            if poses.shape != (params.max_samples, 3):
                return None

            def t(name, dtype):
                return torch.as_tensor(np.array(z[name]), dtype=dtype, device=device)

            poses = t("poses", torch.float32)
            weights = t("weights", torch.float32)
            n_active = t("n_active", torch.int32)
            state = MCLState(
                poses=poses, weights=weights, n_active=n_active,
                w_slow=t("w_slow", torch.float32), w_fast=t("w_fast", torch.float32),
                alpha_slow=t("alpha_slow", torch.float32),
                alpha_fast=t("alpha_fast", torch.float32),
                converged=t("converged", torch.bool), stats=None)
    except (OSError, ValueError, KeyError):
        return None
    stats = cluster.compute_cluster_stats(state.poses, state.weights, state.active_mask,
                                          params)
    return Loaded(state.replace(stats=stats), domain, gen_state)


def restore_generator(generator: torch.Generator, generator_state) -> bool:
    """Resume `generator` from a snapshot's state when it was saved from a
    generator on the same device type (a CPU and a CUDA generator keep
    different states); returns whether it did."""
    device_type, state = generator_state
    if device_type != generator.device.type:
        return False
    generator.set_state(state)
    return True
