"""Scalar division that rounds the same on every device, and the count of
host syncs taken by the dispatch tree.

`fdiv`: PyTorch's CUDA division by a Python number multiplies by its f32
reciprocal, which can differ from true division in the last bit; the JAX
package divides exactly, and a kernel that divides exactly must agree with
its plain version bit for bit. Dividing by a 0-dim tensor on the same
device takes true IEEE division everywhere.

`host_values`: the JAX package branches on device scalars inside
`lax.cond`; in eager PyTorch each such branch reads the predicate back to
the host. Every read goes through here so a run can count them
(`SYNCS.count`); several predicates known at once are read in one sync.
`host_arrays` reads whole tensors (the node's published pose, covariance
and particle cloud) the same way.
"""

from __future__ import annotations

import numpy as np
import torch


def fdiv(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s with IEEE f32 division on CPU and CUDA alike."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


class _SyncCounter:
    """Host-sync count of the dispatch tree (diagnostic)."""

    def __init__(self):
        self.count = 0


SYNCS = _SyncCounter()


def host_values(*ts: torch.Tensor) -> list:
    """Read scalar tensors to Python values in one host sync."""
    SYNCS.count += 1
    if len(ts) == 1:
        return [ts[0].item()]
    return torch.stack([t.to(torch.float64) for t in ts]).tolist()


def host_arrays(*ts: torch.Tensor) -> list:
    """Copy tensors of any shape and dtype to numpy arrays in one host
    sync (their bytes concatenated on the device, one transfer)."""
    SYNCS.count += 1
    flat = [t.detach().reshape(-1).contiguous() for t in ts]
    raw = torch.cat([f.view(torch.uint8) for f in flat]).cpu().numpy().tobytes()
    out, off = [], 0
    for t, f in zip(ts, flat):
        nbytes = f.numel() * f.element_size()
        dtype = torch.empty((0,), dtype=t.dtype).numpy().dtype
        out.append(np.frombuffer(raw[off:off + nbytes], dtype).reshape(tuple(t.shape)))
        off += nbytes
    return out


def host_bool(t: torch.Tensor) -> bool:
    """One device predicate as a Python bool (one host sync)."""
    return bool(host_values(t)[0])
