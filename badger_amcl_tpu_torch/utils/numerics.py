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
"""

from __future__ import annotations

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


def host_bool(t: torch.Tensor) -> bool:
    """One device predicate as a Python bool (one host sync)."""
    return bool(host_values(t)[0])
