"""Scalar division that rounds the same on every device, a cumulative sum
that rounds the same on every call, and the count of host syncs taken by
the dispatch tree.

`fdiv`: PyTorch's CUDA division by a Python number multiplies by its f32
reciprocal, which can differ from true division in the last bit; the JAX
package divides exactly, and a kernel that divides exactly must agree with
its plain version bit for bit. Dividing by a 0-dim tensor on the same
device takes true IEEE division everywhere.

`cumsum_det`: PyTorch scans a single CUDA row of floats with CUB's
decoupled look-back, whose association follows the timing of its tiles,
so two calls on the same weights can differ in the last bit and a
resampling pick at a boundary can move to the neighbouring particle.

`host_values`: the JAX package branches on device scalars inside
`lax.cond`; in an eager PyTorch step each such branch reads the predicate
back to the host (`utils.control`). Every read goes through here so a run
can count them (`SYNCS.count`); several predicates known at once are read
in one sync.
`host_arrays` reads whole tensors (the node's published pose, covariance
and particle cloud) the same way. Each read is a `sync` region of
`utils.profiling`: the host time of a scan's reads, a span under a
profiler.
"""

from __future__ import annotations

import numpy as np
import torch

from badger_amcl_tpu_torch.utils import profiling


def fdiv(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s with IEEE f32 division on CPU and CUDA alike."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def device_vector(values, dtype, device) -> torch.Tensor:
    """A short constant vector filled on the device: a tensor built from
    host data is a host-to-device copy, which a graph capture refuses."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device) for v in values])


SCAN_ROW = 1024  # the row length of cumsum_det's blocked scan


def cumsum_det(x: torch.Tensor) -> torch.Tensor:
    """torch.cumsum(x, -1), bit-identical from call to call. A single row
    of floats is scanned as rows of SCAN_ROW by PyTorch's per-row kernel
    (on CUDA one block a row, a fixed order), then each row offset by the
    scanned totals of the rows before it, on every device alike; several
    rows and integers take torch.cumsum, which is deterministic there."""
    if not x.is_floating_point() or x.numel() != x.shape[-1]:
        return torch.cumsum(x, -1)
    return blocked_cumsum(x.reshape(-1)).view_as(x)


def blocked_cumsum(flat: torch.Tensor) -> torch.Tensor:
    """cumsum_det's scan of a 1-D tensor: rows of SCAN_ROW (at least two,
    so that PyTorch takes its per-row kernel), each offset by the scanned
    totals of the rows before it."""
    n = flat.shape[0]
    if n <= SCAN_ROW:  # a zero second row keeps PyTorch off the one-row path
        return torch.cumsum(torch.stack([flat, torch.zeros_like(flat)]), -1)[0]
    rows = -(-n // SCAN_ROW)
    part = torch.cumsum(torch.nn.functional.pad(flat, (0, rows * SCAN_ROW - n))
                        .view(rows, SCAN_ROW), -1)
    part[1:] += blocked_cumsum(part[:, -1])[:-1, None]
    return part.reshape(-1)[:n]


class _SyncCounter:
    """Host-sync count of the dispatch tree (diagnostic)."""

    def __init__(self):
        self.count = 0


SYNCS = _SyncCounter()


def host_values(*ts: torch.Tensor) -> list:
    """Read scalar tensors to Python values in one host sync."""
    SYNCS.count += 1
    with profiling.sync():
        if len(ts) == 1:
            return [ts[0].item()]
        return torch.stack([t.to(torch.float64) for t in ts]).tolist()


def host_arrays(*ts: torch.Tensor) -> list:
    """Copy tensors of any shape and dtype to numpy arrays in one host
    sync (their bytes concatenated on the device, one transfer)."""
    SYNCS.count += 1
    flat = [t.detach().reshape(-1).contiguous() for t in ts]
    with profiling.sync():
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
