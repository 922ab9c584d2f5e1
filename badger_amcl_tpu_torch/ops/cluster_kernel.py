"""Connected-component labels of the occupied pose-histogram bins: the
fixpoint of the JAX package's `_cluster_grid` (badger_amcl_tpu.pf.cluster,
its `lax.while_loop` of box-min sweeps at cluster.py:72).

`cluster_labels` is the kernel wrapper: CUDA tensors launch
csrc/cluster_labels.cu (union-find to the fixpoint in three launches, no
host read, so a compiled step captures it as it is); CPU tensors run
`cluster_labels_plain`, the JAX package's sweeps in a
`utils.control.while_loop` (one host read per _SWEEPS_PER_CHECK sweeps).
Both label every occupied cell with its component's smallest flat index
(26-neighbourhood) and every empty cell with BIG: a component's minimum is
unique, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from badger_amcl_tpu_torch.ops import _build
from badger_amcl_tpu_torch.utils import control

BIG = 2 ** 30  # pf.kld.BIG: an empty cell's label
# dilation sweeps per convergence check of the plain version: each check
# is a host read, and sweeps past the fixpoint change nothing
_SWEEPS_PER_CHECK = 8


def _box_min(g3: torch.Tensor) -> torch.Tensor:
    """Separable 3x3x3 minimum over the last three axes via rolls; the
    1-cell empty border kept by kld.grid_cells stops roll wrap-around from
    leaking labels."""
    for axis in (-3, -2, -1):
        g3 = torch.minimum(g3, torch.minimum(torch.roll(g3, 1, dims=axis),
                                             torch.roll(g3, -1, dims=axis)))
    return g3


def _check(occ_flat: torch.Tensor, shape):
    gx, gy, ga = shape
    if occ_flat.dtype != torch.bool or occ_flat.dim() < 1 or occ_flat.shape[-1] != gx * gy * ga:
        raise ValueError(f"occupancy must be bool (..., {gx * gy * ga}) for grid {shape}")


def cluster_labels_plain(occ_flat: torch.Tensor, shape) -> torch.Tensor:
    """Plain PyTorch version: the JAX package's box-min sweeps until no
    label changes. occ_flat: bool (..., gx*gy*ga) in (a, x, y) packing, one
    grid per leading index. Returns int32 labels of occ_flat's shape."""
    _check(occ_flat, shape)
    gx, gy, ga = shape
    occ3 = occ_flat.reshape(occ_flat.shape[:-1] + (ga, gx, gy))
    idx = torch.arange(gx * gy * ga, dtype=torch.int32, device=occ_flat.device)
    labels0 = torch.where(occ3, idx.reshape(ga, gx, gy), BIG)

    def sweeps(carry):
        labels, _ = carry
        new = labels
        for _ in range(_SWEEPS_PER_CHECK):
            new = torch.where(occ3, _box_min(new), BIG)
        return new, torch.any(new != labels)

    labels, _ = control.while_loop(lambda carry: carry[1], sweeps, sweeps((labels0, True)))
    return labels.reshape(occ_flat.shape)


def cluster_labels(occ_flat: torch.Tensor, shape) -> torch.Tensor:
    """The labels of `cluster_labels_plain`: one call of the CUDA kernel
    (three launches) on a CUDA tensor."""
    _check(occ_flat, shape)
    if occ_flat.device.type != "cuda":
        return cluster_labels_plain(occ_flat, shape)
    gx, gy, ga = shape
    total = occ_flat.numel()
    if total >= 2 ** 31:
        raise ValueError(f"{total} cells exceed the kernel's int32 indices")
    occ = occ_flat.contiguous()
    parent = torch.empty(occ.shape, dtype=torch.int32, device=occ.device)
    labels = torch.empty_like(parent)
    code = _build.lib().cluster_labels_launch(occ.data_ptr(), total, gx, gy, ga,
                                              parent.data_ptr(), labels.data_ptr(),
                                              _build.stream_ptr(occ.device))
    _build.check(code, "cluster_labels")
    cluster_labels.launches += 1
    return labels


cluster_labels.launches = 0
