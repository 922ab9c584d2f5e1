"""Covariance-shaped Gaussian pose sampling (counterpart of
badger_amcl_tpu.pf.gaussian; reference PDFGaussian, pdf_gaussian.cpp).

The 3x3 covariance is eigendecomposed into rotation x per-axis stddev
(pdf_gaussian.cpp:99-127) and standard normals are scaled per axis then
rotated (pdf_gaussian.cpp:53-71). The normals are an argument, so a test
can feed the JAX package's draws; `sample_poses_gen` draws them from a
torch.Generator.
"""

from __future__ import annotations

import torch


def decompose(cov: torch.Tensor):
    """cov (3,3) -> (rotation (3,3), per-axis stddev (3,)); symmetrized
    eigh, negative eigenvalues clamped to zero."""
    sym = 0.5 * (cov + cov.T)
    evals, evecs = torch.linalg.eigh(sym)
    return evecs, torch.sqrt(torch.clamp(evals, min=0.0))


def sample_poses(normals: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor):
    """normals (n, 3) standard normal variates -> (n, 3) f32 poses
    mean + (normals * std) @ rot.T, as PDFGaussian::sample."""
    rot, std = decompose(cov.to(torch.float32))
    r = normals.to(torch.float32) * std[None, :]
    return (mean.to(torch.float32)[None, :] + r @ rot.T).to(torch.float32)


def sample_poses_gen(gen: torch.Generator, mean: torch.Tensor,
                     cov: torch.Tensor, n: int):
    """`sample_poses` with normals drawn from `gen` (on mean's device)."""
    normals = torch.randn((n, 3), generator=gen, device=mean.device)
    return sample_poses(normals, mean, cov)
