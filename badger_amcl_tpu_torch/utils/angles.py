"""Angle arithmetic on tensors (counterpart of badger_amcl_tpu.utils.angles).

Replaces the reference's `angles` C++ library (Odom::angleDiff/normalize,
odom.cpp:313-321; PlanarScanner::coordAdd, planar_scanner.cpp:693-701).
"""

import torch


def normalize_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def angle_diff(a: torch.Tensor, b) -> torch.Tensor:
    """Reference `Odom::angleDiff(a, b)` == shortest rotation taking b onto a."""
    return normalize_angle(a - b)
