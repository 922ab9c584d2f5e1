"""Angle arithmetic on tensors (counterpart of badger_amcl_tpu.utils.angles).

Replaces the reference's `angles` C++ library (Odom::angleDiff/normalize,
odom.cpp:313-321; PlanarScanner::coordAdd, planar_scanner.cpp:693-701).
"""

import ctypes
import ctypes.util
import functools

import numpy as np
import torch


def normalize_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def angle_diff(a: torch.Tensor, b) -> torch.Tensor:
    """Reference `Odom::angleDiff(a, b)` == shortest rotation taking b onto a."""
    return normalize_angle(a - b)


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for f in ("sinf", "cosf"):
        getattr(lib, f).restype = ctypes.c_float
        getattr(lib, f).argtypes = [ctypes.c_float]
    lib.atan2f.restype = ctypes.c_float
    lib.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib


def shortest_angular_distance(frm: float, to: float) -> float:
    """Signed shortest rotation taking host scalar `frm` onto `to`, as the
    JAX node computes it (utils/angles.py on Python floats): the difference
    in double, then atan2(sin, cos) in float32. XLA's CPU float32 sin, cos
    and atan2 are the C library's sinf, cosf and atan2f, which this calls,
    so the node's gating and integrated odometry match the JAX node's bit
    for bit (numpy's and torch's float32 trig differ in the last ulp)."""
    lib = _libm()
    d = float(np.float32(to - frm))
    return float(lib.atan2f(lib.sinf(d), lib.cosf(d)))
