"""Conditional IF nodes of a CUDA graph under capture (csrc/graph_cond.cu),
the device side of `utils.control.cond` in a compiled step.

`if_begin(pred)` adds an IF node on a 0-dim bool device predicate to the
graph that the current stream of pred's device is capturing, and returns
the raw stream that captures the node's body; the caller issues the arm's
work on that stream, then `if_end(body)` ends the body's capture. At every
replay the body runs exactly when the predicate is true, with no host
read. There is no plain version: a conditional node exists only in a
captured graph.
"""

from __future__ import annotations

import ctypes

import torch

from badger_amcl_tpu_torch.ops import _build


def load_library() -> None:
    """Build and load the kernel library, which must never happen inside a
    capture."""
    _build.lib()


def if_begin(pred: torch.Tensor) -> int:
    """Start an IF node on pred; returns the body's capturing stream."""
    body = ctypes.c_void_p()
    _build.check(_build.lib().graph_if_begin(_build.stream_ptr(pred.device), pred.data_ptr(),
                                             ctypes.addressof(body)), "graph_if_begin")
    return body.value


def if_end(body: int) -> None:
    """End the body's capture that `if_begin` started."""
    _build.check(_build.lib().graph_if_end(body), "graph_if_end")
