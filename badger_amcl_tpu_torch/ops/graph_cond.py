"""Conditional IF and WHILE nodes of a CUDA graph under capture
(csrc/graph_cond.cu), the device side of `utils.control.cond` and
`utils.control.fori_loop` in a compiled step.

`if_begin(pred)` adds an IF node on a 0-dim bool device predicate to the
graph that the current stream of pred's device is capturing, and returns
the raw stream that captures the node's body; the caller issues the arm's
work on that stream, then `if_end(body)` ends the body's capture and
returns its node count (`capture_nodes` counts the top level). At every
replay the body runs exactly when the predicate is true, with no host
read. `while_begin` / `while_end` make a WHILE node the same way: its
body runs again as long as the predicate the body leaves is true. There
is no plain version: a conditional node exists only in a captured graph.
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


def if_end(body: int) -> int:
    """End the body's capture that `if_begin` started; returns the body's
    node count (at its own level)."""
    nodes = ctypes.c_size_t()
    _build.check(_build.lib().graph_if_end(body, ctypes.addressof(nodes)), "graph_if_end")
    return nodes.value


def while_begin(pred: torch.Tensor) -> tuple:
    """Start a WHILE node on pred; returns (the body's capturing stream, the
    node's handle for `while_end`)."""
    body, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
    _build.check(_build.lib().graph_while_begin(_build.stream_ptr(pred.device),
                                                pred.data_ptr(), ctypes.addressof(body),
                                                ctypes.addressof(handle)),
                 "graph_while_begin")
    return body.value, handle.value


def while_end(body: int, handle: int, pred: torch.Tensor) -> int:
    """End a WHILE body: its last node sets the loop's handle from pred (the
    body's updated predicate). Returns the body's node count (at its own
    level)."""
    nodes = ctypes.c_size_t()
    _build.check(_build.lib().graph_while_end(body, handle, pred.data_ptr(),
                                              ctypes.addressof(nodes)), "graph_while_end")
    return nodes.value


def capture_nodes(device) -> int:
    """The node count, at its top level, of the graph that the current
    stream of `device` is capturing."""
    nodes = ctypes.c_size_t()
    _build.check(_build.lib().graph_capture_nodes(_build.stream_ptr(device),
                                                  ctypes.addressof(nodes)),
                 "graph_capture_nodes")
    return nodes.value
