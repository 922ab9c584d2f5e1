"""The port's counterparts of `lax.cond`, `lax.fori_loop` / `lax.map` and
`lax.while_loop`.

The JAX package branches on device scalars in `lax.cond` and loops in
`lax.map` (fleet/fleet.py:131) and `lax.while_loop` (pf/cluster.py:72):
its compiled step is one device program. Every such branch of the port
goes through `cond`, every such loop through `fori_loop` or
`while_loop`. By mode:

- eager (CPU tensors, or CUDA outside a capture): a predicate is read to
  the host in one counted sync (`numerics.SYNCS`) and one arm runs.
  `read` reads several predicates known together in one sync and returns
  Python bools, which `cond` takes without a read, so the eager step keeps
  its sync count. The arms taken count in `ARMS`.
- capture (CUDA, inside `utils.graph.graph_jit`'s capture): `cond` hands
  its arms to the capture that `recording_into` names (`utils.graph.Capture`),
  which makes them two conditional IF nodes of the graph, on the predicate
  and on its negation (ops/graph_cond.py). The arms return identically
  shaped outputs, as `lax.cond` requires. `read` returns the predicates as
  they are. `fori_loop` (a static trip count) becomes one WHILE node,
  its body captured once (its executions count as "name:body").
  `while_loop` refuses to be captured: the slice's one data-dependent
  loop, the cluster-labelling fixpoint, is a kernel on the card
  (ops/cluster_kernel.py).
- warm-up (`all_arms`): before its capture, graph_jit runs the step
  eagerly once with every `cond` running both arms and returning the one
  its predicate picks, so whatever an arm touches (kernels, caches, the
  allocator) is set up before the capture. Every arm is a pure function of
  its inputs and safe on any of them (JAX's vmap of a lax.cond runs both).

`StrictHostReads` finds host reads that bypass these helpers: a
TorchDispatchMode that traps the ops that read a tensor back to the host.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from badger_amcl_tpu_torch.utils import tree
from badger_amcl_tpu_torch.utils.numerics import host_values

# the arms taken by eager steps, "name:true" / "name:false" -> count
ARMS = collections.Counter()
# the StrictHostReads modes entered, which count the predicate reads
_STRICT_MODES = []

_state = threading.local()


def _depth(attr: str) -> int:
    return getattr(_state, attr, 0)


@contextlib.contextmanager
def _nested(attr: str):
    setattr(_state, attr, _depth(attr) + 1)
    try:
        yield
    finally:
        setattr(_state, attr, _depth(attr) - 1)


def all_arms():
    """Warm-up mode: every `cond` runs both arms (eagerly)."""
    return _nested("warmup")


def plain_version(fn):
    """Mark a kernel's plain PyTorch version: it runs only on CPU tensors,
    in place of the kernel, so `StrictHostReads` lets its reads pass."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _nested("plain"):
            return fn(*args, **kwargs)

    return wrapped


def reading():
    """A counted read's own transfer (`numerics.LaggedFlags`' copy of a
    flag, counted when it is read): `StrictHostReads` lets it through."""
    return _nested("allowed")


def _read_predicates(preds) -> list:
    """Predicates to Python bools in one counted host sync."""
    for mode in _STRICT_MODES:
        mode.reads += 1
    with _nested("allowed"):
        return [bool(v) for v in host_values(*preds)]


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def recording_into(capture):
    """Make `capture` (utils.graph.Capture) the one that `cond` records into
    while this thread captures a graph."""
    prev = getattr(_state, "capture", None)
    _state.capture = capture
    try:
        yield capture
    finally:
        _state.capture = prev


def _capture_of(t):
    """The capture recording `t`'s stream, or None outside a capture."""
    if not (isinstance(t, torch.Tensor) and t.is_cuda and _capturing()):
        return None
    cap = getattr(_state, "capture", None)
    if cap is None:
        raise RuntimeError("utils.control.cond under a CUDA graph capture needs the "
                           "capture of utils.graph.graph_jit")
    return cap


def read(*preds):
    """Several predicates known together: Python bools in one host sync,
    or, while a graph is captured, the device tensors as they are."""
    if any(_capture_of(p) is not None for p in preds):
        return list(preds)
    return _read_predicates(preds)


def cond(pred, true_fn, false_fn, *operands, name: str):
    """`lax.cond(pred, true_fn, false_fn, *operands)`: pred a Python bool
    (already read) or a 0-dim bool tensor. `name` keys the arm counters."""
    cap = _capture_of(pred)
    if cap is not None:
        return cap.if_else(pred, true_fn, false_fn, operands, name)
    taken = pred if isinstance(pred, bool) else _read_predicates([pred])[0]
    if _depth("warmup"):
        outs = true_fn(*operands), false_fn(*operands)
        return outs[0] if taken else outs[1]
    ARMS[f"{name}:{'true' if taken else 'false'}"] += 1
    return (true_fn if taken else false_fn)(*operands)


def fori_loop(n: int, body_fn, carry, *, name: str):
    """`lax.fori_loop(0, n, body_fn, carry)` (or `lax.map` over n rows)
    with a static trip count: body_fn(i, carry) -> carry, the same
    structure of tensors of the same shapes and dtypes; it may update the
    carry's tensors in place and return them. Eagerly (warm-up included)
    a Python loop, i a Python int; while a graph is captured one WHILE
    node whose body is captured once, as JAX traces one (i a 0-dim int64
    device tensor: index with it by `index_select`, never `int()`). `name`
    keys the body's counter, and its executions count in `ARMS` as
    "name:body"."""
    cap = _capture_of(next(iter(tree.leaves(carry)), None))
    if cap is not None:
        return cap.fori(n, body_fn, carry, name)
    for i in range(n):
        if not _depth("warmup"):
            ARMS[f"{name}:body"] += 1
        carry = body_fn(i, carry)
    return carry


def while_loop(cond_fn, body_fn, init):
    """`lax.while_loop(cond_fn, body_fn, init)`, eagerly: cond_fn's value
    (a Python bool, or a 0-dim tensor read in one counted host sync) is
    checked before every body. Not capturable."""
    if _capturing():
        raise RuntimeError("while_loop cannot run inside a CUDA graph capture: give the "
                           "loop a kernel (as ops/cluster_kernel.py does)")
    val = init
    while True:
        c = cond_fn(val)
        if not (c if isinstance(c, bool) else _read_predicates([c])[0]):
            return val
        val = body_fn(val)


# --- the strict mode ---------------------------------------------------------

_aten = torch.ops.aten
# ops that read a tensor's value back to the host
_READ_OPS = {_aten._local_scalar_dense.default, _aten.is_nonzero.default,
             _aten.nonzero.default, _aten.masked_select.default, _aten.equal.default}
_INDEX_OPS = {_aten.index.Tensor, _aten.index_put.default, _aten.index_put_.default,
              _aten._index_put_impl_.default}
# a tensor made from host data (`torch.tensor`, `x[i] = 1.0`): on the card a
# host-to-device copy, which a graph capture refuses
_HOST_DATA_OPS = {_aten.lift_fresh.default, _aten.lift_fresh_copy.default}


def _reads_host(func, args, kwargs) -> bool:
    if func in _READ_OPS or func in _HOST_DATA_OPS:
        return True
    if func in _INDEX_OPS:  # a boolean mask index is a nonzero
        return any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                   for i in args[1] if i is not None)
    if func is _aten._to_copy.default:  # device to host
        dst = kwargs.get("device")
        return args[0].is_cuda and dst is not None and torch.device(dst).type == "cpu"
    if func is _aten.copy_.default:
        return args[1].is_cuda and not args[0].is_cuda
    return False


class StrictHostReads(TorchDispatchMode):
    """Traps the ops that read a tensor back to the host (`.item()`,
    `bool(t)`, nonzero, masked_select, boolean mask indexing, torch.equal,
    a copy to the host) or make one from host data, outside a predicate
    read of `cond`, `read` or `while_loop` and outside a kernel's plain
    version. raise_on_read: raise at the first such op; else collect them
    in `untracked`. `reads` counts the predicate reads (each one counted
    host sync)."""

    def __init__(self, raise_on_read: bool = True):
        super().__init__()
        self.raise_on_read = raise_on_read
        self.reads = 0
        self.untracked = []

    def __enter__(self):
        _STRICT_MODES.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STRICT_MODES.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not (_depth("allowed") or _depth("plain")) and _reads_host(func, args, kwargs):
            if self.raise_on_read:
                raise RuntimeError(f"host read outside a cond / while_loop predicate: {func}")
            self.untracked.append(str(func))
        return func(*args, **kwargs)
