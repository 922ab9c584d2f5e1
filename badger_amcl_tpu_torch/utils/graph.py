"""`graph_jit`, the port's counterpart of `jax.jit`: a step captured into a
CUDA graph once per static key and replayed after that.

The key is the static arguments' values, the identity of the arguments
held by reference (`omap`, the map, and `fsi`, a node's free cells: they
are read where they lie, never copied, and the entry holds them so they
stay alive), and of every other argument its structure, its non-tensor
values and the shape, dtype and device of each tensor (`utils.tree`).
The first call of a key

1. loads the kernel library (`graph_cond.load_library()`: the nvcc build
   never runs inside a capture),
2. copies the tensors into static buffers and runs the step once eagerly
   with every `control.cond` running both arms (`control.all_arms`), so
   every arm's kernels, caches and allocations exist before the capture,
3. captures the step on the buffers (`torch.cuda.graph`, its `cond`s as
   conditional nodes, `Capture`), then replays it.

Every call copies its tensors into the key's buffers, replays the graph
and returns fresh copies of the outputs, as JAX returns new arrays: no
host read happens inside a replay, which a caller can hold it to with
`torch.cuda.set_sync_debug_mode("error")`; a capture, which reads
predicates and synchronises, runs with the mode off. The launch counts of
the kernel wrappers in `.kernels` move with the warm-up's launches only:
what the capture records is counted per replay (`Capture.replay_launches`). A key's graph, buffers and memory
pools live until `release` drops the entries holding an object by
reference (a node does so for the map it replaces), else as long as the
process, as a JAX compile cache does. Random
variates are arguments, drawn before the call. On CPU tensors the step
runs eagerly through the same helpers, as every kernel wrapper runs its
plain version on the CPU; on CUDA tensors a call captures or raises and
never falls back to the eager step.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import inspect
import time

import torch

from badger_amcl_tpu_torch.ops import graph_cond
from badger_amcl_tpu_torch.utils import control, tree

# the arguments held by identity in the key, not copied into buffers
_REFERENCES = ("omap", "fsi")


class Capture:
    """What one graph capture records: each `cond` as a pair of IF nodes,
    a device counter per arm (SLOTS int64, one added at every execution),
    the private pool of the arm bodies' allocations and, for the kernel
    wrappers in `kernels` ({name: wrapper with a `launches` count}), the
    launches captured in each arm (their host counters read before and
    after each arm body)."""

    SLOTS = 64

    def __init__(self, device: torch.device, kernels: dict):
        self.counts = torch.zeros((self.SLOTS,), dtype=torch.int64, device=device)
        self.slots = {}  # "name:arm" -> counter index
        self.kernels = dict(kernels)
        # counter index (None: outside every arm) -> {kernel: launches in it}
        self.launches = collections.defaultdict(collections.Counter)
        self.pool = torch.cuda.graph_pool_handle()
        self._index = device.index if device.index is not None else torch.cuda.current_device()
        self._pool_uses = 0  # the allocator counts a use of the pool per arm routed to it
        self._frames = []

    def _snapshot(self):
        return collections.Counter({k: fn.launches for k, fn in self.kernels.items()})

    @contextlib.contextmanager
    def recording(self):
        """Make this the capture that `cond` records into; attribute the
        launches outside every arm."""
        self._frames.append([None, self._snapshot(), collections.Counter()])
        try:
            with control.recording_into(self):
                yield self
        finally:
            self._pop_frame()

    def _pop_frame(self):
        slot, start, nested = self._frames.pop()
        inclusive = self._snapshot() - start
        self.launches[slot].update(inclusive - nested)
        if self._frames:
            self._frames[-1][2].update(inclusive)

    @contextlib.contextmanager
    def arm(self, key: str, pred: torch.Tensor):
        """Capture what the block issues into the body of an IF node on
        pred (a 0-dim bool on the capturing device)."""
        slot = self.slots.setdefault(key, len(self.slots))
        if slot >= self.SLOTS:
            raise RuntimeError(f"more than {self.SLOTS} cond arms in one capture")
        body = graph_cond.if_begin(pred)
        index = self._index
        outermost = all(f[0] is None for f in self._frames)
        if outermost:  # nested arms allocate under the outermost arm's routing
            torch._C._cuda_beginAllocateCurrentThreadToPool(index, self.pool)
            self._pool_uses += 1
        self._frames.append([slot, self._snapshot(), collections.Counter()])
        try:
            with torch.cuda.stream(torch.cuda.ExternalStream(body, device=pred.device)):
                self.counts.narrow(0, slot, 1).add_(1)
                yield
        finally:
            self._pop_frame()
            if outermost:
                torch._C._cuda_endAllocateToPool(index, self.pool)
            graph_cond.if_end(body)

    def if_else(self, pred, true_fn, false_fn, operands, name):
        """`control.cond` under capture: the true arm's outputs are copied
        into fresh tensors, which the false arm's copy overwrites."""
        if pred.dtype != torch.bool or pred.numel() != 1:
            raise ValueError(f"cond {name}: the predicate must be one bool, got "
                             f"{pred.dtype} {tuple(pred.shape)}")
        pred = pred.reshape(()).contiguous()
        npred = torch.logical_not(pred)
        with self.arm(f"{name}:true", pred):
            out = tree.map_tensors(torch.clone, true_fn(*operands))
        with self.arm(f"{name}:false", npred):
            other = false_fn(*operands)
            mine, theirs = tree.leaves(out), tree.leaves(other)
            if len(mine) != len(theirs) or any(
                    a.shape != b.shape or a.dtype != b.dtype for a, b in zip(mine, theirs)):
                raise ValueError(f"cond {name}: the arms return differently shaped outputs")
            for a, b in zip(mine, theirs):
                a.copy_(b)
        return out

    def release(self) -> None:
        """Give the arms' pool back to the allocator (once its graph is
        gone): its blocks free as their tensors die."""
        for _ in range(self._pool_uses):
            torch._C._cuda_releasePool(self._index, self.pool)
        self._pool_uses = 0

    def arm_counts(self) -> dict:
        """{"name:arm": executions} over every replay so far (one host read)."""
        counts = self.counts.tolist()
        return {k: counts[i] for k, i in self.slots.items()}

    def replay_launches(self, replays: int, counts: dict = None) -> collections.Counter:
        """Kernel launches over `replays` replays: those outside every arm
        once a replay, each arm's as often as its counter says."""
        counts = self.arm_counts() if counts is None else counts
        by_slot = {i: counts[k] for k, i in self.slots.items()}
        out = collections.Counter()
        for slot, launched in self.launches.items():
            times = replays if slot is None else by_slot[slot]
            for k, n in launched.items():
                out[k] += n * times
        return out


@dataclasses.dataclass
class Entry:
    """One static key's graph: its input buffers, outputs, capture record
    and counts."""

    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: object
    capture: Capture
    references: dict
    capture_s: float
    replays: int = 0


def graph_jit(fn, static_argnames):
    """fn compiled per static key into a CUDA graph (module docstring).
    `wrapper.entries` maps each key to its `Entry`; `wrapper.captures`
    counts the captures (one per key); `wrapper.kernels` ({name: kernel
    wrapper}, empty unless a caller fills it) names the kernels whose
    launches each later capture attributes to its arms;
    `wrapper.release(obj)` drops every entry holding obj by reference."""
    sig = inspect.signature(fn)
    entries = {}

    def capture(bound, leaves, spec, references):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return capture_step(bound, leaves, spec, references)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def capture_step(bound, leaves, spec, references):
        wrapper.captures += 1
        graph_cond.load_library()
        inputs = [t.clone() for t in leaves]
        args = dict(bound.arguments, **tree.unflatten(spec, inputs))
        dev = inputs[0].device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), control.all_arms():
            fn(**args)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        cap = Capture(dev, wrapper.kernels)
        graph = torch.cuda.CUDAGraph()
        counted = {k: k_fn.launches for k, k_fn in cap.kernels.items()}
        t0 = time.perf_counter()
        with cap.recording(), torch.cuda.graph(graph):
            outputs = fn(**args)
        torch.cuda.synchronize(dev)
        for k, k_fn in cap.kernels.items():  # recorded, not launched
            k_fn.launches = counted[k]
        return Entry(graph, inputs, outputs, cap, references, time.perf_counter() - t0)

    def bind(args, kwargs):
        """(bound arguments, those held by reference, flattening spec,
        tensor leaves, key); the key is None for CPU tensors, which run the
        step eagerly."""
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        static = tuple((k, bound.arguments[k]) for k in static_argnames)
        references = {k: bound.arguments[k] for k in _REFERENCES if k in bound.arguments}
        dynamic = {k: v for k, v in bound.arguments.items()
                   if k not in static_argnames and k not in references}
        spec, leaves = tree.flatten(dynamic)
        devices = {t.device for t in leaves}
        if len(devices) != 1:
            raise ValueError(f"{fn.__name__}: the tensors must lie on one device, got "
                             f"{sorted(map(str, devices))}")
        if devices.pop().type != "cuda":
            return bound, references, spec, leaves, None
        key = (static, tuple((k, id(v)) for k, v in references.items()), spec,
               tuple((tuple(t.shape), t.dtype, t.device) for t in leaves))
        return bound, references, spec, leaves, key

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        bound, references, spec, leaves, key = bind(args, kwargs)
        if key is None:
            return fn(**bound.arguments)
        entry = entries.get(key)
        if entry is None:
            entry = entries[key] = capture(bound, leaves, spec, references)
        for buf, t in zip(entry.inputs, leaves):
            buf.copy_(t)
        entry.graph.replay()
        entry.replays += 1
        return tree.map_tensors(torch.clone, entry.outputs)

    def release(obj) -> int:
        """Drop every entry holding obj by reference (its graph, buffers,
        pools and its hold on obj); returns how many."""
        dead = [k for k, e in entries.items()
                if any(v is obj for v in e.references.values())]
        for k in dead:
            entry = entries.pop(k)
            del entry.graph  # the graph's own pool goes back with it
            entry.capture.release()
        return len(dead)

    wrapper.entries = entries
    wrapper.release = release
    wrapper.captures = 0
    wrapper.kernels = {}
    return wrapper
