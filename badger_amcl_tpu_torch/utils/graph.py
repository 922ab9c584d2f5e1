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
reference (a node does so for the map it replaces and when it goes),
`release_where` those whose static arguments a predicate picks (a node's
reconfiguration), or the wrapper evicts the entry as the least recently
used of more than MAX_ENTRIES (a JAX compile cache keeps every entry; an
entry here pins device memory). A release asked for while a call runs (a
node collected inside it) waits for the call's end. Random
variates are arguments, drawn before the call. On CPU tensors the step
runs eagerly through the same helpers, as every kernel wrapper runs its
plain version on the CPU; on CUDA tensors a call captures or raises and
never falls back to the eager step.

Every call is a `graph.call` region of `utils.profiling` (the host time
of the scans' calls, a span under a profiler, tagged with fn's name);
under a profiler only, its steps are the spans `graph.key`,
`graph.copy_in`, `graph.replay` (the host launch) and `graph.copy_out`.
A key's first call is a `graph.capture` region, timed always.
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
from badger_amcl_tpu_torch.utils import control, profiling, tree

# the arguments held by identity in the key, not copied into buffers
_REFERENCES = ("omap", "fsi")
# the live entries of one wrapper, beyond which the least recently used one
# goes. Each entry pins its buffers and pools on the card, ~13 MB for a 3D
# node's key at 50,000 particles, and a new key costs its warm-up and
# capture, ~35 ms of a scan (chip_smoke.py's "entries" lines, NVIDIA H100
# 80GB HBM3 at 700 W; PERF.md). A node keeps 1-3 keys a helper, and a
# 128-point cloud budget decimates raw clouds of 200-5,000 points to ~20
# sizes: 16 keeps such a stream resident and caps what ever-new sizes pin
# at ~0.2 GB a helper
MAX_ENTRIES = 16


class Capture:
    """What one graph capture records: each `cond` as a pair of IF nodes,
    each `fori_loop` as a WHILE node, a device counter per body (SLOTS
    int64, one added at every execution; a cond captured several times
    has a body and a counter each time), the
    private pool of the arm bodies' allocations and, for the kernel
    wrappers in `kernels` ({name: wrapper with a `launches` count}), the
    launches captured in each arm body (their host counters read before
    and after it)."""

    SLOTS = 4096

    def __init__(self, device: torch.device, kernels: dict):
        self.counts = torch.zeros((self.SLOTS,), dtype=torch.int64, device=device)
        self.slots = []  # "name:arm" of each arm body, by its counter index
        self.kernels = dict(kernels)
        # counter index (None: outside every arm) -> {kernel: launches in it}
        self.launches = collections.defaultdict(collections.Counter)
        self.pool = torch.cuda.graph_pool_handle()
        self._index = device.index if device.index is not None else torch.cuda.current_device()
        self._pool_uses = 0  # the allocator counts a use of the pool per arm routed to it
        self._frames = []
        self.nodes = 0  # the graph's nodes inside arm bodies (nested ones too)

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

    def arm(self, key: str, pred: torch.Tensor):
        """Capture what the block issues into the body of an IF node on
        pred (a 0-dim bool on the capturing device)."""
        return self._body(key, pred.device, lambda: (graph_cond.if_begin(pred), None),
                          lambda body, _: graph_cond.if_end(body))

    @contextlib.contextmanager
    def _body(self, key: str, device, begin, end):
        """Capture what the block issues into the body of a conditional
        node: begin() -> (its capturing stream, a token), end(stream,
        token) -> the body's node count."""
        slot = len(self.slots)
        if slot >= self.SLOTS:
            raise RuntimeError(f"more than {self.SLOTS} cond arm bodies in one capture")
        self.slots.append(key)
        body, token = begin()
        index = self._index
        outermost = all(f[0] is None for f in self._frames)
        if outermost:  # nested arms allocate under the outermost arm's routing
            torch._C._cuda_beginAllocateCurrentThreadToPool(index, self.pool)
            self._pool_uses += 1
        self._frames.append([slot, self._snapshot(), collections.Counter()])
        try:
            with torch.cuda.stream(torch.cuda.ExternalStream(body, device=device)):
                self.counts.narrow(0, slot, 1).add_(1)
                yield
        finally:
            self._pop_frame()
            if outermost:
                torch._C._cuda_endAllocateToPool(index, self.pool)
            self.nodes += end(body, token)

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

    def fori(self, n: int, body_fn, carry, name: str):
        """`control.fori_loop` under capture: one WHILE node whose body,
        captured once, runs body_fn(i, carry) with i a 0-dim int64 device
        counter, copies its result into the loop-carried buffers (unless
        body_fn updated them in place and returned them) and counts i up;
        the loop runs while i < n. Returns the buffers."""
        state = tree.map_tensors(torch.clone, carry)
        dev = tree.leaves(state)[0].device
        i = torch.zeros((), dtype=torch.int64, device=dev)
        pred = torch.lt(i, n)
        with self._body(f"{name}:body", dev, lambda: graph_cond.while_begin(pred),
                        lambda body, handle: graph_cond.while_end(body, handle, pred)):
            out = body_fn(i, state)
            mine, theirs = tree.leaves(state), tree.leaves(out)
            if len(mine) != len(theirs) or any(
                    a.shape != b.shape or a.dtype != b.dtype for a, b in zip(mine, theirs)):
                raise ValueError(f"fori_loop {name}: the body changes the carry's shapes")
            for a, b in zip(mine, theirs):
                if a is not b:
                    a.copy_(b)
            i.add_(1)
            torch.lt(i, n, out=pred)
        return state

    def release(self) -> None:
        """Give the arms' pool back to the allocator (once its graph is
        gone): its blocks free as their tensors die."""
        for _ in range(self._pool_uses):
            torch._C._cuda_releasePool(self._index, self.pool)
        self._pool_uses = 0

    def slot_counts(self) -> list:
        """Executions of each arm body over every replay so far, by counter
        index (one host read)."""
        return self.counts[:len(self.slots)].tolist()

    def arm_counts(self) -> dict:
        """{"name:arm": executions of its bodies} over every replay so far
        (one host read)."""
        out = collections.Counter()
        for k, n in zip(self.slots, self.slot_counts()):
            out[k] += n
        return dict(out)

    def replay_launches(self, replays: int, counts: list = None) -> collections.Counter:
        """Kernel launches over `replays` replays: those outside every arm
        once a replay, each arm body's as often as its counter says
        (`counts`, by counter index: `slot_counts()` or a difference of
        two)."""
        counts = self.slot_counts() if counts is None else counts
        out = collections.Counter()
        for slot, launched in self.launches.items():
            times = replays if slot is None else counts[slot]
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
    nodes: int = 0  # the graph's nodes, every arm body's included
    replays: int = 0
    static: dict = dataclasses.field(default_factory=dict)


# while a call runs, from its lookup to its replay (_deferring_drops): the
# releases asked for in it (a node collected there) and the graphs of the
# entries dropped in it wait for its end
_PENDING = []  # (entries, key, entry, tally) released while a call runs
_DEFERRED = []  # (entry, tally) dropped while a call runs
_busy = [0]


@contextlib.contextmanager
def _sync_mode(mode):
    """torch.cuda's sync debug mode set to `mode` for the block."""
    saved = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(saved)


def _destroy(entry: Entry, tally: collections.Counter) -> None:
    """Destroy a dropped entry's graph (its own pool goes back with it) and
    release its arms' pool, or defer that until the running call ends.
    Where its capture attributed kernel launches, add those of its replays
    to `tally` (one host read)."""
    if _busy[0]:
        _DEFERRED.append((entry, tally))
        return
    if entry.replays and any(entry.capture.launches.values()):
        with _sync_mode(0):
            tally.update(entry.capture.replay_launches(entry.replays))
    del entry.graph
    entry.capture.release()


@contextlib.contextmanager
def _deferring_drops():
    """While a call runs, every release asked for and every dropped
    entry's destruction wait for its end."""
    _busy[0] += 1
    try:
        yield
    finally:
        _busy[0] -= 1
        while not _busy[0] and (_PENDING or _DEFERRED):
            if _PENDING:
                entries, key, entry, tally = _PENDING.pop()
                if entries.get(key) is entry:
                    del entries[key]
                    _destroy(entry, tally)
            else:
                _destroy(*_DEFERRED.pop())


def _captures_on(device: torch.device) -> bool:
    """Whether a call on tensors of this device captures a graph (CUDA) or
    runs its function eagerly."""
    return device.type == "cuda"


def _capture(fn, bound, leaves, spec, references, kernels, static) -> Entry:
    """A new key's entry: its buffers, the warm-up with every arm run, then
    the capture, with the sync debug mode off (a capture reads predicates
    and synchronises)."""
    with _sync_mode(0):
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
        cap = Capture(dev, kernels)
        graph = torch.cuda.CUDAGraph()
        counted = {k: k_fn.launches for k, k_fn in cap.kernels.items()}
        t0 = time.perf_counter()
        with cap.recording(), torch.cuda.graph(graph):
            outputs = fn(**args)
            top = graph_cond.capture_nodes(dev)
        torch.cuda.synchronize(dev)
        for k, k_fn in cap.kernels.items():  # recorded, not launched
            k_fn.launches = counted[k]
        return Entry(graph, inputs, outputs, cap, references, time.perf_counter() - t0,
                     nodes=top + cap.nodes, static=static)


def device_tensor(v, device):
    """An f32 argument (odometry) as a tensor on the step's device: a
    device f32 tensor or None as it is, host data copied there before the
    replay."""
    if v is None or (isinstance(v, torch.Tensor) and v.device == device
                     and v.dtype == torch.float32):
        return v
    return torch.as_tensor(v, dtype=torch.float32).to(device)


def graph_jit(fn, static_argnames):
    """fn compiled per static key into a CUDA graph (module docstring).
    `wrapper.entries` maps each live key to its `Entry`, least recently
    used first, at most MAX_ENTRIES of them; `wrapper.captures` counts the
    captures (one per key while it lives) and `wrapper.evictions` the
    entries evicted; `wrapper.kernels` ({name: kernel wrapper}, empty
    unless a caller fills it) names the kernels whose launches each later
    capture attributes to its arms, and `wrapper.dropped_launches` counts
    those launched in the replays of the entries dropped so far;
    `wrapper.release(obj)` drops every entry holding obj by reference,
    `wrapper.release_where(pred)` every entry whose static arguments
    ({name: value}) pred accepts."""
    sig = inspect.signature(fn)
    name = fn.__name__
    entries = collections.OrderedDict()

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
        if not _captures_on(devices.pop()):
            return bound, references, spec, leaves, None
        key = (static, tuple((k, id(v)) for k, v in references.items()), spec,
               tuple((tuple(t.shape), t.dtype, t.device) for t in leaves))
        return bound, references, spec, leaves, key

    def entry_of(key, bound, leaves, spec, references):
        """The key's entry, captured on its first call, now the most
        recently used."""
        entry = entries.get(key)
        if entry is None:
            while len(entries) >= MAX_ENTRIES:  # the least recently used goes first
                _destroy(entries.popitem(last=False)[1], wrapper.dropped_launches)
                wrapper.evictions += 1
            wrapper.captures += 1
            with profiling.capture(name):
                entry = entries[key] = _capture(fn, bound, leaves, spec, references,
                                                wrapper.kernels, dict(key[0]))
        entries.move_to_end(key)
        return entry

    def run(args, kwargs):
        bound, references, spec, leaves, key = bind(args, kwargs)
        if key is None:
            return fn(**bound.arguments)
        with _deferring_drops():
            entry = entry_of(key, bound, leaves, spec, references)
            for buf, t in zip(entry.inputs, leaves):
                buf.copy_(t)
            entry.graph.replay()
            entry.replays += 1
            return tree.map_tensors(torch.clone, entry.outputs)

    def run_traced(args, kwargs):
        """run, its steps each a span."""
        span = profiling.span
        with span("graph.key"):
            bound, references, spec, leaves, key = bind(args, kwargs)
        if key is None:
            return fn(**bound.arguments)
        with _deferring_drops():
            entry = entry_of(key, bound, leaves, spec, references)
            with span("graph.copy_in"):
                for buf, t in zip(entry.inputs, leaves):
                    buf.copy_(t)
            with span("graph.replay"):
                entry.graph.replay()
            entry.replays += 1
            with span("graph.copy_out"):
                return tree.map_tensors(torch.clone, entry.outputs)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with profiling.call(name) as call:
            return (run if call.span is None else run_traced)(args, kwargs)

    def drop(key):
        """Drop one entry: its graph, buffers, arm pool and its hold on what
        it references; inside a call, once the call ends."""
        if _busy[0]:
            _PENDING.append((entries, key, entries[key], wrapper.dropped_launches))
            return
        _destroy(entries.pop(key), wrapper.dropped_launches)

    def release_where(pred) -> int:
        """Drop every entry whose static arguments ({name: value}) pred
        accepts; returns how many."""
        dead = [k for k, e in entries.items() if pred(e.static)]
        for k in dead:
            drop(k)
        return len(dead)

    def release(obj) -> int:
        """Drop every entry holding obj by reference; returns how many."""
        dead = [k for k, e in entries.items()
                if any(v is obj for v in e.references.values())]
        for k in dead:
            drop(k)
        return len(dead)

    wrapper.entries = entries
    wrapper.release = release
    wrapper.release_where = release_where
    wrapper.captures = 0
    wrapper.evictions = 0
    wrapper.kernels = {}
    wrapper.dropped_launches = collections.Counter()
    return wrapper
