"""PyTorch port: how a `graph_jit` call moves its tensors (`utils.graph`),
on the CPU.

The outputs are `Packed`: one flat buffer per dtype, each tensor in a slot
of its own at a multiple of ALIGN bytes; an unpack returns the tensors bit
for bit as packed, as views into a fresh clone of each flat buffer, so two
unpacks share no storage and a write into one returned tensor reaches
neither its neighbours nor the buffers. The copy-in moves each dtype
group's contiguous tensors in one `_foreach_copy_` and a non-contiguous
one alone, with the same result as a `copy_` per tensor. Through a
compiled call (a fake capture on CPU tensors) every tensor moved is
tallied, and every one in a grouped transfer but the non-contiguous.
"""

import pytest
import torch

from badger_amcl_tpu_torch.utils import graph, profiling, tree
from badger_amcl_tpu_torch.utils.graph import ALIGN, Entry, Packed

M = 37  # no multiple of a slot's alignment in any dtype


def _mixed(seed=0):
    """A structure of every shape and dtype the node's helpers move: 0-dim,
    (M,), (M, 3), (M, 3, 3), float32, int32 and bool, interleaved, with an
    empty tensor and a non-tensor value."""
    g = torch.Generator().manual_seed(seed)
    return {
        "poses": torch.randn((M, 3), generator=g),
        "count": torch.randint(-2**31, 2**31 - 1, (), generator=g, dtype=torch.int32),
        "weights": torch.rand((M,), generator=g),
        "flag": torch.rand((), generator=g) < 0.5,
        "cov": torch.randn((M, 3, 3), generator=g),
        "labels": torch.randint(-5, 5, (M,), generator=g, dtype=torch.int32),
        "mask": torch.rand((M,), generator=g) < 0.5,
        "w": torch.randn((), generator=g),
        "none": torch.zeros((0, 3)),
        "static": "kept",
        "nested": (torch.randn((M, 3), generator=g), [torch.rand((3,), generator=g)]),
    }


def _packed(obj):
    spec, leaves = tree.flatten(obj)
    packed = Packed(spec, leaves)
    packed.pack(leaves)
    return packed


def _bits(t):
    """t's bytes (bool as it is): NaN payloads and signed zeros compared."""
    return t if t.dtype == torch.bool else t.reshape(-1).view(torch.uint8)


def test_a_round_trip_is_bit_exact():
    obj = _mixed()
    out = _packed(obj).unpack()
    spec, want = tree.flatten(obj)
    got_spec, got = tree.flatten(out)
    assert got_spec == spec and out["static"] == "kept"
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype and a.is_contiguous()
        assert torch.equal(_bits(a), _bits(b))
    # -0.0 and NaN payloads come back as they went in
    special = torch.tensor([-0.0, float("nan"), float("inf")])
    (back,) = _packed([special]).unpack()
    assert torch.equal(back.view(torch.int32), special.view(torch.int32))


def test_one_flat_buffer_per_dtype_and_each_slot_aligned():
    packed = _packed(_mixed())
    assert [flat.dtype for _, flat, _ in packed.groups] == [torch.float32, torch.int32,
                                                           torch.bool]
    out = tree.leaves(packed.unpack())
    bases = {}
    for t in out:
        offset = t.storage_offset() * t.element_size()
        assert offset % ALIGN == 0
        bases.setdefault(t.dtype, set()).add(t.untyped_storage().data_ptr())
    assert all(len(b) == 1 for b in bases.values())  # one clone per dtype group


def test_two_unpacks_share_no_storage():
    packed = _packed(_mixed())
    first, second = tree.leaves(packed.unpack()), tree.leaves(packed.unpack())
    statics = {flat.untyped_storage().data_ptr() for _, flat, _ in packed.groups}
    mine = {t.untyped_storage().data_ptr() for t in first}
    theirs = {t.untyped_storage().data_ptr() for t in second}
    assert not mine & theirs and not (mine | theirs) & statics


def test_a_write_to_one_returned_tensor_stays_in_its_slot():
    obj = _mixed()
    packed = _packed(obj)
    before = [flat.clone() for _, flat, _ in packed.groups]
    want = tree.leaves(obj)
    for k in range(len(want)):
        out = tree.leaves(packed.unpack())
        out[k].copy_(~want[k] if want[k].dtype == torch.bool else want[k] + 1)
        for j, (a, b) in enumerate(zip(out, want)):
            assert torch.equal(_bits(a), _bits(b)) == (j != k or not b.numel())
    for (_, flat, _), b in zip(packed.groups, before):
        assert torch.equal(_bits(flat), _bits(b))


def test_the_grouped_copy_in_equals_a_copy_per_tensor():
    src = tree.leaves(_mixed(1))
    src[0] = torch.randn((3, M)).t()  # (M, 3), not contiguous
    src[4] = torch.randn((M, 3, 3)).transpose(1, 2)
    assert not src[0].is_contiguous() and not src[4].is_contiguous()
    grouped_bufs = [torch.zeros(t.shape, dtype=t.dtype) for t in src]
    single_bufs = [b.clone() for b in grouped_bufs]
    groups = [(index, [grouped_bufs[i] for i in index])
              for index in graph.dtype_groups(src)]
    assert graph.copy_in(groups, src) == len(src) - 2
    for b, t in zip(single_bufs, src):
        b.copy_(t)
    for a, b in zip(grouped_bufs, single_bufs):
        assert torch.equal(_bits(a), _bits(b))


def _step(x, n, mask, by):
    return dict(x=x * by, n=n + 1, mask=~mask, both=(x.sum(), mask.any()))


@pytest.fixture
def fake_graphs(monkeypatch):
    """graph_jit's compiled path on CPU tensors: a capture packs the
    outputs of one eager run, a replay runs the step again on the buffers
    and packs its outputs."""

    class Replay:
        def __init__(self, run, outputs):
            self.run, self.outputs = run, outputs

        def replay(self):
            self.outputs.pack(tree.leaves(self.run()))

    def capture(fn, bound, leaves, spec, references, kernels, static):
        inputs = [t.clone(memory_format=torch.contiguous_format) for t in leaves]
        args = dict(bound.arguments, **tree.unflatten(spec, inputs))
        outputs = _packed(fn(**args))
        return Entry(Replay(lambda: fn(**args), outputs), inputs, outputs, None, references,
                     0.0, static=static)

    monkeypatch.setattr(graph, "_captures_on", lambda device: True)
    monkeypatch.setattr(graph, "_capture", capture)
    profiling.reset()
    yield
    profiling.reset()


def test_a_compiled_call_tallies_what_it_moved(fake_graphs):
    jit = graph.graph_jit(_step, static_argnames=("by",))
    x, n, mask = torch.arange(6.0), torch.tensor(3, dtype=torch.int32), torch.rand(6) < 0.5
    first = jit(x, n, mask, by=2.0)  # the capture: set-up, in no timed scan
    kept = tree.map_tensors(torch.clone, first)
    with profiling.scan():
        second = jit(x + 1, n, mask, by=2.0)
    c = profiling.counters()
    assert c["entry_leaves"] == 3 + 5 and c["entry_grouped"] == 3 + 5
    with profiling.scan():  # a non-contiguous input moves alone
        third = jit(torch.arange(12.0).reshape(6, 2)[:, 1], n + 1, ~mask, by=2.0)
    c = profiling.counters()
    assert c["entry_leaves"] == 2 * 8 and c["entry_grouped"] == 2 * 8 - 1
    assert jit.captures == 1
    # each call's outputs are its own: the later calls wrote none of the first's
    for a, b in zip(tree.leaves(first), tree.leaves(kept)):
        assert torch.equal(a, b)
    assert torch.equal(second["x"], (x + 1) * 2)
    assert torch.equal(third["x"], torch.arange(1.0, 12.0, 2.0) * 2)
    assert third["n"].item() == 5 and torch.equal(third["mask"], mask)
    assert third["both"][0].item() == 36.0 and third["both"][1].item() == bool((~mask).any())
