"""Nested structures of tensors, the JAX package's pytrees: dataclasses,
tuples (named ones too), lists and dicts, nested in any way, whose tensors
are the leaves; any other value is part of the structure."""

from __future__ import annotations

import dataclasses

import torch


def _flatten(obj, tensors: list):
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return ("tensor",)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return ("dataclass", type(obj), tuple(
            (f.name, _flatten(getattr(obj, f.name), tensors)) for f in dataclasses.fields(obj)))
    if isinstance(obj, (tuple, list)):
        return (type(obj), tuple(_flatten(x, tensors) for x in obj))
    if isinstance(obj, dict):
        return (dict, tuple((k, _flatten(obj[k], tensors)) for k in obj))
    return ("value", obj)


def flatten(obj) -> tuple:
    """(spec, tensors): the structure with its non-tensor values (hashable
    where they are) and the tensors in a fixed order."""
    tensors = []
    return _flatten(obj, tensors), tensors


def _unflatten(spec, tensors):
    kind = spec[0]
    if kind == "tensor":
        return next(tensors)
    if kind == "value":
        return spec[1]
    if kind == "dataclass":
        return spec[1](**{name: _unflatten(s, tensors) for name, s in spec[2]})
    if kind is dict:
        return {k: _unflatten(s, tensors) for k, s in spec[1]}
    items = [_unflatten(s, tensors) for s in spec[1]]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def unflatten(spec, tensors):
    """The structure of `spec` holding `tensors` (an iterable, in
    `flatten`'s order)."""
    return _unflatten(spec, iter(tensors))


def leaves(obj) -> list:
    """The tensors of obj, in `flatten`'s order."""
    return flatten(obj)[1]


def map_tensors(fn, *objs):
    """obj's structure with fn over the matching tensors of objs (each of
    the same structure)."""
    spec, first = flatten(objs[0])
    return unflatten(spec, [fn(*ts) for ts in zip(first, *map(leaves, objs[1:]), strict=True)])
