"""Elementwise and reduction ops the loss blocks use (counterpart of part
of `incubator_mxnet_tpu/ops/math.py` and `ops/reduce.py`)."""
from __future__ import annotations

import torch

from .registry import register


_INTS = (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64)


def _axes(data, axis, exclude):
    """The reduced dims: `axis` (all for None, none for ()), or every
    other dim with `exclude`."""
    if axis is None:
        return tuple(range(data.ndim))
    axes = {a % data.ndim for a in ((axis,) if isinstance(axis, int)
                                    else axis)}
    if exclude:
        axes = set(range(data.ndim)) - axes
    return tuple(sorted(axes))


def _reduce(fn, data, axis, exclude):
    """`fn` over the reduced dims; with none (`axis=()`) the data comes
    back unchanged, as from `jnp.sum`/`jnp.mean` (torch reads an empty
    dim list as every dim)."""
    dims = _axes(data, axis, exclude)
    return fn(data, dims) if dims else data.clone()


@register("mean")
def mean(data, *, axis=None, keepdims=False, exclude=False):
    """The mean; integer and bool data give the float32 mean, as
    `jnp.mean` does."""
    if not data.is_floating_point():
        data = data.to(torch.float32)
    return _reduce(lambda t, d: t.mean(dim=d, keepdim=keepdims), data,
                   axis, exclude)


@register("sum")
def sum_(data, *, axis=None, keepdims=False, exclude=False):
    """The sum; integer data keep their dtype, as with `jnp.sum` (torch
    would widen to int64)."""
    keep = data.dtype if data.dtype in _INTS else None
    return _reduce(lambda t, d: t.sum(dim=d, keepdim=keepdims, dtype=keep),
                   data, axis, exclude)


@register("square")
def square(data):
    return data * data


@register("abs")
def abs_(data):
    return data.abs()


@register("broadcast_mul")
def broadcast_mul(lhs, rhs):
    return lhs * rhs
