"""Elementwise and reduction ops the loss blocks use (counterpart of part
of `incubator_mxnet_tpu/ops/math.py` and `ops/reduce.py`)."""
from __future__ import annotations

import torch

from .registry import register


def _axes(data, axis, exclude):
    """The reduced dims: `axis` (all for None), or every other dim with
    `exclude`."""
    if axis is None:
        return tuple(range(data.ndim))
    axes = {a % data.ndim for a in ((axis,) if isinstance(axis, int)
                                    else axis)}
    if exclude:
        axes = set(range(data.ndim)) - axes
    return tuple(sorted(axes))


@register("mean")
def mean(data, *, axis=None, keepdims=False, exclude=False):
    return data.mean(dim=_axes(data, axis, exclude), keepdim=keepdims)


@register("sum")
def sum_(data, *, axis=None, keepdims=False, exclude=False):
    return data.sum(dim=_axes(data, axis, exclude), keepdim=keepdims)


@register("square")
def square(data):
    return data * data


@register("abs")
def abs_(data):
    return data.abs()


@register("broadcast_mul")
def broadcast_mul(lhs, rhs):
    return lhs * rhs
