"""Reduction, sorting and scan ops (counterpart of
`incubator_mxnet_tpu/ops/reduce.py`).

`MXNET_SAFE_ACCUMULATION` (default on) keeps the JAX `_safe_acc` rule:
bfloat16 and float16 data are summed (`sum`, `mean`, `nansum`) in
float32 and the result rounded back.  Integer sums, products and cumsums
give int32, unsigned ones uint32, as `jnp` without x64 (narrow integers
are widened, int32 wraps as there; torch would give int64); bool sums
give int32.  `argmax`/`argmin` and the
index outputs of `argsort`/`topk` are float32 by default, as in MXNet.
Ties: `argsort`, `sort` and `topk` order equal values by index, as the
stable `jnp.argsort` and `lax.top_k` do (descending order reverses the
ascending one, as the JAX op flips it).
"""
from __future__ import annotations

import torch

from .registry import register
from ..base import get_env, torch_dtype

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


def _safe_acc(data):
    """(data in float32, True) for bfloat16/float16 data under
    MXNET_SAFE_ACCUMULATION, else (data, False)."""
    if get_env("MXNET_SAFE_ACCUMULATION", True, bool) and data.dtype in (
            torch.bfloat16, torch.float16):
        return data.to(torch.float32), True
    return data, False


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def _int_out(data):
    """The dtype of an integer or bool sum or product, as `jnp`'s
    without x64: uint32 for unsigned data, int32 for the rest (None for
    float data)."""
    if data.is_floating_point():
        return None
    return torch.uint32 if data.dtype in _UNSIGNED else torch.int32


def _make_safe(name, fn):
    def impl(data, *, axis=None, keepdims=False, exclude=False):
        dt = data.dtype
        if fn is _mean and not data.is_floating_point():
            data, dt = data.to(torch.float32), torch.float32
        data, cast = _safe_acc(data)
        out = _reduce(lambda t, d: fn(t, d, keepdims), data, axis, exclude)
        return out.to(dt) if cast else out
    impl.__name__ = impl.__qualname__ = name
    return impl


def _sum(t, dims, keepdims):
    """Integer data are summed in int64 and wrapped to the 32-bit result
    dtype, which gives `jnp`'s wrapped 32-bit sum."""
    out = _int_out(t)
    if out is None:
        return t.sum(dim=dims, keepdim=keepdims)
    return t.sum(dim=dims, keepdim=keepdims, dtype=torch.int64).to(out)


def _nansum(t, dims, keepdims):
    if not t.is_floating_point():
        return _sum(t, dims, keepdims)
    return torch.nansum(t, dim=dims, keepdim=keepdims)


def _mean(t, dims, keepdims):
    return t.mean(dim=dims, keepdim=keepdims)


def _prod(t, dims, keepdims):
    """torch's `prod` takes one dim: the dims are folded one at a time."""
    out = _int_out(t)
    for d in sorted(dims, reverse=True):
        t = t.prod(dim=d, keepdim=keepdims,
                   dtype=None if out is None else torch.int64)
    return t if out is None else t.to(out)


def _nanprod(t, dims, keepdims):
    if t.is_floating_point():
        t = torch.where(torch.isnan(t), torch.ones_like(t), t)
    return _prod(t, dims, keepdims)


register("sum", aliases=("sum_axis",))(_make_safe("sum", _sum))
register("mean")(_make_safe("mean", _mean))
register("nansum")(_make_safe("nansum", _nansum))


def _make_plain(name, fn):
    def impl(data, *, axis=None, keepdims=False, exclude=False):
        return _reduce(lambda t, d: fn(t, d, keepdims), data, axis, exclude)
    impl.__name__ = impl.__qualname__ = name
    return impl


register("prod")(_make_plain("prod", _prod))
register("nanprod")(_make_plain("nanprod", _nanprod))
register("max", aliases=("max_axis",))(_make_plain(
    "max", lambda t, d, k: t.amax(dim=d, keepdim=k)))
register("min", aliases=("min_axis",))(_make_plain(
    "min", lambda t, d, k: t.amin(dim=d, keepdim=k)))


@register("norm")
def norm(data, *, ord=2, axis=None, keepdims=False):
    """The `ord`-norm over `axis` (all axes for None), returned in the
    data's dtype; bfloat16 and float16 data accumulate in float32 and
    the result is rounded back."""
    dt = data.dtype
    low = dt in (torch.bfloat16, torch.float16)
    if low:
        data = data.to(torch.float32)
    dims = _axes(data, axis, False)

    def total(t):
        return t.sum(dim=dims, keepdim=keepdims) if dims else t
    if ord == 1 and not data.is_floating_point():
        # integer data sum as `jnp.sum` sums them (int32, or uint32 for
        # unsigned data); the absolute value of bool data is itself
        return _reduce(lambda t, d: _sum(t, d, keepdims),
                       data if data.dtype == torch.bool else data.abs(),
                       axis, False)
    if ord == 1:
        out = total(data.abs())
    elif ord == 2:
        out = total(data.square()).sqrt()
    else:
        out = total(data.abs() ** ord) ** (1.0 / ord)
    return out.to(dt) if low else out


def _arg(fn, data, axis, keepdims):
    """`jnp.argmax`/`argmin` (first of equal values), as float32; bool
    data order as 0 and 1."""
    data = data.detach()
    if data.dtype == torch.bool:
        data = data.to(torch.uint8)
    if axis is None:
        out = fn(data.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * data.ndim)
    else:
        out = fn(data, dim=axis, keepdim=bool(keepdims))
    return out.to(torch.float32)


@register("argmax")
def argmax(data, *, axis=None, keepdims=False):
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin")
def argmin(data, *, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


def _stable_order(data, axis, is_ascend):
    """Indices of the stable ascending sort along `axis`, flipped for
    descending order (the JAX op's flip)."""
    idx = torch.argsort(data, dim=axis, stable=True)
    return idx if is_ascend else idx.flip(axis)


@register("argsort")
def argsort(data, *, axis=-1, is_ascend=True, dtype="float32"):
    return _stable_order(data.detach(), axis, is_ascend).to(
        torch_dtype(dtype))


@register("sort")
def sort(data, *, axis=-1, is_ascend=True):
    return data.gather(axis, _stable_order(data.detach(), axis, is_ascend))


@register("topk")
def topk(data, *, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The k largest (smallest with `is_ascend`) along `axis`, equal
    values in index order, as `lax.top_k`.  `ret_typ` "value", "both"
    (values, indices) or anything else the indices.  No gradient flows
    back, as the JAX op is registered `differentiable=False`."""
    data = data.detach()
    idx = torch.argsort(data, dim=axis, stable=True,
                        descending=not is_ascend).narrow(axis, 0, k)
    if ret_typ == "value":
        return data.gather(axis, idx)
    if ret_typ == "both":
        return data.gather(axis, idx), idx.to(torch_dtype(dtype))
    return idx.to(torch_dtype(dtype))


@register("cumsum")
def cumsum(data, *, axis=None, dtype=None):
    """`jnp.cumsum`: over the flattened data for axis None; integer data
    keeps its dtype unless `dtype` says otherwise."""
    if axis is None:
        data, axis = data.reshape(-1), 0
    dt = torch_dtype(dtype) if dtype is not None else (
        torch.int32 if data.dtype == torch.bool
        else data.dtype if data.dtype in _INTS else None)
    return torch.cumsum(data, dim=axis, dtype=dt)
