"""Reduction, sorting and scan ops (counterpart of
`incubator_mxnet_tpu/ops/reduce.py`).

`MXNET_SAFE_ACCUMULATION` (default on) keeps the JAX `_safe_acc` rule:
bfloat16 and float16 data are summed (`sum`, `mean`, `nansum`) in
float32 and the result rounded back.  Integer sums, products and cumsums
keep the data's dtype (int32 stays int32, as `jnp` without x64; torch
would widen to int64), bool sums give int32.  `argmax`/`argmin` and the
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


def _int_keep(data):
    """The dtype an integer or bool reduction keeps (None: torch's)."""
    if data.dtype == torch.bool:
        return torch.int32
    return data.dtype if data.dtype in _INTS else None


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
    return t.sum(dim=dims, keepdim=keepdims, dtype=_int_keep(t))


def _nansum(t, dims, keepdims):
    if not t.is_floating_point():
        return _sum(t, dims, keepdims)
    return torch.nansum(t, dim=dims, keepdim=keepdims)


def _mean(t, dims, keepdims):
    return t.mean(dim=dims, keepdim=keepdims)


def _prod(t, dims, keepdims):
    """torch's `prod` takes one dim: the dims are folded one at a time."""
    keep = _int_keep(t)
    for d in sorted(dims, reverse=True):
        t = t.prod(dim=d, keepdim=keepdims, dtype=keep)
    return t


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
    if ord == 1:
        out = total(data.abs())
    elif ord == 2:
        out = total(data.square()).sqrt()
    else:
        out = total(data.abs() ** ord) ** (1.0 / ord)
    return out.to(dt) if low else out


def _arg(fn, data, axis, keepdims):
    """`jnp.argmax`/`argmin` (first of equal values), as float32."""
    data = data.detach()
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
    dt = torch_dtype(dtype) if dtype is not None else _int_keep(data)
    return torch.cumsum(data, dim=axis, dtype=dt)
