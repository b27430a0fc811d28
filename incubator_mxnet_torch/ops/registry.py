"""Operator registry: one registration per op, whose implementation is a
plain function on torch tensors (array inputs positional, static
attributes keyword-only).

PyTorch counterpart of `incubator_mxnet_tpu/ops/registry.py`
(`register`, `apply_op`).  PyTorch runs eagerly, so there is no
executable cache: `apply_op` unwraps NDArrays, calls the function under
`autograd.grad_scope()` (a graph is kept only inside `record()`) and
wraps what it returns.  The `nd` namespace, which is the `F` that
`HybridBlock.hybrid_forward` receives, is generated from this table.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..autograd import grad_scope

__all__ = ["register", "get_op", "list_ops", "apply_op", "make_nd_function"]

_REGISTRY = {}


def register(name, aliases=()):
    """Register `impl` under `name` (and `aliases`)."""
    def deco(impl):
        _REGISTRY[name] = impl
        for a in aliases:
            _REGISTRY[a] = impl
        return impl
    return deco


def get_op(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MXNetError(f"operator {name!r} is not registered") from None


def list_ops():
    return sorted(_REGISTRY)


def _unwrap(a):
    from ..ndarray import NDArray
    return a._data if isinstance(a, NDArray) else a


def _wrap(out):
    from ..ndarray import NDArray
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (tuple, list)):
        return tuple(_wrap(o) for o in out)
    return out


def apply_op(name, *inputs, **attrs):
    """Run a registered op on NDArrays (or tensors); returns NDArrays."""
    impl = get_op(name)
    with grad_scope():
        out = impl(*[_unwrap(a) for a in inputs],
                   **{k: _unwrap(v) for k, v in attrs.items()})
    return _wrap(out)


def make_nd_function(name):
    def fn(*args, **kwargs):
        kwargs.pop("name", None)     # symbol-compat: a no-op in nd
        return apply_op(name, *args, **kwargs)
    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = get_op(name).__doc__
    return fn
