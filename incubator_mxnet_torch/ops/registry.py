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

from ..base import MXNetError
from ..autograd import grad_scope

__all__ = ["register", "add_alias", "get_op", "list_ops", "apply_op",
           "write_out", "make_nd_function"]

_REGISTRY = {}


def register(name, aliases=()):
    """Register `impl` under `name` (and `aliases`)."""
    def deco(impl):
        _REGISTRY[name] = impl
        for a in aliases:
            _REGISTRY[a] = impl
        return impl
    return deco


def add_alias(alias, target):
    """Register another name for op `target` (legacy names)."""
    _REGISTRY[alias] = get_op(target)


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


def apply_op(name, *inputs, **attrs):
    """Run a registered op on NDArrays (or tensors); returns NDArrays.
    An output that shares an input's storage is registered as a view
    (`ndarray.ndarray`: a write to either side leaves the other)."""
    from ..ndarray.ndarray import wrap
    impl = get_op(name)
    tensors = [_unwrap(a) for a in inputs]
    with grad_scope():
        out = impl(*tensors, **{k: _unwrap(v) for k, v in attrs.items()})
    return wrap(out, tensors)


def write_out(res, out):
    """Write result `res` into `out` (an NDArray, or a list of them for
    several outputs), as the JAX package's `out=` rebinds them; returns
    `out`."""
    if isinstance(res, tuple):
        if not isinstance(out, (list, tuple)) or len(out) != len(res):
            raise MXNetError(f"out= must be a list of {len(res)} arrays")
        for o, r in zip(out, res):
            o._assign(r._data)
        return tuple(out)
    out._assign(res._data)
    return out


def make_nd_function(name):
    def fn(*args, **kwargs):
        kwargs.pop("name", None)     # symbol-compat: a no-op in nd
        out = kwargs.pop("out", None)
        res = apply_op(name, *args, **kwargs)
        return res if out is None else write_out(res, out)
    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = get_op(name).__doc__
    return fn
