"""`nd` namespace: NDArray, its creation functions and one function per
registered op (this module is the `F` of `HybridBlock.hybrid_forward`),
with the `nd.random` and `nd.contrib` sub-namespaces, `nd.sparse` and
the DLPack functions, as the JAX package's `nd`."""
import sys as _sys
import types as _types

import torch as _torch

from .ndarray import (NDArray, array, zeros, ones, full, empty, arange,
                      linspace, eye, zeros_like, ones_like, from_numpy,
                      waitall, save, load, load_tensors, to_numpy)
from .. import ops as _ops
from . import sparse
from .sparse import (BaseSparseNDArray, RowSparseNDArray,  # noqa: F401
                     CSRNDArray)
from ..ops import registry as _registry
from ..random import seed as _seed

_this = _sys.modules[__name__]
for _name in _registry.list_ops():
    if not hasattr(_this, _name):
        setattr(_this, _name, _registry.make_nd_function(_name))

# nd.contrib: every _contrib_* op under its public name
contrib = _types.ModuleType(__name__ + ".contrib")
for _name in _registry.list_ops():
    if _name.startswith("_contrib_"):
        setattr(contrib, _name[len("_contrib_"):], getattr(_this, _name))
_sys.modules[contrib.__name__] = contrib



def _install_control_flow():
    """Put `foreach`, `while_loop` and `cond` in `nd.contrib` (called by
    the package once `contrib` is imported: its module imports NDArray
    from here)."""
    from ..contrib.control_flow import foreach, while_loop, cond
    contrib.foreach = foreach
    contrib.while_loop = while_loop
    contrib.cond = cond


# nd.random: the sampling ops with `ctx=` and `out=`, positional
# parameters in MXNet's order, and the framework seed
random = _types.ModuleType(__name__ + ".random")
_POSITIONAL = {"_random_uniform": ("low", "high"),
               "_random_normal": ("loc", "scale"),
               "_random_gamma": ("alpha", "beta"),
               "_random_randint": ("low", "high"),
               "_random_poisson": ("lam",),
               "_random_exponential": ("lam",),
               "_sample_bernoulli": ("p",)}


def _rand_fn(op_name, public):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        for n, v in zip(_POSITIONAL[op_name], args):
            kwargs.setdefault(n, v)
        res = _registry.apply_op(op_name, **kwargs)
        return res if out is None else _registry.write_out(res, out)
    fn.__name__ = fn.__qualname__ = public
    fn.__doc__ = _registry.get_op(op_name).__doc__
    return fn


for _opn, _pub in [("_random_uniform", "uniform"),
                   ("_random_normal", "normal"), ("_random_gamma", "gamma"),
                   ("_random_exponential", "exponential"),
                   ("_random_poisson", "poisson"),
                   ("_random_randint", "randint"),
                   ("_sample_bernoulli", "bernoulli")]:
    setattr(random, _pub, _rand_fn(_opn, _pub))


def _randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None, **kw):
    return random.normal(loc, scale, shape=tuple(shape), dtype=dtype,
                         ctx=ctx, **kw)


random.randn = _randn
random.multinomial = _this.sample_multinomial
random.shuffle = _this.shuffle
random.seed = _seed
_sys.modules[random.__name__] = random


def Custom(*inputs, op_type, **kwargs):
    """Run registered custom op `op_type` (MXNet's `mx.nd.Custom`; see
    `operator.Custom`)."""
    from ..operator import Custom as _custom
    return _custom(*inputs, op_type=op_type, **kwargs)


def from_dlpack(obj):
    """An NDArray over a DLPack producer's memory (a tensor with
    `__dlpack__`, or a capsule), with no copy."""
    return NDArray(_torch.utils.dlpack.from_dlpack(obj))


def to_dlpack_for_read(arr):
    return arr.to_dlpack_for_read()


def to_dlpack_for_write(arr):
    return arr.to_dlpack_for_write()
