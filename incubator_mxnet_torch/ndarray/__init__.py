"""`nd` namespace: NDArray, its creation functions and one function per
registered op (this module is the `F` of `HybridBlock.hybrid_forward`)."""
import sys as _sys

from .ndarray import (NDArray, array, zeros, zeros_like, ones_like,
                      save, load, load_tensors, to_numpy)
from .. import ops as _ops
from . import sparse
from ..ops import registry as _registry

_this = _sys.modules[__name__]
for _name in _registry.list_ops():
    if not hasattr(_this, _name):
        setattr(_this, _name, _registry.make_nd_function(_name))


def Custom(*inputs, op_type, **kwargs):
    """Run registered custom op `op_type` (MXNet's `mx.nd.Custom`; see
    `operator.Custom`)."""
    from ..operator import Custom as _custom
    return _custom(*inputs, op_type=op_type, **kwargs)
