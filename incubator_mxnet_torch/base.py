"""Foundation utilities: the error type, env-flag config, dtype names.

PyTorch counterpart of `incubator_mxnet_tpu/base.py` (`MXNetError`,
`get_env`).  The port keeps its own copy: it imports nothing of the JAX
package.  Env flags keep the MXNET_* names so scripts and docs carry
over.
"""
from __future__ import annotations

import contextlib
import os

import numpy as _np
import torch
from torch._subclasses.fake_tensor import FakeTensor as _FakeTensor, \
    is_fake as _is_fake

__all__ = ["MXNetError", "get_env", "torch_dtype", "dtype_name",
           "numpy_dtype", "traced", "outside_trace", "string_types",
           "numeric_types", "integer_types", "mx_real_t"]


class MXNetError(RuntimeError):
    """Default error thrown by framework functions."""


# the type tuples MXNet user code tests values against
# (`from mxnet.base import numeric_types`), the JAX package's values
string_types = (str,)
numeric_types = (float, int, _np.generic)
integer_types = (int, _np.integer)

mx_real_t = _np.float32

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off", ""}


def get_env(name, default=None, type_=None):
    """Read an MXNET_*-style environment flag; `type_` coerces the raw
    string (bool understands 1/true/0/false)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    if type_ is bool:
        low = raw.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise MXNetError(f"Cannot parse env {name}={raw!r} as bool")
    if type_ is not None:
        try:
            return type_(raw)
        except ValueError as e:
            raise MXNetError(f"Cannot parse env {name}={raw!r} as {type_}") from e
    return raw


_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool, "int16": torch.int16,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
}


def torch_dtype(dtype):
    """A torch dtype from a name ("bfloat16"), a numpy dtype or type, or
    a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32}


def torch_dtype_32(dtype):
    """`torch_dtype`, with float64, int64 and uint64 as float32, int32
    and uint32: the
    dtype the JAX package stores for a requested one (JAX runs without
    x64)."""
    t = torch_dtype(dtype)
    return _NARROW.get(t, t)


def dtype_name(dtype):
    """The framework's name of a dtype ("bfloat16", "float32", ...)."""
    return str(torch_dtype(dtype)).replace("torch.", "")


def _bfloat16():
    try:
        import ml_dtypes
    except ImportError:
        return torch.bfloat16
    return _np.dtype(ml_dtypes.bfloat16)


_NUMPY_DTYPES = {}


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype, as the JAX package's
    `NDArray.dtype` gives it, so it compares equal to `numpy.float32`
    and to "float32".  bfloat16 is `ml_dtypes`' where that imports;
    without it, numpy has no bfloat16 and `torch.bfloat16` itself is
    returned (`torch_dtype` and `dtype_name` take either)."""
    out = _NUMPY_DTYPES.get(dtype)
    if out is None:
        name = str(dtype).replace("torch.", "")
        out = _NUMPY_DTYPES[dtype] = _bfloat16() if name == "bfloat16" \
            else _np.dtype(name)
    return out


_EAGER_TYPES = (torch.Tensor, torch.nn.Parameter)


def traced(t):
    """True for a tensor of a trace (`torch.export`, `make_fx` with fake
    tensors): it has shapes and dtypes but no storage to read.  A plain
    eager tensor is told apart by its type alone, in two type tests."""
    if isinstance(t, _FakeTensor):
        return True
    return type(t) not in _EAGER_TYPES and isinstance(t, torch.Tensor) \
        and _is_fake(t)


@contextlib.contextmanager
def outside_trace():
    """Run a host computation on real tensors even while a trace is
    recorded (`torch.export`, `make_fx`): the dispatch modes that record
    it are off for the duration, so a Python number computed inside is a
    constant of the trace with the value eager code computes."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        yield
