"""Foundation utilities: the error type, env-flag config, dtype names.

PyTorch counterpart of `incubator_mxnet_tpu/base.py` (`MXNetError`,
`get_env`).  The port keeps its own copy: it imports nothing of the JAX
package.  Env flags keep the MXNET_* names so scripts and docs carry
over.
"""
from __future__ import annotations

import os

import numpy as _np
import torch

__all__ = ["MXNetError", "get_env", "torch_dtype", "dtype_name",
           "numpy_dtype"]


class MXNetError(RuntimeError):
    """Default error thrown by framework functions."""


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
    "int64": torch.int64, "bool": torch.bool,
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


_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def torch_dtype_32(dtype):
    """`torch_dtype`, with float64 and int64 as float32 and int32: the
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
