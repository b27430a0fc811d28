"""Elementwise and reduction ops (counterpart of part of
`incubator_mxnet_tpu/ops/math.py` and `ops/reduce.py`): the unary table
with its integer-preserving part, relu, LeakyReLU, clip, where,
broadcast_mul, and the mean, sum and norm reductions."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register
from ..base import MXNetError


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


# ----------------------------------------------------------------- unary ----
# the JAX op's functions: dtypes follow torch's promotion, which for
# these is jnp's (integer data to float32 for the transcendental ones)
_UNARY = {
    "negative": torch.neg,
    "abs": lambda x: x.clone() if x.dtype == torch.bool else torch.abs(x),
    "sign": torch.sign,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0),
    "square": torch.square,
    "reciprocal": torch.reciprocal,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "erf": torch.special.erf,
    "erfinv": torch.special.erfinv,
    # exp(log|Γ(x)|), the JAX op's definition: |Γ(x)| for x < 0
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
    # x + 0: bool becomes an integer, as in jnp (int32 there)
    "_copy": lambda x: x.to(torch.int32) if x.dtype == torch.bool
    else x.clone(),
    "identity": lambda x: x,
}

# integer data keeps its dtype (rint's becomes float32, as in jnp);
# isnan and isinf give float32, logical_not the data's dtype.  No
# gradient flows through these.
_UNARY_INT = {
    "round": torch.round,
    "rint": lambda x: torch.round(x if x.is_floating_point()
                                  else x.to(torch.float32)),
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "logical_not": lambda x: torch.logical_not(x).to(x.dtype),
    "isnan": lambda x: torch.isnan(x).to(torch.float32),
    "isinf": lambda x: torch.isinf(x).to(torch.float32),
}


def _make_unary(name, fn, differentiable):
    def impl(data):
        return fn(data) if differentiable else fn(data.detach())
    impl.__name__ = impl.__qualname__ = name
    return impl


for _name, _fn in _UNARY.items():
    register(_name)(_make_unary(_name, _fn, True))
for _name, _fn in _UNARY_INT.items():
    register(_name)(_make_unary(_name, _fn, False))


@register("relu")
def relu(data):
    return torch.relu(data)


# SELU's constants, as the JAX op has them
_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU")
def leaky_relu(data, gamma=None, *, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """leaky: x or slope·x; prelu: x or gamma·x, a 1-d gamma over the
    channel axis 1; elu: x or slope·expm1(x); selu: scale·(x or
    alpha·expm1(x)); gelu: the exact (erf) form.  `lower_bound` and
    `upper_bound` (rrelu's) are taken and ignored, as in the JAX op."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) \
            if gamma.ndim == 1 else gamma
        return torch.where(data >= 0, data, g * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(
            data >= 0, data, _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    raise MXNetError(f"unknown LeakyReLU act_type {act_type!r}")


@register("clip")
def clip(data, *, a_min=None, a_max=None):
    """`data` clamped to [a_min, a_max]; a bound of None is open, and
    with both open the data comes back as it is (`jnp.clip`)."""
    if a_min is None and a_max is None:
        return data
    return torch.clamp(data, a_min, a_max)


@register("where")
def where(condition, x, y):
    return torch.where(condition.to(torch.bool), x, y)


@register("broadcast_mul")
def broadcast_mul(lhs, rhs):
    return lhs * rhs
