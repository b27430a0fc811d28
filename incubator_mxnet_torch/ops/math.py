"""Elementwise, broadcast and scalar ops (counterpart of
`incubator_mxnet_tpu/ops/math.py`): the broadcast binary table and its
aliases, the comparisons and logical ops (1s and 0s in the left
operand's dtype), the scalar table (the scalar cast to the data's dtype
first, as `jnp.asarray(scalar, data.dtype)` casts it, so int32 + 0.5
stays int32) and its comparisons (the scalar as it is), the unary table
with its integer-preserving part, relu, softrelu, LeakyReLU, clip,
where, cast, and `_index`/`_fancy_index`, the registered forms behind
`NDArray.__getitem__`."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register
from .reduce import norm  # noqa: F401  (reached as ops.math.norm too)
from ..base import MXNetError, torch_dtype_32


# ----------------------------------------------------------------- unary ----
def _abs(x):
    """`jnp.abs`, whose gradient at 0 is 1 (torch's is 0): the branch
    x >= 0 keeps x; + 0.0 turns its -0.0 into 0.0."""
    if x.dtype == torch.bool:
        return x.clone()
    if not x.is_floating_point():
        return torch.abs(x)
    return torch.where(x >= 0, x, -x) + 0.0


# the JAX op's functions: dtypes follow torch's promotion, which for
# these is jnp's (integer data to float32 for the transcendental ones)
_UNARY = {
    "negative": torch.neg,
    "abs": _abs,
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


@register("softrelu")
def softrelu(data):
    return F.softplus(data)


@register("cast", aliases=("Cast",))
def cast(data, *, dtype):
    """`data.astype(dtype)` as `jnp` casts: float64 and int64 are
    float32 and int32, and a float cast to an integer type saturates at
    the type's bounds with NaN as 0 (torch's wraps)."""
    dt = torch_dtype_32(dtype)
    if data.is_floating_point() and not dt.is_floating_point \
            and dt != torch.bool:
        info = torch.iinfo(dt)
        x = data.detach().to(torch.float64)    # holds every int32 bound
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
        return x.clamp(info.min, info.max).to(dt)
    return data.to(dt)


# ---------------------------------------------------------------- binary ----
def _operand(x, like):
    """A Python number as a 0-d tensor on `like`'s device, which takes
    part in type promotion as a weak scalar, as `jnp` takes it."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=like.device)


def _mod(a, b):
    """`jnp.remainder`: Python's sign rule, and an integer remainder by
    0 is 0 (torch's raises on the CPU)."""
    if a.is_floating_point() or b.is_floating_point():
        return torch.remainder(a, b)
    zero = b == 0
    r = torch.remainder(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros_like(r), r)


def _hypot(a, b):
    """`jnp.hypot`: integer operands give float32."""
    if not a.is_floating_point():
        a = a.to(torch.float32)
    if not b.is_floating_point():
        b = b.to(torch.float32)
    return torch.hypot(a, b)


_BINARY = {
    "broadcast_add": (torch.add, ("elemwise_add", "_plus", "add")),
    "broadcast_sub": (torch.sub, ("elemwise_sub", "_minus", "subtract")),
    "broadcast_mul": (torch.mul, ("elemwise_mul", "_mul", "multiply")),
    "broadcast_div": (torch.div, ("elemwise_div", "_div", "divide")),
    "broadcast_power": (torch.pow, ("_power", "power", "pow")),
    # Python's sign rule, as `jnp.mod`
    "broadcast_mod": (_mod, ("_mod", "mod")),
    "broadcast_maximum": (torch.maximum, ("maximum",)),
    "broadcast_minimum": (torch.minimum, ("minimum",)),
    "broadcast_hypot": (_hypot, ()),
}


def _make_binary(name, fn):
    def impl(lhs, rhs):
        return fn(lhs, _operand(rhs, lhs))
    impl.__name__ = impl.__qualname__ = name
    return impl


for _name, (_fn, _aliases) in _BINARY.items():
    register(_name, aliases=_aliases)(_make_binary(_name, _fn))

_CMP = {
    "broadcast_equal": torch.eq,
    "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt,
    "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt,
    "broadcast_lesser_equal": torch.le,
    "broadcast_logical_and": torch.logical_and,
    "broadcast_logical_or": torch.logical_or,
    "broadcast_logical_xor": torch.logical_xor,
}


def _make_cmp(name, fn):
    def impl(lhs, rhs):
        return fn(lhs.detach(), _operand(rhs, lhs).detach()).to(lhs.dtype)
    impl.__name__ = impl.__qualname__ = name
    return impl


for _name, _fn in _CMP.items():
    register(_name, aliases=(_name.replace("broadcast_", ""),))(
        _make_cmp(_name, _fn))


# ---------------------------------------------------------------- scalar ----
def scalar_of(value, dtype):
    """Python scalar `value` cast to tensor dtype `dtype` as
    `jnp.asarray(value, dtype)` casts it: towards zero for integers,
    rounded to the nearest value of a float type."""
    if dtype == torch.bool:
        return bool(value)
    if not dtype.is_floating_point:
        return int(value)
    if dtype == torch.float64:
        return float(value)
    return torch.tensor(float(value), dtype=dtype).item()


_SCALAR = {
    "_scalar_add": (torch.add, lambda s, x: x + s, ("_plus_scalar",)),
    "_scalar_sub": (torch.sub, lambda s, x: s - x, ("_minus_scalar",)),
    "_scalar_mul": (torch.mul, lambda s, x: x * s, ("_mul_scalar",)),
    "_scalar_div": (torch.div, lambda s, x: s / x, ("_div_scalar",)),
    "_scalar_power": (torch.pow, torch.pow, ("_power_scalar",)),
    "_scalar_mod": (lambda x, s: _mod(x, _operand(s, x)),
                    lambda s, x: _mod(_operand(s, x), x), ("_mod_scalar",)),
    "_scalar_maximum": (torch.clamp_min, lambda s, x: torch.clamp_min(x, s),
                        ("_maximum_scalar",)),
    "_scalar_minimum": (torch.clamp_max, lambda s, x: torch.clamp_max(x, s),
                        ("_minimum_scalar",)),
}


def _make_scalar(name, fn, rfn):
    def impl(data, *, scalar, reverse=False):
        s = scalar_of(scalar, data.dtype)
        return rfn(s, data) if reverse else fn(data, s)
    impl.__name__ = impl.__qualname__ = name
    return impl


for _name, (_fn, _rfn, _aliases) in _SCALAR.items():
    register(_name, aliases=_aliases)(_make_scalar(_name, _fn, _rfn))

# the comparisons take the scalar as it is (int32 == 1.5 is 0), and the
# reversed form s OP x is x OP' s
_SCALAR_CMP = {
    "_scalar_equal": (torch.eq, torch.eq),
    "_scalar_not_equal": (torch.ne, torch.ne),
    "_scalar_greater": (torch.gt, torch.lt),
    "_scalar_greater_equal": (torch.ge, torch.le),
    "_scalar_lesser": (torch.lt, torch.gt),
    "_scalar_lesser_equal": (torch.le, torch.ge),
}


def _make_scalar_cmp(name, fn, rfn):
    def impl(data, *, scalar, reverse=False):
        x = data.detach()
        return (rfn(x, scalar) if reverse else fn(x, scalar)).to(data.dtype)
    impl.__name__ = impl.__qualname__ = name
    return impl


for _name, (_fn, _rfn) in _SCALAR_CMP.items():
    register(_name)(_make_scalar_cmp(_name, _fn, _rfn))


# ---------------------------------------------------------------- index ----
def _indexed(data, key_spec, arrays):
    from ..ndarray.ndarray import rebuild_index, torch_index, clamp_index
    arrays = [a if a.dtype == torch.bool else a.to(torch.int64)
              for a in arrays]
    flips, key = torch_index(
        clamp_index(rebuild_index(key_spec, arrays), data.shape), data.shape)
    return (data.flip(flips) if flips else data)[key]


@register("_fancy_index")
def _fancy_index(data, *arrays, key_spec):
    """data[key]: `key_spec` is `NDArray.__getitem__`'s encoding of the
    key, with ("__arr__", i) for the i-th index array of `arrays`.  An
    integer index past an end reads the nearest row (`clamp_index`)."""
    return _indexed(data, key_spec, arrays)


@register("_index")
def _index(data, *, key_spec):
    """data[key] for a key with no index array."""
    return _indexed(data, key_spec, ())
