"""Weight initializers (counterpart of `incubator_mxnet_tpu/initializer.py`).

The same registry and name routing: an Initializer is called with the
parameter name and the tensor to fill, and names ending in
bias/gamma/beta, and BatchNorm's running (moving) mean and variance, go
to their conventional values.  Random draws come
from the framework generator of the tensor's device
(`random.generator`), so `random.seed(n)` reproduces them.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError
from .random import generator

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "LSTMBias", "Bilinear",
           "InitDesc", "register", "create"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(initializer, **kwargs):
    if initializer is None:
        return Uniform()
    if isinstance(initializer, Initializer):
        return initializer
    if isinstance(initializer, str):
        name = initializer.lower()
        name = {"zeros": "zero", "ones": "one"}.get(name, name)
        if name not in _REGISTRY:
            raise MXNetError(f"unknown initializer {initializer!r}")
        return _REGISTRY[name](**kwargs)
    raise MXNetError(f"cannot create initializer from {initializer!r}")


class InitDesc(str):
    """A parameter name that carries init attributes: `attrs["__init__"]`
    names the initializer that fills the parameter whatever the name."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    @torch.no_grad()
    def __call__(self, name, arr):
        """Fill tensor `arr` in place according to the parameter name."""
        if not isinstance(name, str):
            name = str(name)
        init_attr = getattr(name, "attrs", {}).get("__init__", None)
        if init_attr:
            create(init_attr)._init_weight(name, arr)
            return
        lname = name.lower()
        if lname.endswith("weight"):
            self._init_weight(name, arr)
        elif lname.endswith("bias"):
            self._init_bias(name, arr)
        elif lname.endswith("gamma"):
            self._init_one(name, arr)
        elif lname.endswith("beta"):
            self._init_zero(name, arr)
        elif "running_mean" in lname or "moving_mean" in lname:
            self._init_zero(name, arr)
        elif "running_var" in lname or "moving_var" in lname:
            self._init_one(name, arr)
        else:
            self._init_default(name, arr)

    def _init_zero(self, _, arr):
        arr.zero_()

    def _init_one(self, _, arr):
        arr.fill_(1.0)

    def _init_bias(self, _, arr):
        arr.zero_()

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        self._init_weight(name, arr)

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr.zero_()


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr.fill_(1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr.fill_(self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr.uniform_(-self.scale, self.scale, generator=generator(arr.device))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr.normal_(0.0, self.sigma, generator=generator(arr.device))


@register
class Orthogonal(Initializer):
    """A scaled orthonormal basis: the left or right singular vectors of
    a (rows, prod(rest)) draw, uniform in [-1, 1] or standard normal."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        rows = arr.shape[0]
        cols = math.prod(arr.shape[1:])
        gen = generator(arr.device)
        tmp = torch.empty((rows, cols), dtype=torch.float64,
                          device=arr.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _s, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (rows, cols) else v
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Xavier/Glorot."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError(
                f"Xavier requires ndim >= 2 (param {name}, shape {tuple(shape)})")
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("invalid factor_type")
        scale = math.sqrt(self.magnitude / factor)
        gen = generator(arr.device)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=gen)
        elif self.rnd_type == "gaussian":
            arr.normal_(0.0, scale, generator=gen)
        else:
            raise MXNetError("invalid rnd_type")


@register
class MSRAPrelu(Xavier):
    """Xavier gaussian with magnitude 2 / (1 + slope²) (He et al.)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class LSTMBias(Initializer):
    """Zeros, with `forget_bias` on the forget gate's quarter (cuDNN's
    gate order i, f, g, o), whatever the parameter's name."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        arr.zero_()
        n = arr.shape[0] // 4
        arr[n:2 * n] = self.forget_bias

    _init_bias = _init_weight
    _init_default = _init_weight


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a (..., kh, kw) weight."""

    def _init_weight(self, _, arr):
        shape = arr.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = torch.arange(math.prod(shape), dtype=torch.float64)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = (1 - (x / f - c).abs()) * (1 - (y / f - c).abs())
        arr.copy_(weight.to(torch.float32).reshape(shape))
