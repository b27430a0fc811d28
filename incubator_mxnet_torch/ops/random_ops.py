"""Sampling ops (counterpart of `incubator_mxnet_tpu/ops/random_ops.py`).

Every draw comes from the framework generator of the device it lands on
(`random.generator`), so `seed(n)` makes a stream repeat.  The streams
are not the JAX package's threefry bits: they are held to it by
distribution and by seed determinism.  Ops without an array input take
`ctx` (default: the current context) for their device; each honours
`shape` and `dtype`.  Samples are drawn in float32 and cast, so a
bfloat16 uniform may round up to `high`.
"""
from __future__ import annotations

import torch

from .registry import register
from ..base import torch_dtype_32
from ..context import as_device
from ..random import generator

_F32 = torch.float32


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _place(ctx):
    dev = as_device(ctx)
    return dev, generator(dev)


@register("_random_uniform", aliases=("random_uniform", "uniform"))
def random_uniform(*, low=0.0, high=1.0, shape=(), dtype="float32",
                   ctx=None):
    dev, gen = _place(ctx)
    u = torch.rand(_shape(shape), generator=gen, device=dev, dtype=_F32)
    return (low + (high - low) * u).to(torch_dtype_32(dtype))


@register("_random_normal", aliases=("random_normal", "normal", "randn"))
def random_normal(*, loc=0.0, scale=1.0, shape=(), dtype="float32",
                  ctx=None):
    dev, gen = _place(ctx)
    z = torch.randn(_shape(shape), generator=gen, device=dev, dtype=_F32)
    return (loc + scale * z).to(torch_dtype_32(dtype))


@register("_random_gamma", aliases=("random_gamma",))
def random_gamma(*, alpha=1.0, beta=1.0, shape=(), dtype="float32",
                 ctx=None):
    """Gamma(alpha) scaled by `beta`."""
    dev, gen = _place(ctx)
    a = torch.full(_shape(shape), float(alpha), device=dev, dtype=_F32)
    return (beta * torch._standard_gamma(a, generator=gen)).to(
        torch_dtype_32(dtype))


@register("_random_exponential", aliases=("random_exponential",))
def random_exponential(*, lam=1.0, shape=(), dtype="float32", ctx=None):
    dev, gen = _place(ctx)
    e = torch.empty(_shape(shape), device=dev, dtype=_F32).exponential_(
        generator=gen)
    return (e / lam).to(torch_dtype_32(dtype))


@register("_random_poisson", aliases=("random_poisson",))
def random_poisson(*, lam=1.0, shape=(), dtype="float32", ctx=None):
    dev, gen = _place(ctx)
    rate = torch.full(_shape(shape), float(lam), device=dev, dtype=_F32)
    return torch.poisson(rate, generator=gen).to(torch_dtype_32(dtype))


@register("_random_randint", aliases=("random_randint", "randint"))
def random_randint(*, low=0, high=1, shape=(), dtype="int32", ctx=None):
    """Integers uniform in [low, high)."""
    dev, gen = _place(ctx)
    return torch.randint(int(low), int(high), _shape(shape), generator=gen,
                         device=dev, dtype=torch_dtype_32(dtype))


@register("_sample_multinomial", aliases=("sample_multinomial",))
def sample_multinomial(data, *, shape=(), get_prob=False, dtype="int32"):
    """Class ids drawn from the distributions in the last axis of `data`
    (weights max(p, 1e-30), as the JAX op's logits log(max(p, 1e-30))):
    `shape` draws per distribution, after the batch axes; one draw and no
    extra axis for `shape=()`.  `get_prob` is taken and, as in the JAX
    op, not used."""
    extra = _shape(shape) if shape else ()
    n = 1
    for s in extra:
        n *= s if s else 1
    p = data.detach().to(_F32).clamp_min(1e-30)
    rows = p.reshape(-1, p.shape[-1])
    draws = torch.multinomial(rows, n, replacement=True,
                              generator=generator(data.device))
    out = draws.reshape(tuple(data.shape[:-1]) + (extra or ()))
    return out.to(torch_dtype_32(dtype))


@register("_shuffle", aliases=("shuffle",))
def shuffle(data):
    """The rows of `data` (axis 0) in a random order."""
    perm = torch.randperm(data.shape[0], generator=generator(data.device),
                          device=data.device)
    return data.detach()[perm]


@register("_sample_bernoulli")
def sample_bernoulli(*, p=0.5, shape=(), dtype="float32", ctx=None):
    dev, gen = _place(ctx)
    u = torch.rand(_shape(shape), generator=gen, device=dev, dtype=_F32)
    return (u < p).to(torch_dtype_32(dtype))
