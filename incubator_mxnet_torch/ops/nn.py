"""Neural-network ops (counterpart of `incubator_mxnet_tpu/ops/nn.py` and
the `Activation` op of its `ops/math.py`).  Plain torch: the JAX package
leaves these to XLA, the port to PyTorch's own operators.

`sparse_softmax_ce` is the JAX package's fused softmax cross-entropy
with its custom VJP, here a `torch.autograd.Function`: not a registered
op, the fast path of `gluon.loss.SoftmaxCrossEntropyLoss`."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register
from .. import autograd
from ..base import MXNetError
from ..random import generator


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, *, num_hidden=0, no_bias=False,
                    flatten=True):
    """`data @ weight.T + bias`; the weight is (units, in_units), as in
    the JAX package."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


@register("LayerNorm")
def layer_norm(data, gamma, beta, *, axis=-1, eps=1e-5, output_mean_var=False):
    """Two-pass float32 statistics, the JAX op's CPU/oracle branch."""
    shape = [1] * data.ndim
    shape[axis] = data.shape[axis]
    x32 = data.to(torch.float32)
    mean = x32.mean(dim=axis, keepdim=True)
    var = x32.var(dim=axis, keepdim=True, unbiased=False)
    out = ((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
    return out * gamma.reshape(shape) + beta.reshape(shape)


@register("Dropout")
def dropout(data, *, p=0.5, mode="training", axes=(), cudnn_off=False):
    """In train mode (`autograd.is_training()`, or `mode="always"`) each
    element is kept with probability 1 - p and scaled by 1 / (1 - p);
    `axes` share one draw along those axes.  Elsewhere the identity.  The
    draws come from the framework generator of the data's device, so
    they are not the JAX package's bits."""
    if not (mode == "always" or autograd.is_training()) or p <= 0:
        return data
    keep = 1.0 - p
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    draw = torch.rand(shape, generator=generator(data.device),
                      device=data.device)
    return data * (draw < keep).to(data.dtype) / keep


@register("softmax")
def softmax(data, length=None, *, axis=-1, temperature=None, dtype=None,
            use_length=False):
    x = data if temperature in (None, 1.0) else data / temperature
    if length is not None:
        idx = torch.arange(x.shape[axis], device=x.device)
        bshape = [1] * x.ndim
        bshape[axis] = x.shape[axis]
        mask = idx.reshape(bshape) < length.to(torch.int64).unsqueeze(axis)
        x = x.masked_fill(~mask, float("-inf"))
    out = torch.softmax(x, dim=axis)
    if length is not None:
        out = out.masked_fill(~mask, 0.0)
    return out.to(_dtype(dtype)) if dtype else out


@register("log_softmax")
def log_softmax(data, *, axis=-1, temperature=None, dtype=None):
    x = data if temperature in (None, 1.0) else data / temperature
    out = torch.log_softmax(x, dim=axis)
    return out.to(_dtype(dtype)) if dtype else out


def _dtype(dtype):
    from ..base import torch_dtype
    return torch_dtype(dtype)


class _SparseSoftmaxCE(torch.autograd.Function):
    """Forward lse − x[label] in float32, saving (x, label, lse); backward
    (softmax(x) − onehot(label))·g, cast to x's dtype — the JAX package's
    `_sparse_ce_fwd` / `_sparse_ce_bwd`."""

    @staticmethod
    def forward(ctx, x, lab):
        m = x.amax(dim=-1)
        s = torch.exp((x - m.unsqueeze(-1)).to(torch.float32)).sum(dim=-1)
        lse = m.to(torch.float32) + torch.log(s)
        picked = x.gather(-1, lab.unsqueeze(-1)).squeeze(-1)
        ctx.save_for_backward(x, lab, lse)
        return lse - picked.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, lab, lse = ctx.saved_tensors
        p = torch.exp(x.to(torch.float32) - lse.unsqueeze(-1))
        onehot = torch.arange(x.shape[-1], device=x.device) == \
            lab.unsqueeze(-1)
        return ((p - onehot.to(torch.float32)) * g.unsqueeze(-1)).to(
            x.dtype), None


def sparse_softmax_ce(x, label):
    """Per-row −log softmax(x)[label] over the last axis, in float32.
    `label` may be float (the MXNet convention) or int; labels outside
    [0, C − 1] clamp to it, so forward and backward agree for them."""
    lab = label.to(torch.int64).clamp(0, x.shape[-1] - 1)
    return _SparseSoftmaxCE.apply(x, lab)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}


@register("Activation")
def activation(data, *, act_type="relu"):
    try:
        return _ACTIVATIONS[act_type](data)
    except KeyError:
        raise MXNetError(f"unknown act_type {act_type!r}") from None
