"""Neural-network ops (counterpart of `incubator_mxnet_tpu/ops/nn.py` and
the `Activation` op of its `ops/math.py`).  Plain torch: the JAX package
leaves these to XLA (convolution and deconvolution to
`lax.conv_general_dilated`, pooling to `lax.reduce_window`), the port
to PyTorch's own operators.
`BatchNorm` keeps the JAX op's arithmetic step by step rather than
`F.batch_norm`'s, whose running variance is the unbiased one.

`sparse_softmax_ce` is the JAX package's fused softmax cross-entropy
with its custom VJP, here a `torch.autograd.Function`: not a registered
op, the fast path of `gluon.loss.SoftmaxCrossEntropyLoss`.
`SoftmaxOutput` keeps the JAX op's custom VJP in another: its backward
is the classifier's loss gradient, not the softmax's Jacobian.
`Convolution_v1`, `Pooling_v1` and `batch_norm` are the legacy names of
`Convolution`, `Pooling` and `BatchNorm`."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register, add_alias
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


def _tuplize(v, n):
    if isinstance(v, int):
        return (v,) * n
    if len(v) == 0:
        return (1,) * n
    return tuple(v)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution")
def convolution(data, weight, bias=None, *, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                layout=None, cudnn_tune=None, cudnn_off=False, workspace=1024):
    """N-d convolution, NC(D)HW data and OIHW weights, symmetric padding.
    The bias is added after the convolution, in the output's dtype, as
    the JAX op adds it."""
    nd = len(kernel)
    if nd not in _CONV:
        raise MXNetError("Convolution supports 1/2/3 spatial dims")
    out = _CONV[nd](data, weight, None, stride=_tuplize(stride or 1, nd),
                    padding=_tuplize(pad or 0, nd),
                    dilation=_tuplize(dilate or 1, nd), groups=num_group)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution")
def deconvolution(data, weight, bias=None, *, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), num_filter=0, num_group=1, no_bias=True,
                  target_shape=(), layout=None, workspace=512,
                  cudnn_tune=None, cudnn_off=False):
    """Transposed convolution with the JAX op's arithmetic: the weight
    is (in, out, *kernel) and is NOT flipped on its spatial axes (the
    JAX op convolves the stride-dilated data with it as it is, where
    upstream MXNet and torch flip it), so this is `conv_transpose` of
    the flipped weight.  Each spatial axis grows to
    (n − 1)·stride − 2·pad + (k − 1)·dilate + 1 + adj; `adj` is solved
    from `target_shape` when it is not given.  The full transposed
    convolution is cut by `pad` below and by pad − adj above (zeros
    where adj passes pad), so any adj works.  The bias is added after,
    in the output's dtype.  `num_group` > 1 raises: the JAX op rejects
    the layer's (in, out // groups, *kernel) weight."""
    nd = len(kernel)
    if nd not in _CONV_T:
        raise MXNetError("Deconvolution supports 1/2/3 spatial dims")
    if num_group != 1:
        raise MXNetError(f"Deconvolution: num_group {num_group} is not "
                         "supported (only 1)")
    stride = _tuplize(stride or 1, nd)
    pad = _tuplize(pad or 0, nd)
    dilate = _tuplize(dilate or 1, nd)
    adj = _tuplize(adj, nd) if adj else None
    if adj is None and target_shape:
        adj = tuple(
            t - ((data.shape[2 + i] - 1) * stride[i] - 2 * pad[i]
                 + (kernel[i] - 1) * dilate[i] + 1)
            for i, t in enumerate(target_shape))
    adj = adj or (0,) * nd
    full = _CONV_T[nd](data, weight.flip(tuple(range(2, 2 + nd))), None,
                       stride=stride, dilation=dilate)
    cut = [x for p, a in reversed(list(zip(pad, adj))) for x in (-p, a - p)]
    out = F.pad(full, cut) if any(cut) else full
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


_POOL = {"max": {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d},
         "avg": {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}}


@register("Pooling")
def pooling(data, *, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, cudnn_off=False, layout=None):
    """max / avg / sum pooling over the spatial axes of NC(D)HW data.

    The JAX op's windows: `pad` on both sides ("valid"), and under
    "full" the upper side grows so the last partial window fits; padded
    cells are -inf for max and 0 for avg and sum.  avg divides by the
    window's size, or with `count_include_pad=False` by the number of
    real cells it covers.  Global pooling is the max, or for every other
    pool_type the mean, over all spatial axes (the JAX op's rule).

    Integer data keeps the JAX op's types: max pads with the type's
    least value and returns the type, sum returns the type, avg and the
    global mean return float32.  torch has no integer avg pooling, so
    integer windows are cut with `unfold` and reduced."""
    nd = data.ndim - 2
    floating = data.is_floating_point()
    if global_pool:
        axes = tuple(range(2, data.ndim))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        return (data if floating else data.float()).mean(dim=axes,
                                                         keepdim=True)
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError(f"unknown pool_type {pool_type}" if pool_type != "lp"
                         else "lp pooling not implemented yet")
    kernel = _tuplize(kernel, nd)
    stride = _tuplize(stride or 1, nd)
    pad = _tuplize(pad or 0, nd)
    pads = []
    for i, (k, s, p) in enumerate(zip(kernel, stride, pad)):
        hi = p
        if pooling_convention == "full":
            size = data.shape[2 + i]
            out_full = -(-(size + 2 * p - k) // s) + 1
            hi = max(p, (out_full - 1) * s + k - size - p)
        pads.append((p, hi))
    flat = [x for lo_hi in reversed(pads) for x in lo_hi]   # F.pad's order
    if not floating:
        return _int_pooling(data, pool_type, kernel, stride, flat,
                            count_include_pad)
    if pool_type == "max":
        x = F.pad(data, flat, value=float("-inf")) if any(flat) else data
        return _POOL["max"][nd](x, kernel, stride)
    x = F.pad(data, flat) if any(flat) else data
    avg = _avg_pool(x, kernel, stride)
    if pool_type == "sum":
        return avg * math.prod(kernel)
    if count_include_pad or not any(flat):
        return avg
    inside = F.pad(torch.ones_like(data), flat)
    return avg / _avg_pool(inside, kernel, stride)


def _avg_pool(x, kernel, stride):
    """torch's `avg_pool3d` has no bfloat16 kernel on the CPU, so 3-D
    bfloat16 windows are averaged in float32 and rounded once, as the
    CUDA kernel does with its float32 accumulator."""
    if x.dtype == torch.bfloat16 and len(kernel) == 3:
        return F.avg_pool3d(x.float(), kernel, stride).to(x.dtype)
    return _POOL["avg"][len(kernel)](x, kernel, stride)


def _int_pooling(data, pool_type, kernel, stride, flat, count_include_pad):
    def windows(x):
        for i, (k, s) in enumerate(zip(kernel, stride)):
            x = x.unfold(2 + i, k, s)
        return x                                # (N, C, *out, *kernel)
    dims = tuple(range(-len(kernel), 0))
    if pool_type == "max":
        low = torch.iinfo(data.dtype).min
        return windows(F.pad(data, flat, value=low)).amax(dim=dims)
    total = windows(F.pad(data, flat)).sum(dim=dims, dtype=data.dtype)
    if pool_type == "sum":
        return total
    if count_include_pad:
        return total.float() / math.prod(kernel)
    return total.float() / windows(F.pad(torch.ones_like(data), flat)) \
        .sum(dim=dims).float()


@register("BatchNorm", needs_mode=True)
def batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False):
    """(out, batch_mean, batch_var) with the JAX op's numerics, not
    `F.batch_norm`'s.  In train mode (`autograd.is_training()`) without
    `use_global_stats` the statistics are the batch's: the mean in
    float32, E[x²] from `data * data` in the data's dtype averaged in
    float32, and the biased variance max(E[x²] − mean², 0); elsewhere
    the moving stats.  scale = gamma·rsqrt(var + eps) and shift =
    beta − mean·scale are rounded to the data's dtype before
    `data * scale + shift`.  The statistics come back in the moving
    stats' dtype; the Gluon layer folds them into its running stats."""
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    red = tuple(i for i in range(data.ndim) if i != axis % data.ndim)
    bshape = [1] * data.ndim
    bshape[axis] = data.shape[axis]
    if autograd.is_training() and not use_global_stats:
        mean = data.mean(dim=red, dtype=torch.float32)
        sq = data.to(torch.float32).square() if data.dtype == torch.float32 \
            else data * data
        var = torch.clamp_min(sq.mean(dim=red, dtype=torch.float32)
                              - mean.square(), 0.0)
    else:
        mean = moving_mean.to(torch.float32)
        var = moving_var.to(torch.float32)
    inv = torch.rsqrt(var + eps)
    g32 = gamma.to(torch.float32)
    scale = (inv * g32).to(data.dtype).reshape(bshape)
    shift = (beta.to(torch.float32) - mean * inv * g32).to(
        data.dtype).reshape(bshape)
    return (data * scale + shift, mean.to(moving_mean.dtype),
            var.to(moving_var.dtype))


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


@register("InstanceNorm")
def instance_norm(data, gamma, beta, *, eps=1e-3):
    """Each sample and channel normalized over its spatial axes, in the
    data's dtype: (x − mean)·rsqrt(var + eps)·gamma + beta, the variance
    the biased one (the JAX op)."""
    axes = tuple(range(2, data.ndim))
    mean = data.mean(dim=axes, keepdim=True)
    var = data.var(dim=axes, keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (data.ndim - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register("Dropout", needs_rng=True, needs_mode=True)
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


def _floating(data):
    """Integer and bool data as float32 (the softmaxes' `jax.nn` rule)."""
    return data if data.is_floating_point() else data.to(torch.float32)


@register("softmax")
def softmax(data, length=None, *, axis=-1, temperature=None, dtype=None,
            use_length=False):
    """Softmax over `axis`; with `length` only the first length[i]
    entries of each row count and the rest are 0.  Integer data gives
    float32, as `jax.nn.softmax` does."""
    data = _floating(data)
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
    data = _floating(data)
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


@register("GroupNorm")
def group_norm(data, gamma, beta, *, num_groups=1, eps=1e-5):
    """Channels in `num_groups` groups, each sample's group normalized
    over its channels and spatial axes in the data's dtype (the biased
    variance), then the per-channel gamma and beta."""
    n, c = data.shape[:2]
    rest = tuple(data.shape[2:])
    x = data.reshape((n, num_groups, c // num_groups) + rest)
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, correction=0)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    shape = (1, -1) + (1,) * (data.ndim - 2)
    return x * gamma.reshape(shape) + beta.reshape(shape)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """The summed −log softmax(data)[label] over the rows, a 0-d array."""
    logp = torch.log_softmax(data, dim=-1)
    lab = label.detach().to(torch.int64).unsqueeze(-1)
    return -logp.gather(-1, lab).sum()


class _SoftmaxOutput(torch.autograd.Function):
    """Forward softmax over axis 1 (`multi_output`) or the last; backward
    (p − onehot(label))·scale for the data, ignoring the incoming
    gradient (the JAX op's `_so_bwd`), and zeros for the label."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                multi_output, normalization, smooth_alpha):
        axis = 1 if multi_output else -1
        out = torch.softmax(data, dim=axis)
        ctx.save_for_backward(out, label)
        ctx.attrs = (grad_scale, ignore_label, use_ignore, multi_output,
                     normalization, smooth_alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        (grad_scale, ignore_label, use_ignore, multi_output, normalization,
         smooth_alpha) = ctx.attrs
        axis = 1 if multi_output else out.ndim - 1
        depth = out.shape[axis]
        lab = label.to(torch.int32)
        ar = torch.arange(depth, device=out.device).reshape(
            (depth,) + (1,) * (out.ndim - 1 - axis))
        onehot = (lab.unsqueeze(axis) == ar).to(out.dtype)
        if smooth_alpha:
            onehot = onehot * (1 - smooth_alpha) + smooth_alpha / depth
        grad = out - onehot
        keep = lab != int(ignore_label)
        if use_ignore:
            grad = grad * keep.to(out.dtype).unsqueeze(axis)
        scale = grad_scale
        if normalization == "batch":
            scale = scale / out.shape[0]
        elif normalization == "valid" and use_ignore:
            scale = scale / torch.clamp_min(keep.sum(), 1)
        return (grad * scale, torch.zeros_like(label)) + (None,) * 6


@register("SoftmaxOutput", aliases=("softmax_output", "Softmax"))
def softmax_output(data, label, *, grad_scale=1.0, ignore_label=-1.0,
                   use_ignore=False, multi_output=False, preserve_shape=False,
                   normalization="null", smooth_alpha=0.0, out_grad=False):
    """Forward softmax; backward the fused classifier gradient p −
    onehot(label) (label smoothing by `smooth_alpha`), rows whose label
    is `ignore_label` dropped under `use_ignore`, times `grad_scale`,
    over the batch size ("batch") or the count of kept labels ("valid"
    with `use_ignore`).  `preserve_shape` and `out_grad` are taken and
    not used, as in the JAX op."""
    return _SoftmaxOutput.apply(data, label, grad_scale, ignore_label,
                                use_ignore, multi_output, normalization,
                                smooth_alpha)


@register("L2Normalization")
def l2_normalization(data, *, eps=1e-10, mode="instance"):
    """data / sqrt(sum(data²) + eps) over all axes but the batch
    ("instance"), over axis 1 ("channel"), or over the spatial axes
    (any other mode)."""
    if mode == "instance":
        axes = tuple(range(1, data.ndim))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, data.ndim))
    return data / torch.sqrt(data.square().sum(dim=axes, keepdim=True) + eps)


@register("RMSNorm")
def rms_norm(data, gamma, *, axis=-1, eps=1e-6):
    """x·rsqrt(mean(x²) + eps) in float32, rounded to the data's dtype,
    times gamma."""
    x32 = data.to(torch.float32)
    ms = x32.square().mean(dim=axis, keepdim=True)
    shape = [1] * data.ndim
    shape[axis] = data.shape[axis]
    return (x32 * torch.rsqrt(ms + eps)).to(data.dtype) * gamma.reshape(shape)


add_alias("Convolution_v1", "Convolution")
add_alias("Pooling_v1", "Pooling")
add_alias("batch_norm", "BatchNorm")
