"""The long tail of the op surface (counterpart of
`incubator_mxnet_tpu/ops/extended.py`): LRN, SoftmaxActivation,
softmin, moments, SVMOutput, ROIPooling, Crop, space_to_depth /
depth_to_space, im2col / col2im, broadcast_like, batch_take,
fill_element_0index, khatri_rao, allclose, boolean_mask, amp_cast /
amp_multicast, fft / ifft, Correlation, DeformableConvolution, the SSD
ops (MultiBoxPrior, MultiBoxTarget, MultiBoxDetection), greedy
bipartite matching, the multi-tensor and multi-precision SGD updates
and div_sqrt_dim.

Each op keeps the JAX op's name, aliases, attributes, defaults and
formulas, also where they are not upstream MXNet's: ROIPooling takes the
max over a fixed 4 x 4 nearest-sample grid of each bin, MultiBoxDetection
ignores `nms_topk`, Correlation takes only kernel_size=1, stride1=1 and
pad_size == max_displacement, fft interleaves [re, im] along the last
axis in float32 and ignores `compute_size`.  An op the JAX package
registers `differentiable=False` takes its inputs detached.

The greedy NMS of MultiBoxDetection (a `fori_loop` with one step per box
there) runs here as `greedy_nms`: blocks of boxes in score order, each
block settled by a fixed-point sweep and then applied to every later
box at once, so a batch of 8,732 anchors takes tens of steps, not
8,732, and never builds the (A, A) IoU matrix.  The result is the same
boolean function of the same IoUs.
"""
from __future__ import annotations

import itertools
import math

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype_32
from .registry import register


# ---------------------------------------------------------------- nn ------

@register("LRN", aliases=("lrn",))
def lrn(data, *, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Across-channel local response normalization: the sum of squares
    over a window of `nsize` channels, zero padded."""
    sq = torch.square(data)
    pad = nsize // 2
    sqp = F.pad(sq, (0, 0, 0, 0, pad, pad))
    n_out = sqp.shape[1] - nsize + 1
    sums = sqp[:, 0:n_out]
    for i in range(1, nsize):
        sums = sums + sqp[:, i:i + n_out]
    return data * torch.pow(knorm + alpha / nsize * sums, -beta)


@register("SoftmaxActivation")
def softmax_activation(data, *, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


@register("softmin")
def softmin(data, *, axis=-1, temperature=None, dtype=None):
    x = -data if temperature in (None, 1.0) else -data / temperature
    out = torch.softmax(x, dim=axis)
    return out.to(torch_dtype_32(dtype)) if dtype else out


@register("moments")
def moments(data, *, axes=None, keepdims=False):
    """(mean, population variance) over `axes` (all when None)."""
    dims = tuple(axes) if axes is not None else tuple(range(data.ndim))
    mean = torch.mean(data, dim=dims, keepdim=bool(keepdims))
    var = torch.var(data, dim=dims, unbiased=False, keepdim=bool(keepdims))
    return mean, var


def _svm_grad(data, label, margin, reg_coef, use_linear):
    c = data.shape[1]
    hot = label.to(torch.int64).unsqueeze(-1) == torch.arange(
        c, device=data.device)
    y = torch.where(hot, 1.0, -1.0).to(data.dtype)
    viol = (margin - y * data) > 0
    if use_linear:
        g = torch.where(viol, -y * reg_coef, torch.zeros_like(data))
    else:
        g = torch.where(viol, -2.0 * (margin - y * data) * y * reg_coef,
                        torch.zeros_like(data))
    return g.to(data.dtype)


class _SVMOutput(torch.autograd.Function):
    """Identity forward; the backward is the one-vs-all hinge gradient,
    whatever the cotangent (the JAX op's custom VJP)."""

    @staticmethod
    def forward(ctx, data, label, margin, reg_coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.attrs = (margin, reg_coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        return (_svm_grad(data, label, *ctx.attrs), None, None, None, None)


@register("SVMOutput")
def svm_output(data, label, *, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Forward = identity; backward = one-vs-all hinge gradient."""
    return _SVMOutput.apply(data, label.detach(), float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


def _image_index(b, n):
    """Float batch ids as the JAX gathers read them: truncated, negative
    ones counted from the end, then clamped."""
    b = b.to(torch.int64)
    return torch.where(b < 0, b + n, b).clamp(0, n - 1)


@register("ROIPooling", aliases=("roi_pooling",))
def roi_pooling(data, rois, *, pooled_size, spatial_scale=1.0):
    """Max of each ROI bin over a fixed 4 x 4 nearest-neighbour sample
    grid (exact when bins are at most 4 px), as the JAX op defines it."""
    ph, pw = (pooled_size if isinstance(pooled_size, (tuple, list))
              else (pooled_size, pooled_size))
    ns = 4
    N, C, H, W = data.shape
    dev = data.device
    rois = rois.detach()
    r = rois.shape[0]
    b = _image_index(rois[:, 0], N).view(r, 1, 1, 1, 1)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale)
                      .view(r, 1, 1, 1, 1) for i in range(1, 5))
    rh = torch.clamp_min(y2 - y1 + 1.0, 1.0)
    rw = torch.clamp_min(x2 - x1 + 1.0, 1.0)
    bh, bw = rh / ph, rw / pw
    iy = torch.arange(ph, device=dev).view(1, ph, 1, 1, 1)
    ix = torch.arange(pw, device=dev).view(1, 1, pw, 1, 1)
    sy = torch.arange(ns, device=dev).view(1, 1, 1, ns, 1)
    sx = torch.arange(ns, device=dev).view(1, 1, 1, 1, ns)
    yy = y1 + iy * bh + (sy + 0.5) * bh / ns - 0.5
    xx = x1 + ix * bw + (sx + 0.5) * bw / ns - 0.5
    yy = torch.clamp(torch.round(yy), 0, H - 1).to(torch.int64)
    xx = torch.clamp(torch.round(xx), 0, W - 1).to(torch.int64)
    vals = data[b, :, yy, xx]                     # (R, ph, pw, ns, ns, C)
    return torch.amax(vals, dim=(3, 4)).permute(0, 3, 1, 2)


@register("Crop", aliases=("crop_like",))
def crop_op(data, shape_like=None, *, offset=(0, 0), h_w=(0, 0),
            num_args=1, center_crop=False):
    """Spatial crop to `shape_like`'s or `h_w`'s height and width."""
    H, W = data.shape[2], data.shape[3]
    th, tw = (shape_like.shape[2], shape_like.shape[3]) \
        if shape_like is not None else tuple(h_w)
    if center_crop:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = offset
    return data[:, :, oy:oy + th, ox:ox + tw]


# ------------------------------------------------------------- layout -----

@register("space_to_depth")
def space_to_depth(data, *, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("depth_to_space")
def depth_to_space(data, *, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


def _conv_geometry(kernel, stride, dilate, pad):
    nd = len(kernel)
    return (tuple(stride) if stride else (1,) * nd,
            tuple(dilate) if dilate else (1,) * nd,
            tuple(pad) if pad else (0,) * nd)


@register("im2col")
def im2col(data, *, kernel, stride=(), dilate=(), pad=()):
    """Patches (N, C * prod(kernel), L): channel-major, then the taps in
    row-major order, as `lax.conv_general_dilated_patches` lays them."""
    nd = len(kernel)
    stride, dilate, pad = _conv_geometry(kernel, stride, dilate, pad)
    x = F.pad(data, [p for p in reversed(pad) for _ in range(2)])
    outs = [(x.shape[2 + i] - ((kernel[i] - 1) * dilate[i] + 1))
            // stride[i] + 1 for i in range(nd)]
    taps = []
    for t in itertools.product(*[range(k) for k in kernel]):
        sl = tuple(slice(t[i] * dilate[i],
                         t[i] * dilate[i] + (outs[i] - 1) * stride[i] + 1,
                         stride[i]) for i in range(nd))
        taps.append(x[(slice(None), slice(None)) + sl])
    n, c = data.shape[:2]
    return torch.stack(taps, dim=2).reshape(n, c * len(taps), -1)


@register("col2im")
def col2im(data, *, output_size, kernel, stride=(), dilate=(), pad=()):
    """Patches added back into an image: im2col's adjoint."""
    nd = len(kernel)
    stride, dilate, pad = _conv_geometry(kernel, stride, dilate, pad)
    out_size = tuple(output_size)
    n, ck, _ = data.shape
    c = ck // int(_np.prod(kernel))
    outs = [(out_size[i] + 2 * pad[i] - ((kernel[i] - 1) * dilate[i] + 1))
            // stride[i] + 1 for i in range(nd)]
    padded = tuple(out_size[i] + 2 * pad[i] for i in range(nd))
    grids = _np.meshgrid(*[_np.arange(o) for o in outs], indexing="ij")
    taps = _np.meshgrid(*[_np.arange(k) for k in kernel], indexing="ij")
    flat = _np.zeros(tuple(kernel) + tuple(outs), _np.int64)
    for i in range(nd):
        pos = (grids[i][None] * stride[i]
               + taps[i].reshape(tuple(kernel) + (1,) * nd) * dilate[i])
        flat = flat * padded[i] + pos.reshape(tuple(kernel) + tuple(outs))
    idx = torch.as_tensor(flat.reshape(-1), device=data.device)
    img = torch.zeros((n, c, int(_np.prod(padded))), dtype=data.dtype,
                      device=data.device)
    img = img.index_add(2, idx, data.reshape(n, c, -1))
    sl = tuple(slice(pad[i], pad[i] + out_size[i]) for i in range(nd))
    return img.reshape((n, c) + padded)[(slice(None), slice(None)) + sl]


@register("broadcast_like")
def broadcast_like(lhs, rhs, *, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return torch.broadcast_to(lhs, rhs.shape)
    shape = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        shape[la] = rhs.shape[ra]
    return torch.broadcast_to(lhs, tuple(shape))


@register("batch_take", aliases=("choose_element_0index",))
def batch_take(a, indices):
    """a (N, C), indices (N,) → a[i, indices[i]]; a negative index
    counts from the end, and one out of range reads NaN (the JAX
    `take_along_axis`'s fill)."""
    c = a.shape[1]
    idx = indices.detach().reshape(-1, 1).to(torch.int64)
    idx = torch.where(idx < 0, idx + c, idx)
    ok = (idx >= 0) & (idx < c)
    out = torch.gather(a, 1, idx.clamp(0, c - 1))
    return torch.where(ok, out, torch.full_like(out, float("nan")))[:, 0]


@register("fill_element_0index")
def fill_element_0index(lhs, mhs, rhs):
    """lhs with lhs[i, rhs[i]] = mhs[i]; an index out of range writes
    nothing."""
    out = lhs.detach().clone()
    n, c = out.shape
    idx = rhs.detach().to(torch.int64)
    idx = torch.where(idx < 0, idx + c, idx)
    ok = (idx >= 0) & (idx < c)
    rows = torch.arange(n, device=out.device)
    flat = torch.where(ok, rows * c + idx, n * c)
    padded = torch.cat([out.reshape(-1), out.new_zeros(1)])
    padded[flat] = mhs.detach().to(out.dtype)
    return padded[:-1].reshape(n, c)


@register("khatri_rao")
def khatri_rao(*args):
    """Column-wise Kronecker product."""
    out = args[0]
    for m in args[1:]:
        k = out.shape[1]
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, k)
    return out


@register("allclose")
def allclose(a, b, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    """1.0 or 0.0 (a 0-d float32 array)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    ok = torch.allclose(a.detach().to(dt), b.detach().to(dt), rtol=rtol,
                        atol=atol, equal_nan=equal_nan)
    return torch.tensor(float(ok), dtype=torch.float32, device=a.device)


@register("_contrib_boolean_mask", aliases=("boolean_mask",))
def boolean_mask(data, index, *, axis=0):
    """The slices of `data` along `axis` where `index` is nonzero: a
    shape that depends on the data, so it syncs with the host once."""
    keep = torch.nonzero(index.detach().to(torch.bool)).reshape(-1)
    return data.detach().index_select(axis, keep)


# ------------------------------------------------------------------ amp ---

@register("amp_cast")
def amp_cast(data, *, dtype="float32"):
    return data.to(torch_dtype_32(dtype))


@register("amp_multicast")
def amp_multicast(*data, num_outputs=0, cast_narrow=False):
    """Every input cast to the widest dtype among them (the narrowest
    with `cast_narrow`); the first of equal widths wins."""
    def key(a):
        return a.element_size()
    pick = min(data, key=key) if cast_narrow else max(data, key=key)
    return tuple(a.to(pick.dtype) for a in data)


# ------------------------------------------------------------------ fft ---

@register("_contrib_fft", aliases=("fft",))
def fft(data, *, compute_size=128):
    """Real → [re, im] interleaved along the last axis, doubled length,
    float32."""
    f = torch.fft.fft(data.detach().to(torch.float32), dim=-1)
    out = torch.stack([f.real, f.imag], dim=-1)
    return out.reshape(data.shape[:-1] + (2 * data.shape[-1],)) \
        .to(torch.float32)


@register("_contrib_ifft", aliases=("ifft",))
def ifft(data, *, compute_size=128):
    n = data.shape[-1] // 2
    pairs = data.detach().to(torch.float32).reshape(
        data.shape[:-1] + (n, 2))
    comp = torch.complex(pairs[..., 0], pairs[..., 1])
    return torch.fft.ifft(comp, dim=-1).real.to(torch.float32)


# ---------------------------------------------------------- correlation ---

@register("Correlation")
def correlation(data1, data2, *, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """FlowNet correlation for kernel_size=1, stride1=1 and
    pad_size == max_displacement (the JAX op's configurations)."""
    if kernel_size != 1 or stride1 != 1:
        raise MXNetError("Correlation: only kernel_size=1, stride1=1")
    if pad_size != max_displacement:
        raise MXNetError("Correlation: pad_size must equal max_displacement "
                         "(same-size output geometry; other paddings change "
                         "the output shape in the reference)")
    n, c, h, w = data1.shape
    pad = max_displacement
    p2 = F.pad(data2, (pad, pad, pad, pad))
    d = max_displacement // stride2
    outs = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            oy, ox = pad + dy * stride2, pad + dx * stride2
            shifted = p2[:, :, oy:oy + h, ox:ox + w]
            if is_multiply:
                outs.append(torch.mean(data1 * shifted, dim=1))
            else:
                outs.append(torch.mean(torch.abs(data1 - shifted), dim=1))
    return torch.stack(outs, dim=1)


# ------------------------------------------------- deformable convolution -

def bilinear_at(data, b, y, x):
    """`data` (N, C, H, W) sampled bilinearly at float coordinates y, x
    of image `b` (all broadcast to one shape S): (*S, C), zero outside
    (-1, H) x (-1, W), corner indices clamped into the image (the JAX
    `_bilinear_at`, batched).  The four corners are gathered one at a
    time."""
    H, W = data.shape[-2], data.shape[-1]
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1

    def at(yi, xi):
        yc = yi.to(torch.int64).clamp(0, H - 1)
        xc = xi.to(torch.int64).clamp(0, W - 1)
        return data[b, :, yc, xc]

    inside = (y > -1.0) & (y < H) & (x > -1.0) & (x < W)
    val = at(y0, x0) * (wy0 * wx0).unsqueeze(-1)
    val = val + at(y0, x0 + 1) * (wy0 * wx1).unsqueeze(-1)
    val = val + at(y0 + 1, x0) * (wy1 * wx0).unsqueeze(-1)
    val = val + at(y0 + 1, x0 + 1) * (wy1 * wx1).unsqueeze(-1)
    return torch.where(inside.unsqueeze(-1), val, torch.zeros_like(val))


@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution", "deformable_convolution"))
def deformable_convolution(data, offset, weight, bias=None, *, kernel=(),
                           stride=(), dilate=(), pad=(), num_filter=0,
                           num_group=1, num_deformable_group=1,
                           no_bias=False, workspace=1024, layout=None):
    """Deformable convolution v1: data sampled bilinearly at each tap's
    position shifted by its (y, x) offset, then contracted with the
    weights; num_group = num_deformable_group = 1."""
    if num_group != 1 or num_deformable_group != 1:
        raise MXNetError("deformable_convolution: groups=1 only")
    kh, kw = kernel
    stride, dilate, pad = _conv_geometry(kernel, stride, dilate, pad)
    N, C, H, W = data.shape
    Ho = (H + 2 * pad[0] - ((kh - 1) * dilate[0] + 1)) // stride[0] + 1
    Wo = (W + 2 * pad[1] - ((kw - 1) * dilate[1] + 1)) // stride[1] + 1
    dev = data.device
    oy = torch.arange(Ho, device=dev) * stride[0] - pad[0]
    ox = torch.arange(Wo, device=dev) * stride[1] - pad[1]
    ky = torch.arange(kh, device=dev) * dilate[0]
    kx = torch.arange(kw, device=dev) * dilate[1]
    ty = torch.arange(kh * kw, device=dev) // kw
    tx = torch.arange(kh * kw, device=dev) % kw
    base_y = (oy[None, :, None] + ky[ty][:, None, None])    # (kk, Ho, 1)
    base_x = (ox[None, None, :] + kx[tx][:, None, None])    # (kk, 1, Wo)
    off = offset.reshape(N, kh * kw, 2, Ho, Wo)
    y = base_y[None] + off[:, :, 0]                         # (N, kk, Ho, Wo)
    x = base_x[None] + off[:, :, 1]
    b = torch.arange(N, device=dev).view(N, 1, 1, 1)
    sampled = bilinear_at(data, b, y, x)              # (N, kk, Ho, Wo, C)
    s2 = sampled.permute(0, 4, 1, 2, 3).reshape(N, C * kh * kw, Ho * Wo)
    w2 = weight.reshape(num_filter, C * kh * kw)
    out = torch.einsum("oc,ncl->nol", w2, s2).reshape(N, num_filter, Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# ------------------------------------------------------------- multibox ---

@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",))
def multibox_prior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchors (1, H * W * (S + R - 1), 4), corner form, normalized:
    each size at the first ratio, then the first size at each further
    ratio."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    sizes, ratios = tuple(sizes), tuple(ratios)
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(w, device=dev) + offsets[1]) * step_x
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")
    whs = [(s * _np.sqrt(ratios[0]), s / _np.sqrt(ratios[0]))
           for s in sizes]
    whs += [(sizes[0] * _np.sqrt(r), sizes[0] / _np.sqrt(r))
            for r in ratios[1:]]
    anchors = [torch.stack([cx - aw / 2, cy - ah / 2, cx + aw / 2,
                            cy + ah / 2], dim=-1) for aw, ah in whs]
    out = torch.stack(anchors, dim=2).reshape(-1, 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out[None]


def col(x, k):
    """Column `k` of the last axis; past the last column, the last one
    (a `jnp` read clamps a static index, so a row with fewer columns
    than an op reads gives the JAX op's values)."""
    return x[..., min(k, x.shape[-1] - 1)]


def box_iou_corner(a, b):
    """IoU of corner boxes a (..., A, 4) and b (..., M, 4): (..., A, M),
    areas floored at 0 (the JAX `_box_iou_corner`)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(br - tl, 0.0)
    inter = col(wh, 0) * col(wh, 1)
    area_a = torch.clamp_min((col(a, 2) - col(a, 0))
                             * (col(a, 3) - col(a, 1)), 0.0)
    area_b = torch.clamp_min((col(b, 2) - col(b, 0))
                             * (col(b, 3) - col(b, 1)), 0.0)
    return inter / torch.clamp_min(area_a[..., :, None]
                                   + area_b[..., None, :] - inter, 1e-12)


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",))
def multibox_target(anchor, label, cls_pred, *, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets: anchor (1, A, 4), label (N, M, 5) rows
    [cls, x1, y1, x2, y2] (cls < 0 pads) → (box_target (N, A * 4),
    box_mask (N, A * 4), cls_target (N, A)).  Each valid label claims
    its best anchor (of two claiming one anchor, the later row wins, as
    the JAX scatter leaves it); every other anchor matches its best
    label at IoU >= `overlap_threshold`.  The mining attributes are
    taken and unused, as in the JAX op."""
    anc = anchor.detach()[0]
    lab = label.detach()
    N, M = lab.shape[:2]
    A = anc.shape[0]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    aw = torch.clamp_min(anc[:, 2] - anc[:, 0], 1e-12)
    ah = torch.clamp_min(anc[:, 3] - anc[:, 1], 1e-12)
    v0, v1, v2, v3 = variances
    valid = col(lab, 0) >= 0                              # (N, M)
    ious = box_iou_corner(anc, lab[:, :, 1:5])            # (N, A, M)
    ious = torch.where(valid[:, None, :], ious, torch.full_like(ious, -1.0))
    best_iou = torch.amax(ious, dim=2)
    best_gt = torch.argmax(ious, dim=2)                   # first of ties
    best_anchor = torch.argmax(ious, dim=1)               # (N, M)
    claims = (best_anchor[:, None, :] == torch.arange(
        A, device=anc.device)[None, :, None]) & valid[:, None, :]
    forced = claims.any(dim=2)                            # (N, A)
    rank = torch.arange(1, M + 1, device=anc.device)
    gt_of_forced = (claims * rank).amax(dim=2) - 1
    matched = forced | (best_iou >= overlap_threshold)
    gt_idx = torch.where(forced, gt_of_forced, best_gt)
    g = torch.gather(lab, 1, gt_idx.unsqueeze(-1).expand(
        N, A, lab.shape[-1]))
    gcx = (col(g, 1) + col(g, 3)) / 2
    gcy = (col(g, 2) + col(g, 4)) / 2
    gw = torch.clamp_min(col(g, 3) - col(g, 1), 1e-12)
    gh = torch.clamp_min(col(g, 4) - col(g, 2), 1e-12)
    tx = (gcx - acx) / aw / v0
    ty = (gcy - acy) / ah / v1
    tw = torch.log(gw / aw) / v2
    th = torch.log(gh / ah) / v3
    bt = torch.stack([tx, ty, tw, th], dim=-1)            # (N, A, 4)
    mask = matched.unsqueeze(-1).to(anc.dtype)
    cls_t = torch.where(matched, col(g, 0) + 1.0, torch.zeros_like(gcx))
    return ((bt * mask).reshape(N, -1),
            mask.expand(N, A, 4).reshape(N, -1), cls_t)


NMS_BLOCK = 128


def greedy_nms(boxes, thresh, iou_fn, ids=None, suppressor=None):
    """Greedy NMS over boxes (N, A, 4) in sweep order: (N, A) bool,
    False where an earlier box that is still alive, and may suppress
    (`suppressor`, default all), overlaps it by IoU > `thresh` (with the
    same id, when `ids` (N, A) is given).

    The JAX ops sweep one box per step.  Here the boxes go in blocks of
    `NMS_BLOCK`:
    a block's IoUs against every box from it on are computed at once,
    the block's own boxes are settled by iterating keep =
    alive & ~any(keep[i] & sup[i, j], i < j) to its fixed point (each
    sweep settles at least one more box, and the fixed point is the
    sequential result), and the kept ones then suppress every later
    box in one reduction.  The sweep ends at the last box that may
    suppress."""
    N, A = boxes.shape[:2]
    dev = boxes.device
    alive = torch.ones((N, A), dtype=torch.bool, device=dev)
    if suppressor is None:
        n_sweep = A
    else:
        any_sup = suppressor.any(dim=0)
        n_sweep = int(torch.nonzero(any_sup).max()) + 1 \
            if bool(any_sup.any()) else 0
    for s in range(0, n_sweep, NMS_BLOCK):
        e = min(s + NMS_BLOCK, n_sweep)
        sup = iou_fn(boxes[:, s:e], boxes[:, s:]) > thresh   # (N, B, A - s)
        if ids is not None:
            sup &= ids[:, s:e, None] == ids[:, None, s:]
        if suppressor is not None:
            sup &= suppressor[:, s:e, None]
        later = torch.arange(e - s, device=dev)[:, None] < torch.arange(
            A - s, device=dev)[None, :]
        sup &= later
        inner, outer = sup[:, :, :e - s], sup[:, :, e - s:]
        start = alive[:, s:e]
        keep = start
        while True:
            new = start & ~(keep.unsqueeze(-1) & inner).any(dim=1)
            if torch.equal(new, keep):
                break
            keep = new
        alive[:, s:e] = keep
        if e < A:
            alive[:, e:] &= ~(keep.unsqueeze(-1) & outer).any(dim=1)
    return alive


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",))
def multibox_detection(cls_prob, loc_pred, anchor, *, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD decode and per-class NMS: cls_prob (N, classes, A), loc_pred
    (N, A * 4), anchor (1, A, 4) → (N, A, 6) rows [cls_id, score, x1,
    y1, x2, y2] in descending score order, suppressed rows -1.  Class
    ids count without the background; `nms_topk` is taken and unused.
    A box at or under `threshold` sorts after every box over it, so it
    can suppress only boxes that are dropped anyway: the sweep stops at
    the last box over `threshold`."""
    cls_prob, loc_pred = cls_prob.detach(), loc_pred.detach()
    N, ncls, A = cls_prob.shape
    anc = anchor.detach()[0]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    v0, v1, v2, v3 = variances
    loc = loc_pred.reshape(N, A, 4)
    cx = loc[..., 0] * v0 * aw + acx
    cy = loc[..., 1] * v1 * ah + acy
    w = torch.exp(loc[..., 2] * v2) * aw
    h = torch.exp(loc[..., 3] * v3) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1) \
        if ncls > 1 else cls_prob
    score = torch.amax(fg, dim=1)
    cls_id = torch.argmax(fg, dim=1).to(torch.float32)
    order = torch.argsort(-score, dim=1, stable=True)
    boxes_o = torch.gather(boxes, 1, order.unsqueeze(-1).expand(N, A, 4))
    score_o = torch.gather(score, 1, order)
    cls_o = torch.gather(cls_id, 1, order)
    keep = score_o > threshold
    # past the last box over threshold no box can change a kept one
    alive = greedy_nms(boxes_o, nms_threshold, box_iou_corner,
                       ids=None if force_suppress else cls_o,
                       suppressor=keep)
    ok = alive & keep
    neg = torch.full_like(score_o, -1.0)
    return torch.cat([torch.where(ok, cls_o, neg)[..., None],
                      torch.where(ok, score_o, neg)[..., None],
                      torch.where(ok[..., None], boxes_o,
                                  torch.full_like(boxes_o, -1.0))], dim=-1)


@register("_contrib_bipartite_matching", aliases=("bipartite_matching",))
def bipartite_matching(dist, *, threshold=1e-12, is_ascend=False, topk=-1):
    """Greedy bipartite matching over dist (..., R, C): k times, the best
    cell left (the largest, the smallest with `is_ascend`; the first in
    row-major order of equal ones) is matched if it passes `threshold`,
    and its row and column leave → (row_match (..., R), col_match
    (..., C)) float32, -1 unmatched.  Each step runs over the whole
    batch at once."""
    d = dist.detach()
    lead = d.shape[:-2]
    R, C = d.shape[-2], d.shape[-1]
    dd = d.reshape((-1, R, C)).clone()
    B = dd.shape[0]
    sign = 1.0 if is_ascend else -1.0
    k = min(R, C) if topk <= 0 else min(topk, min(R, C))
    rm = torch.full((B, R), -1.0, device=d.device)
    cm = torch.full((B, C), -1.0, device=d.device)
    rows = torch.arange(B, device=d.device)
    out_val = sign * float("inf")
    for _ in range(k):
        flat = torch.argmin(sign * dd.reshape(B, -1), dim=1)
        r, c = flat // C, flat % C
        v = dd[rows, r, c]
        ok = v <= threshold if is_ascend else v >= threshold
        rm[rows, r] = torch.where(ok, c.to(torch.float32), rm[rows, r])
        cm[rows, c] = torch.where(ok, r.to(torch.float32), cm[rows, c])
        dd[rows, r, :] = out_val
        dd[rows, :, c] = out_val
    return rm.reshape(lead + (R,)), cm.reshape(lead + (C,))


# ----------------------------------------------------- multi-tensor sgd ---

def _clip(g, c):
    return torch.clamp(g, -c, c) if c is not None and c > 0 else g


@register("multi_sgd_update")
def multi_sgd_update(*arrays, lrs=(), wds=(), rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1):
    """SGD over (weight, grad) pairs: returns the updated weights."""
    outs = []
    for i in range(num_weights):
        w, g = arrays[2 * i].detach(), arrays[2 * i + 1].detach()
        g = _clip(g * rescale_grad, clip_gradient)
        outs.append(w - lrs[i] * (g + wds[i] * w))
    return tuple(outs)


@register("multi_sgd_mom_update")
def multi_sgd_mom_update(*arrays, lrs=(), wds=(), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1):
    """Momentum SGD over (weight, grad, mom) triples: returns the
    updated weights, then the updated momenta."""
    ws, ms = [], []
    for i in range(num_weights):
        w, g, m = (a.detach() for a in arrays[3 * i:3 * i + 3])
        g = _clip(g * rescale_grad, clip_gradient)
        m2 = momentum * m - lrs[i] * (g + wds[i] * w)
        ws.append(w + m2)
        ms.append(m2)
    return tuple(ws + ms)


@register("mp_sgd_update")
def mp_sgd_update(weight, grad, weight32, *, lr=0.01, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """Multi-precision SGD on the float32 master weights: returns
    (weight in its own dtype, weight32)."""
    g = _clip(grad.detach().to(torch.float32) * rescale_grad, clip_gradient)
    w32 = weight32.detach()
    w32 = w32 - lr * (g + wd * w32)
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update")
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr=0.01,
                      momentum=0.0, wd=0.0, rescale_grad=1.0,
                      clip_gradient=-1.0, lazy_update=True):
    """Returns (weight, mom, weight32)."""
    g = _clip(grad.detach().to(torch.float32) * rescale_grad, clip_gradient)
    w32 = weight32.detach()
    m2 = momentum * mom.detach() - lr * (g + wd * w32)
    w32 = w32 + m2
    return w32.to(weight.dtype), m2, w32


# ------------------------------------------------------- legacy aliases ---

@register("_contrib_div_sqrt_dim")
def div_sqrt_dim(data):
    """data / sqrt(last dim), the root rounded to the data's dtype."""
    return data / torch.tensor(math.sqrt(data.shape[-1]), dtype=data.dtype,
                               device=data.device)
