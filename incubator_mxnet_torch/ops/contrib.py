"""Contrib ops (counterpart of `incubator_mxnet_tpu/ops/contrib_ops.py`):
the CTC loss, ROIAlign, box_iou and box_nms, the spatial samplers
(UpSampling, GridGenerator, BilinearSampler, SpatialTransformer,
BilinearResize2D, AdaptiveAvgPooling2D), the small elementwise ops
(smooth_l1, hard_sigmoid, log_sigmoid, mish, digamma),
ravel_multi_index / unravel_index and index_copy / index_add.

ROIAlign follows the JAX formula, not torchvision's: a fixed 2 x 2
sample grid when `sample_ratio <= 0`, no half-pixel offset, samples
outside (-1, H) x (-1, W) zero; it works through the RoIs in chunks so
that no gather holds more than `ROI_CHUNK_BYTES`.  box_nms keeps the
rows in input order and marks a suppressed or invalid row's score (and
id) -1; its greedy sweep is `extended.greedy_nms`.

`CTCLoss` (aliases `ctc_loss`, `_contrib_CTCLoss`, `_contrib_ctc_loss`)
runs the JAX op's forward recursion in log space over the extended
label [blank, l0, blank, l1, ..., blank], one step of torch ops per
time step where the JAX op scans, so torch autograd gives its gradient.
Blank "first" is class 0 and pads labels with 0; blank "last" is class
C − 1 and pads with −1.  A length input counts only with its `use_*`
flag, and a length given without its flag raises, as in the JAX op.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .extended import bilinear_at, col, greedy_nms, _image_index
from .math import _abs
from .registry import register

__all__ = ["ctc_loss", "roi_align", "box_iou", "box_nms"]

# the most bytes one ROIAlign corner gather may take (float32 samples
# of a chunk of RoIs)
ROI_CHUNK_BYTES = 1 << 26

_NEG = -1e30


def _shift(alpha, k, neg):
    """alpha shifted right by k along the label axis, NEG filled."""
    n, s = alpha.shape
    if k >= s:
        return neg.expand(n, s)
    return torch.cat([neg.expand(n, k), alpha[:, :s - k]], dim=1)


@register("CTCLoss", aliases=("ctc_loss", "_contrib_CTCLoss",
                              "_contrib_ctc_loss"))
def ctc_loss(data, label, data_lengths=None, label_lengths=None, *,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Negative log-likelihood (N,) float32 of each label sequence under
    `data` (T, N, C) unnormalized activations."""
    T, N, C = data.shape
    L = label.shape[1]
    dev = data.device
    logp = torch.log_softmax(data.to(torch.float32), dim=-1)
    raw = label.to(torch.int64)
    if blank_label == "first":
        blank, lab, pad_mask = 0, raw, raw == 0
    else:
        blank, pad_mask = C - 1, raw < 0
        lab = torch.where(pad_mask, torch.zeros_like(raw), raw)
    if use_data_lengths and data_lengths is None:
        raise MXNetError("ctc_loss: use_data_lengths=True needs "
                         "data_lengths")
    if use_label_lengths and label_lengths is None:
        raise MXNetError("ctc_loss: use_label_lengths=True needs "
                         "label_lengths")
    if data_lengths is not None and not use_data_lengths:
        raise MXNetError("ctc_loss: data_lengths given but "
                         "use_data_lengths=False; set the flag")
    if label_lengths is not None and not use_label_lengths:
        raise MXNetError("ctc_loss: label_lengths given but "
                         "use_label_lengths=False; set the flag")
    dlen = torch.full((N,), T, dtype=torch.int64, device=dev) \
        if data_lengths is None else data_lengths.to(torch.int64)
    llen = (~pad_mask).sum(dim=1) if label_lengths is None \
        else label_lengths.to(torch.int64)

    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    pos = torch.arange(S, device=dev).unsqueeze(0)
    valid = pos < (2 * llen.unsqueeze(1) + 1)
    ext_m2 = torch.cat([torch.full((N, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)[:, :S]
    can_skip = (ext != blank) & (ext != ext_m2)
    neg = torch.full((1, 1), _NEG, dtype=torch.float32, device=dev)

    first = logp[0].gather(1, ext[:, 1:2])[:, 0] if S > 1 else None
    alpha = torch.cat(
        [logp[0, :, blank:blank + 1]]
        + ([torch.where(llen > 0, first, neg[0]).unsqueeze(1)]
           if S > 1 else [])
        + ([neg.expand(N, S - 2)] if S > 2 else []), dim=1)
    alpha = torch.where(valid, alpha, neg)
    for t in range(1, T):
        a_m2 = torch.where(can_skip, _shift(alpha, 2, neg), neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1, neg)),
                                 a_m2)
        new = torch.where(valid, merged + logp[t].gather(1, ext), neg)
        # frozen once t reaches the data length: the final alpha is
        # read at dlen − 1
        alpha = torch.where((t < dlen).unsqueeze(1), new, alpha)
    last = alpha.gather(1, (2 * llen).clamp_max(S - 1).unsqueeze(1))[:, 0]
    prev = alpha.gather(1, (2 * llen - 1).clamp(0, S - 1).unsqueeze(1))[:, 0]
    return -torch.logaddexp(last, torch.where(llen > 0, prev, neg[0]))


# ---------------------------------------------------------------------
# ROIAlign
# ---------------------------------------------------------------------

@register("ROIAlign", aliases=("_contrib_ROIAlign", "roi_align"))
def roi_align(data, rois, *, pooled_size, spatial_scale=1.0,
              sample_ratio=-1):
    """data (N, C, H, W), rois (R, 5) = [batch_idx, x1, y1, x2, y2] in
    image coordinates → (R, C, ph, pw): the mean of an ns x ns grid of
    bilinear samples per bin (ns = sample_ratio, or 2 when it is <= 0)."""
    ph, pw = (pooled_size if isinstance(pooled_size, (tuple, list))
              else (pooled_size, pooled_size))
    ns = sample_ratio if sample_ratio > 0 else 2
    N, C, H, W = data.shape
    rois = rois.to(torch.float32)
    per_roi = ph * pw * ns * ns * C * 4
    chunk = max(1, ROI_CHUNK_BYTES // per_roi)
    outs = [_roi_align_chunk(data, rois[s:s + chunk], ph, pw, ns,
                             spatial_scale)
            for s in range(0, rois.shape[0], chunk)]
    if not outs:
        return data.new_zeros((0, C, ph, pw))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _roi_align_chunk(data, rois, ph, pw, ns, spatial_scale):
    dev = data.device
    r = rois.shape[0]
    b = _image_index(rois[:, 0].detach(), data.shape[0]).view(r, 1, 1, 1, 1)
    x1, y1, x2, y2 = ((rois[:, i] * spatial_scale).view(r, 1, 1, 1, 1)
                      for i in range(1, 5))
    rh = torch.clamp_min(y2 - y1, 1.0)
    rw = torch.clamp_min(x2 - x1, 1.0)
    bh, bw = rh / ph, rw / pw
    iy = torch.arange(ph, device=dev).view(1, ph, 1, 1, 1)
    ix = torch.arange(pw, device=dev).view(1, 1, pw, 1, 1)
    sy = torch.arange(ns, device=dev).view(1, 1, 1, ns, 1)
    sx = torch.arange(ns, device=dev).view(1, 1, 1, 1, ns)
    y = y1 + iy * bh + (sy + 0.5) * bh / ns
    x = x1 + ix * bw + (sx + 0.5) * bw / ns
    shape = (r, ph, pw, ns, ns)
    vals = bilinear_at(data, b, y.expand(shape), x.expand(shape))
    return vals.mean(dim=(3, 4)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------
# bounding boxes
# ---------------------------------------------------------------------

def _to_corner(b, fmt):
    if fmt == "center":
        cx, cy, w, h = col(b, 0), col(b, 1), col(b, 2), col(b, 3)
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                           dim=-1)
    return b


@register("box_iou", aliases=("_contrib_box_iou",))
def box_iou(lhs, rhs, *, format="corner"):
    """IoU matrix (..., N, M) of (..., N, 4) and (..., M, 4) boxes."""
    a = _to_corner(lhs.detach(), format)[..., :, None, :]
    b = _to_corner(rhs.detach(), format)[..., None, :, :]
    ix1 = torch.maximum(col(a, 0), col(b, 0))
    iy1 = torch.maximum(col(a, 1), col(b, 1))
    ix2 = torch.minimum(col(a, 2), col(b, 2))
    iy2 = torch.minimum(col(a, 3), col(b, 3))
    inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
    area_a = (col(a, 2) - col(a, 0)) * (col(a, 3) - col(a, 1))
    area_b = (col(b, 2) - col(b, 0)) * (col(b, 3) - col(b, 1))
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-12)


@register("box_nms", aliases=("_contrib_box_nms",))
def box_nms(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy NMS over data (..., N, K) rows holding an id, a score and 4
    coordinates: the rows stay in input order, a suppressed or invalid
    row's score (and id) becomes -1.  A row is valid when its score is
    over `valid_thresh` and ranks in the `topk`; only valid rows
    suppress, and only rows of their own id unless `force_suppress`."""
    data = data.detach()
    orig_shape = data.shape
    d2 = data.reshape((-1,) + tuple(orig_shape[-2:]))
    B, N, _ = d2.shape
    scores = col(d2, score_index)
    order = torch.argsort(-scores, dim=1, stable=True)
    sorted_rows = torch.gather(d2, 1, order.unsqueeze(-1).expand_as(d2))
    boxes = sorted_rows[:, :, coord_start:coord_start + 4]
    valid = col(sorted_rows, score_index) > valid_thresh
    if topk > 0:
        valid &= torch.arange(N, device=data.device)[None, :] < topk
    ids = col(sorted_rows, id_index) \
        if id_index >= 0 and not force_suppress else None
    alive = greedy_nms(boxes, overlap_thresh,
                       lambda a, b: box_iou(a, b, format=in_format),
                       ids=ids, suppressor=valid)
    keep = torch.zeros_like(alive).scatter(1, order, alive & valid)
    out = d2.clone()
    out[:, :, score_index] = torch.where(keep, scores,
                                         torch.full_like(scores, -1.0))
    if id_index >= 0:
        out[:, :, id_index] = torch.where(
            keep, col(d2, id_index), torch.full_like(scores, -1.0))
    if out_format != in_format:
        c = out[:, :, coord_start:coord_start + 4]
        lo, hi = c[..., :2], c[..., 2:]
        if out_format == "center":                       # corner → center
            conv = torch.cat([(lo + hi) * 0.5, hi - lo], dim=-1)
        else:                                            # center → corner
            half = hi * 0.5
            conv = torch.cat([lo - half, lo + half], dim=-1)
        out = torch.cat([out[:, :, :coord_start], conv,
                         out[:, :, coord_start + 4:]], dim=-1)
    return out.reshape(orig_shape)


# ---------------------------------------------------------------------
# spatial sampling
# ---------------------------------------------------------------------

@register("UpSampling", aliases=("upsampling",))
def upsampling(data, *, scale, sample_type="nearest", num_filter=0):
    if sample_type == "nearest":
        return torch.repeat_interleave(
            torch.repeat_interleave(data, scale, dim=2), scale, dim=3)
    out = F.interpolate(data, scale_factor=scale, mode="bilinear",
                        align_corners=False)
    return out.to(data.dtype)


@register("GridGenerator", aliases=("grid_generator",))
def grid_generator(data, *, transform_type="affine", target_shape=None):
    """affine: data (N, 6) → sampling grid (N, 2, H, W) in [-1, 1], x
    then y; warp: data is a flow field (N, 2, H, W) in pixels."""
    dev = data.device
    if transform_type == "affine":
        H, W = target_shape
        theta = data.reshape(-1, 2, 3)
        ys = torch.linspace(-1.0, 1.0, H, device=dev)
        xs = torch.linspace(-1.0, 1.0, W, device=dev)
        gx, gy = torch.meshgrid(xs, ys, indexing="xy")          # (H, W)
        base = torch.stack([gx, gy, torch.ones_like(gx)],
                           dim=0).reshape(3, -1)
        dt = torch.promote_types(theta.dtype, base.dtype)   # float32 at least
        out = torch.einsum("nij,jk->nik", theta.to(dt), base.to(dt))
        return out.reshape(-1, 2, H, W)
    N, _, H, W = data.shape
    ys = torch.arange(H, dtype=data.dtype, device=dev)
    xs = torch.arange(W, dtype=data.dtype, device=dev)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    x = (data[:, 0] + gx) * 2.0 / max(W - 1, 1) - 1.0
    y = (data[:, 1] + gy) * 2.0 / max(H - 1, 1) - 1.0
    return torch.stack([x, y], dim=1)


@register("BilinearSampler", aliases=("bilinear_sampler",))
def bilinear_sampler(data, grid, *, cudnn_off=False):
    """data (N, C, H, W) sampled at grid (N, 2, Ho, Wo), x then y in
    [-1, 1] → (N, C, Ho, Wo)."""
    N, C, H, W = data.shape
    x = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    y = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    b = torch.arange(N, device=data.device).view(N, 1, 1)
    return bilinear_at(data, b, y, x).permute(0, 3, 1, 2)


@register("SpatialTransformer", aliases=("spatial_transformer",))
def spatial_transformer(data, loc, *, target_shape,
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False):
    if transform_type not in ("affine", "warp"):
        raise MXNetError(
            f"SpatialTransformer: unsupported transform_type "
            f"{transform_type!r}")
    if sampler_type != "bilinear":
        raise MXNetError(
            f"SpatialTransformer: unsupported sampler_type "
            f"{sampler_type!r}")
    grid = grid_generator(loc, transform_type=transform_type,
                          target_shape=tuple(target_shape))
    return bilinear_sampler(data, grid)


# ---------------------------------------------------------------------
# small elementwise ops
# ---------------------------------------------------------------------

@register("smooth_l1")
def smooth_l1(data, *, scalar=1.0):
    s2 = scalar * scalar
    ax = _abs(data)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * data * data, ax - 0.5 / s2)


@register("hard_sigmoid")
def hard_sigmoid(data, *, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("log_sigmoid")
def log_sigmoid(data):
    return F.logsigmoid(data)


@register("mish")
def mish(data):
    return data * torch.tanh(F.softplus(data))


@register("digamma")
def digamma(data):
    return torch.special.digamma(data)


@register("ravel_multi_index", aliases=("_ravel_multi_index",))
def ravel_multi_index(data, *, shape):
    """data (ndim, n) of indices → (n,) row-major flat indices."""
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    st = torch.tensor(list(reversed(strides)), dtype=data.dtype,
                      device=data.device)
    return (data.detach() * st[:, None]).sum(dim=0)


@register("unravel_index", aliases=("_unravel_index",))
def unravel_index(data, *, shape):
    """(n,) row-major flat indices → (ndim, n) multi-indices."""
    out, rem = [], data.detach()
    for s in reversed(shape):
        out.append(torch.remainder(rem, s))
        rem = torch.div(rem, s, rounding_mode="floor")
    return torch.stack(list(reversed(out)), dim=0)


def _rows_in_range(index, n):
    """Row ids counted from the end where negative, and a mask of those
    in range (a write drops the rest, as `.at[]` does)."""
    idx = index.detach().to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


@register("index_copy", aliases=("_contrib_index_copy",))
def index_copy(old, index, new):
    """old with rows `index` set to `new`'s; of rows named twice the
    later write stays, as the JAX scatter leaves it."""
    n = old.shape[0]
    idx, ok = _rows_in_range(index, n)
    pos = torch.arange(idx.numel(), device=idx.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, torch.where(ok, idx, n), pos, "amax")
    ok &= last[idx.clamp(0, n)] == pos
    if not bool(ok.all()):
        idx, new = idx[ok], new[ok]
    return old.index_copy(0, idx, new.to(old.dtype))


@register("index_add", aliases=("_contrib_index_add",))
def index_add(old, index, new):
    idx, ok = _rows_in_range(index, old.shape[0])
    if not bool(ok.all()):
        idx, new = idx[ok], new[ok]
    return old.index_add(0, idx, new.to(old.dtype))


def _resize_axis_align_corners(x, axis, out_len):
    """1-D bilinear resize along `axis`, align_corners scaling ((in - 1)
    / (out - 1))."""
    in_len = x.shape[axis]
    if out_len == in_len:
        return x
    dev = x.device
    if out_len == 1 or in_len == 1:
        return torch.index_select(
            x, axis, torch.zeros(out_len, dtype=torch.int64, device=dev))
    pos = torch.arange(out_len, dtype=torch.float32, device=dev) \
        * (in_len - 1) / (out_len - 1)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, in_len - 2)
    w = (pos - lo).to(x.dtype)
    shape = [1] * x.ndim
    shape[axis] = out_len
    w = w.reshape(shape)
    a = torch.index_select(x, axis, lo)
    b = torch.index_select(x, axis, lo + 1)
    return a * (1 - w) + b * w


@register("BilinearResize2D", aliases=("_contrib_BilinearResize2D",
                                       "bilinear_resize_2d"))
def bilinear_resize_2d(data, *, height=0, width=0, scale_height=0.0,
                       scale_width=0.0, mode="size"):
    """NCHW bilinear resize with align_corners scaling; the size from
    height/width or scale_*, a missing side keeping its extent."""
    if mode not in ("size", "scale"):
        raise MXNetError(
            f"BilinearResize2D: mode {mode!r} is not supported "
            "(only 'size' and 'scale')")
    N, C, H, W = data.shape
    th = int(height) if height else (
        max(1, int(round(H * scale_height))) if scale_height else H)
    tw = int(width) if width else (
        max(1, int(round(W * scale_width))) if scale_width else W)
    out = _resize_axis_align_corners(data, 2, th)
    out = _resize_axis_align_corners(out, 3, tw)
    return out.to(data.dtype)


@register("AdaptiveAvgPooling2D", aliases=("_contrib_AdaptiveAvgPooling2D",
                                           "adaptive_avg_pooling"))
def adaptive_avg_pooling(data, *, output_size=1):
    """Exact adaptive average pooling over NCHW: bin i covers
    [floor(i * L / out), ceil((i + 1) * L / out)), as two products with
    averaging matrices built on the host."""
    oh, ow = (output_size if isinstance(output_size, (tuple, list))
              else (output_size, output_size))
    N, C, H, W = data.shape

    def weights(L, out):
        ss = _np.floor(_np.arange(out) * L / out).astype(_np.int64)
        ee = _np.ceil((_np.arange(out) + 1) * L / out).astype(_np.int64)
        m = _np.zeros((out, L), _np.float32)
        for i, (a, b) in enumerate(zip(ss, ee)):
            m[i, a:b] = 1.0 / (b - a)
        return torch.from_numpy(m).to(data.device)
    out = torch.einsum("ih,nchw,jw->ncij", weights(H, oh),
                       data.to(torch.float32), weights(W, ow))
    return out.to(data.dtype)
