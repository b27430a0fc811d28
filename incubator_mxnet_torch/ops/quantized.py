"""Quantized (int8) operators (counterpart of
`incubator_mxnet_tpu/ops/quantized.py`).

The same 18 names, aliases, attributes and formulas in two families:

- the per-tensor ops with MXNet's (data, min_range, max_range) triples
  (`_contrib_quantize_v2`, `_contrib_quantized_conv`, ...), the ranges
  0-d tensors on the data's device (never read back to the host);
- the fused per-channel ops of `contrib.quantization.quantize_net`
  (`_quantized_conv_pc`, `_quantized_dense_pc`): activation to int8,
  the int8 product, the per-channel rescale, the bias and relu in one
  epilogue, the output in the input's dtype.

The JAX package leaves the int8 products to XLA (`conv_general_dilated`
and `dot_general` with `preferred_element_type=int32`); PyTorch on CUDA
has no integer convolution and its one int8 product (`torch._int_mm`)
refuses m <= 16 and k or n not a multiple of 8.  So on the card every
int8 product goes through this repo's kernel `int8_igemm`
(`csrc/int8_gemm.cu`: the dense product and the implicit-GEMM
convolution, with the int32-plus-bias epilogue of the per-tensor ops or
the fused epilogue of the per-channel ones), and every activation to
int8 through `int8_quantize` (one pass with a static threshold, an
absolute-max pass first with a dynamic one).  Beside each is its plain
version (`igemm_plain`, `quantize_plain`), which a CPU or meta tensor
takes; it widens int8 to float64, where every product and sum of int8
values is exact (int8 convolution on the CPU returns int8 and wraps).
The rest (dequantize, pooling, relu, flatten) is plain PyTorch on every
device, as it is plain XLA in the JAX package.  The ops take no
gradient: their inputs are detached, as the JAX ops are registered
`differentiable=False`.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as _np
import torch
import torch.nn.functional as F

from .._kernels import entry, route, stream
from ..base import MXNetError
from .registry import register

__all__ = ["int8_quantize", "int8_dense", "int8_conv", "quantize_plain",
           "igemm_plain", "igemm_form", "IGEMM_FORMS", "launch_counts",
           "form_counts", "reset_launch_counts"]

INT8_MAX = 127.0
INT32_MAX = float(2 ** 31 - 1)

_count_lock = threading.Lock()
launch_counts = {"int8_igemm": 0, "int8_quantize": 0}
# the device kernels of `int8_igemm`'s forms (csrc/int8_gemm.cu's
# `IgemmForm`, in its order): the wrapper passes the entry the form's
# index, and the entry launches that kernel or refuses the shape, so
# each launch of int8_igemm is counted here too, by the kernel it ran
IGEMM_FORMS = ("igemm_wgmma", "igemm_conv_wgmma", "igemm_kernel<2>",
               "igemm_kernel<1>", "igemm_kernel<0>")
form_counts = dict.fromkeys(IGEMM_FORMS, 0)


def reset_launch_counts():
    with _count_lock:
        for counts in (launch_counts, form_counts):
            for k in counts:
                counts[k] = 0


def _launched(name, err, form=None):
    if err != 0:
        raise MXNetError(f"{name}: kernel launch failed with cudaError {err}")
    with _count_lock:
        launch_counts[name] += 1
        if form is not None:
            form_counts[form] += 1


def igemm_form(K=None, conv=None, aligned=True):
    """The device kernel that `int8_igemm` launches for a dense product
    of depth K or the convolution `conv`, decided by shape before the
    launch: the one router (the
    wrappers pass it to the kernel's entry, which runs no other; the
    tests call it on the CPU).  `aligned`: the operands as the kernel
    reads them start 16-byte aligned.

    - dense (`conv` None): "igemm_wgmma" where K is a multiple of 16,
      else "igemm_kernel<0>" (bytes gathered through registers);
    - a convolution, `conv` = (C, groups, (kh, kw), stride, pad): where
      `conv_nhwc(C, groups)`, "igemm_wgmma"
      for a pointwise one (1 x 1, stride 1, no padding, one group: the
      dense product of the NHWC rows, written NCHW), "igemm_conv_wgmma"
      for any other of one group, "igemm_kernel<2>" for more groups;
      else "igemm_kernel<1>" (ResNet's stem, groups of few channels).
    """
    if conv is None:
        return "igemm_wgmma" if K > 0 and K % 16 == 0 and aligned \
            else "igemm_kernel<0>"
    C, groups, kernel, stride, pad = conv
    if not (conv_nhwc(C, groups) and aligned):
        return "igemm_kernel<1>"
    if groups > 1:
        return "igemm_kernel<2>"
    if tuple(kernel) == (1, 1) and tuple(stride) == (1, 1) and \
            tuple(pad) == (0, 0):
        return "igemm_wgmma"
    return "igemm_conv_wgmma"


def _f32(v, device):
    """A 0-d float32 of `v` on `device`, filled there (no host copy that
    would wait for the card)."""
    return torch.full((), v, dtype=torch.float32, device=device)


# max(amax, 1e-12) / denom as the JAX package computes it: XLA folds a
# division by a constant into a multiplication by its float32 reciprocal
# where amax is a run-time value, and folds the whole expression (a true
# division) where amax is a constant of the trace (a static threshold)
_RECIP = {INT8_MAX: float(_np.float32(1) / _np.float32(INT8_MAX)),
          INT32_MAX: float(_np.float32(1) / _np.float32(INT32_MAX))}


def _runtime_scale(amax, denom=INT8_MAX):
    return torch.clamp_min(amax.to(torch.float32), 1e-12) * _RECIP[denom]


def _static_scale(threshold):
    return float(_np.maximum(_np.float32(threshold), _np.float32(1e-12))
                 / _np.float32(INT8_MAX))


def _sym_scale(mn, mx):
    """Symmetric per-tensor scale from a (min, max) range pair."""
    return _runtime_scale(torch.maximum(torch.abs(mn), torch.abs(mx)))


# ---------------------------------------------------------------------
# the kernels' wrappers and their plain versions
# ---------------------------------------------------------------------

_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
_IN_KIND = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def quantize_plain(x, threshold=None):
    """Activation -> int8, as the JAX `_quantize_act`: (q, scale, amax)
    with scale = max(amax, 1e-12) / 127 (as XLA computes it: a true
    division for a static `threshold`, a multiplication by 1/127 for
    amax = max|x|), both 0-d float32."""
    if threshold is not None:
        amax = _f32(threshold, x.device)
        scale = _f32(_static_scale(threshold), x.device)
    else:
        amax = torch.amax(torch.abs(x)).to(torch.float32)
        scale = _runtime_scale(amax)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale),
                    -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale, amax


def int8_quantize(x, threshold=None, channels_last=False):
    """`quantize_plain` through the kernel on a CUDA tensor: one pass
    with a static threshold, an absolute-max pass (an atomic max on the
    float's bits) and the pass with a dynamic one.  x is float32 or
    bfloat16.  `channels_last` (a 4-D x): q is laid out (B, H, W, C)
    under its (B, C, H, W) shape, as `int8_conv`'s NHWC form reads it;
    the values are the same."""
    x = x.detach()

    def launch():
        if x.dtype not in _IN_KIND:
            raise MXNetError(f"int8_quantize: float32 or bfloat16 input, "
                             f"got {x.dtype}")
        xc = x.contiguous()
        nhwc = channels_last and xc.ndim == 4 and conv_nhwc(xc.shape[1])
        q = torch.empty(xc.shape, dtype=torch.int8, device=x.device,
                        memory_format=torch.channels_last if nhwc
                        else torch.contiguous_format)
        C, HW = (xc.shape[1], xc.shape[2] * xc.shape[3]) if nhwc else (0, 0)
        # [scale, amax] in one allocation; with a dynamic scale amax holds
        # the atomic max's float bits and starts from 0, with a static
        # one the kernel writes the threshold there
        dynamic = threshold is None
        pair = (torch.zeros if dynamic else torch.empty)(
            2, dtype=torch.float32, device=x.device)
        scale, amax = pair[0], pair[1]
        thr = 0.0 if dynamic else float(_np.float32(threshold))
        fn = entry("int8_gemm", "int8_quantize",
                   [_P, _I, ctypes.c_longlong, _P, _P, ctypes.c_float, _I,
                    _P, _I, _I, _P])
        _launched("int8_quantize", fn(
            xc.data_ptr(), _IN_KIND[x.dtype], xc.numel(), q.data_ptr(),
            amax.data_ptr(), thr, int(dynamic), scale.data_ptr(), C, HW,
            stream(x)))
        return q, scale, amax
    return route("int8_quantize", x, launch,
                 lambda: quantize_plain(x, threshold))


def _epilogue_plain(acc, ch_shape, bias_i32, x_scale, w_scale, bias,
                    relu, out_dtype):
    if out_dtype == torch.int32:
        if bias_i32 is not None:
            acc = acc + bias_i32.reshape(ch_shape)
        return acc
    out = acc.to(torch.float32) * (x_scale * w_scale).reshape(ch_shape)
    if bias is not None:
        out = out + bias.to(torch.float32).reshape(ch_shape)
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out.to(out_dtype)


def igemm_plain(q, w, conv=None, bias_i32=None, x_scale=None,
                w_scale=None, bias=None, relu=False,
                out_dtype=torch.int32):
    """The int8 product in float64, exact: dense (q [..., K] against
    w [N, K]) or, with `conv` = (stride, pad, dilate, groups), an
    N-d convolution (q NC..., w OI...).  Then either epilogue (i), int32
    plus `bias_i32` over the channels, or (ii), `acc * (x_scale *
    w_scale) + bias`, relu when asked, cast to `out_dtype`."""
    if conv is None:
        acc = torch.matmul(q.to(torch.float64), w.to(torch.float64).t())
        ch_shape = (-1,)
    else:
        stride, pad, dilate, groups = conv
        nd = q.ndim - 2
        fn = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
        acc = fn(q.to(torch.float64), w.to(torch.float64), None,
                 tuple(stride), tuple(pad), tuple(dilate), groups)
        ch_shape = (1, -1) + (1,) * nd
    return _epilogue_plain(acc.to(torch.int32), ch_shape, bias_i32,
                           x_scale, w_scale, bias, relu, out_dtype)


def _epilogue_args(out_dtype, bias_i32, x_scale, w_scale, bias, n_out):
    """The kernel's epilogue pointers: int32 bias, or float32 scales and
    bias (a bias of another dtype is widened first, as the JAX op does)."""
    if out_dtype not in _OUT_KIND:
        raise MXNetError(f"int8_igemm: output int32, float32 or bfloat16, "
                         f"got {out_dtype}")
    keep = []

    def ptr(t, dtype):
        if t is None:
            return None
        if t.dtype != dtype or not t.is_contiguous():
            t = t.detach().to(dtype).contiguous()
        if t.numel() != n_out:
            raise MXNetError(f"int8_igemm: a per-channel vector of "
                             f"{t.numel()}, expected {n_out}")
        keep.append(t)
        return t.data_ptr()
    if out_dtype == torch.int32:
        return keep, (ptr(bias_i32, torch.int32), None, None, None)
    if x_scale is None or w_scale is None:
        raise MXNetError("int8_igemm: the float epilogue needs x_scale "
                         "and w_scale")
    xs = x_scale
    if xs.numel() != 1:
        raise MXNetError(f"int8_igemm: x_scale of {xs.numel()} values")
    if xs.dtype != torch.float32 or not xs.is_contiguous():
        xs = xs.detach().to(torch.float32).contiguous()
    keep.append(xs)
    return keep, (None, ptr(bias, torch.float32), xs.data_ptr(),
                  ptr(w_scale, torch.float32))


def _int8_operands(name, q, w, channels_last=False):
    """q and w contiguous (a 4-D q laid out channels-last stays so where
    `channels_last`)."""
    if q.dtype != torch.int8 or w.dtype != torch.int8:
        raise MXNetError(f"{name}: int8 operands, got {q.dtype}, {w.dtype}")
    if q.device != w.device:
        raise MXNetError(f"{name}: operands on {q.device} and {w.device}")
    keep = channels_last and q.ndim == 4 and \
        q.is_contiguous(memory_format=torch.channels_last)
    return (q if keep else q.contiguous()), w.contiguous()


def int8_dense(q, w, bias_i32=None, x_scale=None, w_scale=None, bias=None,
               relu=False, out_dtype=torch.int32):
    """q [..., K] int8 against w [N, K] int8 -> [..., N] through the
    kernel's dense form on a CUDA tensor (`igemm_plain` otherwise)."""
    q, w = q.detach(), w.detach()

    def launch():
        qc, wc = _int8_operands("int8_igemm", q, w)
        K = qc.shape[-1]
        N = wc.shape[0]
        if wc.ndim != 2 or wc.shape[1] != K:
            raise MXNetError(f"int8_igemm: weight {tuple(wc.shape)} against "
                             f"data {tuple(qc.shape)}")
        M = qc.numel() // K if K else 0
        out = torch.empty(qc.shape[:-1] + (N,), dtype=out_dtype,
                          device=q.device)
        keep, (bi, bf, xs, ws) = _epilogue_args(
            out_dtype, bias_i32, x_scale, w_scale, bias, N)
        if out.numel() == 0:
            return out
        form = igemm_form(K, aligned=qc.data_ptr() % 16 == 0
                          and wc.data_ptr() % 16 == 0)
        fn = entry("int8_gemm", "int8_igemm_dense",
                   [_P] * 3 + [_I] * 4 + [_P] * 4 + [_I] * 2 + [_P])
        _launched("int8_igemm", fn(
            qc.data_ptr(), wc.data_ptr(), out.data_ptr(), M, N, K,
            _OUT_KIND[out_dtype], bi, bf, xs, ws, int(bool(relu)),
            IGEMM_FORMS.index(form), stream(q)), form)
        del keep
        return out
    return route("int8_igemm", q, launch, lambda: igemm_plain(
        q, w, None, bias_i32, x_scale, w_scale, bias, relu, out_dtype))


def conv_nhwc(channels, groups=1):
    """Whether `int8_conv` takes its NHWC form for data of `channels`
    channels in `groups` groups, the one place that decides it: each
    group's channels a multiple of 16, whose 16-byte chunks the kernel
    loads whole.  A caller that quantizes for such a convolution asks
    `int8_quantize` for q channels-last."""
    return channels % groups == 0 and channels // groups % 16 == 0


def _conv_out(size, k, s, p, d):
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def int8_conv(q, w, stride, pad, dilate, groups=1, bias_i32=None,
              x_scale=None, w_scale=None, bias=None, relu=False,
              out_dtype=torch.int32):
    """The int8 convolution of q (N, C, [H,] W) with w (O, C/groups,
    [kh,] kw) -> (N, O, [OH,] OW) through the kernel's implicit-GEMM form
    on a CUDA tensor (1-D as 2-D of height 1; 3-D has no kernel and
    raises there), `igemm_plain` otherwise."""
    q, w = q.detach(), w.detach()
    nd = q.ndim - 2
    stride, pad, dilate = (tuple(int(v) for v in t)
                           for t in (stride, pad, dilate))

    def launch():
        qc, wc = _int8_operands("int8_igemm", q, w, channels_last=True)
        if nd not in (1, 2):
            raise MXNetError(f"int8_igemm: {nd}-D convolution has no kernel")
        q4, w4 = (qc.unsqueeze(2), wc.unsqueeze(2)) if nd == 1 else (qc, wc)
        st, pd, dl = ((1,) + stride, (0,) + pad, (1,) + dilate) \
            if nd == 1 else (stride, pad, dilate)
        B, C, H, W = q4.shape
        O, Cg, kh, kw = w4.shape
        if C % groups or O % groups or Cg != C // groups:
            raise MXNetError(f"int8_igemm: weight {tuple(wc.shape)} against "
                             f"data {tuple(qc.shape)}, {groups} groups")
        OH = _conv_out(H, kh, st[0], pd[0], dl[0])
        OW = _conv_out(W, kw, st[1], pd[1], dl[1])
        out = torch.empty((B, O, OH, OW), dtype=out_dtype, device=q.device)
        keep, (bi, bf, xs, ws) = _epilogue_args(
            out_dtype, bias_i32, x_scale, w_scale, bias, O)
        if out.numel() == 0:
            return out.squeeze(2) if nd == 1 else out
        # NHWC data and OHWI weights; a pointwise one is the dense
        # product of the NHWC rows
        xr = q4.permute(0, 2, 3, 1).contiguous() \
            if conv_nhwc(C, groups) else q4   # a view where int8_quantize
        # wrote q channels-last
        form = igemm_form(conv=(C, groups, (kh, kw), st, pd),
                          aligned=xr.data_ptr() % 16 == 0
                          and wc.data_ptr() % 16 == 0)
        if form == "igemm_wgmma":
            fn = entry("int8_gemm", "int8_igemm_pointwise",
                       [_P] * 3 + [_I] * 5 + [_P] * 4 + [_I, _P])
            _launched("int8_igemm", fn(
                xr.data_ptr(), wc.data_ptr(), out.data_ptr(), B * H * W, O,
                C, H * W, _OUT_KIND[out_dtype], bi, bf, xs, ws,
                int(bool(relu)), stream(q)), form)
            del keep
            return out.squeeze(2) if nd == 1 else out
        nhwc = form != "igemm_kernel<1>"
        if nhwc:
            q4 = xr                                   # a view if NHWC
            w4 = w4.permute(0, 2, 3, 1).contiguous()
        elif not q4.is_contiguous():
            q4 = q4.contiguous()
        fn = entry("int8_gemm", "int8_igemm_conv",
                   [_P] * 3 + [_I] * 17 + [_P] * 4 + [_I] * 2 + [_P])
        _launched("int8_igemm", fn(
            q4.data_ptr(), w4.data_ptr(), out.data_ptr(), B, C, H, W, O,
            groups, kh, kw, st[0], st[1], pd[0], pd[1], dl[0], dl[1], OH,
            OW, _OUT_KIND[out_dtype], bi, bf, xs, ws, int(bool(relu)),
            IGEMM_FORMS.index(form), stream(q)), form)
        del keep
        return out.squeeze(2) if nd == 1 else out
    return route("int8_igemm", q, launch, lambda: igemm_plain(
        q, w, (stride, pad, dilate, groups), bias_i32, x_scale, w_scale,
        bias, relu, out_dtype))


# ---------------------------------------------------------------------
# the per-tensor ops
# ---------------------------------------------------------------------

@register("_contrib_quantize_v2", aliases=("quantize_v2",))
def quantize_v2(data, *, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """float -> (int8, min_range, max_range): the calibrated range when
    given, else the runtime absolute max."""
    if out_type != "int8":
        raise MXNetError("quantize_v2: only int8 supported")
    if min_calib_range is not None and max_calib_range is not None:
        mn32 = _np.float32(min_calib_range)
        mx32 = _np.float32(max_calib_range)
        q, _, _ = int8_quantize(data, max(abs(mn32), abs(mx32)))
        return q, _f32(mn32, data.device), _f32(mx32, data.device)
    q, _, mx = int8_quantize(data)
    return q, -mx, mx


@register("_contrib_dequantize", aliases=("dequantize",))
def dequantize(data, min_range, max_range, *, out_type="float32"):
    """(int8|int32, min, max) -> float32."""
    amax = torch.maximum(torch.abs(min_range), torch.abs(max_range))
    scale = _runtime_scale(
        amax, INT8_MAX if data.dtype == torch.int8 else INT32_MAX)
    return data.detach().to(torch.float32) * scale


@register("_contrib_requantize", aliases=("requantize",))
def requantize(data, min_range, max_range, *, min_calib_range=None,
               max_calib_range=None, out_type="int8"):
    """int32 accumulator -> int8 with the calibrated or runtime range."""
    f = dequantize(data, min_range, max_range)
    return quantize_v2(f, min_calib_range=min_calib_range,
                       max_calib_range=max_calib_range)


def _int32_range_outputs(min_d, max_d, min_w, max_w):
    """The (min, max) of an int32 accumulator: the range a full-scale
    int32 maps back to under scale_d * scale_w."""
    scale = _sym_scale(min_d, max_d) * _sym_scale(min_w, max_w)
    amax = scale * _f32(INT32_MAX, scale.device)
    return -amax, amax


def _bias_i32(bias, min_bias, max_bias, out_scale):
    """The int8 bias rescaled into the accumulator's domain, as the JAX
    op does before its add: round(bias * scale_b / out_scale)."""
    if bias is None:
        return None
    bias_f = bias.detach().to(torch.float32) * _sym_scale(min_bias, max_bias)
    return torch.round(bias_f / out_scale).to(torch.int32)


def _conv_geometry(kernel, stride, dilate, pad):
    nd = len(kernel)
    return (tuple(stride) if stride else (1,) * nd,
            tuple(pad) if pad else (0,) * nd,
            tuple(dilate) if dilate else (1,) * nd)


@register("_contrib_quantized_conv", aliases=("quantized_conv",))
def quantized_conv(data, weight, bias=None, min_data=None, max_data=None,
                   min_weight=None, max_weight=None, min_bias=None,
                   max_bias=None, *, kernel=(), stride=(), dilate=(), pad=(),
                   num_filter=0, num_group=1, no_bias=True, layout=None):
    """int8 convolution -> int32 accumulator + range outputs; an int8
    bias is rescaled into the accumulator's domain."""
    stride, pad, dilate = _conv_geometry(kernel, stride, dilate, pad)
    out_scale = _sym_scale(min_data, max_data) * _sym_scale(min_weight,
                                                            max_weight)
    out = int8_conv(data, weight, stride, pad, dilate, num_group,
                    bias_i32=_bias_i32(bias, min_bias, max_bias, out_scale))
    mn, mx = _int32_range_outputs(min_data, max_data, min_weight, max_weight)
    return out, mn, mx


@register("_contrib_quantized_fully_connected",
          aliases=("quantized_fully_connected",))
def quantized_fully_connected(data, weight, bias=None, min_data=None,
                              max_data=None, min_weight=None, max_weight=None,
                              min_bias=None, max_bias=None, *, num_hidden=0,
                              no_bias=True, flatten=True):
    """int8 matrix product -> int32 accumulator + range outputs."""
    if flatten and data.ndim > 2:
        data = torch.reshape(data, (data.shape[0], -1))
    out_scale = _sym_scale(min_data, max_data) * _sym_scale(min_weight,
                                                            max_weight)
    out = int8_dense(data, weight,
                     bias_i32=_bias_i32(bias, min_bias, max_bias, out_scale))
    mn, mx = _int32_range_outputs(min_data, max_data, min_weight, max_weight)
    return out, mn, mx


def _window(x, kernel, stride, pads, fill, reduce):
    """`reduce` ("max" or "sum") over windows of x (float, N C ...) after
    padding each spatial side with `fill`, as `lax.reduce_window` does;
    exact for int8 values (float32 max, float64 sums)."""
    nd = len(kernel)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    x = F.pad(x, flat, value=fill)
    if reduce == "max":
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1]
        return pool(x, kernel, stride)
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    C = x.shape[1]
    ones = torch.ones((C, 1) + tuple(kernel), dtype=x.dtype, device=x.device)
    return conv(x, ones, None, stride, 0, 1, C)


@register("_contrib_quantized_pooling", aliases=("quantized_pooling",))
def quantized_pooling(data, min_data, max_data, *, kernel=(), pool_type="max",
                      stride=(), pad=(), global_pool=False,
                      pooling_convention="valid", count_include_pad=True,
                      layout=None):
    """Pooling on int8 values; the ranges pass through.  The max window
    starts at -128; avg sums in integers and divides by the window, or
    by its count of real elements under `count_include_pad=False`;
    `pooling_convention="full"` pads the right edge as ceil mode does."""
    data = data.detach()
    nd = data.ndim - 2
    if global_pool:
        axes = tuple(range(2, data.ndim))
        if pool_type == "max":
            out = torch.amax(data.to(torch.float32), dim=axes, keepdim=True)
            return out.to(torch.int8), min_data, max_data
        out = torch.round(torch.mean(data.to(torch.float32), dim=axes,
                                     keepdim=True)).to(torch.int8)
        return out, min_data, max_data
    kernel = tuple(kernel)
    stride = tuple(stride) if stride else (1,) * nd
    pad = tuple(pad) if pad else (0,) * nd
    pads = [(p, p) for p in pad]
    if pooling_convention == "full":
        pads = []
        for i, (k, s, p) in enumerate(zip(kernel, stride, pad)):
            size = data.shape[2 + i]
            out_full = -(-(size + 2 * p - k) // s) + 1
            needed = (out_full - 1) * s + k - size - p
            pads.append((p, max(p, needed)))
    if pool_type == "max":
        out = _window(data.to(torch.float32), kernel, stride, pads, -128.0,
                      "max")
        return out.to(torch.int8), min_data, max_data
    if pool_type != "avg":
        raise MXNetError(f"quantized_pooling: pool_type {pool_type}")
    summed = _window(data.to(torch.float64), kernel, stride, pads, 0.0,
                     "sum")
    if count_include_pad:
        denom = 1
        for k in kernel:
            denom *= k
        denom = _f32(denom, data.device)
    else:
        ones = torch.ones((1, 1) + data.shape[2:], dtype=torch.float64,
                          device=data.device)
        denom = _window(ones, kernel, stride, pads, 0.0, "sum") \
            .to(torch.float32)
    out = torch.round(summed.to(torch.float32) / denom).to(torch.int8)
    return out, min_data, max_data


@register("_contrib_quantized_act", aliases=("quantized_act",))
def quantized_act(data, min_data, max_data, *, act_type="relu"):
    """ReLU on int8."""
    if act_type != "relu":
        raise MXNetError("quantized_act: only relu")
    return torch.clamp_min(data.detach(), 0), min_data, max_data


@register("_contrib_quantized_flatten", aliases=("quantized_flatten",))
def quantized_flatten(data, min_data, max_data):
    return torch.reshape(data.detach(), (data.shape[0], -1)), min_data, \
        max_data


# ---------------------------------------------------------------------
# the fused per-channel ops: quantize_net's layers
# ---------------------------------------------------------------------

@register("_quantized_conv_pc")
def quantized_conv_pc(data, q_weight, w_scale, bias=None, *, kernel=(),
                      stride=(), dilate=(), pad=(), num_group=1,
                      act_threshold=None, relu=False):
    """Fused int8 convolution with per-output-channel weight scales:
    activation -> int8, int8 x int8 -> int32, x_scale * w_scale, + bias,
    relu; the output in the input's dtype."""
    stride, pad, dilate = _conv_geometry(kernel, stride, dilate, pad)
    q, x_scale, _ = int8_quantize(
        data, act_threshold,
        channels_last=data.ndim == 4 and conv_nhwc(data.shape[1], num_group))
    return int8_conv(q, q_weight, stride, pad, dilate, num_group,
                     x_scale=x_scale, w_scale=w_scale, bias=bias,
                     relu=relu, out_dtype=data.dtype)


@register("_quantized_dense_pc")
def quantized_dense_pc(data, q_weight, w_scale, bias=None, *,
                       act_threshold=None, flatten=True, relu=False):
    """Fused int8 dense with per-output-channel weight scales."""
    if flatten and data.ndim > 2:
        data = torch.reshape(data, (data.shape[0], -1))
    q, x_scale, _ = int8_quantize(data, act_threshold)
    return int8_dense(q, q_weight, x_scale=x_scale, w_scale=w_scale,
                      bias=bias, relu=relu, out_dtype=data.dtype)
