"""Array helpers on HWC images (counterpart of the functions at the top
of `incubator_mxnet_tpu/image/image.py`): `imresize`, `resize_short`,
`fixed_crop`, `random_crop`, `center_crop` and `color_normalize`.  They
take and give numpy arrays.

`imresize` of uint8 data goes through PIL (imported when called), as in
the JAX package.  Other dtypes are resized in float32 without
quantizing, with the resampling `jax.image.resize` does: separable
weights from a triangle (linear), Keys cubic (a = -0.5) or Lanczos-3
kernel on half-pixel centres, widened by the scale when downscaling (the
antialias), each output column normalized to sum 1, built here in numpy
and applied as one product per axis; nearest takes input index
floor((i + 0.5) * in / out).  `random_crop` draws its corner from
Python's `random` module, as the JAX package's does.
"""
from __future__ import annotations

import random as _random

import numpy as _np

__all__ = ["imresize", "resize_short", "fixed_crop", "random_crop",
           "center_crop", "color_normalize"]

_METHODS = {0: "nearest", 1: "linear", 2: "cubic", 3: "linear",
            4: "lanczos3"}      # cv2's flags; 3 (area) resizes linearly


def _triangle(x):
    return _np.maximum(0, 1 - _np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = _np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return _np.where(x >= 2., 0., out)


def _lanczos3(x):
    radius = 3.
    with _np.errstate(divide="ignore", invalid="ignore"):
        y = radius * _np.sin(_np.pi * x) * _np.sin(_np.pi * x / radius)
        out = _np.where(x > 1e-3, y / _np.where(x != 0, _np.pi ** 2 * x ** 2,
                                                 1), 1)
    return _np.where(x > radius, 0., out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic,
            "lanczos3": _lanczos3}


def _weights(n_in, n_out, kernel):
    """(n_in, n_out) float32 resampling weights of one axis."""
    f32 = _np.float32
    inv_scale = f32(1.) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.))
    sample = (_np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = _np.abs(sample[None, :] - _np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = kernel(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = _np.where(_np.abs(total) > 1000. * float(_np.finfo(f32).eps),
                  w / _np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return _np.where(inside[None, :], w, 0).astype(f32)


def _resize_float(a, h, w, method):
    """(H, W, C) float32 -> (h, w, C) float32."""
    if method == "nearest":
        for axis, (n_in, n_out) in enumerate(((a.shape[0], h),
                                              (a.shape[1], w))):
            if n_in != n_out:
                idx = _np.floor(((_np.arange(n_out, dtype=_np.float32)
                                  + 0.5) * n_in / n_out).astype(_np.float32)
                                ).astype(_np.int32)
                a = _np.take(a, idx, axis=axis)
        return a
    kernel = _KERNELS[method]
    if a.shape[0] != h:
        a = _np.einsum("hwc,hH->Hwc", a, _weights(a.shape[0], h, kernel))
    if a.shape[1] != w:
        a = _np.einsum("hwc,wW->hWc", a, _weights(a.shape[1], w, kernel))
    return a


def imresize(src, w, h, interp=2):
    """`src` (HWC, or HW) resized to width `w` and height `h`."""
    a = _np.asarray(src)
    if a.dtype == _np.uint8:
        from PIL import Image
        img = Image.fromarray(a.squeeze() if a.shape[-1] == 1 else a)
        img = img.resize((w, h), _pil_filter(interp))
        out = _np.asarray(img)
        if out.ndim == 2:
            out = out[:, :, None]
        return out
    squeeze = a.ndim == 2
    if squeeze:
        a = a[:, :, None]
    out = _resize_float(a.astype(_np.float32), h, w,
                        _METHODS.get(interp, "cubic"))
    out = out.astype(a.dtype, copy=False)
    return out[:, :, 0:1] if squeeze else out


def _pil_filter(i):
    """cv2's flags as PIL filters: 0 nearest, 1 bilinear, 2 bicubic,
    3 area, 4 lanczos."""
    from PIL import Image
    return {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
            3: Image.BOX, 4: Image.LANCZOS}.get(i, Image.BICUBIC)


def resize_short(src, size, interp=2):
    """`src` resized so that its shorter edge is `size`."""
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, size * h // w
    else:
        new_w, new_h = size * w // h, size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    """A `size` = (w, h) crop at a random corner, and its (x0, y0, w, h);
    a smaller `src` is first resized up to fit."""
    h, w = src.shape[:2]
    tw, th = size
    if w < tw or h < th:
        src = imresize(src, max(w, tw), max(h, th), interp)
        h, w = src.shape[:2]
    x0 = _random.randint(0, w - tw)
    y0 = _random.randint(0, h - th)
    return fixed_crop(src, x0, y0, tw, th), (x0, y0, tw, th)


def center_crop(src, size, interp=2):
    """The centred `size` = (w, h) crop, and its (x0, y0, w, h)."""
    h, w = src.shape[:2]
    tw, th = size
    if w < tw or h < th:
        src = imresize(src, max(w, tw), max(h, th), interp)
        h, w = src.shape[:2]
    x0 = (w - tw) // 2
    y0 = (h - th) // 2
    return fixed_crop(src, x0, y0, tw, th), (x0, y0, tw, th)


def color_normalize(src, mean, std=None):
    src = src.astype(_np.float32) - mean
    if std is not None:
        src = src / std
    return src
