"""Image decode, resize, augment and iterate (counterpart of
`incubator_mxnet_tpu/image/image.py`).  Arrays are HWC numpy.

`imdecode` reads JPEG, PNG and BMP through the port's own codecs
(`image/codec.py`), as the JAX package reads them through PIL.

`imresize` of uint8 data computes what PIL's ``Image.resize`` computes
(the JAX package resizes through PIL), in numpy with integer arithmetic:
for bilinear, bicubic, box and Lanczos the separable passes of PIL's
Resample.c, horizontal then vertical, with the filter's support widened
by the scale when downscaling, each output's weights normalized and then
made fixed point with PIL's PRECISION_BITS (32 - 8 - 2), the sums
rounded and clipped to uint8 after each pass; RGBA and LA images are
premultiplied by alpha around the passes as PIL does.  Nearest takes
PIL's affine index tables.  Other dtypes are resized in float32 without
quantizing, with the resampling `jax.image.resize` does: separable
weights from a triangle (linear), Keys cubic (a = -0.5) or Lanczos-3
kernel on half-pixel centres, widened by the scale when downscaling,
each output column normalized to sum 1; nearest takes input index
floor((i + 0.5) * in / out).

The Augmenters, `random_crop` and `ImageIter` draw from Python's `random`
module and `np.random.RandomState(seed)` as the JAX package's do, so the
same seeds give the same crops, flips and orders.
"""
from __future__ import annotations

import math
import os
import random as _random
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as _np

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray import array
from . import codec as _codec

__all__ = ["imdecode", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize", "Augmenter",
           "ResizeAug", "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "HorizontalFlipAug", "CastAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "ColorJitterAug",
           "NormalizeAug", "CreateAugmenter", "ImageIter"]


def imdecode(buf, to_rgb=1, flag=1):
    """JPEG, PNG or BMP bytes -> HWC uint8: 3 channels (RGB), or 1 with
    `flag=0`."""
    return _codec.decode(buf, channels=1 if not flag else 3)


# ---------------------------------------------------------------------------
# resizing
# ---------------------------------------------------------------------------

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


# PIL's Resample.c filters: (function, support)

def _pil_box(x):
    return 1.0 if -0.5 < x <= 0.5 else 0.0


def _pil_bilinear(x):
    x = -x if x < 0.0 else x
    return 1.0 - x if x < 1.0 else 0.0


def _pil_bicubic(x):
    a = -0.5
    x = -x if x < 0.0 else x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x):
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _pil_lanczos(x):
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


_PIL_FILTERS = {1: (_pil_bilinear, 1.0), 2: (_pil_bicubic, 2.0),
                3: (_pil_box, 0.5), 4: (_pil_lanczos, 3.0)}
_PRECISION_BITS = 32 - 8 - 2


def _pil_coeffs(n_in, n_out, filt, support):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc: (first index,
    fixed-point weights (n_out, ksize)) of one axis."""
    scale = float(n_in) / n_out
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = _np.zeros(n_out, _np.int64)
    kk = _np.zeros((n_out, ksize), _np.int64)
    ss = 1.0 / filterscale
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        k = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        if ww != 0.0:
            k = [v / ww for v in k]
        first[xx] = xmin
        kk[xx, :xmax] = [int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0
                         else int(0.5 + v * (1 << _PRECISION_BITS))
                         for v in k]
    return first, kk


def _pil_pass(a, n_out, axis, filt, support):
    """One separable pass of uint8 (H, W, C) along `axis` (0 or 1)."""
    n_in = a.shape[axis]
    first, kk = _pil_coeffs(n_in, n_out, filt, support)
    idx = _np.minimum(first[:, None] + _np.arange(kk.shape[1]), n_in - 1)
    src = _np.moveaxis(a, axis, 0).astype(_np.int64)       # (n_in, ., C)
    acc = _np.einsum("okx,ok->ox", src[idx].reshape(n_out, kk.shape[1], -1),
                     kk)
    acc = (acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS
    out = _np.clip(acc, 0, 255).astype(_np.uint8)
    shape = (n_out,) + tuple(_np.moveaxis(a, axis, 0).shape[1:])
    return _np.moveaxis(out.reshape(shape), 0, axis)


def _pil_nearest(a, w, h):
    """PIL's ImagingScaleAffine index tables (the positions accumulate
    in double precision, as PIL's do)."""
    def table(n_in, n_out):
        step = float(n_in) / n_out
        pos, out = step * 0.5, []
        for _ in range(n_out):
            out.append(min(max(-1 if pos < 0.0 else int(pos), 0), n_in - 1))
            pos += step
        return _np.asarray(out, _np.int64)
    return a[table(a.shape[0], h)][:, table(a.shape[1], w)]


def _premultiply(a):
    """RGBA -> RGBa (PIL's MULDIV255)."""
    alpha = a[..., -1:].astype(_np.uint32)
    tmp = a[..., :-1].astype(_np.uint32) * alpha + 128
    color = ((tmp >> 8) + tmp) >> 8
    return _np.concatenate([color.astype(_np.uint8), a[..., -1:]], axis=-1)


def _unpremultiply(a):
    """RGBa -> RGBA: 255 * c // alpha clipped, alpha 0 and 255 kept."""
    alpha = a[..., -1:].astype(_np.int64)
    color = a[..., :-1].astype(_np.int64)
    div = _np.clip(255 * color // _np.maximum(alpha, 1), 0, 255)
    keep = (alpha == 0) | (alpha == 255)
    color = _np.where(keep, color, div).astype(_np.uint8)
    return _np.concatenate([color, a[..., -1:]], axis=-1)


def _pil_resize(a, w, h, interp):
    """uint8 (H, W, C), C in 1..4, as PIL's Image.resize((w, h))."""
    if (a.shape[1], a.shape[0]) == (w, h):
        return a.copy()
    if interp == 0:
        return _pil_nearest(a, w, h)
    filt, support = _PIL_FILTERS.get(interp, _PIL_FILTERS[2])
    alpha = a.shape[2] in (2, 4)
    if alpha:
        a = _premultiply(a)
    if a.shape[1] != w:
        a = _pil_pass(a, w, 1, filt, support)
    if a.shape[0] != h:
        a = _pil_pass(a, h, 0, filt, support)
    return _unpremultiply(a) if alpha else a


def imresize(src, w, h, interp=2):
    """`src` (HWC, or HW) resized to width `w` and height `h`."""
    a = _np.asarray(src)
    squeeze = a.ndim == 2
    if squeeze:
        a = a[:, :, None]
    if a.dtype == _np.uint8:
        if a.shape[2] > 4:
            raise MXNetError(f"imresize of uint8 takes 1 to 4 channels, "
                             f"not {a.shape[2]}")
        out = _pil_resize(a, int(w), int(h), interp)
    else:
        out = _resize_float(a.astype(_np.float32), h, w,
                            _METHODS.get(interp, "cubic"))
        out = out.astype(a.dtype, copy=False)
    return out[:, :, 0:1] if squeeze else out


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


# ---------------------------------------------------------------------------
# augmenters
# ---------------------------------------------------------------------------

class Augmenter:
    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src):
        if _random.random() < self.p:
            return src[:, ::-1]
        return src


class CastAug(Augmenter):
    def __init__(self, dtype="float32"):
        self.dtype = dtype

    def __call__(self, src):
        return src.astype(self.dtype)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _random.uniform(-self.brightness, self.brightness)
        return src.astype(_np.float32) * alpha


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _random.uniform(-self.contrast, self.contrast)
        gray = src.astype(_np.float32).mean()
        return src.astype(_np.float32) * alpha + gray * (1 - alpha)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _random.uniform(-self.saturation, self.saturation)
        coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)
        gray = (src.astype(_np.float32) * coef).sum(2, keepdims=True)
        return src.astype(_np.float32) * alpha + gray * (1 - alpha)


class ColorJitterAug(Augmenter):
    def __init__(self, brightness=0, contrast=0, saturation=0):
        self.augs = []
        if brightness:
            self.augs.append(BrightnessJitterAug(brightness))
        if contrast:
            self.augs.append(ContrastJitterAug(contrast))
        if saturation:
            self.augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        augs = list(self.augs)
        _random.shuffle(augs)
        for a in augs:
            src = a(src)
        return src


class NormalizeAug(Augmenter):
    def __init__(self, mean, std):
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, inter_method=2):
    """The standard augmenter list: resize, crop, mirror, color jitter,
    cast, normalize (`mean`/`std` True take the ImageNet statistics)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    auglist.append(CastAug())
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53], _np.float32)
    if std is True:
        std = _np.array([58.395, 57.12, 57.375], _np.float32)
    if mean is not None:
        auglist.append(NormalizeAug(_np.asarray(mean, _np.float32),
                                    _np.asarray(std, _np.float32)
                                    if std is not None else None))
    return auglist


# ---------------------------------------------------------------------------
# ImageIter
# ---------------------------------------------------------------------------

class ImageIter(DataIter):
    """Image batches from a `.rec` shard (with or without its `.idx`), a
    `.lst` file or an `imglist`.  Decode and augment run on a pool of
    `preprocess_threads` threads; a batch is NCHW float32, staged in a
    numpy buffer and made an NDArray in the current context.
    `part_index`/`num_parts` take one contiguous part of the records;
    `shuffle` reorders them with `np.random.RandomState(seed)` at every
    reset."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 preprocess_threads=4, seed=0, **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (C, H, W)")
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._data_name = data_name
        self._label_name = label_name
        self._shuffle = shuffle
        self._rng = _np.random.RandomState(seed)
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{k: v for k, v in kwargs.items()
                                           if k in ("resize", "rand_crop",
                                                    "rand_mirror", "mean",
                                                    "std", "brightness",
                                                    "contrast",
                                                    "saturation")})
        self._record = None
        self._offsets = None
        self._imglist = None
        if path_imgrec:
            from ..recordio import MXIndexedRecordIO, MXRecordIO
            idx_path = kwargs.get("path_imgidx") or \
                os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                self._record = MXIndexedRecordIO(idx_path, path_imgrec, "r")
                keys = list(self._record.keys)
            else:
                # one sequential scan for the record offsets
                rec = MXRecordIO(path_imgrec, "r")
                keys, offsets = [], []
                while True:
                    pos = rec.tell()
                    if rec.read() is None:
                        break
                    keys.append(len(keys))
                    offsets.append(pos)
                rec.close()
                self._record = MXRecordIO(path_imgrec, "r")
                self._offsets = dict(zip(keys, offsets))
        elif path_imglist or imglist is not None:
            entries = []
            if path_imglist:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        entries.append((float(parts[1]) if label_width == 1
                                        else [float(x) for x in
                                              parts[1:1 + label_width]],
                                        os.path.join(path_root, parts[-1])))
            else:
                for item in imglist:
                    entries.append((item[0], os.path.join(path_root,
                                                          item[-1])))
            self._imglist = entries
            keys = list(range(len(entries)))
        else:
            raise MXNetError("need path_imgrec, path_imglist, or imglist")
        n = len(keys)
        per = n // num_parts
        self._keys = keys[part_index * per:
                          (part_index + 1) * per if part_index
                          < num_parts - 1 else n]
        self._order = list(range(len(self._keys)))
        self._cursor = 0
        self._pool = ThreadPoolExecutor(max_workers=preprocess_threads)
        self._lock = threading.Lock()
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def _read_sample(self, i):
        from ..recordio import unpack_img
        key = self._keys[i]
        if self._record is not None:
            with self._lock:
                if self._offsets is not None:
                    self._record.seek(self._offsets[key])
                    raw = self._record.read()
                else:
                    raw = self._record.read_idx(key)
            hdr, img = unpack_img(raw)
            label = hdr.label
            if isinstance(label, _np.ndarray) and label.size == 1:
                label = float(label[0])
        else:
            label, path = self._imglist[i]
            with open(path, "rb") as f:
                img = imdecode(f.read())
        for aug in self.auglist:
            img = aug(img)
        return img.astype(_np.float32).transpose(2, 0, 1), label

    def next(self):
        if self._cursor + self.batch_size > len(self._order):
            raise StopIteration
        idxs = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        results = list(self._pool.map(self._read_sample, idxs))
        data = _np.stack([r[0] for r in results])
        if self.label_width == 1:
            label = _np.array([r[1] for r in results], _np.float32)
        else:
            label = _np.stack([_np.asarray(r[1], _np.float32)
                               for r in results])
        return DataBatch([array(data)], [array(label)],
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
