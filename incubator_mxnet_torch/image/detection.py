"""Detection augmenters, which transform the image and its boxes
together, and `ImageDetIter` (counterpart of
`incubator_mxnet_tpu/image/detection.py`).

Labels are (N, 5+) rows [cls, x1, y1, x2, y2, ...] with coordinates
normalized to [0, 1].  The augmenters draw from the framework's numpy
RandomState (`random.np_rng()`), so `mx.random.seed` reproduces them and
the same seed gives the JAX package's crops and flips.
"""
from __future__ import annotations

import numpy as _np

from ..base import MXNetError
from ..random import np_rng as _frng
from . import image as _img

__all__ = ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Base: __call__(src, label) -> (src, label)."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only augmenter (geometry-preserving ones only)."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if _frng().uniform() < self.p:
            src = src[:, ::-1]
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping enough box overlap (simplified constraint
    set: min_object_covered + aspect/area ranges, retries).  `p` is the
    crop probability (`CreateDetAugmenter`'s rand_crop)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), max_attempts=50, p=1.0):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.p = p

    def __call__(self, src, label):
        if _frng().uniform() >= self.p:
            return src, label
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            area = _frng().uniform(*self.area_range) * h * w
            ar = _frng().uniform(*self.aspect_ratio_range)
            cw = int(round((area * ar) ** 0.5))
            ch = int(round((area / ar) ** 0.5))
            if cw > w or ch > h or cw < 1 or ch < 1:
                continue
            x0 = _frng().randint(0, w - cw + 1)
            y0 = _frng().randint(0, h - ch + 1)
            new_label = self._update_labels(label, (x0 / w, y0 / h,
                                                    (x0 + cw) / w,
                                                    (y0 + ch) / h))
            if new_label is not None:
                return src[y0:y0 + ch, x0:x0 + cw], new_label
        return src, label

    def _update_labels(self, label, crop):
        cx1, cy1, cx2, cy2 = crop
        out = []
        for row in label:
            x1, y1, x2, y2 = row[1:5]
            ix1, iy1 = max(x1, cx1), max(y1, cy1)
            ix2, iy2 = min(x2, cx2), min(y2, cy2)
            inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
            area = (x2 - x1) * (y2 - y1)
            if area <= 0 or inter / area < self.min_object_covered:
                continue
            nw, nh = cx2 - cx1, cy2 - cy1
            nr = row.copy()
            nr[1] = (ix1 - cx1) / nw
            nr[2] = (iy1 - cy1) / nh
            nr[3] = (ix2 - cx1) / nw
            nr[4] = (iy2 - cy1) / nh
            out.append(nr)
        if not out:
            return None
        return _np.stack(out)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_mirror=False,
                       mean=None, std=None, brightness=0, contrast=0,
                       saturation=0, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 1.0), max_attempts=50,
                       inter_method=2):
    """Standard augmenter list (resize, crop, mirror, force-resize, color jitter, normalize)."""
    augs = []
    if resize > 0:
        augs.append(DetBorrowAug(_img.ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        # rand_crop is the probability of a crop
        augs.append(DetRandomCropAug(min_object_covered,
                                     aspect_ratio_range, area_range,
                                     max_attempts, p=float(rand_crop)))
    if rand_mirror:
        augs.append(DetHorizontalFlipAug(0.5))
    augs.append(DetBorrowAug(_img.ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    if brightness or contrast or saturation:
        augs.append(DetBorrowAug(_img.ColorJitterAug(
            brightness, contrast, saturation)))
    if mean is True:      # True: the ImageNet statistics
        mean = _np.array([123.68, 116.28, 103.53], _np.float32)
    if std is True:
        std = _np.array([58.395, 57.12, 57.375], _np.float32)
    if mean is not None:
        augs.append(DetBorrowAug(_img.CastAug()))
        _mean = _np.asarray(mean, _np.float32)
        _std = _np.asarray(std, _np.float32) if std is not None else None

        class _NormAug(_img.Augmenter):
            def __call__(self, src):
                return _img.color_normalize(src, _mean, _std)
        augs.append(DetBorrowAug(_NormAug()))
    return augs


class ImageDetIter:
    """Detection batches from in-memory (img, label) pairs.  Yields data
    (B, C, H, W) float32 and labels (B, M, 5+) padded with -1 rows to the
    largest box count, in the current context."""

    def __init__(self, batch_size, data_shape, imglist=None,
                 augmenters=None, max_boxes=None, shuffle=False,
                 data_name="data", label_name="label"):
        if imglist is None:
            raise MXNetError("ImageDetIter needs imglist "
                             "[(img_array, label_rows), ...]")
        self.batch_size = batch_size
        self.data_shape = data_shape
        self._augs = augmenters or []
        self._shuffle = shuffle
        # Parse once: each item's labels to 2D with its OWN width (flat
        # lists use the 5-column convention), then pad columns with -1
        # to the global width — fixed label shape across ALL batches.
        parsed = []
        for img, lab in imglist:
            a = _np.asarray(lab, _np.float32)
            if a.ndim == 1:
                a = a.reshape(-1, 5)
            elif a.ndim != 2:
                raise MXNetError("ImageDetIter labels must be (N, 5+)")
            parsed.append((img, a))
        self._label_width = max((a.shape[1] for _, a in parsed),
                                default=5)
        self._items = [
            (img, _np.concatenate(
                [a, _np.full((a.shape[0], self._label_width - a.shape[1]),
                             -1.0, _np.float32)], axis=1)
             if a.shape[1] < self._label_width else a)
            for img, a in parsed]
        self._max_boxes = max_boxes or max(
            (a.shape[0] for _, a in self._items), default=1)
        self._cursor = 0
        self._order = _np.arange(len(self._items))

    def reset(self):
        self._cursor = 0
        if self._shuffle:
            _frng().shuffle(self._order)

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        from ..io.io import DataBatch
        from ..ndarray import array
        if self._cursor >= len(self._items):
            raise StopIteration
        idx = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        imgs, labels = [], []
        for i in idx:
            img, lab = self._items[i]
            img = _np.asarray(img)
            for aug in self._augs:
                img, lab = aug(img, lab)
            imgs.append(_np.transpose(img, (2, 0, 1)))
            labels.append(lab)
        pad = self.batch_size - len(imgs)
        for _ in range(pad):          # full-size batch; last `pad`
            imgs.append(imgs[-1])     # entries are filler (DataBatch
            labels.append(labels[-1])  # pad contract)
        maxm, lw = self._max_boxes, self._label_width
        out_lab = _np.full((len(labels), maxm, lw), -1.0, _np.float32)
        for i, l in enumerate(labels):
            out_lab[i, :min(maxm, l.shape[0])] = l[:maxm]
        data = _np.stack(imgs).astype(_np.float32)
        return DataBatch(data=[array(data)], label=[array(out_lab)],
                         pad=pad)

    next = __next__
