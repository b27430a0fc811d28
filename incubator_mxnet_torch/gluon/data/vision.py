"""Vision datasets and transforms (counterpart of
`incubator_mxnet_tpu/gluon/data/vision.py`).

There is no download: MNIST, FashionMNIST and CIFAR10 read their
standard files from a local directory and raise without them.
`SyntheticImageDataset` is deterministic learnable data made from a
seed.  Items and transform outputs are NDArrays made in the current
context; the DataLoader's workers make them under `cpu()`.  The random
transforms draw from the framework's numpy RandomState
(`random.np_rng()`), so `mx.random.seed(n)` gives the same crops, flips
and jitters as in the JAX package.  `ImageRecordDataset` (an im2rec
shard) and `ImageFolderDataset` (`root/<class>/<image>`) decode through
the port's `imdecode`.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as _np

from ...base import MXNetError
from ...image import (center_crop, fixed_crop, imdecode, imresize,
                      resize_short)
from ...ndarray import NDArray, array
from ...random import np_rng as _frng
from .dataset import Dataset, ArrayDataset, RecordFileDataset  # noqa: F401

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "SyntheticImageDataset",
           "ImageRecordDataset", "ImageFolderDataset", "transforms"]


class ImageRecordDataset(RecordFileDataset):
    """The images of an im2rec-packed `.rec` file (with its `.idx`).
    Items are (image NDArray HWC uint8, label float or float32 vector);
    `flag=0` decodes gray with a channel axis of 1."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ...recordio import unpack
        header, img_bytes = unpack(super().__getitem__(idx))
        img = array(imdecode(img_bytes, flag=self._flag))
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """The images under `root/<category>/`, in sorted order.  `synsets`
    lists the category names; an item's label is its category's index."""

    def __init__(self, root, flag=1, transform=None,
                 exts=(".jpg", ".jpeg", ".png")):
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith(tuple(exts)):
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        path, label = self.items[idx]
        with open(path, "rb") as f:
            img = array(imdecode(f.read(), flag=self._flag))
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        data = array(self._data[idx])
        if self._transform is not None:
            return self._transform(data, self._label[idx])
        return data, self._label[idx]


class MNIST(_DownloadedDataset):
    """MNIST from its local gzipped idx files."""

    _files = {
        True: ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
        False: ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
    }

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        img_f, lab_f = self._files[self._train]
        img_path = os.path.join(self._root, img_f)
        lab_path = os.path.join(self._root, lab_f)
        if not (os.path.exists(img_path) and os.path.exists(lab_path)):
            raise MXNetError(
                f"MNIST files not found under {self._root} and there is no "
                "download: place the idx files there, or use "
                "SyntheticImageDataset")
        with gzip.open(lab_path, "rb") as f:
            struct.unpack(">II", f.read(8))
            label = _np.frombuffer(f.read(), dtype=_np.uint8).astype(_np.int32)
        with gzip.open(img_path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = _np.frombuffer(f.read(), dtype=_np.uint8)
            data = data.reshape(n, rows, cols, 1)
        self._data = data
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                 if self._train else ["test_batch.bin"])
        data, labels = [], []
        for fname in files:
            path = os.path.join(self._root, fname)
            if not os.path.exists(path):
                raise MXNetError(
                    f"CIFAR10 binaries not found under {self._root} and "
                    "there is no download: place them there")
            raw = _np.fromfile(path, dtype=_np.uint8).reshape(-1, 3073)
            labels.append(raw[:, 0].astype(_np.int32))
            data.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                        .transpose(0, 2, 3, 1))
        self._data = _np.concatenate(data)
        self._label = _np.concatenate(labels)


class SyntheticImageDataset(Dataset):
    """Deterministic learnable classification data: each class is a fixed
    random template plus noise; item `idx` draws its noise from its own
    seed, so any worker makes the same item."""

    def __init__(self, num_samples=1024, shape=(1, 28, 28), num_classes=10,
                 noise=0.15, seed=0, template_seed=0, channels_last=False):
        trng = _np.random.RandomState(template_seed)
        self._templates = trng.uniform(0, 1, (num_classes,) + tuple(shape)) \
            .astype(_np.float32)
        rng = _np.random.RandomState(seed)
        self._labels = rng.randint(0, num_classes, num_samples) \
            .astype(_np.int32)
        self._noise = noise
        self._seed = seed
        self._shape = tuple(shape)
        self._channels_last = channels_last

    def __len__(self):
        return len(self._labels)

    def __getitem__(self, idx):
        label = self._labels[idx]
        rng = _np.random.RandomState(self._seed * 100003 + idx)
        img = self._templates[label] + rng.normal(
            0, self._noise, self._shape).astype(_np.float32)
        if self._channels_last:
            img = _np.moveaxis(img, 0, -1)
        return array(img), int(label)


def _luma(a):
    """BT.601 luma (the reference's gray for color jitter); keeps dims."""
    if a.ndim == 3 and a.shape[-1] == 3:
        return (a @ _np.array([0.299, 0.587, 0.114], _np.float32)
                )[..., None]
    return a.mean(axis=-1, keepdims=True)


class transforms:
    """Transforms: callables on one image NDArray."""

    class Compose:
        def __init__(self, transforms_list):
            self._ts = transforms_list

        def __call__(self, x):
            for t in self._ts:
                x = t(x)
            return x

    class ToTensor:
        """HWC uint8 [0, 255] to CHW float32 [0, 1]."""

        def __call__(self, x):
            data = x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)
            if data.ndim == 3:
                data = data.transpose(2, 0, 1)
            return array(data.astype(_np.float32) / 255.0)

    class Normalize:
        def __init__(self, mean=0.0, std=1.0):
            self._mean = _np.asarray(mean, dtype=_np.float32)
            self._std = _np.asarray(std, dtype=_np.float32)

        def __call__(self, x):
            data = x.asnumpy()
            mean, std = (v.reshape(-1, 1, 1) if v.ndim else v
                         for v in (self._mean, self._std))
            return array((data - mean) / std)

    class Cast:
        def __init__(self, dtype="float32"):
            self._dtype = dtype

        def __call__(self, x):
            return x.astype(self._dtype)

    # -- geometric and photometric transforms on HWC arrays ------------

    class _HWC:
        """Base: `_apply` is numpy HWC to numpy HWC; `__call__` converts
        once on the way in and out."""

        def _np_in(self, x):
            return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)

        def _out(self, a):
            return array(a)

        def __call__(self, x):
            return self._out(self._apply(self._np_in(x)))

    class Resize(_HWC):
        def __init__(self, size, keep_ratio=False, interpolation=1):
            self._size = (size, size) if isinstance(size, int) else size
            self._keep = keep_ratio
            self._interp = interpolation

        def _apply(self, a):
            w, h = self._size
            if self._keep:
                # the short edge becomes `size`
                return resize_short(a, min(w, h), self._interp)
            return imresize(a, w, h, self._interp)

    class CenterCrop(_HWC):
        def __init__(self, size, interpolation=1):
            self._size = (size, size) if isinstance(size, int) else size
            self._interp = interpolation

        def _apply(self, a):
            cropped, _bbox = center_crop(a, self._size, self._interp)
            return cropped

    class RandomResizedCrop(_HWC):
        def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                     interpolation=1):
            self._size = (size, size) if isinstance(size, int) else size
            self._scale = scale
            self._ratio = ratio
            self._interp = interpolation

        def _apply(self, a):
            h, w = a.shape[:2]
            for _ in range(10):
                area = _frng().uniform(*self._scale) * h * w
                ar = _frng().uniform(*self._ratio)
                cw = int(round((area * ar) ** 0.5))
                ch = int(round((area / ar) ** 0.5))
                if cw <= w and ch <= h and cw > 0 and ch > 0:
                    x0 = _frng().randint(0, w - cw + 1)
                    y0 = _frng().randint(0, h - ch + 1)
                    crop = fixed_crop(a, x0, y0, cw, ch)
                    return imresize(crop, *self._size, self._interp)
            return imresize(a, *self._size, self._interp)

    class RandomFlipLeftRight(_HWC):
        def __init__(self, p=0.5):
            self._p = p

        def _apply(self, a):
            if _frng().uniform() < self._p:
                a = a[:, ::-1].copy()
            return a

    class RandomFlipTopBottom(_HWC):
        def __init__(self, p=0.5):
            self._p = p

        def _apply(self, a):
            if _frng().uniform() < self._p:
                a = a[::-1].copy()
            return a

    class RandomBrightness(_HWC):
        def __init__(self, brightness):
            self._b = brightness

        def _apply(self, a):
            a = a.astype(_np.float32)
            f = 1.0 + _frng().uniform(-self._b, self._b)
            return a * f

    class RandomContrast(_HWC):
        def __init__(self, contrast):
            self._c = contrast

        def _apply(self, a):
            a = a.astype(_np.float32)
            f = 1.0 + _frng().uniform(-self._c, self._c)
            gray = _luma(a).mean()
            return gray + (a - gray) * f

    class RandomSaturation(_HWC):
        def __init__(self, saturation):
            self._s = saturation

        def _apply(self, a):
            a = a.astype(_np.float32)
            f = 1.0 + _frng().uniform(-self._s, self._s)
            gray = _luma(a)
            return gray + (a - gray) * f

    class RandomHue(_HWC):
        """Approximate hue jitter by a rotation mix of the channels."""

        def __init__(self, hue):
            self._h = hue

        def _apply(self, a):
            a = a.astype(_np.float32)
            f = _frng().uniform(-self._h, self._h)
            if a.ndim == 3 and a.shape[-1] == 3:
                t = _np.array([[0.299, 0.587, 0.114]] * 3, _np.float32)
                u = _np.eye(3, dtype=_np.float32) - t
                a = a @ (t + _np.cos(f * _np.pi) * u
                         + _np.sin(f * _np.pi) * (u[[1, 2, 0]] - u)).T
            return a

    class RandomColorJitter(_HWC):
        def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
            ts = []
            if brightness:
                ts.append(transforms.RandomBrightness(brightness))
            if contrast:
                ts.append(transforms.RandomContrast(contrast))
            if saturation:
                ts.append(transforms.RandomSaturation(saturation))
            if hue:
                ts.append(transforms.RandomHue(hue))
            self._ts = ts

        def _apply(self, a):
            # chained in numpy: no NDArray between the stages
            for t in self._ts:
                a = t._apply(a)
            return a

    class RandomLighting(_HWC):
        """AlexNet-style PCA lighting noise."""

        _eigval = _np.array([55.46, 4.794, 1.148], _np.float32)
        _eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                             [-0.5808, -0.0045, -0.8140],
                             [-0.5836, -0.6948, 0.4203]], _np.float32)

        def __init__(self, alpha=0.1):
            self._alpha = alpha

        def _apply(self, a):
            a = a.astype(_np.float32)
            if a.ndim == 3 and a.shape[-1] == 3:
                alpha = _frng().normal(0, self._alpha, 3) \
                    .astype(_np.float32)
                a = a + self._eigvec @ (alpha * self._eigval)
            return a
