"""The port's `gluon.data` and `image` helpers against the JAX package's
on the CPU: the samplers, the datasets (`transform`, `transform_first`,
`filter`, `take`, `RecordFileDataset`), `default_batchify_fn`'s dtypes,
DataLoader batches for 0 workers, threads and spawned processes and each
`last_batch`, where the loader places its batches, the vision datasets
(local files and `SyntheticImageDataset`), every transform under
`mx.random.seed`, and the image array helpers.

Tolerances: exact everywhere except the float resize (`imresize` of
non-uint8 data, and the transforms that resize float images), which is
held to 1e-5 of the largest value: the port builds the same separable
weights as `jax.image.resize` in numpy, and the products add in another
order.  uint8 resizes (PIL in the JAX package, the port's numpy copy of
PIL's arithmetic) are exact.
"""
import collections
import gzip
import os
import random
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import image as jimage
from incubator_mxnet_tpu.gluon import data as jdata
from incubator_mxnet_tpu.gluon.data.vision import transforms as jT

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import image, nd
from incubator_mxnet_torch.gluon import data
from incubator_mxnet_torch.gluon.data.vision import transforms as T

RESIZE_RTOL = 1e-5


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _tree_equal(got, ref):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys()
        for k in ref:
            _tree_equal(got[k], ref[k])
        return
    if isinstance(ref, (tuple, list)):
        assert type(got).__name__ == type(ref).__name__, (got, ref)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _tree_equal(g, r)
        return
    g, r = _np(got), _np(ref)
    assert g.dtype == r.dtype, (g.dtype, r.dtype)
    assert g.shape == r.shape, (g.shape, r.shape)
    np.testing.assert_array_equal(g, r)


# -- samplers and datasets ---------------------------------------------

@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match_jax(last_batch):
    assert list(data.SequentialSampler(5, start=2)) == \
        list(jdata.SequentialSampler(5, start=2))
    np.random.seed(7)
    got = list(data.RandomSampler(11))
    np.random.seed(7)
    assert got == list(jdata.RandomSampler(11))
    got = data.BatchSampler(data.SequentialSampler(11), 4, last_batch)
    ref = jdata.BatchSampler(jdata.SequentialSampler(11), 4, last_batch)
    for _ in range(3):                      # rollover carries across epochs
        assert len(got) == len(ref)
        assert list(got) == list(ref)


def test_batch_sampler_rejects_an_unknown_last_batch():
    with pytest.raises(mx.MXNetError, match="last_batch"):
        list(data.BatchSampler(data.SequentialSampler(3), 2, "bogus"))


def test_datasets_match_jax():
    x = np.arange(12).reshape(6, 2)
    y = list("abcdef")
    got, ref = data.ArrayDataset(x, y), jdata.ArrayDataset(x, y)
    assert len(got) == len(ref) == 6
    for i in range(6):
        _tree_equal(got[i], ref[i])
    for g, r in ((got.transform(lambda a, b: (a * 2, b + "!")),
                  ref.transform(lambda a, b: (a * 2, b + "!"))),
                 (got.transform_first(lambda a: a + 1, lazy=False),
                  ref.transform_first(lambda a: a + 1, lazy=False)),
                 (got.filter(lambda s: s[0][0] % 4 == 0),
                  ref.filter(lambda s: s[0][0] % 4 == 0)),
                 (got.take(4), ref.take(4)),
                 (data.SimpleDataset(y).transform(str.upper),
                  jdata.SimpleDataset(y).transform(str.upper))):
        assert len(g) == len(r)
        for i in range(len(r)):
            _tree_equal(g[i], r[i])
    with pytest.raises(mx.MXNetError, match="same length"):
        data.ArrayDataset(x, y[:3])
    with pytest.raises(mx.MXNetError, match="at least one"):
        data.ArrayDataset()


def test_record_file_dataset_reads_a_jax_written_file(tmp_path):
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = mxj.recordio.MXIndexedRecordIO(idx, rec, "w")
    payloads = [bytes([i]) * (i + 1) for i in range(7)]
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()
    ds = data.RecordFileDataset(rec)
    assert len(ds) == 7
    assert [ds[i] for i in range(7)] == payloads


# -- batchify and the DataLoader ---------------------------------------

Pair = collections.namedtuple("Pair", ["img", "label"])


@pytest.mark.parametrize("kind", ["float64", "int64", "bool", "float32",
                                  "ndarray", "tuple", "namedtuple"])
def test_default_batchify_dtypes_match_jax(kind):
    rng = np.random.RandomState(0)
    a = rng.randn(4, 3)
    samples = {
        "float64": list(a), "int64": [1, 2, 3], "bool": [True, False],
        "float32": list(a.astype(np.float32)),
        "ndarray": [a[i].astype(np.float32) for i in range(4)],
        "tuple": [(a[i], i) for i in range(4)],
        "namedtuple": [Pair(a[i].astype(np.float32), i) for i in range(4)],
    }[kind]
    with mx.cpu():
        got_in = [nd.array(s) for s in samples] if kind == "ndarray" \
            else samples
        got = data.default_batchify_fn(got_in)
    ref_in = [mxj.nd.array(s) for s in samples] if kind == "ndarray" \
        else samples
    _tree_equal(got, jdata.dataloader.default_batchify_fn(ref_in))


class _Items(data.Dataset):
    """Items of three kinds: an NDArray made in the current context, a
    float64 numpy row and a Python int; and the context it was made in."""

    def __init__(self, n=23):
        self._x = np.random.RandomState(1).randn(n, 2, 3)

    def __len__(self):
        return len(self._x)

    def __getitem__(self, i):
        a = nd.array(self._x[i].astype(np.float32))
        return a, self._x[i], i, int(a.context.device_type == "cpu")


class _JaxItems(_Items):
    def __getitem__(self, i):
        return mxj.nd.array(self._x[i].astype(np.float32)), self._x[i], i, 1


def _jax_batches(last_batch, batch_size=5):
    return list(jdata.DataLoader(_JaxItems(), batch_size,
                                 last_batch=last_batch))


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("workers", [(0, None), (0, 0), (3, None)],
                         ids=["inline-prefetch", "inline", "threads"])
def test_dataloader_threads_match_jax(last_batch, workers):
    num_workers, prefetch = workers
    loader = data.DataLoader(_Items(), 5, last_batch=last_batch,
                             num_workers=num_workers, prefetch=prefetch,
                             thread_pool=True)
    ref = _jax_batches(last_batch)
    n = len(loader)
    with mx.cpu():
        got = list(loader)
    assert len(got) == len(ref) == n
    for g, r in zip(got, ref):
        _tree_equal(g, r)
        assert g[0].context == mx.cpu()


def test_dataloader_processes_match_jax_for_each_last_batch():
    """Spawned workers (the JAX loader's threads give the reference)."""
    for last_batch in ("keep", "discard", "rollover"):
        loader = data.DataLoader(_Items(), 5, last_batch=last_batch,
                                 num_workers=2)
        try:
            with mx.cpu():
                got = list(loader) + list(loader)    # two epochs
        finally:
            loader.close()
        ref = _jax_batches(last_batch)
        ref += list(jdata.DataLoader(_JaxItems(), 5, last_batch=last_batch)) \
            if last_batch != "rollover" else _rollover_second_epoch()
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _tree_equal(g, r)


def _rollover_second_epoch():
    loader = jdata.DataLoader(_JaxItems(), 5, last_batch="rollover")
    list(loader)
    return list(loader)


Sample = collections.namedtuple("Sample", ["x", "y"])


class _Nested(data.Dataset):
    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == 4:
            raise ValueError("bad item 4")
        return Sample(np.full((2,), i, np.float64), {"k": [i, i + 1]})


def test_dataloader_processes_keep_layout_and_raise_worker_errors():
    """A namedtuple and dict layout crosses the process boundary, a
    worker's exception reaches the consumer, and every staged shared
    memory segment is unlinked."""
    from multiprocessing import shared_memory
    loader = data.DataLoader(_Nested(), 2, num_workers=2,
                             batchify_fn=_keep_layout)
    names = []
    real_read = data.dataloader._read_shm_batch

    def spy(result, pin):
        names.append(result[0])
        return real_read(result, pin)
    data.dataloader._read_shm_batch = spy
    try:
        with mx.cpu():
            it = iter(loader)
            first = next(it)
            assert isinstance(first, Sample)
            np.testing.assert_array_equal(first.x.asnumpy(),
                                          [[0, 0], [1, 1]])
            assert first.x.dtype == np.float32
            assert [d["k"][0].asnumpy().tolist() for d in first.y] == [0, 1]
            next(it)
            with pytest.raises(ValueError, match="bad item 4"):
                next(it)
    finally:
        data.dataloader._read_shm_batch = real_read
        loader.close()
    assert not os.path.exists(loader._payload)    # the workers' dataset
    for name in names:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)


def _keep_layout(items):
    return Sample(data.default_batchify_fn([s.x for s in items]),
                  [s.y for s in items])


def test_dataloader_places_batches_in_the_callers_context():
    """Items are made under cpu() on the loader's threads whatever the
    caller's context; iter() takes the caller's context, and without
    CUDA a gpu(0) caller raises there."""
    loader = data.DataLoader(_Items(), 5, num_workers=2, thread_pool=True)
    with mx.cpu():
        batches = list(loader)
    assert all(b[3].asnumpy().all() for b in batches)
    if not torch.cuda.is_available():
        with pytest.raises(mx.MXNetError, match="CUDA is not available"):
            iter(loader)


def test_dataloader_shuffle_uses_numpy_global_rng():
    ds = data.ArrayDataset(np.arange(20, dtype=np.float32))
    np.random.seed(3)
    with mx.cpu():
        got = [b.asnumpy() for b in data.DataLoader(ds, 6, shuffle=True)]
    np.random.seed(3)
    ref = [b.asnumpy() for b in jdata.DataLoader(
        jdata.ArrayDataset(np.arange(20, dtype=np.float32)), 6,
        shuffle=True)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(mx.MXNetError, match="shuffle must be False"):
        data.DataLoader(ds, 2, shuffle=True,
                        sampler=data.SequentialSampler(20))
    with pytest.raises(mx.MXNetError, match="batch_size required"):
        data.DataLoader(ds)


def test_dataloader_early_break_stops_its_thread():
    loader = data.DataLoader(_Items(200), 2, num_workers=2,
                             thread_pool=True, prefetch=2)
    with mx.cpu():
        it = iter(loader)
        next(it)
    it.close()              # the generator's finally stops the producer


# -- vision datasets ----------------------------------------------------

def test_synthetic_dataset_matches_jax():
    kw = dict(num_samples=9, shape=(3, 5, 4), num_classes=4, seed=2)
    for extra in ({}, {"channels_last": True}):
        got = data.vision.SyntheticImageDataset(**kw, **extra)
        ref = jdata.vision.SyntheticImageDataset(**kw, **extra)
        assert len(got) == len(ref)
        with mx.cpu():
            for i in range(len(ref)):
                _tree_equal(got[i], ref[i])


def _write_mnist(root, n=5):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    with gzip.open(os.path.join(root, "train-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with gzip.open(os.path.join(root, "train-labels-idx1-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _write_cifar(root, n=4):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(1)
    for name in ["test_batch.bin"]:
        raw = np.concatenate([rng.randint(0, 10, (n, 1)),
                              rng.randint(0, 256, (n, 3072))], axis=1)
        raw.astype(np.uint8).tofile(os.path.join(root, name))


def test_local_vision_datasets_match_jax(tmp_path):
    _write_mnist(str(tmp_path / "mnist"))
    _write_mnist(str(tmp_path / "fashion"))
    _write_cifar(str(tmp_path / "cifar"))
    cases = (("MNIST", str(tmp_path / "mnist"), True),
             ("FashionMNIST", str(tmp_path / "fashion"), True),
             ("CIFAR10", str(tmp_path / "cifar"), False))
    for name, root, train in cases:
        got = getattr(data.vision, name)(root=root, train=train)
        ref = getattr(jdata.vision, name)(root=root, train=train)
        assert len(got) == len(ref)
        with mx.cpu():
            for i in range(len(ref)):
                _tree_equal(got[i], ref[i])
        with pytest.raises(mx.MXNetError, match="no download"):
            getattr(data.vision, name)(root=str(tmp_path / "none"),
                                       train=train)
    got = data.vision.MNIST(root=str(tmp_path / "mnist"),
                            transform=lambda x, y: (x.astype("float32"), y))
    with mx.cpu():
        assert got[0][0].dtype == np.float32


# -- transforms under a shared seed -------------------------------------

def _hwc(rng, dtype, h=12, w=10):
    if dtype == "uint8":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return rng.rand(h, w, 3).astype(np.float32)


TRANSFORMS = {
    "Resize": lambda m: m.Resize((7, 5)),
    "Resize-keep": lambda m: m.Resize(8, keep_ratio=True),
    "CenterCrop": lambda m: m.CenterCrop(6),
    "CenterCrop-up": lambda m: m.CenterCrop((14, 9)),
    "RandomResizedCrop": lambda m: m.RandomResizedCrop(6),
    "RandomFlipLeftRight": lambda m: m.RandomFlipLeftRight(),
    "RandomFlipTopBottom": lambda m: m.RandomFlipTopBottom(),
    "RandomBrightness": lambda m: m.RandomBrightness(0.4),
    "RandomContrast": lambda m: m.RandomContrast(0.4),
    "RandomSaturation": lambda m: m.RandomSaturation(0.4),
    "RandomHue": lambda m: m.RandomHue(0.3),
    "RandomColorJitter": lambda m: m.RandomColorJitter(0.3, 0.3, 0.3, 0.2),
    "RandomLighting": lambda m: m.RandomLighting(0.2),
    "ToTensor": lambda m: m.ToTensor(),
    "Normalize": lambda m: m.Compose([m.ToTensor(), m.Normalize(
        (0.4, 0.5, 0.6), (0.2, 0.25, 0.3))]),
    "Normalize-scalar": lambda m: m.Normalize(0.5, 0.25),
    "Cast": lambda m: m.Cast("float16"),
}
RESIZING = {"Resize", "Resize-keep", "CenterCrop-up", "RandomResizedCrop"}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax_under_a_shared_seed(name, dtype):
    rng = np.random.RandomState(5)
    imgs = [_hwc(rng, dtype) for _ in range(4)]
    got_t, ref_t = TRANSFORMS[name](T), TRANSFORMS[name](jT)
    mx.random.seed(11)
    mxj.random.seed(11)
    with mx.cpu():
        got = [got_t(nd.array(a, dtype=a.dtype)) for a in imgs]
    ref = [ref_t(mxj.nd.array(a, dtype=a.dtype)) for a in imgs]
    for g, r in zip(got, ref):
        g, r = g.asnumpy(), r.asnumpy()
        assert g.dtype == r.dtype and g.shape == r.shape, (g.shape, r.shape)
        if name in RESIZING and dtype == "float32":
            np.testing.assert_allclose(
                g, r, rtol=0, atol=RESIZE_RTOL * np.abs(r).max())
        else:
            np.testing.assert_array_equal(g, r)
    # the transforms drew the same numbers: the generators agree after
    assert mx.random.np_rng().randint(1 << 30) == \
        mxj.random.np_rng().randint(1 << 30)


def test_seed_recreates_the_framework_numpy_rng():
    mx.random.seed(3)
    a = mx.random.np_rng().uniform(size=4)
    mx.random.seed(3)
    np.testing.assert_array_equal(a, mx.random.np_rng().uniform(size=4))
    mxj.random.seed(3)
    np.testing.assert_array_equal(a, mxj.random.np_rng().uniform(size=4))


# -- image helpers ------------------------------------------------------

@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(17, 23, 8, 11), (8, 11, 17, 23),
                                   (10, 7, 3, 19), (16, 16, 16, 9)])
def test_float_resize_matches_jax(shape, interp):
    H, W, h, w = shape
    rng = np.random.RandomState(interp)
    a = rng.randn(H, W, 3).astype(np.float32)
    got, ref = image.imresize(a, w, h, interp), jimage.imresize(a, w, h,
                                                                interp)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=RESIZE_RTOL * np.abs(ref).max())
    g2 = image.imresize(a[:, :, 0], w, h, interp)       # HW input
    np.testing.assert_allclose(g2, jimage.imresize(a[:, :, 0], w, h, interp),
                               rtol=0, atol=RESIZE_RTOL * np.abs(ref).max())


def test_image_helpers_match_jax():
    rng = np.random.RandomState(9)
    u8 = rng.randint(0, 256, (13, 9, 3)).astype(np.uint8)
    f32 = rng.rand(13, 9, 3).astype(np.float32)
    np.testing.assert_array_equal(image.imresize(u8, 5, 7, 1),
                                  jimage.imresize(u8, 5, 7, 1))
    np.testing.assert_array_equal(image.resize_short(u8, 6),
                                  jimage.resize_short(u8, 6))
    np.testing.assert_array_equal(image.fixed_crop(u8, 1, 2, 4, 5),
                                  jimage.fixed_crop(u8, 1, 2, 4, 5))
    np.testing.assert_array_equal(image.fixed_crop(u8, 1, 2, 4, 5, (6, 6)),
                                  jimage.fixed_crop(u8, 1, 2, 4, 5, (6, 6)))
    for size in ((4, 5), (12, 15)):
        got, ref = image.center_crop(u8, size), jimage.center_crop(u8, size)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]
        random.seed(4)
        got = image.random_crop(u8, size)
        random.seed(4)
        ref = jimage.random_crop(u8, size)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]
    mean, std = np.array([0.1, 0.2, 0.3]), np.array([1.0, 2.0, 4.0])
    np.testing.assert_array_equal(image.color_normalize(f32, mean, std),
                                  jimage.color_normalize(f32, mean, std))
    np.testing.assert_array_equal(image.color_normalize(u8, mean),
                                  jimage.color_normalize(u8, mean))
