"""The port's detection augmenters and `ImageDetIter`
(`image/detection.py`), and `gluon.data.vision.ImageRecordDataset` and
`ImageFolderDataset`, against the JAX package's on the CPU.

The cases follow the JAX package's own tests of these classes
(`test_io_extras.py`, `test_io_image.py`); each package draws from its
framework RandomState after the same `mx.random.seed`, so crops and
flips line up.  Tolerances: labels and uint8 images exact (the same
numpy operations on the same draws; codecs and resamplers that agree bit
for bit); float images that the augmenters resize, 1e-5 of the largest
value (the port builds `jax.image.resize`'s weights in numpy and its
products add in another order, as in `test_torch_data.py`).
"""
import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp  # noqa: F401
import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import image as jimage
from incubator_mxnet_tpu import recordio as jrec

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import image as timage

PKGS = ((jmx, jimage), (mx, timage))


def _run_both(fn, seed=0):
    """fn(mx_module, image_module) under the same framework seed in each
    package, in its CPU context."""
    outs = []
    for pkg, img_mod in PKGS:
        pkg.random.seed(seed)
        with pkg.cpu():
            outs.append(fn(pkg, img_mod))
    return outs


def test_det_horizontal_flip_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.rand(8, 8, 3).astype(np.float32)
    label = np.array([[0, 0.1, 0.2, 0.4, 0.6]], np.float32)
    for pkg, m in PKGS:
        out_img, out_lab = m.DetHorizontalFlipAug(p=1.0)(img, label)
        np.testing.assert_array_equal(out_img, img[:, ::-1])
        np.testing.assert_allclose(out_lab[0], [0, 0.6, 0.2, 0.9, 0.6],
                                   atol=1e-6)

    def draws(pkg, m):
        aug = m.DetHorizontalFlipAug(p=0.5)
        return [aug(img, label) for _ in range(8)]
    for (ri, rl), (gi, gl) in zip(*_run_both(draws, seed=4)):
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)


@pytest.mark.parametrize("seed", range(4))
def test_det_random_crop_matches_jax(seed):
    img = np.random.RandomState(seed).rand(32, 40, 3).astype(np.float32)
    label = np.array([[1, 0.4, 0.4, 0.6, 0.6], [0, 0.1, 0.2, 0.3, 0.5]],
                     np.float32)

    def crops(pkg, m):
        aug = m.DetRandomCropAug(min_object_covered=0.5,
                                 area_range=(0.3, 1.0), p=0.8)
        return [aug(img, label) for _ in range(6)]
    for (ri, rl), (gi, gl) in zip(*_run_both(crops, seed)):
        assert gi.shape == ri.shape
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)
        assert (gl[:, 1:] >= -1e-6).all() and (gl[:, 1:] <= 1 + 1e-6).all()


@pytest.mark.parametrize("kw", [
    dict(rand_mirror=True), dict(resize=20, rand_crop=0.7, rand_mirror=True),
    dict(rand_crop=1, mean=True, std=True),
    dict(brightness=0.2, contrast=0.2, saturation=0.2)])
def test_create_det_augmenter_matches_jax(kw):
    import random
    rng = np.random.RandomState(1)
    img = (rng.rand(24, 30, 3) * 255).astype(np.uint8)
    label = np.array([[0, .1, .1, .5, .5], [1, .2, .2, .8, .8]],
                     np.float32)

    def run(pkg, m):
        random.seed(2)
        augs = m.CreateDetAugmenter(data_shape=(3, 16, 16), **kw)
        out = []
        for _ in range(3):
            x, lab = img, label
            for a in augs:
                x, lab = a(x, lab)
            out.append((np.asarray(x), lab))
        return out
    for (ri, rl), (gi, gl) in zip(*_run_both(run, seed=7)):
        assert gi.shape == ri.shape == (16, 16, 3)
        np.testing.assert_allclose(gi, ri, rtol=1e-6)
        np.testing.assert_array_equal(gl, rl)


def _det_items(seed, widths=None):
    rng = np.random.RandomState(seed)
    labels = [[[0, .1, .1, .5, .5], [1, .2, .2, .8, .8]],
              [[1, .3, .3, .9, .9]],
              [[0, .1, .1, .5, .5], [1, .2, .2, .6, .6], [1, .3, .3, .7, .7]],
              [[1, .2, .2, .6, .6, .9]]]
    return [(rng.rand(16, 16, 3).astype(np.float32), lab)
            for lab in labels[:widths or 4]]


@pytest.mark.parametrize("shuffle", [False, True])
def test_image_det_iter_matches_jax(shuffle):
    items = _det_items(1)

    def run(pkg, m):
        augs = m.CreateDetAugmenter(data_shape=(3, 8, 8), rand_mirror=True,
                                    rand_crop=0.5)
        it = m.ImageDetIter(batch_size=3, data_shape=(3, 8, 8),
                            imglist=items, augmenters=augs,
                            shuffle=shuffle)
        return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in iter(it)]
    ref, got = _run_both(run, seed=3)
    assert len(got) == len(ref) == 2
    assert got[0][1].shape == (3, 3, 6)           # global width, max boxes
    assert got[-1][2] == 2                         # padded last batch
    for (rd, rl, rp), (gd, gl, gp) in zip(ref, got):
        assert gd.shape == (3, 3, 8, 8) and gp == rp
        np.testing.assert_allclose(gd, rd, rtol=0,
                                   atol=1e-5 * np.abs(rd).max())
        np.testing.assert_array_equal(gl, rl)


def test_image_det_iter_over_a_voc_shaped_batch_matches_jax():
    """300 x 300 images, up to 6 boxes each, resized to 300 by the
    augmenters (the shape of SSD-300's input)."""
    rng = np.random.RandomState(5)
    items = []
    for i in range(4):
        n = 1 + i % 6
        x1, y1 = rng.rand(n) * 0.5, rng.rand(n) * 0.5
        boxes = np.stack([rng.randint(0, 20, n), x1, y1,
                          x1 + 0.1 + rng.rand(n) * 0.4,
                          y1 + 0.1 + rng.rand(n) * 0.4], 1)
        items.append(((rng.rand(240 + 20 * i, 320, 3) * 255).astype(
            np.uint8), boxes.astype(np.float32)))

    def run(pkg, m):
        augs = m.CreateDetAugmenter(data_shape=(3, 300, 300), rand_crop=0.5,
                                    rand_mirror=True, mean=True, std=True)
        it = m.ImageDetIter(batch_size=4, data_shape=(3, 300, 300),
                            imglist=items, augmenters=augs)
        b = next(iter(it))
        return b.data[0].asnumpy(), b.label[0].asnumpy()
    (rd, rl), (gd, gl) = _run_both(run, seed=8)
    assert gd.shape == (4, 3, 300, 300) and gl.shape == (4, 4, 5)
    np.testing.assert_allclose(gd, rd, rtol=1e-6)
    np.testing.assert_array_equal(gl, rl)


def test_image_det_iter_needs_imglist():
    with pytest.raises(mx.MXNetError, match="imglist"):
        timage.ImageDetIter(2, (3, 8, 8))


# -- the vision datasets --------------------------------------------------

def _write_rec(tmp_path, fmt):
    rng = np.random.RandomState(0)
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    imgs = []
    for i in range(6):
        img = (rng.rand(10, 12, 3) * 255).astype(np.uint8)
        imgs.append(img)
        label = float(i % 3) if i % 2 else [float(i), 2.0]
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, label, i, 0), img,
                                     img_fmt=fmt, quality=90))
    w.close()
    return rec, imgs


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
@pytest.mark.parametrize("flag", [1, 0])
def test_image_record_dataset_matches_jax(tmp_path, fmt, flag):
    rec, imgs = _write_rec(tmp_path, fmt)
    ref = jmx.gluon.data.vision.ImageRecordDataset(rec, flag=flag)
    got = mx.gluon.data.vision.ImageRecordDataset(rec, flag=flag)
    assert len(got) == len(ref) == 6
    with mx.cpu():
        for i in range(6):
            (ri, rl), (gi, gl) = ref[i], got[i]
            assert gi.shape == ri.shape == (10, 12, 3 if flag else 1)
            np.testing.assert_array_equal(gi.asnumpy(), ri.asnumpy())
            np.testing.assert_array_equal(np.asarray(gl), np.asarray(rl))
        if fmt == ".png" and flag:
            np.testing.assert_array_equal(got[4][0].asnumpy(), imgs[4])
        loader = mx.gluon.data.DataLoader(
            mx.gluon.data.vision.ImageRecordDataset(
                rec, flag, lambda x, y: (x, float(np.ravel(y)[0]))),
            batch_size=3)
        batches = list(loader)
    assert len(batches) == 2
    assert batches[0][0].shape == (3, 10, 12, 3 if flag else 1)


@pytest.mark.parametrize("flag", [1, 0])
def test_image_folder_dataset_matches_jax(tmp_path, flag):
    rng = np.random.RandomState(1)
    for cls in ("cat", "dog"):
        d = tmp_path / cls
        d.mkdir()
        for i in range(3):
            arr = (rng.rand(8, 9, 3) * 255).astype(np.uint8)
            fmt = ("png", "jpeg", "bmp")[i]
            Image.fromarray(arr).save(str(d / f"{i}.{fmt}"))
        Image.fromarray((np.ones((8, 8)) * 128).astype(np.uint8)).save(
            str(d / "gray.png"))
    exts = (".jpeg", ".png", ".bmp")
    ref = jmx.gluon.data.vision.ImageFolderDataset(str(tmp_path), flag, None,
                                                   exts)
    got = mx.gluon.data.vision.ImageFolderDataset(str(tmp_path), flag, None,
                                                  exts)
    assert got.synsets == ref.synsets == ["cat", "dog"]
    assert len(got) == len(ref) == 8
    with mx.cpu():
        for i in range(8):
            (ri, rl), (gi, gl) = ref[i], got[i]
            assert gl == rl
            assert gi.shape == ri.shape and gi.shape[2] == (3 if flag else 1)
            np.testing.assert_array_equal(gi.asnumpy(), ri.asnumpy())
