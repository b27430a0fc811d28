"""The port's image-record pipeline (`csrc/image_pipeline.cc` through
`io/native_image.py`) against the JAX package's `NativeImagePipeline`
(whose OpenCV library must load; the module skips otherwise) on the
CPU, and `ImageRecordIter`'s engine rule, `im2rec` and `build_shard`.

Shards hold 14-24 JPEGs of 24-64 pixels packed by the JAX package (PIL).
At `preprocess_threads=1` both pipelines take the same per-worker
`mt19937` draws, so crops and mirrors line up batch for batch.

Tolerances: labels exact; pixels exact.  The bound allowed is the JAX
package's own native-against-PIL one, 4 levels (`test_io_sharded.py`),
but the port's decoder computes libjpeg's decode (full and reduced size)
and its resize computes OpenCV's 8-bit INTER_LINEAR arithmetic, so no
difference is expected and none is allowed.
"""
import argparse
import importlib.util
import os
import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401
import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import recordio as jrec
from incubator_mxnet_tpu.io import native_image as jnative

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import io as tio
from incubator_mxnet_torch import recordio as trec
from incubator_mxnet_torch.io import native_image as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if not jnative.native_pipeline_available():
    pytest.skip("the JAX package's native pipeline does not load here",
                allow_module_level=True)


def _image(h, w, seed):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (8, 8, 3)).astype(np.float32)
    big = np.kron(base, np.ones((h // 8 + 1, w // 8 + 1, 1), np.float32))
    return np.clip(big[:h, :w] + rng.randn(h, w, 3) * 12, 0, 255).astype(
        np.uint8)


def _shard(path, n=20, sizes=(24, 64), label_width=0, corrupt=(),
           seed=0):
    rng = np.random.RandomState(seed)
    w = jrec.MXRecordIO(str(path), "w")
    for i in range(n):
        label = float(i) if not label_width else \
            [float(i), float(i % 3), 0.5 * i][:label_width]
        hdr = jrec.IRHeader(0, label, i, 0)
        if i in corrupt:
            w.write(jrec.pack(hdr, b"\xff\xd8not a jpeg" * 5))
            continue
        img = _image(int(rng.randint(*sizes)), int(rng.randint(*sizes)), i)
        w.write(jrec.pack_img(hdr, img, quality=int(rng.choice([75, 90]))))
    w.close()
    return str(path)


def _epoch(pipe):
    out = []
    while (b := pipe.next_arrays()) is not None:
        out.append((b[0].copy(), b[1].copy()))
    return out


def _both(path, shape, batch, **kw):
    return (jnative.NativeImagePipeline(path, shape, batch,
                                        preprocess_threads=1, **kw),
            tnative.NativeImagePipeline(path, shape, batch,
                                        preprocess_threads=1, **kw))


def _assert_same(ref, got):
    assert len(got) == len(ref) > 0
    for (rd, rl), (gd, gl) in zip(ref, got):
        assert gd.shape == rd.shape and gd.dtype == rd.dtype
        np.testing.assert_array_equal(gl, rl)
        np.testing.assert_array_equal(gd, rd)


OPTIONS = {
    "center": dict(),
    "resize": dict(resize=28),
    "rand_crop_mirror": dict(resize=30, rand_crop=True, rand_mirror=True),
    "grow_to_fit": dict(resize=12, rand_crop=True),
    "normalize": dict(resize=26, mean=[123.7, 116.3, 103.5],
                      std=[58.4, 57.1, 57.4], rand_mirror=True),
    "uint8": dict(out_uint8=True, resize=24, rand_crop=True,
                  rand_mirror=True),
    "shuffle": dict(shuffle=True, seed=5, resize=24, out_uint8=True),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_pipeline_matches_jax(tmp_path, name):
    path = _shard(tmp_path / "a.rec")
    a, b = _both(path, (3, 20, 20), 4, **OPTIONS[name])
    _assert_same(_epoch(a), _epoch(b))
    assert a.decode_failures == b.decode_failures == 0
    a.close()
    b.close()


@pytest.mark.parametrize("resize,denom", [(28, 2), (14, 4), (7, 8)])
def test_reduced_size_decode_matches_jax(tmp_path, resize, denom):
    """64-pixel images at resize 28, 14 and 7 take the 1/2, 1/4 and 1/8
    decodes; each is exact against OpenCV's."""
    path = _shard(tmp_path / "big.rec", n=8, sizes=(56, 64))
    crop = min(resize, 12)
    a, b = _both(path, (3, crop, crop), 2, resize=resize, rand_crop=True)
    _assert_same(_epoch(a), _epoch(b))


def test_epochs_and_reset_mid_epoch_match_jax(tmp_path):
    """Centre crops: how many random draws the workers made before a
    reset mid-epoch depends on timing, in both packages."""
    path = _shard(tmp_path / "a.rec")
    kw = dict(shuffle=True, seed=2, resize=18, out_uint8=True)
    a, b = _both(path, (3, 16, 16), 3, **kw)
    for pipe in (a, b):
        pipe.next_arrays()
        pipe.reset()                            # mid-epoch
    _assert_same(_epoch(a) + (a.reset() or _epoch(a)),
                 _epoch(b) + (b.reset() or _epoch(b)))
    assert b.num_batches == 6


def test_shuffle_covers_every_record_once(tmp_path):
    path = _shard(tmp_path / "a.rec", n=24)
    pipe = tnative.NativeImagePipeline(path, (3, 16, 16), 4, shuffle=True,
                                       seed=9, preprocess_threads=2)
    orders = []
    for _ in range(2):
        labels = np.concatenate([l[:, 0] for _, l in _epoch(pipe)])
        assert sorted(labels) == list(range(24))
        orders.append(labels)
        pipe.reset()
    assert not np.array_equal(orders[0], orders[1])   # reshuffled


@pytest.mark.parametrize("part", [0, 1, 2])
def test_parts_match_jax(tmp_path, part):
    path = _shard(tmp_path / "a.rec", n=22)
    a, b = _both(path, (3, 16, 16), 2, part_index=part, num_parts=3)
    ref, got = _epoch(a), _epoch(b)
    _assert_same(ref, got)
    assert len(got) == (4 if part == 2 else 3)


@pytest.mark.parametrize("label_width", [1, 2, 3])
def test_label_arrays_match_jax(tmp_path, label_width):
    path = _shard(tmp_path / "a.rec", n=8, label_width=3)
    a, b = _both(path, (3, 16, 16), 4, label_width=label_width)
    ref, got = _epoch(a), _epoch(b)
    _assert_same(ref, got)
    assert got[0][1].shape == (4, label_width)


def test_decode_failures_are_counted_and_zero_filled(tmp_path):
    path = _shard(tmp_path / "a.rec", n=8, corrupt=(5,))
    a, b = _both(path, (3, 16, 16), 4, out_uint8=True)
    ref, got = _epoch(a), _epoch(b)
    _assert_same(ref, got)
    assert a.decode_failures == b.decode_failures == 1
    assert not got[1][0][1].any() and got[1][1][1, 0] == 5.0


def test_bad_arguments_raise(tmp_path):
    path = _shard(tmp_path / "a.rec", n=4)
    with pytest.raises(mx.MXNetError, match="cannot open"):
        tnative.NativeImagePipeline(str(tmp_path / "missing.rec"),
                                    (3, 8, 8), 2)
    with pytest.raises(mx.MXNetError, match="3-channel"):
        tnative.NativeImagePipeline(path, (1, 8, 8), 2)


def test_a_slot_in_use_is_never_overwritten(tmp_path):
    """The view `next_arrays` returns stays intact while the workers fill
    every other slot, until the consumer's next pull hands it back."""
    path = _shard(tmp_path / "a.rec", n=24)
    pipe = tnative.NativeImagePipeline(path, (3, 16, 16), 2, prefetch=2,
                                       preprocess_threads=3,
                                       out_uint8=True)
    ref = _epoch(tnative.NativeImagePipeline(path, (3, 16, 16), 2,
                                             preprocess_threads=1,
                                             out_uint8=True))
    for k in range(len(ref)):
        data, label = pipe.next_arrays()
        snapshot = data.copy()
        time.sleep(0.05)                 # the other slot fills meanwhile
        np.testing.assert_array_equal(data, snapshot)
        np.testing.assert_array_equal(data, ref[k][0])
        np.testing.assert_array_equal(label, ref[k][1])


def test_more_workers_than_cores_give_the_one_thread_batches(tmp_path):
    """A stress test of the slot ring: 4 workers a core fill 2 slots
    over 3 epochs with resets between them; centre crops do not depend
    on which worker decoded an image, so every batch must equal the one
    thread's."""
    path = _shard(tmp_path / "a.rec", n=24)
    kw = dict(resize=20, out_uint8=True, shuffle=True, seed=4)
    ref = tnative.NativeImagePipeline(path, (3, 16, 16), 3,
                                      preprocess_threads=1, **kw)
    many = tnative.NativeImagePipeline(
        path, (3, 16, 16), 3, prefetch=2,
        preprocess_threads=4 * (os.cpu_count() or 2), **kw)
    t0 = time.monotonic()
    for _ in range(3):
        _assert_same(_epoch(ref), _epoch(many))
        ref.reset()
        many.reset()
    assert time.monotonic() - t0 < 60
    many.close()
    ref.close()


def test_staging_ring_delivers_every_batch_intact(tmp_path):
    """`staging_ring` (DevicePrefetcher in sync mode over the slot views)
    gives the batches of an unstaged epoch, in order."""
    path = _shard(tmp_path / "a.rec", n=24)
    kw = dict(resize=20, rand_crop=True, rand_mirror=True, out_uint8=True,
              preprocess_threads=1, prefetch=2)
    ref = _epoch(tnative.NativeImagePipeline(path, (3, 16, 16), 2, **kw))
    it = tnative.NativeImageRecordIter(path, (3, 16, 16), 2, **kw)
    ring = it.staging_ring(ctx=mx.cpu(), depth=2)
    got = [(d.asnumpy(), l.asnumpy()) for d, l in ring]
    ring.close()
    it.close()
    assert len(got) == len(ref) == 12
    for (rd, rl), (gd, gl) in zip(ref, got):
        np.testing.assert_array_equal(gd, rd)
        np.testing.assert_array_equal(gl, rl[:, 0])
    assert threading.active_count() < 50


# -- ImageRecordIter ----------------------------------------------------------

def _iter_batches(it, n=None):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
        if n and len(out) == n:
            break
    return out


@pytest.mark.parametrize("engine", ["1", "0"])
def test_image_record_iter_engines_match_jax(tmp_path, monkeypatch, engine):
    """Crop only, both engines: labels equal and pixels bit-equal, to the
    JAX iterator and across the engines.  The images are smaller than
    twice the crop: a larger one the native engine decodes at reduced
    size before its centre crop (in both packages), `ImageIter` not."""
    path = _shard(tmp_path / "a.rec", n=12, sizes=(24, 40))
    monkeypatch.setenv("MXNET_NATIVE_IMAGE_PIPELINE", engine)
    kw = dict(path_imgrec=path, data_shape=(3, 20, 20), batch_size=4,
              preprocess_threads=1)
    with jmx.cpu():
        ref = _iter_batches(jmx.io.ImageRecordIter(**kw))
    with mx.cpu():
        it = tio.ImageRecordIter(**kw)
        got = _iter_batches(it)
    assert isinstance(it, tnative.NativeImageRecordIter) == (engine == "1")
    _assert_same(ref, got)
    monkeypatch.setenv("MXNET_NATIVE_IMAGE_PIPELINE", "0" if engine == "1"
                       else "1")
    with mx.cpu():
        _assert_same(got, _iter_batches(tio.ImageRecordIter(**kw)))


@pytest.mark.parametrize("kw,native", [
    (dict(), True), (dict(brightness=0.2), False),
    (dict(rand_resize=True), False), (dict(aug_list=[]), False),
    (dict(data_shape=(1, 8, 8)), False)])
def test_image_record_iter_engine_rule(tmp_path, kw, native):
    path = _shard(tmp_path / "a.rec", n=4)
    args = dict(path_imgrec=path, data_shape=(3, 8, 8), batch_size=2)
    args.update(kw)
    it = tio.ImageRecordIter(**args)
    assert isinstance(it, tnative.NativeImageRecordIter) == native
    if not native:
        assert isinstance(it, tio.PrefetchingIter)
        it.close()


# -- im2rec and build_shard ---------------------------------------------------

def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_shard_matches_jax(tmp_path):
    from incubator_mxnet_torch.tools import io_bench
    jbench = _load_jax_tool("io_bench")
    paths = [str(tmp_path / f"{k}.rec") for k in ("jax", "port")]
    jbench.build_shard(paths[0], 6, 64, 85, seed=3)
    io_bench.build_shard(paths[1], 6, 64, 85, seed=3)
    readers = [trec.MXRecordIO(p, "r") for p in paths]
    for _ in range(6):
        ref, got = (r.read() for r in readers)
        (rh, ri), (gh, gi) = jrec.unpack_img(ref), trec.unpack_img(got)
        assert rh.label == gh.label and rh.id == gh.id
        assert np.abs(gi.astype(int) - ri).max() <= 1
    assert readers[1].read() is None


def test_feed_rate_drains_the_shard(tmp_path):
    from incubator_mxnet_torch.tools import io_bench
    path = str(tmp_path / "s.rec")
    io_bench.build_shard(path, 8, 32, 85)
    out = io_bench.feed_rate(path, 16, 4, 1, epochs=1)
    assert out["decode_failures"] == 0 and out["images_per_s"][0] > 0


@pytest.mark.parametrize("packer", ["port", "jax"])
def test_im2rec_round_trip(tmp_path, packer):
    from PIL import Image
    from incubator_mxnet_torch.tools import im2rec
    root = tmp_path / "imgs"
    rng = np.random.RandomState(4)
    for cls in ("a", "b"):
        (root / cls).mkdir(parents=True)
        for i in range(3):
            img = _image(int(rng.randint(20, 40)), 30, i)
            ext = ".png" if i == 1 else ".jpg"
            Image.fromarray(img).save(str(root / cls / f"{i}{ext}"))
    mod = im2rec if packer == "port" else _load_jax_tool("im2rec")
    prefix = str(tmp_path / packer)
    args = argparse.Namespace(prefix=prefix, root=str(root), list=False,
                              resize=24, quality=90, shuffle=True,
                              pass_through=False)
    mod.pack(args)
    with open(prefix + ".lst") as f:
        entries = [line.split("\t") for line in f]
    assert len(entries) == 6
    ref = jmx.gluon.data.vision.ImageRecordDataset(prefix + ".rec")
    got = mx.gluon.data.vision.ImageRecordDataset(prefix + ".rec")
    with mx.cpu():
        for i in range(6):
            (ri, rl), (gi, gl) = ref[i], got[i]
            assert float(gl) == float(rl) == float(entries[i][1])
            assert min(gi.shape[:2]) == 24
            np.testing.assert_array_equal(gi.asnumpy(), ri.asnumpy())
