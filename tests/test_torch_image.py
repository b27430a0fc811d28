"""The port's image module against the JAX package's on the CPU: `imdecode`
(the port's JPEG codec and its PNG and BMP decoders against PIL, which
the JAX `imdecode` is), the JPEG encoder, `imresize` of uint8 data (PIL's
resampling), the Augmenters, `CreateAugmenter` and `ImageIter` over
`.rec` (with and without `.idx`), `.lst` and `imglist`.

Inputs are 17-64 pixel images made with numpy from a seed (8 x 8 blocks
of color plus N(0, 12^2) noise, the benchmark shard's images) and
encoded by PIL, and OpenCV where PIL cannot write the stream (4:4:0
sampling), so that every baseline variant the decoder must handle is
covered.

Tolerances, with their reasons:

- JPEG decode: exact.  The decoder computes libjpeg-turbo's integer IDCT,
  fancy upsampling and color tables, which PIL runs; it is also exact
  against OpenCV's reduced-size decodes (libjpeg's scaled IDCTs).
- the port's JPEG encoder: its bytes decoded by PIL within 1 level of
  PIL's own encode then decode at the same quality (the rule of the
  encoder's contract; it writes PIL's bytes in practice, and the test of
  `pack_img` in `test_torch_recordio.py` holds that).
- PNG, BMP, `imresize` of uint8 data, the Augmenters and `ImageIter`:
  exact, except the float jitters and normalization, held to rtol 1e-6
  (the same float32 operations on both sides).
"""
import io
import os

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp  # noqa: F401
import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import image as jimage
from incubator_mxnet_tpu import recordio as jrec

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import image as timage
from incubator_mxnet_torch.image import codec


def _image(h, w, seed, c=3):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (8, 8, c)).astype(np.float32)
    big = np.kron(base, np.ones((h // 8 + 1, w // 8 + 1, 1), np.float32))
    return np.clip(big[:h, :w] + rng.randn(h, w, c) * 12, 0, 255).astype(
        np.uint8)


def _pil_bytes(img, fmt="JPEG", **kw):
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if img.ndim == 3 and img.shape[2] == 1
                    else img).save(buf, format=fmt, **kw)
    return buf.getvalue()


# -- JPEG decode ------------------------------------------------------------

@pytest.mark.parametrize("size", [(33, 17), (17, 33), (48, 64)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 85, 95])
def test_imdecode_jpeg_matches_jax(size, subsampling, quality):
    data = _pil_bytes(_image(*size, seed=sum(size) + quality),
                      quality=quality, subsampling=subsampling)
    for flag in (1, 0):
        ref = jimage.imdecode(data, flag=flag)
        got = timage.imdecode(data, flag=flag)
        assert got.shape == ref.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (31, 9), (64, 40)])
def test_imdecode_gray_jpeg_matches_jax(size):
    data = _pil_bytes(_image(*size, seed=3, c=1), quality=80)
    for flag in (1, 0):
        np.testing.assert_array_equal(timage.imdecode(data, flag=flag),
                                      jimage.imdecode(data, flag=flag))


@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_imdecode_restart_intervals_match_jax(blocks):
    data = _pil_bytes(_image(40, 56, seed=blocks), quality=85,
                      restart_marker_blocks=blocks)
    assert b"\xff\xdd" in data                    # a DRI marker
    np.testing.assert_array_equal(timage.imdecode(data),
                                  jimage.imdecode(data))


@pytest.mark.parametrize("factor", [0x121111, 0x221111, 0x211111])
def test_imdecode_opencv_streams_and_reduced_sizes(factor):
    """4:4:0 (which PIL cannot write), 4:2:0 and 4:2:2 from OpenCV's
    encoder with a restart interval; full size against PIL, 1/2, 1/4 and
    1/8 against OpenCV's IMREAD_REDUCED_COLOR_{2,4,8}."""
    cv2 = pytest.importorskip("cv2")
    img = _image(45, 61, seed=factor & 0xFF)
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        factor, cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    data = enc.tobytes()
    np.testing.assert_array_equal(timage.imdecode(data),
                                  jimage.imdecode(data))
    for denom, flag in ((2, cv2.IMREAD_REDUCED_COLOR_2),
                        (4, cv2.IMREAD_REDUCED_COLOR_4),
                        (8, cv2.IMREAD_REDUCED_COLOR_8)):
        ref = cv2.imdecode(enc, flag)[..., ::-1]
        np.testing.assert_array_equal(
            codec.jpeg_decode(data, 3, scale_denom=denom), ref)


@pytest.mark.parametrize("kind", ["progressive", "cmyk", "truncated",
                                  "garbage", "empty"])
def test_unsupported_or_corrupt_jpeg_raises(kind):
    img = _image(32, 32, seed=2)
    if kind == "progressive":
        data, match = _pil_bytes(img, progressive=True), "progressive"
    elif kind == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
        data, match = buf.getvalue(), "CMYK"
    elif kind == "truncated":
        data, match = _pil_bytes(img)[:-300], "JPEG"
    elif kind == "garbage":
        data, match = b"\xff\xd8" + bytes(range(256)) * 4, "JPEG"
    else:
        data, match = b"", "cannot decode"
    with pytest.raises(mx.MXNetError, match=match):
        timage.imdecode(data)


# -- JPEG encode ------------------------------------------------------------

@pytest.mark.parametrize("size", [(33, 17), (64, 48), (1, 1), (2, 3),
                                  (17, 40)])
@pytest.mark.parametrize("quality", [10, 50, 85, 95, 100])
def test_jpeg_encoder_within_one_level_of_pil(size, quality):
    img = _image(*size, seed=quality)
    mine = codec.jpeg_encode(img, quality)
    ref = np.asarray(Image.open(io.BytesIO(_pil_bytes(img,
                                                      quality=quality))))
    got = np.asarray(Image.open(io.BytesIO(mine)))
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref).max() <= 1


def test_jpeg_encoder_gray_and_psnr():
    gray = _image(40, 40, seed=4, c=1)
    data = codec.jpeg_encode(gray, 90)
    back = np.asarray(Image.open(io.BytesIO(data)))
    assert back.shape == (40, 40)
    # PSNR of the luma: at 4:2:0 the chroma of these images (independent
    # N(0, 12^2) noise in each channel) is averaged away, so the RGB PSNR
    # is ~24 dB for PIL's codec as for this one; the luma keeps > 30 dB
    img = _image(64, 64, seed=5)
    back = timage.imdecode(codec.jpeg_encode(img, 95)).astype(np.float64)
    weights = np.array([0.299, 0.587, 0.114])
    err = (back - img) @ weights
    psnr = 10 * np.log10(255.0 ** 2 / np.mean(err ** 2))
    assert psnr > 30, psnr
    with pytest.raises(mx.MXNetError, match="1 or 3 channels"):
        codec.jpeg_encode(np.zeros((4, 4, 4), np.uint8))


# -- PNG and BMP ------------------------------------------------------------

def _png_cases():
    rng = np.random.RandomState(6)
    rgb = rng.randint(0, 256, (13, 21, 3)).astype(np.uint8)
    rgba = rng.randint(0, 256, (13, 21, 4)).astype(np.uint8)
    gray = rng.randint(0, 256, (13, 21)).astype(np.uint8)
    return {
        "gray": Image.fromarray(gray),
        "gray_alpha": Image.fromarray(rgba[..., :2], "LA"),
        "rgb": Image.fromarray(rgb),
        "rgba": Image.fromarray(rgba),
        "palette": Image.fromarray(rgb).quantize(200),
        "palette_4bit": Image.fromarray(rgb).quantize(12),
        "palette_1bit": Image.fromarray(rgb).quantize(2),
        "gray_1bit": Image.fromarray(gray > 128),
        "rgb_optimized": Image.fromarray(rgb),
    }


@pytest.mark.parametrize("name", sorted(_png_cases()))
def test_imdecode_png_matches_jax(name):
    im = _png_cases()[name]
    buf = io.BytesIO()
    im.save(buf, format="PNG", optimize=name.endswith("optimized"))
    data = buf.getvalue()
    for flag in (1, 0):
        ref = jimage.imdecode(data, flag=flag)
        got = timage.imdecode(data, flag=flag)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_png_encoder_is_lossless():
    for img in (_image(9, 14, seed=1), _image(9, 14, seed=2, c=1)):
        data = codec.png_encode(img)
        back = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(back.reshape(img.shape), img)
        np.testing.assert_array_equal(codec.decode(data, img.shape[2]), img)


def test_interlaced_and_16bit_png_raise():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, format="PNG")
    with pytest.raises(mx.MXNetError, match="16-bit"):
        timage.imdecode(buf.getvalue())
    data = bytearray(codec.png_encode(np.zeros((4, 4, 3), np.uint8)))
    data[28] = 1                                  # IHDR interlace byte
    with pytest.raises(mx.MXNetError, match="interlaced"):
        timage.imdecode(bytes(data))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_imdecode_bmp_matches_jax(mode):
    img = np.random.RandomState(7).randint(0, 256, (11, 7, len(mode)))
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8), mode).save(buf, format="BMP")
    data = buf.getvalue()
    for flag in (1, 0):
        np.testing.assert_array_equal(timage.imdecode(data, flag=flag),
                                      jimage.imdecode(data, flag=flag))


# -- imresize ---------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
def test_imresize_uint8_matches_jax(channels, interp):
    img = _image(29, 37, seed=interp, c=channels)
    if channels == 4:      # alpha 0, 255 and between: PIL premultiplies
        img[..., 3] = np.random.RandomState(1).choice(
            [0, 7, 128, 200, 255], img.shape[:2])
    for w, h in ((64, 50), (13, 17), (37, 11), (5, 60)):
        np.testing.assert_array_equal(timage.imresize(img, w, h, interp),
                                      jimage.imresize(img, w, h, interp))


# -- Augmenters -------------------------------------------------------------

def _augmenters(mod):
    mean = np.array([123.68, 116.28, 103.53], np.float32)
    std = np.array([58.395, 57.12, 57.375], np.float32)
    return [mod.ResizeAug(24), mod.ResizeAug(40, interp=1),
            mod.ForceResizeAug((30, 20)), mod.RandomCropAug((16, 12)),
            mod.RandomCropAug((50, 50)), mod.CenterCropAug((16, 12)),
            mod.CenterCropAug((48, 48)), mod.HorizontalFlipAug(0.5),
            mod.CastAug(), mod.BrightnessJitterAug(0.3),
            mod.ContrastJitterAug(0.3), mod.SaturationJitterAug(0.3),
            mod.ColorJitterAug(0.2, 0.3, 0.4), mod.NormalizeAug(mean, std)]


@pytest.mark.parametrize("k", range(14))
def test_augmenters_match_jax_under_a_shared_seed(k):
    import random
    img = _image(33, 41, seed=k)
    outs = []
    for mod in (jimage.image, timage.image):      # the modules: the JAX
        random.seed(k)                           # package exports no
        aug = _augmenters(mod)[k]                # NormalizeAug
        outs.append([np.asarray(aug(img)) for _ in range(4)])
    for ref, got in zip(*outs):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(), dict(resize=40, rand_crop=True, rand_mirror=True),
    dict(rand_crop=True, mean=True, std=True),
    dict(resize=30, brightness=0.2, contrast=0.2, saturation=0.2,
         mean=np.array([1., 2., 3.]), std=None)])
def test_create_augmenter_matches_jax(kw):
    import random
    img = _image(37, 29, seed=5)
    outs = []
    for mod in (jimage, timage):
        augs = mod.CreateAugmenter((3, 20, 24), **kw)
        random.seed(3)
        res = []
        for _ in range(3):
            x = img
            for a in augs:
                x = a(x)
            res.append(np.asarray(x))
        outs.append((res, [type(a).__name__ for a in augs]))
    assert outs[0][1] == outs[1][1]
    for ref, got in zip(outs[0][0], outs[1][0]):
        np.testing.assert_allclose(got, ref, rtol=1e-6)


# -- ImageIter --------------------------------------------------------------

def _write_images(tmp_path, n=12, label_width=1):
    """A .rec with .idx, a copy without .idx, and a folder with its .lst
    of the same images (JPEG, sizes 24-47)."""
    rng = np.random.RandomState(8)
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    lst = []
    os.makedirs(tmp_path / "img", exist_ok=True)
    for i in range(n):
        img = _image(int(rng.randint(24, 48)), int(rng.randint(24, 48)),
                     seed=i)
        label = float(i % 5) if label_width == 1 else \
            [float(i), float(i % 3), 0.5 * i][:label_width]
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, label, i, 0), img,
                                     quality=90))
        name = f"img/{i}.jpg"
        with open(tmp_path / name, "wb") as f:
            f.write(_pil_bytes(img, quality=90))
        lst.append((i, label, name))
    w.close()
    noidx = str(tmp_path / "noidx.rec")
    with open(rec, "rb") as a, open(noidx, "wb") as b:
        b.write(a.read())
    lst_path = str(tmp_path / "d.lst")
    with open(lst_path, "w") as f:
        for i, label, name in lst:
            labels = label if isinstance(label, list) else [label]
            f.write("\t".join([str(i)] + [str(x) for x in labels]
                              + [name]) + "\n")
    return rec, noidx, lst_path, lst


def _drain(it, n=None):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
        if n and len(out) == n:
            break
    return out


@pytest.mark.parametrize("source", ["rec_idx", "rec", "lst", "imglist"])
def test_image_iter_matches_jax(tmp_path, source):
    import random
    rec, noidx, lst_path, lst = _write_images(tmp_path)
    kw = dict(batch_size=4, data_shape=(3, 20, 20), resize=26,
              rand_crop=True, rand_mirror=True, shuffle=True, seed=2,
              preprocess_threads=1)
    if source == "rec_idx":
        kw["path_imgrec"] = rec
    elif source == "rec":
        kw["path_imgrec"] = noidx
    elif source == "lst":
        kw.update(path_imglist=lst_path, path_root=str(tmp_path))
    else:
        kw.update(imglist=[(label, name) for _, label, name in lst],
                  path_root=str(tmp_path))
    outs = []
    for mod, ctx in ((jimage, jmx.cpu()), (timage, mx.cpu())):
        random.seed(11)
        with ctx:
            it = mod.ImageIter(**kw)
            outs.append(_drain(it) + (it.reset() or _drain(it)))
    assert len(outs[1]) == len(outs[0]) == 6
    for (rd, rl), (gd, gl) in zip(*outs):
        assert gd.shape == (4, 3, 20, 20) and gd.dtype == np.float32
        np.testing.assert_array_equal(gl, rl)
        np.testing.assert_array_equal(gd, rd)


@pytest.mark.parametrize("part", [0, 1, 2])
def test_image_iter_parts_and_label_width_match_jax(tmp_path, part):
    rec = _write_images(tmp_path, n=14, label_width=3)[0]
    kw = dict(batch_size=2, data_shape=(3, 16, 16), path_imgrec=rec,
              label_width=3, part_index=part, num_parts=3,
              preprocess_threads=2, mean=True, std=True)
    with jmx.cpu():
        ref = _drain(jimage.ImageIter(**kw))
    with mx.cpu():
        it = timage.ImageIter(**kw)
        got = _drain(it)
    assert it.provide_label[0].shape == (2, 3)
    assert len(got) == len(ref) == (3 if part == 2 else 2)
    for (rd, rl), (gd, gl) in zip(ref, got):
        np.testing.assert_array_equal(gl, rl)
        np.testing.assert_allclose(gd, rd, rtol=1e-6)


def test_image_iter_needs_a_source():
    with pytest.raises(mx.MXNetError, match="need path_imgrec"):
        timage.ImageIter(2, (3, 8, 8))
    with pytest.raises(mx.MXNetError, match="data_shape"):
        timage.ImageIter(2, (8, 8), imglist=[])
