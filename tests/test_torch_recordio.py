"""The port's `recordio` against the JAX package's on the CPU: record
files written by each package read in the other (sequential and
indexed), byte-for-byte equal files, `pack`/`unpack` with scalar and
vector labels, and `pack_img`/`unpack_img` (the JPEG bytes equal PIL's;
PNG, written by the port's own encoder, decodes to the same pixels).

Tolerance: none; records, headers and files are compared exactly.  The
JAX writer is run on its Python path (its native library is switched
off), which is the format the port writes.
"""
import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401
from incubator_mxnet_tpu import recordio as jrec

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import recordio as rec


@pytest.fixture
def jax_python_path(monkeypatch):
    monkeypatch.setattr(jrec, "_native", lambda: None)


def _payloads(rng, n=9):
    # lengths 0..n-1 cover every padding to a multiple of 4
    return [rng.randint(0, 256, k).astype(np.uint8).tobytes()
            for k in range(n)] + [b"\xce\xd7\x23\x0a" * 3]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sequential_records_cross_between_packages(tmp_path, writer,
                                                   jax_python_path):
    payloads = _payloads(np.random.RandomState(0))
    paths = {k: str(tmp_path / f"{k}.rec") for k in ("port", "jax")}
    for mod, key in ((rec, "port"), (jrec, "jax")):
        w = mod.MXRecordIO(paths[key], "w")
        offsets = [w.write(p) for p in payloads]
        assert offsets[0] == 0
        w.close()
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    for reader in (rec, jrec):
        r = reader.MXRecordIO(paths[writer], "r")
        got = []
        while (buf := r.read()) is not None:
            got.append(buf)
        assert got == payloads
        r.reset()
        assert r.read() == payloads[0]
        r.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_indexed_records_cross_between_packages(tmp_path, writer,
                                                jax_python_path):
    payloads = _payloads(np.random.RandomState(1))
    mod = rec if writer == "port" else jrec
    idx, path = str(tmp_path / "d.idx"), str(tmp_path / "d.rec")
    w = mod.MXIndexedRecordIO(idx, path, "w")
    for i, p in enumerate(payloads):
        w.write_idx(i * 10, p)
    w.close()
    for reader in (rec, jrec):
        r = reader.MXIndexedRecordIO(idx, path, "r")
        assert r.keys == [i * 10 for i in range(len(payloads))]
        for k in reversed(r.keys):
            assert r.read_idx(k) == payloads[k // 10]
        r.close()


def test_flags_and_corruption_raise(tmp_path):
    with pytest.raises(mx.MXNetError, match="flag"):
        rec.MXRecordIO(str(tmp_path / "a.rec"), "x")
    path = str(tmp_path / "b.rec")
    with rec.MXRecordIO(path, "w") as w:
        w.write(b"abc")
        with pytest.raises(mx.MXNetError, match="not opened for reading"):
            w.read()
    with open(path, "r+b") as f:
        f.write(b"\x00")
    r = rec.MXRecordIO(path, "r")
    with pytest.raises(mx.MXNetError, match="corrupt"):
        r.read()
    with pytest.raises(mx.MXNetError, match="not opened for writing"):
        r.write(b"x")
    r.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0],
                                   np.array([0.5, 7.0], np.float32)])
def test_pack_unpack_match_jax(label):
    hdr = rec.IRHeader(0, label, 17, 3)
    payload = b"payload-bytes"
    packed = rec.pack(hdr, payload)
    assert packed == jrec.pack(jrec.IRHeader(0, label, 17, 3), payload)
    for mod in (rec, jrec):
        h, s = mod.unpack(packed)
        assert s == payload
        assert (h.flag, h.id, h.id2) == (
            0 if np.ndim(label) == 0 else len(label), 17, 3)
        np.testing.assert_array_equal(np.asarray(h.label, np.float32),
                                      np.asarray(label, np.float32)
                                      if np.ndim(label) else
                                      np.float32(label))


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_pack_img_matches_jax(fmt):
    pytest.importorskip("PIL")
    img = np.random.RandomState(2).randint(0, 256, (6, 5, 3)).astype(
        np.uint8)
    hdr = rec.IRHeader(0, 4.0, 1, 0)
    packed = rec.pack_img(hdr, img, img_fmt=fmt)
    jpacked = jrec.pack_img(jrec.IRHeader(0, 4.0, 1, 0), img, img_fmt=fmt)
    if fmt == ".jpg":     # the port's encoder writes PIL's bytes
        assert packed == jpacked
    else:                 # PNG is lossless; the zlib streams may differ
        np.testing.assert_array_equal(jrec.unpack_img(packed)[1],
                                      jrec.unpack_img(jpacked)[1])
    (h, got), (_, ref) = rec.unpack_img(packed), jrec.unpack_img(packed)
    np.testing.assert_array_equal(got, ref)
    assert h.label == 4.0
    if fmt == ".png":
        np.testing.assert_array_equal(got, img)
    gray = rec.unpack_img(packed, iscolor=0)[1]
    np.testing.assert_array_equal(gray, jrec.unpack_img(packed, 0)[1])
