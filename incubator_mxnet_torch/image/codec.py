"""The port's image codecs: what the JAX package reads and writes
through PIL (`imdecode`, `pack_img`, `unpack_img`), without PIL.

* JPEG decodes and encodes through `csrc/jpeg_codec.cc` (host C++, built
  at first use by `_native`): baseline and extended-sequential Huffman
  streams decode to the pixels PIL gives, at full size or at 1/2, 1/4
  and 1/8; the encoder writes PIL's baseline JFIF at the same quality.
  Progressive, arithmetic, lossless, 12-bit and CMYK streams raise
  `MXNetError` naming the feature.
* PNG decodes in Python with the stdlib `zlib`: gray, gray + alpha, RGB,
  RGBA and palette images, 8-bit (gray and palette also at 1, 2 and 4
  bits), filters 0-4, not interlaced.  PNG encodes 8-bit gray, RGB or
  RGBA with filter 0.
* BMP decodes uncompressed 24- and 32-bit images.

Decoded images are HWC uint8 with 3 channels (RGB), or 1 (PIL's
``convert("L")`` weights of RGB) for `channels=1`; alpha is dropped as
``convert("RGB")`` drops it.
"""
from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as _np

from .. import _native
from ..base import MXNetError

__all__ = ["decode", "jpeg_decode", "jpeg_encode", "png_encode",
           "image_format"]

_P = ctypes.POINTER
_ERRLEN = 256


def _bytes(buf):
    if isinstance(buf, bytes):
        return buf
    if isinstance(buf, _np.ndarray):
        return buf.tobytes()
    return bytes(buf)


def image_format(buf):
    """"jpeg", "png", "bmp" or None from the first bytes."""
    if buf[:2] == b"\xff\xd8":
        return "jpeg"
    if buf[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if buf[:2] == b"BM":
        return "bmp"
    return None


def _gray(rgb):
    """PIL's convert("L"): (R 19595 + G 38470 + B 7471 + 0x8000) >> 16."""
    a = rgb.astype(_np.uint32)
    return ((a[..., 0] * 19595 + a[..., 1] * 38470 + a[..., 2] * 7471
             + 0x8000) >> 16).astype(_np.uint8)[..., None]


def _channels(rgb_or_gray, channels):
    a = rgb_or_gray
    if channels == 1:
        return a if a.shape[2] == 1 else _gray(a)
    return _np.repeat(a, 3, axis=2) if a.shape[2] == 1 else a


# -- JPEG (host library) ----------------------------------------------------

def jpeg_decode(buf, channels=3, scale_denom=1):
    """JPEG bytes -> HWC uint8 with `channels` (1 or 3; 0 keeps the
    stream's own), decoded at 1/`scale_denom` of the size (1, 2, 4, 8)."""
    buf = _bytes(buf)
    fn = _native.entry("mxjpeg_decode", [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        _P(_P(ctypes.c_uint8)), _P(ctypes.c_int), _P(ctypes.c_int),
        _P(ctypes.c_int), ctypes.c_char_p, ctypes.c_int])
    out = _P(ctypes.c_uint8)()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if fn(buf, len(buf), int(scale_denom), int(channels), ctypes.byref(out),
          ctypes.byref(h), ctypes.byref(w), ctypes.byref(c), err, _ERRLEN):
        raise MXNetError(f"cannot decode JPEG: {err.value.decode()}")
    try:
        return _np.ctypeslib.as_array(
            out, (h.value, w.value, c.value)).copy()
    finally:
        _native.entry("mxhost_free", [ctypes.c_void_p], None)(out)


def jpeg_encode(img, quality=95):
    """HWC (or HW) uint8 with 1 or 3 channels -> baseline JFIF bytes, as
    PIL writes them at `quality` (color as 4:2:0, PIL's default)."""
    a = _np.ascontiguousarray(img, dtype=_np.uint8)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in (1, 3):
        raise MXNetError(f"JPEG encodes 1 or 3 channels, not shape "
                         f"{a.shape}")
    fn = _native.entry("mxjpeg_encode", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _P(_P(ctypes.c_uint8)), _P(ctypes.c_size_t),
        ctypes.c_char_p, ctypes.c_int])
    out = _P(ctypes.c_uint8)()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERRLEN)
    if fn(a.ctypes.data, a.shape[0], a.shape[1], a.shape[2], int(quality),
          ctypes.byref(out), ctypes.byref(n), err, _ERRLEN):
        raise MXNetError(f"cannot encode JPEG: {err.value.decode()}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        _native.entry("mxhost_free", [ctypes.c_void_p], None)(out)


# -- PNG ---------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw, height, stride, bpp):
    out = _np.zeros((height, stride), _np.uint8)
    prev = _np.zeros(stride, _np.int64)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = _np.frombuffer(raw, _np.uint8, stride, pos + 1).astype(_np.int64)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:     # Sub: a running sum along each byte lane
            cur = line.copy()
            for k in range(bpp, stride, bpp):
                cur[k:k + bpp] = (cur[k:k + bpp] + cur[k - bpp:k]) & 255
        elif ftype == 2:     # Up
            cur = (line + prev) & 255
        elif ftype == 3:     # Average
            cur = line.copy()
            cur[:bpp] = (cur[:bpp] + (prev[:bpp] >> 1)) & 255
            for k in range(bpp, stride, bpp):
                cur[k:k + bpp] = (cur[k:k + bpp] + ((cur[k - bpp:k]
                                  + prev[k:k + bpp]) >> 1)) & 255
        elif ftype == 4:     # Paeth
            cur = [int(v) for v in line]
            up = [int(v) for v in prev]
            for k in range(stride):
                left = cur[k - bpp] if k >= bpp else 0
                ul = up[k - bpp] if k >= bpp else 0
                cur[k] = (cur[k] + _paeth(left, up[k], ul)) & 255
            cur = _np.asarray(cur, _np.int64)
        else:
            raise MXNetError(f"cannot decode PNG: bad filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def png_decode(buf, channels=3):
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise MXNetError("cannot decode PNG: bad signature")
    pos, ihdr, palette, idat = 8, None, None, []
    while pos + 8 <= len(buf):
        length, ctype = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + length]
        if len(body) < length:
            raise MXNetError("cannot decode PNG: truncated chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = _np.frombuffer(body, _np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise MXNetError("cannot decode PNG: no IHDR or IDAT")
    width, height, depth, ctype, _comp, _filt, interlace = ihdr
    if interlace:
        raise MXNetError("interlaced PNG is not supported")
    if ctype not in _PNG_CHANNELS:
        raise MXNetError(f"cannot decode PNG: color type {ctype}")
    if depth == 16:
        raise MXNetError("16-bit PNG is not supported")
    if depth != 8 and ctype not in (0, 3):
        raise MXNetError(f"cannot decode PNG: {depth}-bit color type {ctype}")
    nch = _PNG_CHANNELS[ctype]
    stride = (width * nch * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise MXNetError(f"cannot decode PNG: {e}") from None
    if len(raw) < height * (stride + 1):
        raise MXNetError("cannot decode PNG: truncated image data")
    rows = _unfilter(raw, height, stride, max(1, nch * depth // 8))
    if depth < 8:
        bits = _np.unpackbits(rows, axis=1)
        vals = bits[:, :width * depth].reshape(height, width, depth)
        weights = (1 << _np.arange(depth - 1, -1, -1)).astype(_np.uint8)
        px = (vals * weights).sum(axis=2).astype(_np.uint8)[..., None]
        if ctype == 0:      # PIL scales 1-, 2- and 4-bit gray to 0..255
            px = (px.astype(_np.uint32) * (255 // ((1 << depth) - 1))
                  ).astype(_np.uint8)
    else:
        px = rows.reshape(height, width, nch)
    if ctype == 3:
        if palette is None:
            raise MXNetError("cannot decode PNG: palette image without PLTE")
        idx = px[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            pad = _np.zeros((256, 3), _np.uint8)
            pad[:len(palette)] = palette
            palette = pad
        px = palette[idx]
    elif ctype == 4:
        px = px[..., :1]
    elif ctype == 6:
        px = px[..., :3]
    return _channels(_np.ascontiguousarray(px), channels)


def png_encode(img):
    """HWC (or HW) uint8 with 1 or 3 channels -> PNG bytes (filter 0)."""
    a = _np.ascontiguousarray(img, dtype=_np.uint8)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    if c not in (1, 3, 4):
        raise MXNetError(f"PNG encodes 1, 3 or 4 channels, not {c}")
    ctype = {1: 0, 3: 2, 4: 6}[c]
    raw = _np.concatenate([_np.zeros((h, 1), _np.uint8),
                           a.reshape(h, w * c)], axis=1).tobytes()

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


# -- BMP ---------------------------------------------------------------------

def bmp_decode(buf, channels=3):
    if len(buf) < 54 or buf[:2] != b"BM":
        raise MXNetError("cannot decode BMP: bad header")
    offset = struct.unpack("<I", buf[10:14])[0]
    hsize = struct.unpack("<I", buf[14:18])[0]
    if hsize < 40:
        raise MXNetError("cannot decode BMP: OS/2 headers are not supported")
    width, height, _planes, bpp, compression = struct.unpack(
        "<iiHHI", buf[18:34])
    if bpp not in (24, 32) or compression not in (0, 3):
        raise MXNetError(f"BMP: only uncompressed 24- and 32-bit images "
                         f"are supported (got {bpp}-bit, compression "
                         f"{compression})")
    flip = height > 0
    height = abs(height)
    nb = bpp // 8
    stride = (width * nb + 3) & ~3
    data = _np.frombuffer(buf, _np.uint8, stride * height, offset)
    px = data.reshape(height, stride)[:, :width * nb].reshape(
        height, width, nb)[..., 2::-1]
    if flip:
        px = px[::-1]
    return _channels(_np.ascontiguousarray(px), channels)


def decode(buf, channels=3):
    """JPEG, PNG or BMP bytes -> HWC uint8 with 1 or 3 channels."""
    buf = _bytes(buf)
    fmt = image_format(buf)
    if fmt == "jpeg":
        return jpeg_decode(buf, channels=channels)
    if fmt == "png":
        return png_decode(buf, channels)
    if fmt == "bmp":
        return bmp_decode(buf, channels)
    raise MXNetError("cannot decode image: not a JPEG, PNG or BMP stream")
