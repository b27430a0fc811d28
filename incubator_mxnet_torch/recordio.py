"""RecordIO: binary record files for datasets (counterpart of
`incubator_mxnet_tpu/recordio.py`): `MXRecordIO`, `MXIndexedRecordIO`,
`IRHeader`, `pack`/`unpack` and `pack_img`/`unpack_img`.

The format is dmlc-core's, byte for byte the JAX package's: each record
is the magic 0xced7230a and its length as two little-endian uint32, the
payload, and zeros up to a multiple of 4 bytes; a `.idx` sidecar holds
one ``key<TAB>offset`` line a record.  Files written by either package
read in the other.  The reader and writer here are Python; the host
library's C copy of them (`csrc/recordio.cc`) serves the image-record
pipeline.  `pack_img` and `unpack_img` encode and decode through the
port's own codecs (`image/codec.py`): JPEG as PIL writes it at the same
quality (4:2:0), PNG losslessly.
"""
from __future__ import annotations

import os
import struct
import threading
from collections import namedtuple

import numpy as _np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1


class MXRecordIO:
    """Sequential record reader (flag "r") or writer (flag "w")."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self._fp = None
        if flag not in ("r", "w"):
            raise MXNetError("flag must be 'r' or 'w'")
        self.open()

    def open(self):
        self._fp = open(self.uri, "wb" if self.flag == "w" else "rb")

    def close(self):
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        """Append one record; returns its byte offset."""
        if self.flag != "w":
            raise MXNetError("not opened for writing")
        pos = self._fp.tell()
        self._fp.write(struct.pack("<II", _MAGIC, len(buf) & _LEN_MASK))
        self._fp.write(buf)
        pad = (4 - (len(buf) & 3)) & 3
        if pad:
            self._fp.write(b"\x00" * pad)
        return pos

    def read(self):
        """The next record's bytes, or None at the end of the file."""
        if self.flag != "r":
            raise MXNetError("not opened for reading")
        hdr = self._fp.read(8)
        if len(hdr) < 8:
            return None
        magic, lrec = struct.unpack("<II", hdr)
        if magic != _MAGIC:
            raise MXNetError("corrupt recordio stream")
        length = lrec & _LEN_MASK
        data = self._fp.read(length)
        pad = (4 - (length & 3)) & 3
        if pad:
            self._fp.read(pad)
        return data

    def seek(self, pos):
        self._fp.seek(pos)

    def tell(self):
        return self._fp.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random access through the `.idx` sidecar."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self._rlock = threading.Lock()
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        k = key_type(parts[0])
                        self.idx[k] = int(parts[1])
                        self.keys.append(k)

    def close(self):
        if self.flag == "w" and self.idx:
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def read_idx(self, idx):
        # seek and read together: DataLoader thread workers share this
        # handle, and interleaved seeks would return the wrong record
        with self._rlock:
            self.seek(self.idx[idx])
            return self.read()

    def write_idx(self, idx, buf):
        pos = self.write(buf)
        self.idx[idx] = pos
        self.keys.append(idx)


IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """An IRHeader and raw bytes as one record payload.  A label vector
    is carried after the header, with flag set to its length."""
    label = header.label
    if isinstance(label, (list, tuple, _np.ndarray)):
        label = _np.asarray(label, dtype=_np.float32)
        header = header._replace(flag=label.size, label=0.0)
        return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, float(label), header.id,
                       header.id2) + s


def unpack(s):
    """(IRHeader, payload bytes) of a record packed by `pack`."""
    hdr = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if hdr.flag > 0:
        label = _np.frombuffer(s[:hdr.flag * 4], dtype=_np.float32)
        s = s[hdr.flag * 4:]
        hdr = hdr._replace(label=label)
    return hdr, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC (or HW) uint8 array as JPEG at `quality` or as PNG,
    and pack it."""
    from .image import codec
    a = _np.asarray(img, dtype=_np.uint8)
    if img_fmt.lower() in (".jpg", ".jpeg"):
        buf = codec.jpeg_encode(a, quality=quality)
    else:
        buf = codec.png_encode(a)
    return pack(header, buf)


def unpack_img(s, iscolor=1):
    """(IRHeader, image) of a record packed by `pack_img`: HWC uint8 RGB,
    or HW uint8 gray (PIL's L weights) with `iscolor=0`."""
    from .image import codec
    hdr, img_bytes = unpack(s)
    img = codec.decode(img_bytes, channels=3 if iscolor else 1)
    return hdr, img if iscolor else img[:, :, 0]
