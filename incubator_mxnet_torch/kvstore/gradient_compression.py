"""2-bit gradient compression (counterpart of
`incubator_mxnet_tpu/kvstore/gradient_compression.py`).

A gradient element past +-threshold is sent as +-threshold in 2 bits
(16x smaller than float32 on the wire); what is not sent stays in a
per-key residual on the worker, so it is delayed, never lost.  This is
host-side bit packing for the `dist_*` wire, in numpy as in the JAX
package: 4 codes per byte, the same bytes.
"""
from __future__ import annotations

import struct as _struct

import numpy as _np

from ..base import MXNetError

__all__ = ["GradientCompression", "wire_body", "decode_wire"]

_CODE_ZERO, _CODE_POS, _CODE_NEG = 0, 1, 2


class GradientCompression:
    """Quantizer with per-key residual state (worker side owns it)."""

    def __init__(self, type="2bit", threshold=0.5):
        if type != "2bit":
            raise MXNetError(f"unsupported gradient compression {type!r}")
        if not threshold > 0:
            raise MXNetError("gradient compression threshold must be > 0")
        self.type = type
        self.threshold = float(threshold)
        self._residual = {}

    # ------------------------------------------------------------------
    def compress(self, key, grad):
        """grad (a numpy array or a torch tensor, any shape) -> packed
        uint8 array.  The key's residual is added first; what the codes
        cannot carry stays in the residual."""
        thr = self.threshold
        g = _host_f32(grad)
        res = self._residual.get(key)
        if res is None:
            res = _np.zeros(g.shape, _np.float32)
        acc = res + g
        codes = _np.where(acc >= thr, _CODE_POS,
                          _np.where(acc <= -thr, _CODE_NEG, _CODE_ZERO)) \
            .astype(_np.uint8)
        sent = _np.where(codes == _CODE_POS, thr,
                         _np.where(codes == _CODE_NEG, -thr, 0.0)) \
            .astype(_np.float32)
        self._residual[key] = acc - sent
        flat = codes.reshape(-1)
        pad = (-flat.size) % 4
        if pad:
            flat = _np.concatenate([flat, _np.zeros(pad, _np.uint8)])
        quads = flat.reshape(-1, 4)
        packed = (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
                  | (quads[:, 3] << 6)).astype(_np.uint8)
        return packed

    def decompress(self, packed, shape):
        """packed uint8 array → float gradient of `shape`."""
        thr = self.threshold
        n = int(_np.prod(shape)) if len(shape) else 1
        b = packed.astype(_np.uint8)
        codes = _np.empty((b.size, 4), _np.uint8)
        codes[:, 0] = b & 3
        codes[:, 1] = (b >> 2) & 3
        codes[:, 2] = (b >> 4) & 3
        codes[:, 3] = (b >> 6) & 3
        flat = codes.reshape(-1)[:n]
        out = _np.where(flat == _CODE_POS, thr,
                        _np.where(flat == _CODE_NEG, -thr, 0.0)) \
            .astype(_np.float32)
        return out.reshape(shape)

    def residual(self, key):
        return self._residual.get(key)


# -- wire framing (the dist transport's compressed-payload format) ------

def _host_f32(x):
    """`x` as a float32 numpy array on the host (a bfloat16 tensor's
    values are exact in float32)."""
    if isinstance(x, _np.ndarray):
        return x.astype(_np.float32, copy=False)
    import torch
    return x.detach().to("cpu", torch.float32).numpy()


def wire_body(gc, wire_key, part):
    """Compressed wire body: [thr f32][ndim u8][shape u32..][codes].

    The `_OP_PUSH_CMP` payload and a multi-op entry body (entry flag
    `_ENTRY_2BIT`): one format in both framings."""
    packed = gc.compress(wire_key, part)
    shape = tuple(part.shape)
    hdr = _struct.pack("<fB", gc.threshold, len(shape)) + _struct.pack(
        f"<{len(shape)}I", *shape)
    return hdr + packed.tobytes()


def decode_wire(body):
    """Inverse of :func:`wire_body` (server side: the dequantize is
    stateless — residuals live with the compressing worker)."""
    (thr,) = _struct.unpack("<f", body[:4])
    ndim = body[4]
    shape = _struct.unpack(f"<{ndim}I", body[5:5 + 4 * ndim])
    packed = _np.frombuffer(body[5 + 4 * ndim:], dtype=_np.uint8)
    return GradientCompression(threshold=thr).decompress(packed, shape)
