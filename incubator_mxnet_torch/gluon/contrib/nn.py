"""Contrib layers (counterpart of `incubator_mxnet_tpu/gluon/contrib/nn.py`):
Concurrent/HybridConcurrent, Identity, PixelShuffle1D/2D/3D and
SyncBatchNorm."""
from __future__ import annotations

from ..nn.basic_layers import HybridSequential, BatchNorm
from ..block import HybridBlock

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "PixelShuffle1D",
           "PixelShuffle2D", "PixelShuffle3D", "SyncBatchNorm"]


class HybridConcurrent(HybridSequential):
    """Every child on the same input, the outputs concatenated along
    `axis`."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def _eager_forward(self, x, *args):
        from ... import ndarray as F
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


Concurrent = HybridConcurrent


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class PixelShuffle1D(HybridBlock):
    """(N, C·f, W) to (N, C, W·f)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factor = int(factor)

    def hybrid_forward(self, F, x):
        f = self._factor
        n, c, w = x.shape
        out = F.reshape(x, shape=(n, c // f, f, w))
        out = F.transpose(out, axes=(0, 1, 3, 2))
        return F.reshape(out, shape=(n, c // f, w * f))


class PixelShuffle2D(HybridBlock):
    """(N, C·f1·f2, H, W) to (N, C, H·f1, W·f2), the channels split as
    (C, f1, f2) (the CRD order of the JAX layer; `depth_to_space` is
    DCR)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        if isinstance(factor, int):
            factor = (factor, factor)
        self._factors = tuple(int(f) for f in factor)

    def hybrid_forward(self, F, x):
        f1, f2 = self._factors
        n, c, h, w = x.shape
        c_out = c // (f1 * f2)
        out = F.reshape(x, shape=(n, c_out, f1, f2, h, w))
        out = F.transpose(out, axes=(0, 1, 4, 2, 5, 3))
        return F.reshape(out, shape=(n, c_out, h * f1, w * f2))


class PixelShuffle3D(HybridBlock):
    """(N, C·f1·f2·f3, D, H, W) to (N, C, D·f1, H·f2, W·f3), CRD."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        if isinstance(factor, int):
            factor = (factor, factor, factor)
        self._factors = tuple(int(f) for f in factor)

    def hybrid_forward(self, F, x):
        f1, f2, f3 = self._factors
        n, c, d, h, w = x.shape
        c_out = c // (f1 * f2 * f3)
        out = F.reshape(x, shape=(n, c_out, f1, f2, f3, d, h, w))
        out = F.transpose(out, axes=(0, 1, 5, 2, 6, 3, 7, 4))
        return F.reshape(out, shape=(n, c_out, d * f1, h * f2, w * f3))


class SyncBatchNorm(BatchNorm):
    """BatchNorm: on one device the batch statistics are already the
    whole batch's.  `num_devices` is taken and ignored."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)
