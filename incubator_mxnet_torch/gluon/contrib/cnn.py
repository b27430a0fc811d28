"""Contrib CNN layers (counterpart of
`incubator_mxnet_tpu/gluon/contrib/cnn.py`): DeformableConvolution."""
from __future__ import annotations

from ..block import HybridBlock
from ..nn.conv_layers import _pair
from ...base import MXNetError

__all__ = ["DeformableConvolution"]


class DeformableConvolution(HybridBlock):
    """Deformable convolution v1: a plain convolution branch predicts
    each tap's (y, x) offset, and the deformable op samples the input
    bilinearly at the shifted taps (`_contrib_DeformableConvolution`).
    The offset branch starts at zero, so the layer starts as a plain
    convolution.  groups = num_deformable_group = 1, as in the JAX
    layer."""

    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, use_bias=True, in_channels=0,
                 activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        if groups != 1 or num_deformable_group != 1:
            raise MXNetError("DeformableConvolution: groups=1 only")
        kernel_size = _pair(kernel_size, 2)
        self._kwargs = {"kernel": kernel_size,
                        "stride": _pair(strides, 2),
                        "dilate": _pair(dilation, 2),
                        "pad": _pair(padding, 2),
                        "num_filter": channels,
                        "no_bias": not use_bias}
        self._activation = activation
        offset_channels = 2 * kernel_size[0] * kernel_size[1]
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels) + kernel_size,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            self.offset_weight = self.params.get(
                "offset_weight",
                shape=(offset_channels, in_channels) + kernel_size,
                init=offset_weight_initializer, allow_deferred_init=True)
            self.offset_bias = self.params.get(
                "offset_bias", shape=(offset_channels,),
                init=offset_bias_initializer, allow_deferred_init=True)

    def infer_shape(self, x):
        in_c = x.shape[1]
        for p in (self.weight, self.offset_weight):
            p.shape = (p.shape[0], in_c) + tuple(p.shape[2:])

    def hybrid_forward(self, F, x, weight=None, bias=None,
                       offset_weight=None, offset_bias=None):
        offset = F.Convolution(x, offset_weight, offset_bias,
                               kernel=self._kwargs["kernel"],
                               stride=self._kwargs["stride"],
                               dilate=self._kwargs["dilate"],
                               pad=self._kwargs["pad"],
                               num_filter=offset_weight.shape[0])
        out = F._contrib_DeformableConvolution(x, offset, weight, bias,
                                               **self._kwargs)
        if self._activation is not None:
            out = F.Activation(out, act_type=self._activation)
        return out
