"""Convolution and pooling layers (counterpart of
`incubator_mxnet_tpu/gluon/nn/conv_layers.py`): 1-, 2- and 3-D
convolutions, the transposed ones, and the max, avg and global
poolings.  Data is NC(D)HW and convolution weights (out, in, *kernel),
as in the JAX package; a transposed convolution's weight is (in, out,
*kernel).  The ops are `Convolution`, `Deconvolution` and `Pooling` of
`ops/nn.py`."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D"]


def _pair(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    """A convolution with weight (channels, in_channels // groups,
    *kernel), or under `op_name="Deconvolution"` a transposed one with
    weight (in_channels, channels // groups, *kernel); `in_channels=0`
    defers the input side to the first forward."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 **kwargs):
        super().__init__(**kwargs)
        ndim = len(kernel_size)
        self._kwargs = {
            "kernel": kernel_size,
            "stride": _pair(strides, ndim),
            "dilate": _pair(dilation, ndim),
            "pad": _pair(padding, ndim),
            "num_filter": channels,
            "num_group": groups,
            "no_bias": not use_bias,
        }
        if adj is not None:
            self._kwargs["adj"] = _pair(adj, ndim)
        self._op_name = op_name
        self._activation = activation
        with self.name_scope():
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups)
            elif in_channels:
                wshape = (in_channels, channels // groups)
            else:
                wshape = (0, channels)
            wshape += tuple(kernel_size)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            self.bias = (self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None)

    def infer_shape(self, x):
        w = list(self.weight.shape)
        if self._op_name == "Convolution":
            w[1] = x.shape[1] // self._kwargs["num_group"]
        else:
            w[0] = x.shape[1]
        self.weight.shape = tuple(w)

    def hybrid_forward(self, F, x, weight=None, bias=None):
        out = getattr(F, self._op_name)(x, weight, bias, **self._kwargs)
        if self._activation is not None:
            out = F.Activation(out, act_type=self._activation)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        ndim = len(pool_size)
        self._kwargs = {
            "kernel": pool_size,
            "stride": _pair(strides, ndim),
            "pad": _pair(padding, ndim),
            "pool_type": pool_type,
            "global_pool": global_pool,
            "pooling_convention": "full" if ceil_mode else "valid",
        }
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_pair(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", count_include_pad=count_include_pad,
                         **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_pair(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", count_include_pad=count_include_pad,
                         **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_pair(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", count_include_pad=count_include_pad,
                         **kwargs)


class _GlobalPool(_Pooling):
    def __init__(self, ndim, pool_type, **kwargs):
        super().__init__((1,) * ndim, None, 0, True, True, pool_type,
                         **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "max", **kwargs)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "max", **kwargs)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "max", **kwargs)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "avg", **kwargs)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "avg", **kwargs)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "avg", **kwargs)
