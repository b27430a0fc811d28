"""ResNet v1 and v1b (counterpart of `incubator_mxnet_tpu/models/resnet.py`).

The same blocks under the same attribute names (`features`, `output`,
`body`, `downsample`), so the structural parameter names, the keys of
`convert.params_from_jax`, are the JAX package's.  v1b puts the stride
of a bottleneck in its 3x3 convolution instead of its first 1x1.
ResNetV2 and the CIFAR family are not ported yet.
"""
from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock
from ..base import MXNetError

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet50_v1b", "resnet101_v1b", "resnet152_v1b"]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


def _downsample(channels, stride, in_channels):
    ds = nn.HybridSequential(prefix="")
    ds.add(nn.Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                     in_channels=in_channels),
           nn.BatchNorm())
    return ds


class _ResidualV1(HybridBlock):
    """relu(body(x) + shortcut(x)), the shortcut `downsample` or x."""

    def hybrid_forward(self, F, x):
        residual = x
        out = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(x)
        return F.Activation(out + residual, act_type="relu")


class BasicBlockV1(_ResidualV1):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(_conv3x3(channels, stride, in_channels),
                          nn.BatchNorm(),
                          nn.Activation("relu"),
                          _conv3x3(channels, 1, channels),
                          nn.BatchNorm())
            self.downsample = (_downsample(channels, stride, in_channels)
                               if downsample else None)


class BottleneckV1(_ResidualV1):
    """v1: the stride in the first 1x1; v1b: in the 3x3."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 v1b=False, **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        s1, s3 = (1, stride) if v1b else (stride, 1)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(
                nn.Conv2D(mid, kernel_size=1, strides=s1, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                _conv3x3(mid, s3, mid),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2D(channels, kernel_size=1, strides=1, use_bias=False),
                nn.BatchNorm())
            self.downsample = (_downsample(channels, stride, in_channels)
                               if downsample else None)


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 v1b=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"ResNetV1: {len(layers)} stages need "
                             f"{len(layers) + 1} channel counts, got "
                             f"{len(channels)}")
        self._v1b = v1b
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            kw = {"v1b": self._v1b} if block is BottleneckV1 else {}
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix="", **kw))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix="", **kw))
        return layer

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


_spec = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
         34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
         50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
         101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
         152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}

_v1_blocks = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, pretrained=False, ctx=None, v1b=False,
               root=None, **kwargs):
    """ResNet v1 (or v1b) of `num_layers` layers; random weights only."""
    if version != 1:
        raise MXNetError(f"resnet version {version}: only v1 is ported")
    if pretrained:
        raise MXNetError("pretrained weights are not ported")
    block_type, layers, channels = _spec[num_layers]
    return ResNetV1(_v1_blocks[block_type], layers, channels, v1b=v1b,
                    **kwargs)


def _make(n, v1b=False):
    def ctor(**kwargs):
        return get_resnet(1, n, v1b=v1b, **kwargs)
    ctor.__name__ = f"resnet{n}_v1" + ("b" if v1b else "")
    return ctor


resnet18_v1 = _make(18)
resnet34_v1 = _make(34)
resnet50_v1 = _make(50)
resnet101_v1 = _make(101)
resnet152_v1 = _make(152)
resnet50_v1b = _make(50, v1b=True)
resnet101_v1b = _make(101, v1b=True)
resnet152_v1b = _make(152, v1b=True)
