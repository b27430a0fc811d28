"""ResNet v1, v1b, v2 and the CIFAR family (counterpart of
`incubator_mxnet_tpu/models/resnet.py`).

The same blocks under the same attribute names (`features`, `output`,
`body`, `downsample`, `bn1`, `conv1`, ...), so the structural parameter
names, the keys of `convert.params_from_jax`, are the JAX package's.
v1b puts the stride of a bottleneck in its 3x3 convolution instead of
its first 1x1; v2 is pre-activation (BatchNorm and ReLU before each
convolution).  `pretrained=True` loads sha1-checked weights from the
local model store (`gluon/model_zoo/model_store.py`).
"""
from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock
from ..base import MXNetError

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet", "get_cifar_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2", "resnet50_v1b", "resnet101_v1b",
           "resnet152_v1b", "cifar_resnet20_v1", "cifar_resnet56_v1",
           "cifar_resnet110_v1", "cifar_resnet20_v2", "cifar_resnet56_v2",
           "cifar_resnet110_v2"]


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


class _ResidualV2(HybridBlock):
    """Pre-activation: x → relu(bn1(x)) feeds the shortcut `downsample`
    (else x itself is the shortcut) and the convolutions, each behind
    BatchNorm and ReLU; the sum has no activation."""

    def _shortcut(self, F, x):
        pre = F.Activation(self.bn1(x), act_type="relu")
        return pre, (x if self.downsample is None else self.downsample(pre))


class BasicBlockV2(_ResidualV2):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.bn1 = nn.BatchNorm()
            self.conv1 = _conv3x3(channels, stride, in_channels)
            self.bn2 = nn.BatchNorm()
            self.conv2 = _conv3x3(channels, 1, channels)
            self.downsample = (nn.Conv2D(channels, 1, stride, use_bias=False,
                                         in_channels=in_channels)
                               if downsample else None)

    def hybrid_forward(self, F, x):
        x, residual = self._shortcut(F, x)
        x = F.Activation(self.bn2(self.conv1(x)), act_type="relu")
        return self.conv2(x) + residual


class BottleneckV2(_ResidualV2):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        with self.name_scope():
            self.bn1 = nn.BatchNorm()
            self.conv1 = nn.Conv2D(mid, 1, 1, use_bias=False)
            self.bn2 = nn.BatchNorm()
            self.conv2 = _conv3x3(mid, stride, mid)
            self.bn3 = nn.BatchNorm()
            self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False)
            self.downsample = (nn.Conv2D(channels, 1, stride, use_bias=False,
                                         in_channels=in_channels)
                               if downsample else None)

    def hybrid_forward(self, F, x):
        x, residual = self._shortcut(F, x)
        x = F.Activation(self.bn2(self.conv1(x)), act_type="relu")
        x = F.Activation(self.bn3(self.conv2(x)), act_type="relu")
        return self.conv3(x) + residual


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


class ResNetV2(HybridBlock):
    """Pre-activation ResNet: a BatchNorm without gamma or beta on the
    input, and BatchNorm and ReLU after the last stage."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


_spec = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
         34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
         50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
         101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
         152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}

_v1_blocks = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}
_v2_blocks = {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}


def get_resnet(version, num_layers, pretrained=False, ctx=None, v1b=False,
               root=None, **kwargs):
    """ResNet v1 (or v1b) or v2 of `num_layers` layers; with `pretrained`
    the weights stored as resnet<n>_v<version>[b] in the local model
    store (`root`), loaded onto `ctx`."""
    block_type, layers, channels = _spec[num_layers]
    if version == 1:
        net = ResNetV1(_v1_blocks[block_type], layers, channels, v1b=v1b,
                       **kwargs)
    elif version == 2:
        net = ResNetV2(_v2_blocks[block_type], layers, channels, **kwargs)
    else:
        raise MXNetError(f"invalid resnet version {version}")
    if pretrained:
        from ..gluon.model_zoo.model_store import load_pretrained
        name = f"resnet{num_layers}_v{version}{'b' if v1b else ''}"
        load_pretrained(net, name, root=root, ctx=ctx)
    return net


def get_cifar_resnet(version, num_layers, classes=10, **kwargs):
    """CIFAR ResNet of depth 6n + 2: three stages of n basic blocks at
    16, 32 and 64 channels behind the 3x3 thumbnail stem."""
    if (num_layers - 2) % 6 != 0:
        raise MXNetError(
            f"CIFAR resnet depth must be 6n+2, got {num_layers}")
    n = (num_layers - 2) // 6
    layers, channels = [n] * 3, [16, 16, 32, 64]
    if version == 1:
        return ResNetV1(BasicBlockV1, layers, channels, classes=classes,
                        thumbnail=True, **kwargs)
    if version == 2:
        return ResNetV2(BasicBlockV2, layers, channels, classes=classes,
                        thumbnail=True, **kwargs)
    raise MXNetError(f"invalid resnet version {version}")


def _make_cifar(version, n):
    def ctor(**kwargs):
        return get_cifar_resnet(version, n, **kwargs)
    ctor.__name__ = f"cifar_resnet{n}_v{version}"
    return ctor


def _make(version, n, v1b=False):
    def ctor(**kwargs):
        return get_resnet(version, n, v1b=v1b, **kwargs)
    ctor.__name__ = f"resnet{n}_v{version}" + ("b" if v1b else "")
    return ctor


resnet18_v1 = _make(1, 18)
resnet34_v1 = _make(1, 34)
resnet50_v1 = _make(1, 50)
resnet101_v1 = _make(1, 101)
resnet152_v1 = _make(1, 152)
resnet18_v2 = _make(2, 18)
resnet34_v2 = _make(2, 34)
resnet50_v2 = _make(2, 50)
resnet101_v2 = _make(2, 101)
resnet152_v2 = _make(2, 152)
resnet50_v1b = _make(1, 50, v1b=True)
resnet101_v1b = _make(1, 101, v1b=True)
resnet152_v1b = _make(1, 152, v1b=True)
cifar_resnet20_v1 = _make_cifar(1, 20)
cifar_resnet56_v1 = _make_cifar(1, 56)
cifar_resnet110_v1 = _make_cifar(1, 110)
cifar_resnet20_v2 = _make_cifar(2, 20)
cifar_resnet56_v2 = _make_cifar(2, 56)
cifar_resnet110_v2 = _make_cifar(2, 110)
