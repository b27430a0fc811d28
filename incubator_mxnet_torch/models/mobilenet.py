"""MobileNet v1 and v2 (counterpart of
`incubator_mxnet_tpu/models/mobilenet.py`).  Depthwise 3x3 convolutions
(`groups` = channels) behind 1x1 pointwise ones; v2's inverted
residuals expand by t, filter depthwise and project back, adding the
input where the shape allows.  As in the JAX models, every activation
is a plain ReLU (no ReLU6) and v2's head has 1280·max(1, multiplier)
channels."""
from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet_v2_1_0"]


def _conv_block(out, channels, kernel, stride, pad, num_group=1,
                active=True):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    if active:
        out.add(nn.Activation("relu"))


def _dw_block(out, dw_channels, channels, stride):
    _conv_block(out, dw_channels, 3, stride, 1, num_group=dw_channels)
    _conv_block(out, channels, 1, 1, 0)


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _conv_block(self.features, int(32 * multiplier), 3, 2, 1)
            dw = [32, 64, 128, 128, 256, 256, 512, 512, 512, 512, 512, 512,
                  1024]
            ch = [64, 128, 128, 256, 256, 512, 512, 512, 512, 512, 512, 1024,
                  1024]
            st = [1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 2, 1]
            for d, c, s in zip(dw, ch, st):
                _dw_block(self.features, int(d * multiplier),
                          int(c * multiplier), s)
            self.features.add(nn.GlobalAvgPool2D(), nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class _InvertedResidual(HybridBlock):
    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = nn.HybridSequential(prefix="")
            mid = in_channels * t
            if t != 1:
                _conv_block(self.out, mid, 1, 1, 0)
            _conv_block(self.out, mid, 3, stride, 1, num_group=mid)
            _conv_block(self.out, channels, 1, 1, 0, active=False)

    def hybrid_forward(self, F, x):
        out = self.out(x)
        return out + x if self.use_shortcut else out


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _conv_block(self.features, int(32 * multiplier), 3, 2, 1)
            spec = [  # t, c, n, s
                (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
            in_c = int(32 * multiplier)
            for t, c, n, s in spec:
                c = int(c * multiplier)
                for i in range(n):
                    self.features.add(_InvertedResidual(
                        in_c, c, t, s if i == 0 else 1))
                    in_c = c
            _conv_block(self.features, int(1280 * max(1.0, multiplier)),
                        1, 1, 0)
            self.features.add(nn.GlobalAvgPool2D(), nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def mobilenet1_0(**kwargs):
    return MobileNet(1.0, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return MobileNetV2(1.0, **kwargs)
