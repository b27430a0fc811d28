"""SqueezeNet 1.0 and 1.1 (counterpart of
`incubator_mxnet_tpu/models/squeezenet.py`).  Fire modules: a 1x1
squeeze, then 1x1 and 3x3 expands concatenated on the channels; the max
pools use the "full" convention (`ceil_mode=True`)."""
from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    def __init__(self, squeeze, expand1x1, expand3x3, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.squeeze = nn.Conv2D(squeeze, kernel_size=1)
            self.expand1 = nn.Conv2D(expand1x1, kernel_size=1)
            self.expand3 = nn.Conv2D(expand3x3, kernel_size=3, padding=1)

    def hybrid_forward(self, F, x):
        x = F.relu(self.squeeze(x))
        return F.concat(F.relu(self.expand1(x)), F.relu(self.expand3(x)),
                        dim=1)


def _pool():
    return nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True)


class SqueezeNet(HybridBlock):
    def __init__(self, version="1.0", classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(
                    nn.Conv2D(96, kernel_size=7, strides=2),
                    nn.Activation("relu"), _pool(),
                    _Fire(16, 64, 64), _Fire(16, 64, 64),
                    _Fire(32, 128, 128), _pool(),
                    _Fire(32, 128, 128), _Fire(48, 192, 192),
                    _Fire(48, 192, 192), _Fire(64, 256, 256), _pool(),
                    _Fire(64, 256, 256))
            else:
                self.features.add(
                    nn.Conv2D(64, kernel_size=3, strides=2),
                    nn.Activation("relu"), _pool(),
                    _Fire(16, 64, 64), _Fire(16, 64, 64), _pool(),
                    _Fire(32, 128, 128), _Fire(32, 128, 128), _pool(),
                    _Fire(48, 192, 192), _Fire(48, 192, 192),
                    _Fire(64, 256, 256), _Fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1),
                            nn.Activation("relu"),
                            nn.GlobalAvgPool2D(), nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(**kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return SqueezeNet("1.1", **kwargs)
