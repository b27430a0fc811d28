"""VGG 11/13/16/19, with or without BatchNorm (counterpart of
`incubator_mxnet_tpu/models/vgg.py`)."""
from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
         13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
         16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
         19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


class VGG(HybridBlock):
    """Stages of `layers[i]` 3x3 convolutions of `filters[i]` channels,
    each stage closed by a 2x2 max pool, then two Dense(4096) with
    dropout and the classifier."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for n, f in zip(layers, filters):
                for _ in range(n):
                    self.features.add(nn.Conv2D(f, kernel_size=3, padding=1))
                    if batch_norm:
                        self.features.add(nn.BatchNorm())
                    self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(strides=2))
            self.features.add(nn.Flatten(),
                              nn.Dense(4096, activation="relu"),
                              nn.Dropout(0.5),
                              nn.Dense(4096, activation="relu"),
                              nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _make(n):
    def ctor(**kwargs):
        layers, filters = _spec[n]
        return VGG(layers, filters, **kwargs)
    ctor.__name__ = f"vgg{n}"
    return ctor


vgg11, vgg13, vgg16, vgg19 = _make(11), _make(13), _make(16), _make(19)
