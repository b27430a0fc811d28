"""AlexNet (counterpart of `incubator_mxnet_tpu/models/alexnet.py`)."""
from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(
                nn.Conv2D(64, 11, 4, 2, activation="relu"),
                nn.MaxPool2D(3, 2),
                nn.Conv2D(192, 5, padding=2, activation="relu"),
                nn.MaxPool2D(3, 2),
                nn.Conv2D(384, 3, padding=1, activation="relu"),
                nn.Conv2D(256, 3, padding=1, activation="relu"),
                nn.Conv2D(256, 3, padding=1, activation="relu"),
                nn.MaxPool2D(3, 2),
                nn.Flatten(),
                nn.Dense(4096, activation="relu"), nn.Dropout(0.5),
                nn.Dense(4096, activation="relu"), nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(**kwargs):
    return AlexNet(**kwargs)
