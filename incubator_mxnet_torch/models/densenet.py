"""DenseNet 121/161/169/201 (counterpart of
`incubator_mxnet_tpu/models/densenet.py`).  Each dense layer appends its
`growth_rate` channels to its input's (a concatenation); a transition
halves the channels and the resolution."""
from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]

# num_init_features, growth_rate, block_config
_spec = {121: (64, 32, [6, 12, 24, 16]),
         161: (96, 48, [6, 12, 36, 24]),
         169: (64, 32, [6, 12, 32, 32]),
         201: (64, 32, [6, 12, 48, 32])}


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(nn.BatchNorm(), nn.Activation("relu"),
                          nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                                    use_bias=False),
                          nn.BatchNorm(), nn.Activation("relu"),
                          nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                                    use_bias=False))
            self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        out = self.body(x)
        if self.dropout is not None:
            out = self.dropout(out)
        return F.concat(x, out, dim=1)


def _transition(out_channels):
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(out_channels, kernel_size=1, use_bias=False),
            nn.AvgPool2D(pool_size=2, strides=2))
    return seq


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(
                nn.Conv2D(num_init_features, kernel_size=7, strides=2,
                          padding=3, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            channels = num_init_features
            for i, n_layers in enumerate(block_config):
                for _ in range(n_layers):
                    self.features.add(_DenseLayer(growth_rate, bn_size,
                                                  dropout))
                    channels += growth_rate
                if i != len(block_config) - 1:
                    channels //= 2
                    self.features.add(_transition(channels))
            self.features.add(nn.BatchNorm(), nn.Activation("relu"),
                              nn.GlobalAvgPool2D(), nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _make(n):
    def ctor(**kwargs):
        ni, gr, cfg = _spec[n]
        return DenseNet(ni, gr, cfg, **kwargs)
    ctor.__name__ = f"densenet{n}"
    return ctor


densenet121, densenet161, densenet169, densenet201 = (
    _make(121), _make(161), _make(169), _make(201))
