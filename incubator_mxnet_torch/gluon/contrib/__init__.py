"""Gluon contrib (counterpart of `incubator_mxnet_tpu/gluon/contrib/`):
the `nn` layers.  `estimator`, `cnn` and `rnn` are not ported yet."""
from . import nn
