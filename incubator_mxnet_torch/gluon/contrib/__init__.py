"""Gluon contrib (counterpart of `incubator_mxnet_tpu/gluon/contrib/`):
the `nn` layers, `cnn` (DeformableConvolution) and `rnn` (the
convolutional recurrent cells).  `estimator` is not ported yet."""
from . import nn
from . import cnn
from . import rnn
