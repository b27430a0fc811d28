"""Gluon contrib (counterpart of `incubator_mxnet_tpu/gluon/contrib/`):
`estimator` (the fit loop and its event handlers), the `nn` layers,
`cnn` (DeformableConvolution) and `rnn` (the convolutional recurrent
cells)."""
from . import estimator
from . import nn
from . import cnn
from . import rnn
