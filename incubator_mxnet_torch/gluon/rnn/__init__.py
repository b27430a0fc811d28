"""Recurrent layers and cells (counterpart of
`incubator_mxnet_tpu/gluon/rnn/`)."""
from .rnn_layer import RNN, LSTM, GRU
from .rnn_cell import (RecurrentCell, RNNCell, LSTMCell, GRUCell,
                       SequentialRNNCell, ModifierCell, DropoutCell,
                       ZoneoutCell, ResidualCell, BidirectionalCell,
                       VariationalDropoutCell)
