"""Fused recurrent layers: `RNN`, `LSTM`, `GRU` over the `RNN` op
(counterpart of `incubator_mxnet_tpu/gluon/rnn/rnn_layer.py`)."""
from __future__ import annotations

from ..block import HybridBlock
from ...base import MXNetError
from ...initializer import Uniform
from ...ops.rnn import rnn_param_size

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """Every layer's weights in one packed 1-D `parameters` vector in
    cuDNN's layout, its length deferred until the input size is known.
    A matrix initializer (Xavier) cannot fill a 1-D vector, so the vector
    takes cuDNN's uniform ±1/sqrt(hidden) unless `i2h_weight_initializer`
    names another, whatever `initialize` is given."""

    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, mode, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"layout must be TNC or NTC, got {layout}")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        with self.name_scope():
            shape = (rnn_param_size(num_layers, input_size, hidden_size,
                                    bidirectional, mode),) \
                if input_size else (0,)
            self.parameters_ = self.params.get(
                "parameters", shape=shape,
                init=i2h_weight_initializer or Uniform(hidden_size ** -0.5),
                allow_deferred_init=True)

    def _alias(self):
        # the JAX layer's rule, run before `_mode` is set: every mode's
        # prefix is "rnn<n>_"
        return self._mode if hasattr(self, "_mode") else "rnn"

    def infer_shape(self, x, *states):
        self._input_size = x.shape[2]
        self.parameters_.shape = (rnn_param_size(
            self._num_layers, self._input_size, self._hidden_size,
            self._dir == 2, self._mode),)

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """The initial states, (layers * directions, batch, hidden) each:
        [h, c] for LSTM, [h] otherwise, made by `func` (`nd.zeros`)."""
        from ... import ndarray as nd
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        make = func or nd.zeros
        n_states = 2 if self._mode == "lstm" else 1
        return [make(shape=shape, ctx=ctx, **kwargs) for _ in range(n_states)]

    def hybrid_forward(self, F, x, *states, parameters_=None):
        """The output sequence alone without states; (sequence, new
        states) with them, given as arguments or as one list
        (`layer(x, [h, c])`).  Zero states lie on x's device in x's
        dtype."""
        if len(states) == 1 and isinstance(states[0], (list, tuple)):
            states = tuple(states[0])
        explicit_states = bool(states)
        if self._layout == "NTC":
            x = F.swapaxes(x, dim1=0, dim2=1)
        if not states:
            shape = (self._num_layers * self._dir, x.shape[1],
                     self._hidden_size)
            n_states = 2 if self._mode == "lstm" else 1
            states = [F.zeros(shape, ctx=x.context, dtype=x.dtype)
                      for _ in range(n_states)]
        out = F.RNN(x, parameters_, *states, state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True)
        seq, rstates = out[0], list(out[1:])
        if self._layout == "NTC":
            seq = F.swapaxes(seq, dim1=0, dim2=1)
        if explicit_states:
            return seq, rstates
        return seq


class RNN(_RNNLayer):
    """Elman RNN with a tanh or relu activation."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         "rnn_relu" if activation == "relu" else "rnn_tanh",
                         **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
