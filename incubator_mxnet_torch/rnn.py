"""Legacy symbolic RNN cells (counterpart of
`incubator_mxnet_tpu/rnn.py`): the pre-Gluon interface that
`example/rnn/bucketing`-era scripts use, where cells build `mx.sym`
graphs through `unroll()`.  `FusedRNNCell` lowers to the `sym.RNN`
op."""
from __future__ import annotations

from .base import MXNetError

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell", "FusedRNNCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ResidualCell"]


def _sym():
    from . import symbol as sym
    return sym


class BaseRNNCell:
    """Base: symbolic step + unroll (ref: rnn_cell.BaseRNNCell [U])."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._counter = -1

    @property
    def state_info(self):
        raise NotImplementedError

    def begin_state(self, func=None, **kwargs):
        sym = _sym()
        states = []
        for i, info in enumerate(self.state_info):
            self._counter += 1
            name = f"{self._prefix}begin_state_{self._counter}"
            if func is None:
                states.append(sym.var(name, **dict(kwargs, **info)))
            else:
                states.append(func(name=name, **dict(kwargs, **info)))
        return states

    def __call__(self, inputs, states):
        raise NotImplementedError

    def reset(self):
        self._counter = -1

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        sym = _sym()
        axis = layout.find("T")
        if isinstance(inputs, (list, tuple)):
            seq = list(inputs)
        else:
            seq = list(sym.split(inputs, num_outputs=length, axis=axis,
                                 squeeze_axis=True))
            if length == 1:
                seq = [seq] if not isinstance(seq, list) else seq
        states = begin_state if begin_state is not None \
            else self.begin_state()
        outputs = []
        for t in range(length):
            out, states = self(seq[t], states)
            outputs.append(out)
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    def __init__(self, num_hidden, activation="tanh", prefix="rnn_"):
        super().__init__(prefix)
        self._num_hidden = num_hidden
        self._activation = activation

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden)}]

    def __call__(self, inputs, states):
        sym = _sym()
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(inputs, num_hidden=self._num_hidden,
                                 name=f"{self._prefix}i2h")
        h2h = sym.FullyConnected(states[0], num_hidden=self._num_hidden,
                                 name=f"{self._prefix}h2h")
        h = sym.Activation(i2h + h2h, act_type=self._activation,
                           name=f"{name}out")
        return h, [h]


class LSTMCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="lstm_", forget_bias=1.0):
        super().__init__(prefix)
        self._num_hidden = num_hidden
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden)},
                {"shape": (0, self._num_hidden)}]

    def __call__(self, inputs, states):
        sym = _sym()
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(inputs, num_hidden=4 * self._num_hidden,
                                 name=f"{self._prefix}i2h")
        h2h = sym.FullyConnected(states[0],
                                 num_hidden=4 * self._num_hidden,
                                 name=f"{self._prefix}h2h")
        gates = i2h + h2h
        i, f, g, o = sym.split(gates, num_outputs=4, axis=-1,
                               name=f"{name}slice")
        i = sym.sigmoid(i)
        f = sym.sigmoid(f + self._forget_bias)
        o = sym.sigmoid(o)
        c = f * states[1] + i * sym.tanh(g)
        h = o * sym.tanh(c)
        return h, [h, c]


class GRUCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="gru_"):
        super().__init__(prefix)
        self._num_hidden = num_hidden

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden)}]

    def __call__(self, inputs, states):
        sym = _sym()
        self._counter += 1
        i2h = sym.FullyConnected(inputs, num_hidden=3 * self._num_hidden,
                                 name=f"{self._prefix}i2h")
        h2h = sym.FullyConnected(states[0],
                                 num_hidden=3 * self._num_hidden,
                                 name=f"{self._prefix}h2h")
        i_r, i_z, i_n = sym.split(i2h, num_outputs=3, axis=-1)
        h_r, h_z, h_n = sym.split(h2h, num_outputs=3, axis=-1)
        r = sym.sigmoid(i_r + h_r)
        z = sym.sigmoid(i_z + h_z)
        n = sym.tanh(i_n + r * h_n)
        h = (1 - z) * n + z * states[0]
        return h, [h]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence fused RNN — lowers to the scan-based `sym.RNN` op
    (the reference's cuDNN-fused path; ref: rnn_cell.FusedRNNCell [U])."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, prefix="rnn_"):
        super().__init__(prefix)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout

    @property
    def state_info(self):
        d = 2 if self._bidirectional else 1
        info = [{"shape": (self._num_layers * d, 0, self._num_hidden)}]
        if self._mode == "lstm":
            info.append({"shape": (self._num_layers * d, 0,
                                   self._num_hidden)})
        return info

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        sym = _sym()
        if isinstance(inputs, (list, tuple)):
            inputs = sym.stack(*inputs, axis=1 if layout == "NTC" else 0)
        if layout == "NTC":                  # RNN op wants TNC
            inputs = sym.swapaxes(inputs, dim1=0, dim2=1)
        state_kw = {}
        if begin_state is not None:          # carried state must be USED
            state_kw["state"] = begin_state[0]
            if self._mode == "lstm":
                state_kw["state_cell"] = begin_state[1]
        rnn = sym.RNN(inputs, state_size=self._num_hidden,
                      num_layers=self._num_layers, mode=self._mode,
                      bidirectional=self._bidirectional, p=self._dropout,
                      name=f"{self._prefix}rnn", **state_kw)
        out = rnn[0]
        states = [rnn[i] for i in range(1, len(rnn))]
        if layout == "NTC":
            out = sym.swapaxes(out, dim1=0, dim2=1)
        if merge_outputs is False:
            out = list(sym.split(out, num_outputs=length,
                                 axis=1 if layout == "NTC" else 0,
                                 squeeze_axis=True))
        return out, states


class SequentialRNNCell(BaseRNNCell):
    def __init__(self):
        super().__init__("")
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return [i for c in self._cells for i in c.state_info]

    def __call__(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, s = cell(inputs, states[p:p + n])
            next_states.extend(s)
            p += n
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    def __init__(self, dropout, prefix="dropout_"):
        super().__init__(prefix)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        sym = _sym()
        return sym.Dropout(inputs, p=self._dropout), states


class ResidualCell(BaseRNNCell):
    def __init__(self, base_cell):
        super().__init__("")
        self.base_cell = base_cell

    @property
    def state_info(self):
        return self.base_cell.state_info

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class BidirectionalCell(BaseRNNCell):
    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(output_prefix)
        self._l = l_cell
        self._r = r_cell

    @property
    def state_info(self):
        return self._l.state_info + self._r.state_info

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell supports unroll() only")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        sym = _sym()
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            inputs = list(sym.split(inputs, num_outputs=length, axis=axis,
                                    squeeze_axis=True))
        nl = len(self._l.state_info)
        begin = begin_state if begin_state is not None \
            else self._l.begin_state() + self._r.begin_state()
        l_out, l_states = self._l.unroll(length, inputs,
                                         begin_state=begin[:nl])
        r_out, r_states = self._r.unroll(length, list(reversed(inputs)),
                                         begin_state=begin[nl:])
        outs = [sym.concat(lo, ro, dim=-1)
                for lo, ro in zip(l_out, reversed(r_out))]
        if merge_outputs:
            outs = sym.stack(*outs, axis=axis)
        return outs, l_states + r_states
