"""Contrib recurrent cells (counterpart of
`incubator_mxnet_tpu/gluon/contrib/rnn.py`): the convolutional RNN,
LSTM and GRU cells in 1, 2 and 3 dimensions.

Each cell's gates are an input-to-hidden and a hidden-to-hidden
`Convolution`; the hidden-to-hidden one is padded to keep the state's
shape, so its kernel must be odd.  States are (N, hidden_channels,
*spatial), their spatial shape known from `input_shape=(C, *spatial)`
or from the first step.
"""
from __future__ import annotations

from ..rnn.rnn_cell import RecurrentCell
from ...base import MXNetError

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _pair(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvRNNBase(RecurrentCell):
    """The i2h and h2h convolutions that give the gate stacks."""

    _num_gates = 1

    def __init__(self, hidden_channels, kernel_size, ndim,
                 input_shape=None, i2h_kernel=None, h2h_kernel=None,
                 strides=1, padding=None, dilation=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hc = hidden_channels
        self._ndim = ndim
        self._i2h_kernel = _pair(i2h_kernel or kernel_size, ndim)
        self._h2h_kernel = _pair(h2h_kernel or kernel_size, ndim)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise MXNetError("h2h kernel must be odd (state shape "
                                 "must be preserved across steps)")
        self._strides = _pair(strides, ndim)
        self._dilation = _pair(dilation, ndim)
        self._i2h_pad = _pair(padding if padding is not None
                              else tuple(k // 2 for k in self._i2h_kernel),
                              ndim)
        self._h2h_pad = tuple(d * (k - 1) // 2 for k, d in
                              zip(self._h2h_kernel, self._dilation))
        g = self._num_gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g * hidden_channels, 0)
                + self._i2h_kernel, init=i2h_weight_initializer,
                allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g * hidden_channels, hidden_channels)
                + self._h2h_kernel, init=h2h_weight_initializer,
                allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(g * hidden_channels,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(g * hidden_channels,),
                init=h2h_bias_initializer, allow_deferred_init=True)
        self._state_shape = None
        if input_shape is not None:
            self._apply_input_shape(tuple(input_shape))

    def _apply_input_shape(self, ishape):
        self.i2h_weight.shape = (self._num_gates * self._hc, ishape[0]) \
            + self._i2h_kernel
        spatial = tuple(
            (ishape[1 + i] + 2 * self._i2h_pad[i]
             - self._dilation[i] * (self._i2h_kernel[i] - 1) - 1)
            // self._strides[i] + 1 for i in range(self._ndim))
        self._state_shape = (self._hc,) + spatial

    def infer_shape(self, x, *a):
        self._apply_input_shape(tuple(x.shape[1:]))

    def state_info(self, batch_size=0):
        if self._state_shape is None:
            raise MXNetError(
                f"{type(self).__name__}: state shape unknown — pass "
                "input_shape=(C, *spatial) at construction, or run one "
                "step with explicit states before begin_state()")
        shape = (batch_size,) + self._state_shape
        n_states = 2 if self._num_gates == 4 else 1
        return [{"shape": shape, "__layout__": "NC" + "DHW"[-self._ndim:]}
                ] * n_states

    def _convs(self, F, x, h, i2h_weight, h2h_weight, i2h_bias, h2h_bias):
        g = self._num_gates
        i2h = F.Convolution(x, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel,
                            stride=self._strides, pad=self._i2h_pad,
                            dilate=self._dilation,
                            num_filter=g * self._hc)
        h2h = F.Convolution(h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel,
                            stride=(1,) * self._ndim, pad=self._h2h_pad,
                            dilate=self._dilation,
                            num_filter=g * self._hc)
        return i2h, h2h


class _ConvRNNCell(_ConvRNNBase):
    _num_gates = 1

    def hybrid_forward(self, F, x, states, i2h_weight=None, h2h_weight=None,
                       i2h_bias=None, h2h_bias=None):
        i2h, h2h = self._convs(F, x, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        h = F.tanh(i2h + h2h)
        return h, [h]


class _ConvLSTMCell(_ConvRNNBase):
    _num_gates = 4

    def hybrid_forward(self, F, x, states, i2h_weight=None, h2h_weight=None,
                       i2h_bias=None, h2h_bias=None):
        i2h, h2h = self._convs(F, x, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        i, f, g, o = F.split(i2h + h2h, num_outputs=4, axis=1)
        i, f, o = F.sigmoid(i), F.sigmoid(f), F.sigmoid(o)
        c = f * states[1] + i * F.tanh(g)
        h = o * F.tanh(c)
        return h, [h, c]


class _ConvGRUCell(_ConvRNNBase):
    _num_gates = 3

    def hybrid_forward(self, F, x, states, i2h_weight=None, h2h_weight=None,
                       i2h_bias=None, h2h_bias=None):
        i2h, h2h = self._convs(F, x, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        i_r, i_z, i_n = F.split(i2h, num_outputs=3, axis=1)
        h_r, h_z, h_n = F.split(h2h, num_outputs=3, axis=1)
        r = F.sigmoid(i_r + h_r)
        z = F.sigmoid(i_z + h_z)
        n = F.tanh(i_n + r * h_n)
        h = (1 - z) * n + z * states[0]
        return h, [h]


def _make(cls, ndim, name, kind):
    return type(name, (cls,), {
        "__init__": lambda self, hidden_channels, kernel_size, **kw:
            cls.__init__(self, hidden_channels, kernel_size, ndim, **kw),
        "__doc__": f"{ndim}-D convolutional {kind} cell.",
    })


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell", "RNN")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell", "RNN")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell", "RNN")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell", "LSTM")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell", "LSTM")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell", "LSTM")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell", "GRU")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell", "GRU")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell", "GRU")
