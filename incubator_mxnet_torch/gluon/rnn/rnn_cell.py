"""Per-step recurrent cells and `unroll` (counterpart of
`incubator_mxnet_tpu/gluon/rnn/rnn_cell.py`).

A cell runs one time step, `cell(x, states) -> (out, new_states)`;
`unroll` replays it over a sequence.  The fused layers of `rnn_layer.py`
run a whole sequence in one op; cells are for custom stepping.  States
that `unroll` makes itself lie on the inputs' device.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell", "VariationalDropoutCell"]


class RecurrentCell(HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        from ... import ndarray as nd
        states = []
        make = func or nd.zeros
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(make(shape=info["shape"], ctx=ctx, **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as nd
        axis = layout.find("T")
        batch_axis = layout.find("N")
        if isinstance(inputs, (list, tuple)):
            seq = list(inputs)
            batch = seq[0].shape[0]
        else:
            batch = inputs.shape[batch_axis]
            seq = [x.squeeze(axis=axis) for x in inputs.split(
                num_outputs=length, axis=axis, squeeze_axis=False)]
        states = begin_state or self.begin_state(batch,
                                                 ctx=seq[0].context)
        outputs = []
        step_states = []
        for t in range(length):
            out, states = self(seq[t], states)
            outputs.append(out)
            if valid_length is not None:
                step_states.append(states)
        if valid_length is not None:
            stacked = nd.stack(*outputs, axis=0)
            masked = nd.SequenceMask(stacked, valid_length,
                                     use_sequence_length=True)
            outputs = [masked[t] for t in range(length)]
            # per-sample final state = state at its LAST VALID step
            # (upstream SequenceLast contract; padding never leaks)
            states = [
                nd.SequenceLast(nd.stack(*[ss[i] for ss in step_states],
                                         axis=0),
                                valid_length, use_sequence_length=True)
                for i in range(len(states))]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def forward(self, x, states):
        self._counter += 1
        return super().forward(x, states)


class RNNCell(RecurrentCell):
    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def infer_shape(self, x, *a):
        self.i2h_weight.shape = (self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, x, states, i2h_weight=None, h2h_weight=None,
                       i2h_bias=None, h2h_bias=None):
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(RecurrentCell):
    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def infer_shape(self, x, *a):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, x, states, i2h_weight=None, h2h_weight=None,
                       i2h_bias=None, h2h_bias=None):
        gates = (F.FullyConnected(x, i2h_weight, i2h_bias,
                                  num_hidden=4 * self._hidden_size)
                 + F.FullyConnected(states[0], h2h_weight, h2h_bias,
                                    num_hidden=4 * self._hidden_size))
        i, f, g, o = F.split(gates, num_outputs=4, axis=-1)
        i, f, o = F.sigmoid(i), F.sigmoid(f), F.sigmoid(o)
        c = f * states[1] + i * F.tanh(g)
        h = o * F.tanh(c)
        return h, [h, c]


class GRUCell(RecurrentCell):
    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(3 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(3 * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(3 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(3 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def infer_shape(self, x, *a):
        self.i2h_weight.shape = (3 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, x, states, i2h_weight=None, h2h_weight=None,
                       i2h_bias=None, h2h_bias=None):
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        ir, iz, inn = F.split(i2h, num_outputs=3, axis=-1)
        hr, hz, hn = F.split(h2h, num_outputs=3, axis=-1)
        r = F.sigmoid(ir + hr)
        z = F.sigmoid(iz + hz)
        n = F.tanh(inn + r * hn)
        h = (1 - z) * n + z * states[0]
        return h, [h]


class SequentialRNNCell(RecurrentCell):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return [info for c in self._children.values()
                for info in c.state_info(batch_size)]

    def begin_state(self, batch_size=0, **kwargs):
        return [s for c in self._children.values()
                for s in c.begin_state(batch_size, **kwargs)]

    def __call__(self, x, states):
        next_states = []
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            x, new = cell(x, states[pos:pos + n])
            pos += n
            next_states.extend(new)
        return x, next_states

    def __len__(self):
        return len(self._children)


class ModifierCell(RecurrentCell):
    def __init__(self, base_cell):
        super().__init__(prefix=base_cell.prefix + "mod_")
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)


class DropoutCell(RecurrentCell):
    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, x, states):
        if self._rate > 0:
            x = F.Dropout(x, p=self._rate)
        return x, states


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo, self._zs = zoneout_outputs, zoneout_states

    def __call__(self, x, states):
        from ... import ndarray as nd
        out, next_states = self.base_cell(x, states)
        if self._zs > 0:
            mixed = []
            for new, old in zip(next_states, states):
                from ... import autograd as ag
                if ag.is_training():
                    mask = nd.Dropout(nd.ones_like(new), p=self._zs) > 0
                    mixed.append(nd.where(mask, new, old))
                else:
                    mixed.append(new * (1 - self._zs) + old * self._zs)
            next_states = mixed
        return out, next_states


class ResidualCell(ModifierCell):
    def __call__(self, x, states):
        out, next_states = self.base_cell(x, states)
        return out + x, next_states


class BidirectionalCell(RecurrentCell):
    """Run two cells over the sequence in opposite directions and concat
    their per-step outputs."""

    def __init__(self, l_cell, r_cell, **kwargs):
        super().__init__(**kwargs)
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return (self.l_cell.state_info(batch_size)
                + self.r_cell.state_info(batch_size))

    def begin_state(self, batch_size=0, **kwargs):
        return (self.l_cell.begin_state(batch_size, **kwargs)
                + self.r_cell.begin_state(batch_size, **kwargs))

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(
            "BidirectionalCell is unrolled over a whole sequence; "
            "use .unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as nd
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            inputs = [x.squeeze(axis=axis) for x in inputs.split(
                num_outputs=length, axis=axis, squeeze_axis=False)]
        n_l = len(self.l_cell.state_info())
        states = begin_state
        l0 = states[:n_l] if states else None
        r0 = states[n_l:] if states else None

        if valid_length is None:
            rev_inputs = list(reversed(inputs))
        else:
            # per-sample reversal: padding must stay at the tail so the
            # backward cell starts from each sample's LAST VALID step
            stacked = nd.stack(*inputs, axis=0)          # (T, N, C)
            rev = nd.SequenceReverse(stacked, valid_length,
                                     use_sequence_length=True)
            rev_inputs = [rev[t] for t in range(length)]

        l_out, l_states = self.l_cell.unroll(
            length, inputs, begin_state=l0, merge_outputs=False,
            valid_length=valid_length)
        r_out, r_states = self.r_cell.unroll(
            length, rev_inputs, begin_state=r0, merge_outputs=False,
            valid_length=valid_length)
        if valid_length is None:
            r_out = list(reversed(r_out))
        else:
            rstacked = nd.stack(*r_out, axis=0)
            rrev = nd.SequenceReverse(rstacked, valid_length,
                                      use_sequence_length=True)
            r_out = [rrev[t] for t in range(length)]
        outputs = [nd.concat(lo, ro, dim=-1)
                   for lo, ro in zip(l_out, r_out)]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states


class VariationalDropoutCell(ModifierCell):
    """Same dropout mask at every time step (Gal & Ghahramani 2016)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self._di, self._ds, self._do = drop_inputs, drop_states, drop_outputs
        self._masks = {}

    def reset(self):
        super().reset()
        if hasattr(self, "_masks"):
            self._masks = {}

    def _mask(self, key, arr, rate):
        from ... import ndarray as nd
        if rate <= 0.0:
            return arr
        m = self._masks.get(key)
        if m is None or m.shape != arr.shape:
            # framework RNG + input dtype/ctx (inverted-dropout keep
            # mask, same recipe as ZoneoutCell)
            m = nd.Dropout(nd.ones_like(arr), p=rate)
            self._masks[key] = m
        return arr * m

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        # fresh masks per SEQUENCE, constant across its time steps
        # (Gal & Ghahramani); manual per-step callers use reset()
        self.reset()
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)

    def hybrid_forward(self, F, x, states):
        from ... import autograd
        if autograd.is_training():
            x = self._mask("in", x, self._di)
            states = [self._mask(f"st{i}", s, self._ds)
                      for i, s in enumerate(states)]
        out, nstates = self.base_cell(x, states)
        if autograd.is_training():
            out = self._mask("out", out, self._do)
        return out, nstates
