"""Basic neural-network layers (counterpart of
`incubator_mxnet_tpu/gluon/nn/basic_layers.py`), in full."""
from __future__ import annotations

import torch

from ... import autograd
from ...ndarray import NDArray
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "LayerNorm", "InstanceNorm", "Embedding", "Flatten", "Lambda",
           "HybridLambda", "Activation", "LeakyReLU", "PReLU", "ELU", "SELU",
           "GELU", "Swish", "ReflectionPad2D"]


class Sequential(Block):
    """Stack of blocks."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x, *args)
            args = ()
            if isinstance(x, (tuple, list)):
                args = tuple(x[1:])
                x = x[0]
        if args:
            return (x,) + args
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(Sequential, HybridBlock):
    forward = HybridBlock.forward

    def _eager_forward(self, x, *args):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """Fully-connected layer; the weight is (units, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)

    def infer_shape(self, x):
        in_units = x.size // x.shape[0] if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight=None, bias=None):
        if self.weight._shard is not None:
            # a block placed by a mesh trainer (parallel.tensor_parallel)
            from ...parallel.tensor_parallel import dense_forward
            out = NDArray(dense_forward(
                self, x.data, weight.data,
                None if bias is None else bias.data))
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten,
                                   no_bias=bias is None)
        if self._activation is not None:
            out = F.Activation(out, act_type=self._activation)
        return out


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(HybridBlock):
    """Batch normalization over axis `axis`.  `running_mean` and
    `running_var` take no gradient.  In train mode without
    `use_global_stats` the layer normalizes with the batch's statistics
    and folds them into the running stats as running·m + batch·(1 − m)
    in the running stats' own dtype, in place and outside any recorded
    graph; elsewhere it normalizes with the running stats."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True,
                grad_req="write" if center else "null")
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def hybrid_forward(self, F, x, gamma=None, beta=None, running_mean=None,
                       running_var=None):
        out, batch_mean, batch_var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis)
        if autograd.is_training() and not self._use_global_stats:
            m = self._momentum
            with torch.no_grad():
                for p, run, batch in ((self.running_mean, running_mean,
                                       batch_mean),
                                      (self.running_var, running_var,
                                       batch_var)):
                    p.set_data(run._data * m + batch._data * (1 - m))
        return out


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True,
                grad_req="write" if center else "null")

    def infer_shape(self, x):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class InstanceNorm(HybridBlock):
    """The `InstanceNorm` op with this layer's `epsilon`.  As in the JAX
    layer, gamma and beta always apply and take gradients; `axis`,
    `center` and `scale` are taken and ignored."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x):
        self.gamma.shape = (x.shape[1],)
        self.beta.shape = (x.shape[1],)

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class Embedding(HybridBlock):
    """Row lookup.  With `sparse_grad` the weight's gradient is
    row-sparse (`grad_stype="row_sparse"`): a recorded backward gives
    it only the looked-up rows.  While `ParallelTrainer` records rows
    (the weight's `_rows_sink` is set) the lookup is the dense op and
    its ids are recorded, for the trainer's lazy row update."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight=None):
        sink = self.weight._rows_sink
        if sink is not None:
            rows_out, idx = sink
            rows = x.data.reshape(-1)
            if idx in rows_out:      # a shared table looked up twice
                rows = torch.cat([rows_out[idx], rows])
            rows_out[idx] = rows
            self.weight._rows_lookups += 1
        elif self._sparse_grad:
            from ...ndarray.sparse import sparse_embedding
            return sparse_embedding(x, weight)
        if self.weight._shard is not None:
            from ...parallel.tensor_parallel import cut_axis, \
                embedding_forward
            if cut_axis(self.weight._shard, 0):
                return NDArray(embedding_forward(self, x.data, weight.data))
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Flatten(HybridBlock):
    """(N, ...) to (N, -1)."""

    def hybrid_forward(self, F, x):
        return F.flatten(x)


class Lambda(Block):
    """`function(*args)`; a string names a function of the `nd`
    namespace."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            function = getattr(nd, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """`function(F, *args)`; a string names a function of `F`."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_name = function if isinstance(function, str) else None
        self._func = function

    def hybrid_forward(self, F, *args):
        if self._func_name is not None:
            return getattr(F, self._func_name)(*args)
        return self._func(F, *args)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """x or alpha·x, `alpha` a Parameter of shape (in_channels,) over
    the channel axis (one value for every channel by default)."""

    def __init__(self, alpha_initializer="zeros", in_channels=1, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(in_channels,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha=None):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of H and W of NCHW data; an int pads all four
    sides, else `padding` is the `pad` op's (before, after) per axis."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
