"""Optimizers (counterpart of `incubator_mxnet_tpu/optimizer/optimizer.py`):
`register`/`create`, the `Optimizer` base with its learning-rate
schedule and lr/wd multipliers, `SGD`, `NAG`, `Adam` (bias correction
folded into lr), `AdaGrad`, `RMSProp`, `AdaDelta`, `Ftrl`, `Signum`,
`LAMB`, `DCASGD`, and the per-key `Updater`.

`update(index, weight, grad, state)` keeps the MXNet API.  It runs the
update of `ops/optim.py` and writes the new values into the weight and
state tensors in place (the JAX package rebinds immutable arrays);
weights keep their dtype, states are float32 except DCASGD's, which
are in the weight's dtype as in the JAX package.

A row-sparse gradient (`ndarray.sparse.RowSparseNDArray`) takes the
lazy row updates of SGD and Adam, which touch only its rows; DCASGD
computes on its dense form, as the JAX package's NDArray arithmetic
does.  The seven others raise on it (the JAX package fails there too).
"""
from __future__ import annotations

import math
import pickle

import numpy as _np
import torch

from ..base import MXNetError
from ..ndarray import NDArray, zeros, zeros_like, array
from ..ops import optim as _k
from ..ops.optim import sgd_multi, adam_multi

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "Ftrl", "Signum", "LAMB", "DCASGD", "Updater",
           "get_updater", "create", "register", "ELEMENTWISE_OPTS"]

#: Optimizers whose update is purely elementwise: applying them to a flat
#: view equals applying them per parameter (`Updater.update_flat`).
#: LAMB's layer-wise trust ratio would take its norms over the whole
#: view, so it keeps the per-key path.
ELEMENTWISE_OPTS = ("sgd", "nag", "adam", "adagrad", "rmsprop",
                    "adadelta", "signum")

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    try:
        return _REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise MXNetError(f"unknown optimizer {name!r}") from None


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult, self.wd_mult = {}, {}

    # -- schedule / multipliers ------------------------------------------
    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _mult(self, index, table, attr):
        param = self.param_dict.get(index)
        if param is not None:
            return getattr(param, attr, 1.0)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update)
              if self.lr_scheduler is not None else self.lr)
        return lr * self._mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    def _clip(self):
        return self.clip_gradient if self.clip_gradient is not None else -1.0

    def _kernel_kwargs(self, index):
        return dict(lr=self._get_lr(index), wd=self._get_wd(index),
                    rescale_grad=self.rescale_grad,
                    clip_gradient=self._clip())

    def _dense(self, grad):
        """The gradient's tensor; a row-sparse one raises, for the
        optimizers with no lazy row update."""
        if _is_rsp(grad):
            raise MXNetError(
                f"{type(self).__name__} takes no row_sparse gradient: only "
                f"SGD and Adam have a lazy row update (DCASGD computes "
                f"densely); give the parameter a dense gradient")
        return grad._data

    # -- state / update ----------------------------------------------------
    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


def _f32_zeros(weight):
    return zeros(weight.shape, weight.context, dtype="float32")


def _write(weight, new):
    """Round the float32 result `new` into `weight` in place."""
    with torch.no_grad():
        weight._data.copy_(new)


def _write_all(arrays, values):
    for a, v in zip(arrays, values):
        _write(a, v)


def _is_rsp(grad):
    from ..ndarray.sparse import RowSparseNDArray
    return isinstance(grad, RowSparseNDArray)


@register
class SGD(Optimizer):
    """SGD with optional momentum (the JAX package's `sgd_update` /
    `sgd_mom_update`)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _f32_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        if _is_rsp(grad):
            from ..ndarray import sparse as _sp
            kw = self._kernel_kwargs(index)
            if state is None:
                _sp.sgd_update_rsp(weight, grad, kw["lr"], kw["wd"],
                                   kw["rescale_grad"], kw["clip_gradient"])
            else:
                _sp.sgd_mom_update_rsp(weight, state, grad, kw["lr"],
                                       self.momentum, kw["wd"],
                                       kw["rescale_grad"],
                                       kw["clip_gradient"])
            return
        with torch.no_grad():
            (new,) = sgd_multi(
                [weight._data], [grad._data],
                None if state is None else [state._data],
                lrs=self._get_lr(index), momentum=self.momentum,
                wds=self._get_wd(index), rescale=self.rescale_grad,
                clip=self._clip())
        _write(weight, new)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into lr, as MXNet does."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _f32_zeros(weight), _f32_zeros(weight)

    def corrected_lr(self, lr, t):
        """lr with Adam's bias correction for step t folded in."""
        return lr * (math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        if _is_rsp(grad):
            from ..ndarray import sparse as _sp
            kw = self._kernel_kwargs(index)
            _sp.adam_update_rsp(weight, mean, var, grad,
                                self.corrected_lr(kw["lr"], t), self.beta1,
                                self.beta2, self.epsilon, kw["wd"],
                                kw["rescale_grad"], kw["clip_gradient"])
            return
        with torch.no_grad():
            (new,) = adam_multi(
                [weight._data], [grad._data], [mean._data], [var._data],
                lrs=self.corrected_lr(self._get_lr(index), t),
                beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                wds=self._get_wd(index), rescale=self.rescale_grad,
                clip=self._clip())
        _write(weight, new)


@register
class NAG(Optimizer):
    """Nesterov momentum (`nag_mom_update`); its momentum state exists
    even at momentum 0, as in the JAX package."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _f32_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _write_all((weight, state), _k.nag_mom_update(
            weight._data, self._dense(grad), state._data,
            momentum=self.momentum, **self._kernel_kwargs(index)))


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _f32_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _write_all((weight, state), _k.adagrad_update(
            weight._data, self._dense(grad), state._data,
            epsilon=self.float_stable_eps, **self._kernel_kwargs(index)))


@register
class RMSProp(Optimizer):
    """RMSProp; `centered` keeps (n, g, delta) and takes
    `rmspropalex_update`, else one state n and `rmsprop_update`, whose
    weights are clipped to ±`clip_weights` when it is set."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_f32_zeros(weight) for _ in range(3))
        return _f32_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._kernel_kwargs(index)
        cw = self.clip_weights if self.clip_weights is not None else -1.0
        g = self._dense(grad)
        if self.centered:
            _write_all((weight,) + state, _k.rmspropalex_update(
                weight._data, g, *(s._data for s in state),
                gamma1=self.gamma1, gamma2=self.gamma2,
                epsilon=self.epsilon, clip_weights=cw, **kw))
        else:
            _write_all((weight, state), _k.rmsprop_update(
                weight._data, g, state._data, gamma1=self.gamma1,
                epsilon=self.epsilon, clip_weights=cw, **kw))


@register
class AdaDelta(Optimizer):
    """AdaDelta: no learning rate enters the update."""

    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _f32_zeros(weight), _f32_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._kernel_kwargs(index)
        kw.pop("lr")
        _write_all((weight,) + state, _k.adadelta_update(
            weight._data, self._dense(grad), *(s._data for s in state),
            rho=self.rho, epsilon=self.epsilon, **kw))


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _f32_zeros(weight), _f32_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _write_all((weight,) + state, _k.ftrl_update(
            weight._data, self._dense(grad), *(s._data for s in state),
            lamda1=self.lamda1, beta=self.beta,
            **self._kernel_kwargs(index)))


@register
class Signum(Optimizer):
    """Sign SGD.  `momentum` and `wd_lh` are taken and, as in the JAX
    package, unused: no state, `signsgd_update` every step."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _write(weight, _k.signsgd_update(
            weight._data, self._dense(grad), **self._kernel_kwargs(index)))


@register
class LAMB(Optimizer):
    """Layer-wise adaptive large-batch optimizer: phase 1 gives the raw
    step, phase 2 scales it by the trust ratio ‖w‖ / ‖step‖.  ‖w‖ is
    taken in the weight's dtype and ‖step‖ in float32, as in the JAX
    package; both stay on the device.  A bound of None or 0 is off."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return _f32_zeros(weight), _f32_zeros(weight)

    def update(self, index, weight, grad, state):
        from ..ops.reduce import norm
        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._kernel_kwargs(index)
        mean, var = state
        step, nm, nv = _k.lamb_update_phase1(
            weight._data, self._dense(grad), mean._data, var._data,
            beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon, t=t,
            bias_correction=self.bias_correction, wd=kw["wd"],
            rescale_grad=kw["rescale_grad"],
            clip_gradient=kw["clip_gradient"])
        with torch.no_grad():
            r1, r2 = norm(weight._data), norm(step)
        new = _k.lamb_update_phase2(
            weight._data, step, r1, r2, lr=kw["lr"],
            lower_bound=self.lower_bound if self.lower_bound else -1.0,
            upper_bound=self.upper_bound if self.upper_bound else -1.0)
        _write_all((weight, mean, var), (new, nm, nv))


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD: w −= lr·(g + wd·w + λ·g·g·(w − w_prev)),
    with momentum when it is not 0.  As in the JAX package it computes
    in the weight's dtype (its NDArray arithmetic) and its state
    (momentum or None, the previous weight) is in that dtype; the
    previous weight is a copy taken before each update."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = zeros_like(weight) if self.momentum != 0.0 else None
        return mom, NDArray(weight._data.detach().clone())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        mom, prev = state
        g = grad.tostype("default") if _is_rsp(grad) else grad
        w, p = weight._data, prev._data

        def c(v):
            # a Python number in the weight's dtype, as JAX's weak types
            # round it before the product
            return torch.tensor(v, dtype=w.dtype).item()
        lr, wd = c(self._get_lr(index)), c(self._get_wd(index))
        with torch.no_grad():
            g = g._data * c(self.rescale_grad)
            if self.clip_gradient is not None:
                g = g.clamp(-self.clip_gradient, self.clip_gradient)
            comp = g + wd * w + c(self.lamda) * g * g * (w - p)
            p.copy_(w)
            if mom is not None:
                mom._data.copy_(c(self.momentum) * mom._data - lr * comp)
                w.copy_(w + mom._data)
            else:
                w.copy_(w - lr * comp)


def _state_to_numpy(v):
    """A state slot as numpy: None, an array, or a tuple of them (with
    None in it, as DCASGD's (None, prev))."""
    if isinstance(v, tuple):
        return tuple(_state_to_numpy(s) for s in v)
    return v.asnumpy() if isinstance(v, NDArray) else v


def _state_from_numpy(v, ctx):
    if isinstance(v, tuple):
        return tuple(_state_from_numpy(s, ctx) for s in v)
    return array(v, ctx=ctx) if isinstance(v, _np.ndarray) else v


class Updater:
    """Applies an optimizer keyed by integer index, keeping one state
    slot per key."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight, state_key=None):
        """`index` is the parameter's identity (lr_mult/wd_mult lookups);
        `state_key` (default: index) keys the state slot."""
        skey = index if state_key is None else state_key
        if skey not in self.states:
            self.states[skey] = self.optimizer.create_state(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[skey])

    def update_flat(self, index, grad, weight, state_key=None):
        """Apply the optimizer to one flat shard (a 1-d weight and grad)
        in one pass, with the state slots of the per-key path.  Returns
        False for an optimizer whose update is not elementwise."""
        if type(self.optimizer).__name__.lower() not in ELEMENTWISE_OPTS:
            return False
        self(index, NDArray(grad._data.reshape(-1)),
             NDArray(weight._data.reshape(-1)), state_key)
        return True

    def get_states(self, dump_optimizer=False):
        return pickle.dumps({k: _state_to_numpy(v)
                             for k, v in self.states.items()})

    def set_states(self, states, ctx=None):
        """Load `get_states` output onto `ctx` (default: the current
        context)."""
        self.states = {k: _state_from_numpy(v, ctx)
                       for k, v in pickle.loads(states).items()}


def get_updater(optimizer):
    return Updater(optimizer)
