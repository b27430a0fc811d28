"""Executor: a bound symbolic graph (counterpart of
`incubator_mxnet_tpu/executor.py`).

`bind` keeps the argument, gradient and auxiliary arrays; `forward`
interprets the graph with the port's ops on the bound tensors, on their
device (`symbol._interp`; no `torch.compile`).  In a training forward
the gradient-taking arguments enter as fresh autograd leaves, and
`backward` takes torch autograd from the head outputs to them, writing
or adding into `args_grad` as `grad_req` says (`write`/`add`/`null`).
As in the JAX package, an array fed or written takes the new value's
dtype.
BatchNorm's moving mean and variance fold in the batch statistics in a
training forward, as running·m + batch·(1 − m), in the aux arrays.
Random ops draw from the framework generator of the device (the
streams are not the JAX package's).
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import as_device
from .ndarray import NDArray

__all__ = ["Executor"]


def _tensor(v, device):
    """The tensor of an NDArray, tensor or array-like (numpy's 64-bit
    dtypes stored 32-bit, as `nd.array` stores them), on `device`."""
    if isinstance(v, NDArray):
        t = v._data
    elif isinstance(v, torch.Tensor):
        t = v
    else:
        from .context import cpu
        from .ndarray import array
        t = array(v, ctx=cpu())._data
    return t if device is None else t.to(device)


class Executor:
    def __init__(self, sym, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        from .symbol.symbol import Group
        self._sym = sym
        self._ctx = ctx
        self._device = None if ctx is None else as_device(ctx)
        self._heads = sym.heads if isinstance(sym, Group) else [sym]
        self.arg_names = sym.list_arguments()
        self.aux_names = sym.list_auxiliary_states()

        if isinstance(args, (list, tuple)):
            args = dict(zip(self.arg_names, args))
        self.arg_dict = dict(args or {})
        missing = [n for n in self.arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")

        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(self.arg_names, args_grad))
        self.grad_dict = dict(args_grad or {})

        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self.grad_req = dict(grad_req)

        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.aux_names, aux_states))
        self.aux_dict = dict(aux_states or {})
        for n in self.aux_names:
            if n not in self.aux_dict:
                raise MXNetError(f"bind: missing auxiliary state {n}")

        self.outputs = []
        self._graph = None          # (head tensors, leaves) to backward
        self._monitor = None
        self._grad_names = [n for n in self.arg_names
                            if self.grad_req.get(n, "null") != "null"]
        self._bn_updates = self._find_bn_updates()

    # ------------------------------------------------------------------
    def _find_bn_updates(self):
        """(node, aux_mean_name, aux_var_name, momentum) per BatchNorm."""
        from .ops import registry as _reg
        updates = []
        op = _reg.get_opdef("BatchNorm")
        for node in self._sym._topo():
            if node._op == "BatchNorm":
                names = {}
                for i, inp in enumerate(node._inputs):
                    if i < len(op.input_names) and inp.is_var():
                        names[op.input_names[i]] = inp._name
                mean_n = names.get("moving_mean")
                var_n = names.get("moving_var")
                if mean_n and var_n:
                    momentum = node._attrs.get("momentum", 0.9)
                    updates.append((node, mean_n, var_n, momentum))
        return updates

    def set_monitor_callback(self, callback, monitor_all=False):
        """`callback(name, NDArray)` for every node output of each
        forward (`monitor_all` is taken for the reference's signature:
        every output is seen)."""
        self._monitor = callback

    # ------------------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        from .symbol.symbol import _interp
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {k}")
            # feeds land on the executor's device, in their own dtype
            self.arg_dict[k]._assign(_tensor(v, self._device))
        record = is_train and bool(self._grad_names)
        bindings, leaves = {}, []
        for n in self.arg_names:
            t = self.arg_dict[n]._data
            if record and n in self._grad_names and t.is_floating_point():
                t = t.detach().requires_grad_(True)
                leaves.append((n, t))
            bindings[n] = t
        for n in self.aux_names:
            bindings[n] = self.aux_dict[n]._data.detach()
        bn_syms = []
        if is_train:
            for node, _m, _v, _mom in self._bn_updates:
                bn_syms.extend([node[1], node[2]])
        monitor = None if self._monitor is None else (
            lambda name, t: self._monitor(name, NDArray(t.detach())))
        with torch.set_grad_enabled(record):
            outs = _interp(list(self._heads) + bn_syms, bindings, is_train,
                           monitor)
        heads = outs[:len(self._heads)]
        if is_train:
            with torch.no_grad():
                j = len(self._heads)
                for _node, mean_n, var_n, m in self._bn_updates:
                    for name, batch in ((mean_n, outs[j]),
                                        (var_n, outs[j + 1])):
                        aux = self.aux_dict[name]
                        aux._assign((aux._data * m + batch * (1 - m)).to(
                            aux._data.dtype))
                    j += 2
        self._graph = (heads, leaves) if record else None
        self.outputs = [NDArray(o.detach()) for o in heads]
        return self.outputs

    def backward(self, out_grads=None):
        if self._graph is None:
            raise MXNetError("backward called without a training forward")
        heads, leaves = self._graph
        if out_grads is None:
            cts = [torch.ones_like(o) for o in heads]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            cts = [_tensor(g, o.device).to(o.dtype)
                   for g, o in zip(out_grads, heads)]
        pairs = [(o, c) for o, c in zip(heads, cts) if o.requires_grad]
        grads = [None] * len(leaves)
        if pairs and leaves:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [t for _, t in leaves],
                grad_outputs=[c for _, c in pairs], allow_unused=True)
        for (name, t), g in zip(leaves, grads):
            tgt = self.grad_dict.get(name)
            if tgt is None:
                continue
            if g is None:
                g = torch.zeros_like(t)
            g = g.detach()
            if self.grad_req.get(name, "write") == "add":
                tgt._assign(tgt._data + g)
            else:
                tgt._assign(g)
        self._graph = None

    # ------------------------------------------------------------------
    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in (arg_params or {}).items():
            if k in self.arg_dict:
                dst = self.arg_dict[k]
                dst._assign(_tensor(v, dst._data.device).to(dst._data.dtype))
            elif not allow_extra_params:
                raise MXNetError(f"unknown argument {k}")
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                dst = self.aux_dict[k]
                dst._assign(_tensor(v, dst._data.device).to(dst._data.dtype))
            elif not allow_extra_params:
                raise MXNetError(f"unknown aux state {k}")

    def reshape(self, **kwargs):
        return self  # each forward runs on the shapes it is fed
