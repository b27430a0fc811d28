"""Custom operators: user Python ops with autograd.

Counterpart of `incubator_mxnet_tpu/operator.py` (`CustomOp`,
`CustomOpProp`, `register`, `get`, `Custom`).  A Custom op runs eagerly
over NDArrays, outside any traced graph, as in the JAX package and in
MXNet; its forward and backward are often `rtc.CudaKernel` launches.

Inside `autograd.record()` the op is one `torch.autograd.Function`: its
forward runs the user's `forward` with the graph off, its backward the
user's `backward`.  The outputs, auxiliary states and input gradients
are allocated on the inputs' device (the JAX package allocates them on
the default context).  The backward's `req` is "write" for an input
that takes a gradient and "null" for one that does not (a label); an op
whose prop says `need_top_grad=False` (a loss head) ignores the head
gradient it is given, which for `backward()` on its non-scalar output
is ones, as in MXNet.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get", "Custom"]

_REGISTRY = {}


class CustomOp:
    """Base class for user ops (MXNet's `mx.operator.CustomOp`)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    @staticmethod
    def assign(dst, req, src):
        """Write `src` into `dst` as `req` says: "write" (or "inplace")
        overwrites, "add" accumulates, "null" leaves `dst` alone."""
        if req in ("write", "inplace", None):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        elif req != "null":
            raise MXNetError(f"unknown req {req!r}")


class CustomOpProp:
    """Shape and type inference and the operator factory (MXNet's
    `mx.operator.CustomOpProp`)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        t = in_type[0]
        return in_type, [t] * len(self.list_outputs()), \
            [t] * len(self.list_auxiliary_states())

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Decorator registering a `CustomOpProp` subclass as `op_type`."""
    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register() expects a CustomOpProp subclass")
        _REGISTRY[reg_name] = prop_cls
        return prop_cls
    return deco


def get(reg_name):
    try:
        return _REGISTRY[reg_name]
    except KeyError:
        raise MXNetError(f"custom op {reg_name!r} is not registered") \
            from None


class _CustomFunction(torch.autograd.Function):
    """A recorded call: the inputs and outputs are saved for the
    backward, not held by `call`, so no reference cycle runs through
    the graph."""

    @staticmethod
    def forward(ctx, call, *inputs):
        outs = call.forward(inputs)
        ctx.call = call
        ctx.save_for_backward(*inputs, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        n_in = len(saved) - len(grads)
        return (None, *ctx.call.backward(saved[:n_in], saved[n_in:], grads,
                                         ctx.needs_input_grad[1:]))


class _Call:
    """One call of a Custom op: the user op, its outputs' shapes and
    types, its aux states, on the inputs' device."""

    def __init__(self, op, out_specs, aux, device, is_train):
        self.op, self.out_specs, self.aux = op, out_specs, aux
        self.device, self.is_train = device, is_train

    def forward(self, inputs):
        from . import autograd
        from .ndarray import NDArray, zeros
        out_data = [zeros(s, ctx=self.device, dtype=t)
                    for s, t in self.out_specs]
        with autograd.pause():
            self.op.forward(is_train=self.is_train,
                            req=["write"] * len(out_data),
                            in_data=[NDArray(t) for t in inputs],
                            out_data=out_data, aux=self.aux)
        return [o.data for o in out_data]

    def backward(self, inputs, outputs, grads, needs):
        from . import autograd
        from .ndarray import NDArray
        in_grad = [NDArray(torch.zeros_like(t)) for t in inputs]
        with autograd.pause():
            self.op.backward(req=["write" if n else "null" for n in needs],
                             out_grad=[NDArray(g) for g in grads],
                             in_data=[NDArray(t) for t in inputs],
                             out_data=[NDArray(t) for t in outputs],
                             in_grad=in_grad, aux=self.aux)
        return [g.data if n else None for g, n in zip(in_grad, needs)]


def Custom(*inputs, op_type, **kwargs):
    """Run registered custom op `op_type` on `inputs` (MXNet's
    `mx.nd.Custom`); recorded inside `autograd.record()`."""
    from . import autograd
    from .context import Context
    from .ndarray import NDArray, array, zeros

    prop = get(op_type)(**kwargs)
    names = prop.list_arguments()
    if len(inputs) != len(names):
        raise MXNetError(f"{op_type}: expected {len(names)} inputs {names}, "
                         f"got {len(inputs)}")
    in_data = [a.data if isinstance(a, NDArray) else array(a).data
               for a in inputs]
    device = in_data[0].device
    if any(t.device != device for t in in_data):
        raise MXNetError(f"{op_type}: inputs on several devices "
                         f"{[str(t.device) for t in in_data]}")
    in_shapes = [list(t.shape) for t in in_data]
    _, out_shapes, aux_shapes = prop.infer_shape(in_shapes)
    in_types = [t.dtype for t in in_data]
    _, out_types, aux_types = prop.infer_type(in_types)
    op = prop.create_operator(Context.from_device(device), in_shapes,
                              in_types)
    aux = [zeros(tuple(s), ctx=device, dtype=t)
           for s, t in zip(aux_shapes, aux_types)]
    record = autograd.is_recording()
    call = _Call(op, [(tuple(s), t) for s, t in zip(out_shapes, out_types)],
                 aux, device, record or autograd.is_training())
    if record:
        outs = _CustomFunction.apply(call, *in_data)
    else:
        outs = call.forward(in_data)
    outs = [NDArray(t) for t in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)
