"""Control-flow operators: foreach / while_loop / cond (counterpart of
`incubator_mxnet_tpu/contrib/control_flow.py`).

PyTorch runs eagerly, so each is a Python loop or branch over the
body's NDArray ops, on the inputs' device: every op dispatches
normally, so `autograd.record()` records through the iterations, and
a block that calls them runs the same way hybridized or not (the JAX
package's traced form, `lax.scan`/`while_loop`/`cond`, has no
counterpart to need here).

The outputs keep the structure the body returns (a bare NDArray stays
bare, a one-element list stays a list), as in the JAX package.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["foreach", "while_loop", "cond"]


def _aslist(x):
    return [x] if isinstance(x, NDArray) else list(x)


def _repack(seq, single):
    """Restore the body's return structure: bare value iff the body
    returned a bare NDArray."""
    return seq[0] if single else list(seq)


def foreach(body, data, init_states):
    """Iterate `body(data_t, states) -> (out_t, new_states)` over axis 0
    of `data`; returns (stacked outputs, final states) with the same
    nesting the body used."""
    from ..ndarray import stack as nd_stack

    single_data = isinstance(data, NDArray)
    single_state = isinstance(init_states, NDArray)
    data_l = _aslist(data)
    states_l = _aslist(init_states)
    n = data_l[0].shape[0]
    if n == 0:
        raise MXNetError("foreach: zero-length data axis — output "
                         "shapes are unknowable")
    outs = None
    out_single = True
    states = _repack(states_l, single_state)
    for t in range(n):
        slice_t = _repack([d[t] for d in data_l], single_data)
        out_t, states = body(slice_t, states)
        out_single = isinstance(out_t, NDArray)
        out_l = _aslist(out_t)
        if outs is None:
            outs = [[] for _ in out_l]
        for buf, o in zip(outs, out_l):
            buf.append(o)
    stacked = [nd_stack(*buf, axis=0) for buf in outs]
    return _repack(stacked, out_single), states


def _probe_step(func, lv):
    """One `func` step on meta tensors of the loop vars' shapes and
    dtypes: (output (shape, dtype) pairs, out_single, vars_single)."""
    from .. import autograd
    metas = [NDArray(torch.empty(v.shape, dtype=v._data.dtype,
                                 device="meta")) for v in lv]
    with autograd.pause():
        out_t, new_vars = func(*metas)
    return ([(o.shape, o._data.dtype) for o in _aslist(out_t)],
            isinstance(out_t, NDArray), isinstance(new_vars, NDArray))


def while_loop(cond_fn, func, loop_vars, max_iterations):
    """`func(*loop_vars) -> (step_output(s), new_loop_vars)` while
    `cond_fn(*loop_vars)` holds, at most `max_iterations` times.
    Returns (outputs stacked over max_iterations — rows beyond the
    executed steps are zeros — and the final loop vars).  A condition
    that is false on entry yields all-zero outputs and unchanged loop
    vars."""
    from ..ndarray import stack as nd_stack
    from ..ndarray import zeros as nd_zeros

    if max_iterations is None or max_iterations <= 0:
        raise MXNetError("while_loop needs a positive max_iterations "
                         "(static shapes)")
    lv = _aslist(loop_vars)
    single_lv = isinstance(loop_vars, NDArray)
    outs = None
    out_single = True
    vars_single = single_lv
    steps = 0
    cur = list(lv)
    while steps < max_iterations and \
            bool(_np.asarray(cond_fn(*cur).asnumpy()).reshape(())):
        out_t, new_vars = func(*cur)
        out_single = isinstance(out_t, NDArray)
        vars_single = isinstance(new_vars, NDArray)
        cur = _aslist(new_vars)
        out_l = _aslist(out_t)
        if outs is None:
            outs = [[] for _ in out_l]
        for buf, o in zip(outs, out_l):
            buf.append(o)
        steps += 1
    ctx = lv[0].context
    if outs is None:
        # false on entry: zero outputs of the shapes one step would give
        try:
            shapes, out_single, vars_single = _probe_step(func, lv)
        except Exception as e:
            raise MXNetError(
                "while_loop: condition false on entry and the body "
                "cannot run on shapes alone (uses .asnumpy()/python "
                "control flow), so the output shapes are unknowable "
                f"— underlying error: {e!r}") from None
        padded = [nd_zeros((max_iterations,) + tuple(shp), ctx=ctx,
                           dtype=dt) for shp, dt in shapes]
        return _repack(padded, out_single), _repack(cur, vars_single)
    padded = []
    for buf in outs:
        rows = buf + [nd_zeros(buf[0].shape, ctx=ctx, dtype=buf[0].dtype)
                      for _ in range(max_iterations - steps)]
        padded.append(nd_stack(*rows, axis=0))
    return _repack(padded, out_single), _repack(cur, vars_single)


def cond(pred, then_func, else_func):
    """Run `then_func()` if `pred` (a scalar) is true, else
    `else_func()`."""
    parr = pred.asnumpy() if isinstance(pred, NDArray) else pred
    taken = bool(_np.asarray(parr).reshape(()))
    return then_func() if taken else else_func()
