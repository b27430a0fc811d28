"""Test utilities (counterpart of `incubator_mxnet_tpu/test_utils.py`,
MXNet's `test_utils`): `assert_almost_equal` with dtype-scaled
tolerances, `check_numeric_gradient` (finite differences against the
executor's backward), `check_consistency` (one symbol under several
contexts and dtypes, the first the golden model: the CPU against the
card, ``[{"ctx": cpu(), ...}, {"ctx": gpu(0), ...}]``), `rand_ndarray`
and `default_context`.
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError
from .context import Context, cpu, current_context
from .ndarray import NDArray, array, zeros

__all__ = ["assert_almost_equal", "almost_equal", "same", "rand_ndarray",
           "rand_shape_2d", "rand_shape_3d", "rand_shape_nd",
           "default_context", "set_default_context", "check_numeric_gradient",
           "check_consistency", "numeric_grad", "list_gpus", "DummyIter",
           "simple_forward"]

_DTYPE_TOL = {
    _np.dtype(_np.float64): (1e-12, 1e-12),
    _np.dtype(_np.float32): (1e-4, 1e-5),
    _np.dtype(_np.float16): (1e-2, 1e-2),
}


def _as_np(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    return _np.asarray(a)


def default_context():
    return current_context()


def set_default_context(ctx):
    """Make `ctx` the current context of this thread (until a `with`
    scope says otherwise)."""
    stack = getattr(Context._default_stack, "stack", None)
    if stack is None:
        stack = Context._default_stack.stack = []
    stack[:] = [ctx]


def same(a, b):
    return _np.array_equal(_as_np(a), _as_np(b))


def almost_equal(a, b, rtol=None, atol=None):
    a, b = _as_np(a), _as_np(b)
    rtol, atol = _tols(a, b, rtol, atol)
    return _np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True)


def _tols(a, b, rtol, atol):
    dt = _np.result_type(a.dtype, b.dtype)
    dr, da = _DTYPE_TOL.get(_np.dtype(dt), (1e-5, 1e-8))
    return (dr if rtol is None else rtol), (da if atol is None else atol)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    a_np, b_np = _as_np(a), _as_np(b)
    rtol, atol = _tols(a_np, b_np, rtol, atol)
    _np.testing.assert_allclose(
        a_np, b_np, rtol=rtol, atol=atol, equal_nan=equal_nan,
        err_msg=f"{names[0]} vs {names[1]}")


def rand_shape_2d(dim0=10, dim1=10):
    return (_np.random.randint(1, dim0 + 1),
            _np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return rand_shape_2d(dim0, dim1) + (_np.random.randint(1, dim2 + 1),)


def rand_shape_nd(num_dim, dim=10):
    return tuple(_np.random.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None, dtype="float32",
                 ctx=None, scale=1.0):
    if stype != "default":
        raise MXNetError("sparse stypes are tracked for a later round")
    return array(_np.random.uniform(-scale, scale, size=shape)
                 .astype(dtype), ctx=ctx)


def list_gpus():
    from .context import num_gpus
    return list(range(num_gpus()))


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    from .executor import Executor
    args = {k: array(v) if not isinstance(v, NDArray) else v
            for k, v in inputs.items()}
    ex = Executor(sym, ctx=ctx, args=args, grad_req="null")
    ex.forward(is_train=is_train)
    outs = [o.asnumpy() for o in ex.outputs]
    return outs[0] if len(outs) == 1 else outs


# ---------------------------------------------------------------------------
# numeric gradient checking (MXNet's check_numeric_gradient)
# ---------------------------------------------------------------------------

def numeric_grad(f, xs, eps=1e-4):
    """Central finite differences of scalar f over a list of arrays."""
    grads = []
    for i, x in enumerate(xs):
        g = _np.zeros_like(x, dtype=_np.float64)
        flat = x.reshape(-1)
        gf = g.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = f(xs)
            flat[j] = orig - eps
            fm = f(xs)
            flat[j] = orig
            gf[j] = (fp - fm) / (2 * eps)
        grads.append(g)
    return grads


def check_numeric_gradient(sym, location, aux_states=None,
                           numeric_eps=1e-3, rtol=1e-2, atol=None,
                           grad_nodes=None, ctx=None):
    """Finite-difference check of `sym`'s gradients (symbol path)."""
    from .executor import Executor
    from . import autograd

    if isinstance(location, (list, tuple)):
        location = dict(zip(sym.list_arguments(), location))
    location = {k: (_as_np(v)).astype(_np.float64)
                for k, v in location.items()}
    grad_nodes = grad_nodes or list(location)

    def eval_sum(vals_np):
        args = {k: array(v.astype(_np.float32))
                for k, v in zip(location, vals_np)}
        ex = Executor(sym, args=args, grad_req="null",
                      aux_states=aux_states)
        ex.forward(is_train=True)
        return float(sum(o.asnumpy().astype(_np.float64).sum()
                         for o in ex.outputs))

    names = list(location)
    base_vals = [location[n].copy() for n in names]
    num = numeric_grad(lambda vs: eval_sum(vs), base_vals, eps=numeric_eps)
    numeric = dict(zip(names, num))

    args = {k: array(v.astype(_np.float32)) for k, v in location.items()}
    grads = {k: zeros(v.shape) for k, v in location.items()
             if k in grad_nodes}
    ex = Executor(sym, args=args, args_grad=grads,
                  grad_req={k: ("write" if k in grad_nodes else "null")
                            for k in location}, aux_states=aux_states)
    ex.forward(is_train=True)
    ex.backward()
    for name in grad_nodes:
        assert_almost_equal(grads[name].asnumpy(), numeric[name],
                            rtol=rtol, atol=atol or rtol,
                            names=(f"autograd[{name}]",
                                   f"numeric[{name}]"))


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      rtol=None, atol=None, arg_params=None):
    """Run one symbol under several context/dtype configs and compare
    forward+backward with the first (the golden model: the CPU for the
    card's kernels).  ctx_list entries: {'ctx': Context, 'type_dict':
    {name: dtype}, <name>: shape, ...}."""
    from .executor import Executor

    if len(ctx_list) < 2:
        raise MXNetError("need at least two configs")
    arg_names = sym.list_arguments()
    shapes = {k: v for k, v in ctx_list[0].items()
              if isinstance(v, tuple)}
    inferred, _, _ = sym.infer_shape(**shapes)
    shapes.update({n: s for n, s in zip(arg_names, inferred)
                   if s is not None})
    base = {n: _np.random.uniform(-scale, scale, size=shapes[n])
            .astype(_np.float64) for n in arg_names if n in shapes}
    if arg_params:
        for k, v in arg_params.items():
            base[k] = _as_np(v).astype(_np.float64)

    results = []
    for cfg in ctx_list:
        ctx = cfg.get("ctx", cpu())
        dtypes = cfg.get("type_dict", {})
        args = {n: array(base[n].astype(dtypes.get(n, _np.float32)),
                         ctx=ctx) for n in base}
        grads = {n: zeros(base[n].shape, ctx=ctx) for n in base}
        ex = Executor(sym, ctx=ctx, args=args, args_grad=grads,
                      grad_req=grad_req)
        ex.forward(is_train=True)
        ex.backward()
        results.append((
            [o.asnumpy().astype(_np.float64) for o in ex.outputs],
            {n: g.asnumpy().astype(_np.float64) for n, g in grads.items()}))

    # compare every config against the first (reference/golden) one
    ref_out, ref_grad = results[0]
    for i, (out, grad) in enumerate(results[1:], 1):
        dt = max((_np.dtype(d) for d in
                  ctx_list[i].get("type_dict", {}).values()),
                 default=_np.dtype(_np.float32), key=lambda d: d.itemsize)
        dr, da = _DTYPE_TOL.get(dt, (1e-4, 1e-5))
        for o_ref, o in zip(ref_out, out):
            _np.testing.assert_allclose(o, o_ref,
                                        rtol=rtol or dr, atol=atol or da)
        for n in ref_grad:
            _np.testing.assert_allclose(grad[n], ref_grad[n],
                                        rtol=rtol or dr, atol=atol or da,
                                        err_msg=f"grad[{n}] cfg{i}")
    return results


class DummyIter:
    """Repeat one batch forever (a benchmark iterator)."""

    def __init__(self, real_iter):
        self._iter = real_iter
        self.batch = next(iter(real_iter))
        self.provide_data = real_iter.provide_data
        self.provide_label = real_iter.provide_label
        self.batch_size = real_iter.batch_size

    def __iter__(self):
        while True:
            yield self.batch

    def next(self):
        return self.batch

    def reset(self):
        pass


def pipeline_mlp(d=16, classes=10, n_stage=2, in_units=20, flatten=True):
    """Dense → `parallel.GPipeStack` → Dense with the prefixes the default
    `TRANSFORMER_RULES` key on (`ffn_1_*` column-parallel, `stack_pipe_*`
    staged, `ffn_2_*` row-parallel), initialized Xavier: the JAX
    package's multi-axis test model."""
    from . import initializer
    from .gluon import nn
    from .parallel import GPipeStack
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(d, activation="relu", prefix="ffn_1_",
                         in_units=in_units, flatten=flatten))
        net.add(GPipeStack(n_stage, d, prefix="stack_"))
        net.add(nn.Dense(classes, prefix="ffn_2_", in_units=d,
                         flatten=flatten))
    net.initialize(initializer.Xavier())
    return net
