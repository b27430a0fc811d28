"""Pipeline parallelism: the GPipe microbatch schedule over the 'pp' mesh
axis (counterpart of `incubator_mxnet_tpu/parallel/pipeline.py`).

Each 'pp' rank holds its stages' parameters (the leading stage dim of
the stacked parameters cut over 'pp'; k = n_stage / pp consecutive
layers a rank).  The schedule is the JAX package's: n_micro + pp - 1
slots; in each every rank applies its stages to its input (stage 0 to
the next microbatch, the others to what the previous stage sent), the
last stage keeps its result, and each rank sends its output one stage
on (`ppermute`, a batch of isend/irecv).  Every rank runs every slot,
bubbles included, and chooses by masks, not branches, so all ranks
issue the same collectives and build the same graph; the schedule is
differentiable (the backward sends the gradients one stage back).  The
last stage's outputs are then all-gathered over 'pp', so every 'pp'
rank continues with them.

`ParallelTrainer` installs `pipeline_scope` when a parameter is staged
over 'pp'; inside it `GPipeStack` runs the schedule with
`MXNET_PP_MICROBATCH` microbatches of its rank's rows; outside it the
same block runs its stages one after another, the oracle the pipeline
must match.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..base import MXNetError, get_env
from . import collectives as C

__all__ = ["PipelineStage", "bubble_fraction", "pipeline_step",
           "pipeline_scope", "current_pipeline", "GPipeStack"]

_state = threading.local()


class PipelineStage:
    """Declarative stage: fn(params, x) -> y with y.shape == x.shape;
    the per-stage parameters are stacked on a leading axis."""

    def __init__(self, fn):
        self.fn = fn


def bubble_fraction(pp, n_micro):
    """The GPipe bubble's share of the pipelined wall,
    ``(pp - 1) / (n_micro + pp - 1)``; 0 without a pipeline axis."""
    pp = int(pp)
    n_micro = max(1, int(n_micro))
    if pp <= 1:
        return 0.0
    return (pp - 1) / float(n_micro + pp - 1)


def _tree_index(params, j):
    if isinstance(params, (tuple, list)):
        return type(params)(_tree_index(p, j) for p in params)
    return params[j]


def _leading(params):
    while isinstance(params, (tuple, list)):
        params = params[0]
    return params.shape[0]


def _pipe_local(fn, stage_params, xs, mesh, axis_name):
    """The schedule on this rank: `stage_params` its k stages (leaves
    [k, ...]), `xs` [n_micro, mb, ...] its rows; returns the last
    stage's [n_micro, mb, ...] on every rank of the axis."""
    k = _leading(stage_params)

    def apply_stage(x):
        for j in range(k):
            x = fn(_tree_index(stage_params, j), x)
        return x

    n = mesh.axis_size(axis_name)
    stage = mesh.axis_index(axis_name)
    n_micro = xs.shape[0]
    first = torch.tensor(stage == 0, device=xs.device)
    last = torch.tensor(stage == n - 1, device=xs.device)
    ring = [(i, (i + 1) % n) for i in range(n)]
    state = torch.zeros_like(xs[0])
    outs = []
    for t in range(n_micro + n - 1):
        inp = torch.where(first, xs[min(t, n_micro - 1)], state)
        y = apply_stage(inp)
        if t >= n - 1:
            outs.append(torch.where(last, y, 0.0))
        if t < n_micro + n - 2:
            state = C.ppermute(y, axis_name, ring, mesh)
    out = torch.stack(outs)
    if n > 1:
        # the last stage's outputs to every stage
        out = C.allgather(out, axis_name, axis=0, tiled=False,
                          mesh=mesh)[n - 1]
    return out


def pipeline_step(fn, stacked_params, microbatches, mesh, axis_name="pp",
                  params_specs=None, batch_spec=None):
    """The pipeline forward on global tensors: `stacked_params` leaves
    [n_stage, ...] (n_stage a multiple of the axis size), `microbatches`
    [n_micro, mb, ...]; returns [n_micro, mb, ...] from the last stage.
    `params_specs` (default: the leading dim over `axis_name`) may cut
    inner dims over other axes, `fn` then sees its local block and runs
    its own collective; `batch_spec` is the microbatches' spec
    (default replicated)."""
    from .sharding import PartitionSpec as P
    if axis_name not in mesh.axis_names:
        raise MXNetError(f"mesh has no axis {axis_name!r}")
    n = mesh.shape[axis_name]
    lead = _leading(stacked_params)
    if lead % n != 0:
        raise MXNetError(
            f"stacked params have {lead} stages, not a multiple of mesh "
            f"axis {axis_name}={n}")

    def leaf_specs(tree):
        if isinstance(tree, (tuple, list)):
            return type(tree)(leaf_specs(t) for t in tree)
        return P(axis_name)
    if params_specs is None:
        params_specs = leaf_specs(stacked_params)
    if batch_spec is None:
        batch_spec = P()

    def body(params, xs):
        return _pipe_local(fn, params, xs, mesh, axis_name)
    return C.shard_map(body, mesh, (params_specs, batch_spec),
                       batch_spec)(stacked_params, microbatches)


def current_pipeline():
    """The schedule installed by `pipeline_scope`, or None."""
    return getattr(_state, "cfg", None)


@contextlib.contextmanager
def pipeline_scope(mesh, axis_name="pp", n_micro=None, tp_axis="tp",
                   batch_axis="dp"):
    """While active, `GPipeStack` runs its stages as the GPipe schedule
    over `axis_name` of `mesh`; `n_micro` defaults to
    ``MXNET_PP_MICROBATCH`` (then 4)."""
    if axis_name not in mesh.axis_names:
        raise MXNetError(f"mesh has no axis {axis_name!r}")
    if n_micro is None:
        n_micro = get_env("MXNET_PP_MICROBATCH", 4, int)
    n_micro = max(1, int(n_micro))
    prev = getattr(_state, "cfg", None)
    _state.cfg = {
        "mesh": mesh, "axis": axis_name, "n_micro": n_micro,
        "tp_axis": tp_axis if tp_axis in mesh.axis_names else None,
        "batch_axis": batch_axis if batch_axis in mesh.axis_names
        else None,
    }
    try:
        yield _state.cfg
    finally:
        _state.cfg = prev


def _act(name, y):
    if name is None:
        return y
    if name == "tanh":
        return torch.tanh(y)
    if name == "relu":
        return torch.relu(y)
    raise MXNetError(f"GPipeStack: unsupported activation {name!r} "
                     f"(tanh/relu/None)")


def _gpipe_class():
    global _GPipeStackImpl
    if _GPipeStackImpl is not None:
        return _GPipeStackImpl
    from ..gluon.block import HybridBlock
    from ..ndarray import NDArray

    class _Impl(HybridBlock):
        def __init__(self, n_stage, units, activation="tanh", **kwargs):
            super().__init__(**kwargs)
            self._n_stage = int(n_stage)
            self._units = int(units)
            self._activation = activation
            with self.name_scope():
                self.weight = self.params.get(
                    "pipe_weight", shape=(n_stage, units, units),
                    allow_deferred_init=False)
                self.bias = self.params.get(
                    "pipe_bias", shape=(n_stage, units), init="zeros",
                    allow_deferred_init=False)

        def hybrid_forward(self, F, x, weight=None, bias=None):
            xa = x.data if isinstance(x, NDArray) else x
            w = weight.data if isinstance(weight, NDArray) else weight
            b = bias.data if isinstance(bias, NDArray) else bias
            sh = self.weight._shard
            # the output dim of the stage weight cut over tp: each rank
            # computes its columns, all-gathered
            tp = None
            if sh is not None:
                e = sh.full_spec(3)[2]
                if e is not None and not sh.mesh.trivial(e):
                    tp = e
            mesh = sh.mesh if sh is not None else None
            act = self._activation

            def stage_fn(p, xloc):
                wl, bl = p
                y = xloc @ wl
                if tp:
                    y = C.allgather(y, tp, axis=-1, mesh=mesh)
                return _act(act, y + bl)

            pp = sh.full_spec(3)[0] if sh is not None else None
            if pp is None or sh.mesh.axis_size(pp) <= 1:
                y = xa
                for i in range(w.shape[0]):
                    y = stage_fn((w[i], b[i]), y)
                return NDArray(y)
            # staged over pp: the trainer's schedule, else one
            # microbatch
            cfg = current_pipeline() or {
                "mesh": mesh, "axis": pp, "n_micro": 1,
                "batch_axis": "dp" if "dp" in mesh.axis_names else None}
            mesh, axis = cfg["mesh"], cfg["axis"]
            n_micro = cfg["n_micro"]
            dp = cfg["batch_axis"]
            ndp = mesh.axis_size(dp) if dp else 1
            B = xa.shape[0] * ndp
            if B % n_micro:
                raise MXNetError(
                    f"GPipeStack: batch {B} not divisible by "
                    f"n_micro={n_micro} (MXNET_PP_MICROBATCH)")
            mb = B // n_micro
            if dp and mb % ndp:
                raise MXNetError(
                    f"GPipeStack: microbatch {mb} rows not divisible "
                    f"by the {ndp}-way {dp!r} axis — lower "
                    f"n_micro or grow the batch")
            rest = tuple(xa.shape[1:])
            xs = xa.reshape((n_micro, xa.shape[0] // n_micro) + rest)
            out = _pipe_local(stage_fn, (w, b), xs, mesh, axis)
            return NDArray(out.reshape(xa.shape))

    _GPipeStackImpl = _Impl
    _Impl.__name__ = "GPipeStack"
    return _Impl


class GPipeStack:
    """`n_stage` identical Dense(+activation) layers with their
    parameters stacked on a leading stage dim, [in, out] per stage
    (``pipe_weight`` [n_stage, units, units] → P('pp', None, 'tp'),
    ``pipe_bias`` [n_stage, units] → P('pp', None)).  Outside a
    `pipeline_scope` it runs layer by layer; inside, each 'pp' rank
    applies its n_stage/pp layers in the GPipe schedule.  A gluon
    HybridBlock, made at first use."""

    def __new__(cls, *args, **kwargs):
        return _gpipe_class()(*args, **kwargs)


_GPipeStackImpl = None
