"""Collectives over named mesh axes (counterpart of
`incubator_mxnet_tpu/parallel/collectives.py`).

Each function acts on the sub-group of the ranks that differ only on
`axis_name` (`mesh.group`), on the mesh passed as `mesh=`, else the one
bound by `shard_map`, `ParallelTrainer`'s step or `mesh_scope`.  Each
is differentiable, its backward the transposed collective, as JAX's
transpose rules give: the backward of a sum over ranks (psum) is a sum,
of an all-gather a reduce-scatter (and back), of a permutation the
inverse permutation, of an all-to-all the all-to-all with split and
concat swapped.  Under that convention a rank's gradient is its share
of the gradient of the sum of every rank's objective: `ParallelTrainer`
sums each parameter's gradient over the ranks that hold the same block.

`shard_map(f, mesh, in_specs, out_specs)` keeps its JAX call form on
global tensors: each rank takes its block of every input (the backward
sums the pieces of the input's gradient over the mesh), runs `f` with
the mesh bound, and assembles the global outputs (the backward takes
this rank's block of the output's gradient, divided by the number of
ranks holding it), so every rank's autograd gives the gradient of its
own objective of the global outputs.

Transports (`mesh.transport`): NCCL or gloo on the tensors themselves,
or ``"host"``: CUDA tensors copied into page-locked host buffers, the
collective run by gloo, the result copied back.  Every rank must issue
the same collectives in the same order.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

from ..base import MXNetError

__all__ = ["shard_map", "allreduce", "allmean", "allmax", "allgather",
           "reduce_scatter", "ppermute", "shift", "axis_index", "axis_size",
           "alltoall", "bound_mesh", "bind_mesh", "barrier"]

_state = threading.local()


def _dist():
    import torch.distributed as dist
    return dist


@contextlib.contextmanager
def bind_mesh(mesh):
    """Bind `mesh` for the axis names of the collectives."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def bound_mesh(mesh=None):
    """`mesh`, else the bound mesh, else `mesh_scope`'s."""
    if mesh is not None:
        return mesh
    m = getattr(_state, "mesh", None)
    if m is None:
        from .mesh import current_mesh
        m = current_mesh()
    if m is None:
        raise MXNetError("no mesh bound: pass mesh= or call inside "
                         "shard_map, a trainer's step or mesh_scope")
    return m


# -- the transport ------------------------------------------------------

@contextlib.contextmanager
def _timed(mesh, t):
    """Count a host-transport collective of `t` in `mesh.stats`: from the
    card's copy out to its copy back (the card's stream is drained
    first, so its earlier work is not counted)."""
    if mesh.transport != "host" or not t.is_cuda:
        yield
        return
    torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        mesh.stats["calls"] += 1
        mesh.stats["bytes"] += t.numel() * t.element_size()
        mesh.stats["seconds"] += time.perf_counter() - t0


def _wire(mesh, t):
    """The tensor a collective reads: `t` itself, or a page-locked host
    copy under the host transport."""
    t = t.contiguous()
    if mesh.transport == "host" and t.is_cuda:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h
    return t


def _empty(mesh, shape, like):
    if mesh.transport == "host" and like.is_cuda:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _back(t, like):
    return t.to(like.device) if t.device != like.device else t


def _op(name):
    dist = _dist()
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[name]


def _all_reduce(mesh, axes, t, op="sum"):
    g, _ = mesh.group(axes)
    with _timed(mesh, t):
        w = _wire(mesh, t)
        if w is t:
            w = t.clone()
        _dist().all_reduce(w, op=_op(op), group=g)
        return _back(w, t)


def _all_gather(mesh, axis, t, dim):
    g, ranks = mesh.group(axis)
    n = len(ranks)
    x = t.movedim(dim, 0)
    out = _empty(mesh, (n * x.shape[0],) + tuple(x.shape[1:]), t)
    dist = _dist()
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    with _timed(mesh, t):
        fn(out, _wire(mesh, x), group=g)
        return _back(out, t).movedim(0, dim)


def _reduce_scatter(mesh, axis, t, dim):
    g, ranks = mesh.group(axis)
    n = len(ranks)
    x = t.movedim(dim, 0)
    if x.shape[0] % n:
        raise MXNetError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not divide over {axis} ({n})")
    out = _empty(mesh, (x.shape[0] // n,) + tuple(x.shape[1:]), t)
    dist = _dist()
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    with _timed(mesh, t):
        fn(out, _wire(mesh, x), group=g)
        return _back(out, t).movedim(0, dim)


def _all_to_all(mesh, axis, t, split, concat):
    g, ranks = mesh.group(axis)
    n = len(ranks)
    x = t.movedim(split, 0)
    if x.shape[0] % n:
        raise MXNetError(f"alltoall: dim {split} of {tuple(t.shape)} does "
                         f"not divide over {axis} ({n})")
    out = _empty(mesh, tuple(x.shape), t)
    with _timed(mesh, t):
        _dist().all_to_all_single(out, _wire(mesh, x), group=g)
        got = _back(out, t).chunk(n, 0)
    return torch.cat([c.movedim(0, split) for c in got], dim=concat)


def _permute(mesh, axis, t, perm):
    """Send `t` along `perm` [(source, dest)] of axis indices; a rank no
    pair sends to gets zeros."""
    g, ranks = mesh.group(axis)
    me = mesh.axis_index(axis)
    dests = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(dests) > 1 or len(srcs) > 1:
        raise MXNetError(f"ppermute: {perm} sends or receives twice")
    if dests == [me] and srcs == [me]:
        return t.clone()
    dist = _dist()
    ops, recv = [], None
    with _timed(mesh, t):
        if dests:
            ops.append(dist.P2POp(dist.isend, _wire(mesh, t),
                                  ranks[dests[0]], group=g))
        if srcs:
            recv = _empty(mesh, tuple(t.shape), t)
            ops.append(dist.P2POp(dist.irecv, recv, ranks[srcs[0]],
                                  group=g))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        if recv is None:
            return torch.zeros_like(t)
        return _back(recv, t)


# -- differentiable collectives -----------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(mesh, axes, x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, ctx.axes, g), None, None


class _AllMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        y = _all_reduce(mesh, axes, x, "max")
        ctx.mesh, ctx.axes = mesh, axes
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return (_all_reduce(ctx.mesh, ctx.axes, g) * (x == y).to(g.dtype),
                None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.mesh, ctx.axis, g, ctx.dim), None, None, \
            None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.mesh, ctx.axis, g, ctx.dim), None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _permute(mesh, axis, x, perm)

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return _permute(ctx.mesh, ctx.axis, g, inv), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat):
        ctx.mesh, ctx.axis, ctx.split, ctx.concat = mesh, axis, split, concat
        return _all_to_all(mesh, axis, x, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(ctx.mesh, ctx.axis, g, ctx.concat, ctx.split),
                None, None, None, None)


def allreduce(x, axis_name="dp", mesh=None):
    """Sum over a mesh axis (or a tuple of axes)."""
    mesh = bound_mesh(mesh)
    if mesh.trivial(axis_name):
        return x
    return _AllReduce.apply(x, mesh, axis_name)


def allmean(x, axis_name="dp", mesh=None):
    mesh = bound_mesh(mesh)
    return allreduce(x, axis_name, mesh) / mesh.axis_size(axis_name)


def allmax(x, axis_name="dp", mesh=None):
    """Max over a mesh axis; the gradient goes to the ranks holding the
    max."""
    mesh = bound_mesh(mesh)
    if mesh.trivial(axis_name):
        return x
    return _AllMax.apply(x, mesh, axis_name)


def allgather(x, axis_name, axis=0, tiled=True, mesh=None):
    """Concatenate the axis's shards along dim `axis` (stacked on a new
    dim `axis` with tiled=False)."""
    mesh = bound_mesh(mesh)
    if not tiled:
        x = x.unsqueeze(axis)
    if mesh.trivial(axis_name):
        return x
    return _AllGather.apply(x, mesh, axis_name, axis % x.ndim)


def reduce_scatter(x, axis_name, axis=0, mesh=None):
    """Sum over the axis, then keep this rank's block of dim `axis`."""
    mesh = bound_mesh(mesh)
    if mesh.trivial(axis_name):
        return x
    return _ReduceScatter.apply(x, mesh, axis_name, axis % x.ndim)


def ppermute(x, axis_name, perm, mesh=None):
    """Send along [(source, dest)] axis indices; ranks no pair sends to
    get zeros."""
    mesh = bound_mesh(mesh)
    perm = [(int(s), int(d)) for s, d in perm]
    if mesh.trivial(axis_name):
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Permute.apply(x, mesh, axis_name, perm)


def shift(x, axis_name, offset=1, mesh=None):
    """Rotate shards by `offset` along the axis's ring."""
    mesh = bound_mesh(mesh)
    n = mesh.axis_size(axis_name)
    return ppermute(x, axis_name, [(i, (i + offset) % n) for i in range(n)],
                    mesh)


def axis_index(axis_name, mesh=None):
    return bound_mesh(mesh).axis_index(axis_name)


def axis_size(axis_name, mesh=None):
    return bound_mesh(mesh).axis_size(axis_name)


def alltoall(x, axis_name, split_axis, concat_axis, mesh=None):
    """Block j of dim `split_axis` goes to rank j; the blocks received
    are concatenated along `concat_axis` in rank order."""
    mesh = bound_mesh(mesh)
    if mesh.trivial(axis_name):
        return x
    return _AllToAll.apply(x, mesh, axis_name, split_axis % x.ndim,
                           concat_axis % x.ndim)


# -- shard_map ----------------------------------------------------------

def _spec_sharding(mesh, spec):
    from .sharding import PartitionSpec, Sharding
    if spec is None:
        spec = PartitionSpec()
    return Sharding(mesh, spec)


class _ShardIn(torch.autograd.Function):
    """A global input to this rank's block; the backward places the
    block's gradient in the global shape and sums it over the mesh."""

    @staticmethod
    def forward(ctx, x, sharding):
        ctx.sharding, ctx.shape = sharding, tuple(x.shape)
        return sharding.local_block(x)

    @staticmethod
    def backward(ctx, g):
        sh = ctx.sharding
        full = g.new_zeros(ctx.shape)
        for gi, li in sh.blocks(ctx.shape):
            full[gi] = g[li]
        mesh = sh.mesh
        if not mesh.trivial(mesh.axis_names):
            full = _all_reduce(mesh, mesh.axis_names, full)
        return full, None


class _ShardOut(torch.autograd.Function):
    """This rank's block to the global output (all-gathers along the
    cut dims); the backward takes this rank's block of the gradient over
    the number of ranks holding it."""

    @staticmethod
    def forward(ctx, y, sharding):
        ctx.sharding = sharding
        mesh = sharding.mesh
        spec = sharding.full_spec(y.ndim)
        for dim in range(y.ndim - 1, -1, -1):
            axes = tuple(a for a in mesh.axis_names
                         if a in ((spec[dim],) if isinstance(spec[dim], str)
                                  else tuple(spec[dim] or ())))
            for a in reversed(axes):
                if not mesh.trivial(a):
                    y = _all_gather(mesh, a, y, dim)
        ctx.shape = tuple(y.shape)
        return y

    @staticmethod
    def backward(ctx, g):
        sh = ctx.sharding
        pieces = sh.blocks(ctx.shape)
        out = g.new_empty(sh.local_shape(ctx.shape))
        for gi, li in pieces:
            out[li] = g[gi]
        reps = sh.mesh.axis_size(sh.replica_axes())
        return out / reps, None


def _tree_map(fn, tree, specs):
    from .sharding import PartitionSpec
    if isinstance(specs, PartitionSpec) or specs is None:
        if isinstance(tree, (tuple, list)):
            return type(tree)(_tree_map(fn, t, specs) for t in tree)
        if isinstance(tree, dict):
            return {k: _tree_map(fn, v, specs) for k, v in tree.items()}
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], specs[k]) for k in tree}
    if len(tree) != len(specs):
        raise MXNetError(f"shard_map: {len(specs)} specs for "
                         f"{len(tree)} values")
    return type(tree)(_tree_map(fn, t, s) for t, s in zip(tree, specs))


def shard_map(f, mesh, in_specs, out_specs, check_vma=None, **kwargs):
    """`f` over each rank's blocks of global tensors (see the module
    docstring).  `in_specs` matches the arguments (one PartitionSpec
    applies to all), `out_specs` the outputs."""
    def run(*args):
        local = _tree_map(
            lambda x, s: _ShardIn.apply(x, _spec_sharding(mesh, s)),
            tuple(args), in_specs)
        with bind_mesh(mesh):
            out = f(*local)
        return _tree_map(
            lambda y, s: _ShardOut.apply(y, _spec_sharding(mesh, s)),
            out, out_specs)
    return run


def barrier(mesh):
    """Every rank of `mesh` reaches this point (a one-element sum)."""
    if not mesh.trivial(mesh.axis_names):
        _all_reduce(mesh, mesh.axis_names,
                    torch.zeros(1, device=mesh.device))
