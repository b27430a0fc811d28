"""Device meshes over `torch.distributed` process groups (counterpart of
`incubator_mxnet_tpu/parallel/mesh.py`).

The JAX package runs one controller over many devices; here, as in
torch, a mesh device is one process, a rank of a process group, holding
one device.  `make_mesh({"dp": 2, "tp": 2})` lays the world's ranks out
row-major over the named axes, in order, as the JAX package lays out
`jax.devices()`; each axis, and each set of axes, has its sub-groups,
so a collective over 'tp' runs among the ranks that differ only in
their 'tp' coordinate.  `Mesh(device)` is the mesh of one device with
no process group, which every one-device caller keeps using.

Transports (`init_distributed(..., transport=)`):

- ``"nccl"``: the default on CUDA; every collective of CUDA tensors
  runs on NCCL.  If NCCL fails, the mesh raises.
- ``"gloo"``: the default when the caller asks for `cpu()`.
- ``"host"``: CUDA tensors staged through page-locked host buffers and
  a gloo group, for ranks that share one card (NCCL refuses two ranks
  on one device).  Only ever chosen by the caller.

On a world of one rank the collectives still go through the backend,
so one rank exercises NCCL; on a larger world a group of one rank is
the identity and sends nothing.
"""
from __future__ import annotations

import contextlib
import itertools
import re
import threading
from datetime import timedelta

import numpy as _np
import torch

from ..base import MXNetError, get_env
from ..context import as_device, Context

__all__ = ["Mesh", "MESH_AXES", "init_distributed", "make_mesh",
           "parse_mesh_shape", "mesh_from_shape", "auto_axes",
           "default_mesh", "current_mesh", "mesh_scope", "world"]

# Canonical axis order: dp outermost, then pipeline, tensor, sequence,
# expert (the JAX package's order).
MESH_AXES = ("dp", "pp", "tp", "sp", "ep")

TRANSPORTS = ("nccl", "gloo", "host")

_state = threading.local()
# what init_distributed chose: the transport and this rank's device
_dist = {"transport": None, "device": None}


def _dist_module():
    import torch.distributed as dist
    return dist


def world():
    """(size, rank) of the initialized process group, (1, 0) without."""
    dist = _dist_module()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """Ranks laid out over named axes.

    `axis_names` and `shape` (an ordered {axis: size}) as in a JAX
    mesh; `devices` the array of global ranks in the mesh's shape (the
    JAX mesh's array of devices); `device` this rank's `torch.device`;
    `coords` this rank's index on each axis (None on a rank outside the
    mesh); `transport` one of `TRANSPORTS`, None for a mesh of one
    device without a process group.  `Mesh(device)` is that one-device
    mesh, with the single axis 'dp'."""

    def __init__(self, device, axes=None, transport=None, ranks=None):
        self.device = torch.device(device)
        axes = dict(axes) if axes else {"dp": 1}
        self.axis_names = tuple(axes)
        self.shape = {a: int(s) for a, s in axes.items()}
        sizes = [self.shape[a] for a in self.axis_names]
        n = int(_np.prod(sizes))
        ranks = list(range(n)) if ranks is None else list(ranks)[:n]
        self.devices = _np.array(ranks, dtype=_np.int64).reshape(sizes)
        self.size = n
        self.transport = transport
        size, rank = world() if transport is not None else (1, 0)
        self.world_size = size
        self.rank = rank
        where = _np.argwhere(self.devices == rank)
        self.coords = ({a: int(i) for a, i in zip(self.axis_names, where[0])}
                       if len(where) else None)
        self._groups = {}
        # the host transport's collectives: calls, bytes sent, seconds
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        if transport is not None:
            self._make_groups()

    def transport_stats(self, reset=False):
        """{calls, bytes, seconds} of this mesh's host-transport
        collectives so far; `reset` zeroes them."""
        out = dict(self.stats)
        if reset:
            self.stats.update(calls=0, bytes=0, seconds=0.0)
        return out

    # -- sub-groups ----------------------------------------------------
    def _make_groups(self):
        """A process group for every non-empty set of axes, made by every
        rank of the world in the same order (`new_group` is collective);
        each rank keeps the groups it belongs to."""
        dist = _dist_module()
        backend = "nccl" if self.transport == "nccl" else "gloo"
        names = self.axis_names
        for r in range(1, len(names) + 1):
            for sub in itertools.combinations(names, r):
                # the other axes fixed, `sub` varying (row-major in the
                # mesh's axis order)
                keep = [names.index(a) for a in sub]
                other = [i for i in range(len(names)) if i not in keep]
                moved = _np.transpose(self.devices, other + keep)
                moved = moved.reshape(-1, int(_np.prod(
                    [self.shape[a] for a in sub])))
                for row in moved:
                    ranks = [int(x) for x in row]
                    g = dist.new_group(ranks, backend=backend)
                    if self.rank in ranks:
                        self._groups[sub] = (g, ranks)

    def _axes_key(self, axes):
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in self.axis_names if a in set(axes))
        return axes

    def group(self, axes):
        """(process group, its global ranks in order) of this rank's
        sub-group over `axes` (a name or names), or (None, [rank]) when
        the mesh has no process group."""
        key = self._axes_key(axes)
        if self.transport is None or not key:
            return None, [self.rank]
        if self.coords is None:
            raise MXNetError(f"rank {self.rank} is not in the mesh "
                             f"{self.shape}")
        return self._groups[key]

    def axis_size(self, axes):
        """Product of the sizes of `axes` (a name or names)."""
        key = self._axes_key(axes)
        return int(_np.prod([self.shape[a] for a in key])) if key else 1

    def axis_index(self, axes):
        """This rank's row-major index over `axes`."""
        key = self._axes_key(axes)
        idx = 0
        for a in key:
            idx = idx * self.shape[a] + (self.coords[a] if self.coords
                                         else 0)
        return idx

    def trivial(self, axes):
        """Whether a collective over `axes` sends nothing: no process
        group, or a group of one rank on a world of several."""
        return self.transport is None or (
            self.axis_size(axes) == 1 and self.world_size > 1)

    def __repr__(self):
        return (f"Mesh({self.shape}, device={self.device}, "
                f"transport={self.transport})")


def _default_coordinator():
    """MXNET_JAX_COORDINATOR (set by a launcher), else DMLC_PS_ROOT_URI at
    DMLC_PS_ROOT_PORT + 1, the JAX package's resolution."""
    addr = get_env("MXNET_JAX_COORDINATOR", None)
    if addr:
        return addr
    port = int(get_env("DMLC_PS_ROOT_PORT", "9091")) + 1
    return f"{get_env('DMLC_PS_ROOT_URI', '127.0.0.1')}:{port}"


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     local_device_ids=None, ctx=None, transport=None,
                     timeout=None):
    """Join the process group: one process per mesh device.

    The JAX package's environment contract: `MXNET_JAX_COORDINATOR` (or
    `DMLC_PS_ROOT_URI` at `DMLC_PS_ROOT_PORT` + 1) is the rendezvous
    address ``host:port``, `DMLC_NUM_WORKER` the process count,
    `DMLC_WORKER_RANK`/`DMLC_RANK` this process's id.  The backend is
    NCCL on the card (device `local_device_ids[0]`, default the rank
    modulo the visible cards), gloo when `ctx` is `cpu()` or
    `transport="host"` (the card's tensors staged through host memory;
    the device is `ctx`, default gpu(0)).  `timeout` (seconds, default
    ``MXNET_DIST_TIMEOUT`` or 600) bounds every collective.  Returns
    (num_processes, process_id)."""
    dist = _dist_module()
    if coordinator is None:
        coordinator = _default_coordinator()
    if num_processes is None:
        num_processes = int(get_env("DMLC_NUM_WORKER", "1"))
    if process_id is None:
        process_id = int(get_env("DMLC_WORKER_RANK",
                                 get_env("DMLC_RANK", "0")))
    cpu = isinstance(ctx, Context) and ctx.device_type == "cpu" or (
        ctx is not None and not isinstance(ctx, Context)
        and torch.device(ctx).type == "cpu")
    if transport is None:
        transport = "gloo" if cpu else "nccl"
    if transport not in TRANSPORTS:
        raise MXNetError(f"transport {transport!r}: one of {TRANSPORTS}")
    if transport == "gloo" and not cpu:
        raise MXNetError("the gloo transport carries CPU tensors; name "
                         "transport='host' for CUDA tensors over gloo")
    if transport == "nccl":
        if cpu:
            raise MXNetError("NCCL carries CUDA tensors; ctx=cpu() takes "
                             "the gloo transport")
        if not torch.cuda.is_available():
            raise MXNetError("init_distributed: CUDA is not available on "
                             "this machine; pass ctx=cpu() for gloo")
        idx = (local_device_ids[0] if local_device_ids
               else process_id % torch.cuda.device_count())
        device = torch.device("cuda", idx)
        torch.cuda.set_device(device)
    else:
        device = as_device(ctx)
    if timeout is None:
        timeout = get_env("MXNET_DIST_TIMEOUT", 600, float)
    dist.init_process_group(
        "nccl" if transport == "nccl" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=int(num_processes),
        rank=int(process_id), timeout=timedelta(seconds=float(timeout)),
        **({"device_id": device} if transport == "nccl" else {}))
    _dist["transport"], _dist["device"] = transport, device
    return int(num_processes), int(process_id)


def shutdown():
    """Leave the process group (`destroy_process_group`)."""
    dist = _dist_module()
    if dist.is_initialized():
        dist.destroy_process_group()
    _dist["transport"], _dist["device"] = None, None


def make_mesh(axes=None, devices=None, ctx=None):
    """A mesh over the world's ranks.

    `axes`: an ordered {name: size}, or None for all ranks on 'dp'.
    `devices`: the global ranks to lay out (default all, in order).
    Without `init_distributed` the world is this one device, on `ctx`
    (default the current context)."""
    size, _ = world()
    if devices is None:
        devices = list(range(size))
    if axes is None:
        axes = {"dp": len(devices)}
    names = list(axes)
    n = int(_np.prod([int(axes[a]) for a in names]))
    if n > len(devices):
        raise MXNetError(
            f"mesh {dict(axes)} needs {n} devices, have {len(devices)}")
    transport = _dist["transport"] if size > 1 or _dist["transport"] \
        else None
    if transport is None:
        return Mesh(as_device(ctx), axes)
    device = _dist["device"] if ctx is None else as_device(ctx)
    return Mesh(device, axes, transport=transport, ranks=devices[:n])


def parse_mesh_shape(val):
    """Normalize a mesh-shape declaration to an ordered axis dict: a
    tuple of sizes in (dp, tp, pp) order, a bare csv string of them
    (what ``MXNET_MESH_SHAPE`` takes), named entries ``"dp=2,tp=2"`` /
    ``"dp2,tp4"``, or a dict.  The result is in canonical order
    (`MESH_AXES`) and always carries dp, pp and tp."""
    if isinstance(val, dict):
        sizes = {k: int(v) for k, v in val.items()}
    elif isinstance(val, (tuple, list)):
        if len(val) > 3:
            raise MXNetError(
                f"mesh_shape takes (dp, tp, pp), got {len(val)} entries")
        names = ("dp", "tp", "pp")
        sizes = {names[i]: int(v) for i, v in enumerate(val)}
    elif isinstance(val, str):
        parts = [p.strip() for p in val.split(",") if p.strip()]
        if not parts:
            raise MXNetError("mesh_shape: empty declaration")
        sizes = {}
        if all(p.isdigit() for p in parts):
            return parse_mesh_shape(tuple(int(p) for p in parts))
        for p in parts:
            m = re.fullmatch(r"([a-z]+)\s*=?\s*(\d+)", p)
            if not m:
                raise MXNetError(
                    f"mesh_shape entry {p!r}: want 'dp=2' / 'dp2' / "
                    f"a bare size csv in (dp, tp, pp) order")
            if m.group(1) in sizes:
                raise MXNetError(
                    f"mesh_shape: axis {m.group(1)!r} declared twice "
                    f"in {val!r}")
            sizes[m.group(1)] = int(m.group(2))
    else:
        raise MXNetError(f"mesh_shape: cannot parse {val!r}")
    bad = [k for k in sizes if k not in MESH_AXES]
    if bad:
        raise MXNetError(
            f"mesh_shape: unknown axes {bad}; canonical axes are "
            f"{MESH_AXES}")
    if any(v < 1 for v in sizes.values()):
        raise MXNetError(f"mesh_shape: axis sizes must be >= 1: {sizes}")
    out = {a: int(sizes.get(a, 1)) for a in ("dp", "pp", "tp")}
    for a in MESH_AXES:
        if a in sizes and a not in out:
            out[a] = int(sizes[a])
    return out


def mesh_from_shape(shape=None, devices=None, ctx=None):
    """The trainer's mesh from a shape declaration, or from
    ``MXNET_MESH_SHAPE`` (then the tuner's ``mesh_shape``) when `shape`
    is None; None when neither is given."""
    if shape is None:
        shape = get_env("MXNET_MESH_SHAPE", None)
        if not shape:
            from .. import tuner as _tuner
            shape = _tuner.tuned_value("mesh_shape")
        if not shape:
            return None
    return make_mesh(parse_mesh_shape(shape), devices, ctx=ctx)


def auto_axes(n_devices, want=("dp", "tp", "sp")):
    """Greedy factorization of n_devices over the requested axes: powers
    of two round-robin from the last axis, anything else on the first."""
    sizes = {a: 1 for a in want}
    m = n_devices
    if m & (m - 1):
        sizes[want[0]] = m
        return sizes
    i = len(want) - 1
    while m > 1:
        sizes[want[i]] *= 2
        m //= 2
        i = (i - 1) % len(want)
    return sizes


def default_mesh(n_devices=None, ctx=None):
    """All ranks of the world on 'dp' (the first `n_devices` of them);
    without `init_distributed`, the one-device mesh on `ctx` (default the
    current context)."""
    size, _ = world()
    if size == 1 and _dist["transport"] is None:
        if n_devices not in (None, 1):
            raise MXNetError(
                f"default_mesh({n_devices}): a world of one device; "
                f"init_distributed joins more")
        return Mesh(as_device(ctx))
    n = size if n_devices is None else int(n_devices)
    return make_mesh({"dp": n}, ctx=ctx)


def current_mesh():
    """The mesh installed by `mesh_scope` (None outside any scope)."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_scope(mesh):
    """Install `mesh` as the default (`ParallelTrainer`, the
    collectives)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
