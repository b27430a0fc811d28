"""Parameter sharding rules: name patterns -> PartitionSpec (counterpart
of `incubator_mxnet_tpu/parallel/sharding.py`).

The JAX package annotates global arrays and lets GSPMD partition the
program.  Here each rank holds its local block of every array
explicitly: a sharding is (mesh, spec), and `Sharding.blocks` says
which pieces of the global array make up this rank's block.  The rules
(`ParamRules`, `MEGATRON_RULES`, `TRANSFORMER_RULES`, `_fit`'s
degradation of an indivisible dim to replicated, `zero_state_spec`) are
the JAX package's.

One layout differs from a contiguous slice: a fused q | k | v
projection (a parameter named ``...qkv_weight``/``...qkv_bias``, dim 0
stacking q, k and v) cut over an axis on dim 0 is laid out head-aligned,
so a rank holds q_r ; k_r ; v_r, the rows of its own heads of each,
and the attention kernel sees whole heads.  Its block is three pieces
of the global array; `shard_params`, `ParallelTrainer`'s placement,
`convert.params_from_jax` and the checkpoint map it to and from the
global (JAX) layout.
"""
from __future__ import annotations

import re

import numpy as _np
import torch

from ..base import MXNetError

__all__ = ["PartitionSpec", "P", "Sharding", "named_sharding", "replicate",
           "zero_state_spec", "ParamRules", "MEGATRON_RULES",
           "TRANSFORMER_RULES", "shard_params", "is_fused_qkv"]


class PartitionSpec(tuple):
    """Per-dimension mesh axes: a name, a tuple of names (the dim split
    over their combined group, row-major) or None (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

_QKV = re.compile(r"(^|[_.])qkv_(weight|bias)$")


def is_fused_qkv(name):
    """Whether `name` is a fused q | k | v projection's weight or bias."""
    return bool(name) and bool(_QKV.search(name))


def _axes_of(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class Sharding:
    """(mesh, spec) of an array named `name` (the name picks the
    head-aligned layout of a fused qkv); `zero_dim`/`zero_axis` add
    ZeRO's split of one more dim over the data axis, applied to the
    block the spec gives."""

    def __init__(self, mesh, spec=(), name=None, zero_dim=None,
                 zero_axis=None):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)
        self.name = name
        self.zero_dim = zero_dim
        self.zero_axis = zero_axis

    def full_spec(self, ndim):
        s = list(self.spec) + [None] * (ndim - len(self.spec))
        return s[:ndim]

    def axes(self):
        """The mesh axes the array is cut over."""
        out = []
        for e in self.spec:
            out += [a for a in _axes_of(e) if a not in out]
        if self.zero_dim is not None:
            out.append(self.zero_axis)
        return tuple(out)

    def replica_axes(self):
        """The mesh axes over which every rank holds the same block."""
        used = set(self.axes())
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def _cut(self, e, coords=None):
        axes = _axes_of(e)
        return self.mesh.axis_size(axes), self._index(axes, coords)

    def _index(self, axes, coords):
        if coords is None:
            return self.mesh.axis_index(axes)
        idx = 0
        for a in self.mesh.axis_names:
            if a in axes:
                idx = idx * self.mesh.shape[a] + coords[a]
        return idx

    def local_shape(self, shape):
        out = []
        for d, e in zip(shape, self.full_spec(len(shape))):
            n, _ = self._cut(e)
            out.append(d // n)
        if self.zero_dim is not None:
            out[self.zero_dim] //= self.mesh.axis_size(self.zero_axis)
        return tuple(out)

    def blocks(self, shape, coords=None):
        """[(global index, local index)]: slices of the global array and
        where each lands in this rank's block (the block of the rank at
        mesh `coords`, if given)."""
        shape = tuple(shape)
        spec = self.full_spec(len(shape))
        per_dim = []
        for dim, (d, e) in enumerate(zip(shape, spec)):
            n, i = self._cut(e, coords)
            if d % n:
                raise MXNetError(f"{self.name or 'array'}: dim {dim} of "
                                 f"{shape} does not divide over {e} ({n})")
            b = d // n
            if dim == 0 and n > 1 and is_fused_qkv(self.name):
                if d % (3 * n):
                    raise MXNetError(
                        f"{self.name}: the fused q | k | v rows {d} do not "
                        f"split head-aligned over {n}")
                u, c = d // 3, d // 3 // n
                per_dim.append([(slice(j * u + i * c, j * u + (i + 1) * c),
                                 slice(j * c, (j + 1) * c))
                                for j in range(3)])
            else:
                per_dim.append([(slice(i * b, (i + 1) * b), slice(0, b))])
        if self.zero_dim is not None:
            nz = self.mesh.axis_size(self.zero_axis)
            iz = self._index((self.zero_axis,), coords)
            lb = sum(l.stop - l.start for _, l in per_dim[self.zero_dim])
            zb = lb // nz
            lo, hi = iz * zb, (iz + 1) * zb
            cut = []
            for g, l in per_dim[self.zero_dim]:
                a, b = max(lo, l.start), min(hi, l.stop)
                if a < b:
                    off = g.start - l.start
                    cut.append((slice(a + off, b + off),
                                slice(a - lo, b - lo)))
            per_dim[self.zero_dim] = cut
        out = [((), ())]
        for pieces in per_dim:
            out = [(g0 + (g,), l0 + (l,)) for g0, l0 in out
                   for g, l in pieces]
        return out

    def local_block(self, full):
        """This rank's block of the global tensor `full`."""
        pieces = self.blocks(full.shape)
        if len(pieces) == 1:
            return full[pieces[0][0]].contiguous()
        out = full.new_empty(self.local_shape(full.shape))
        for g, l in pieces:
            out[l] = full[g]
        return out

    def gather(self, block, shape):
        """The global tensor of `shape` from every rank's `block` (a
        collective over the whole mesh)."""
        from .collectives import _all_gather
        mesh = self.mesh
        if mesh.transport is None:
            return block
        every = _all_gather(mesh, mesh.axis_names,
                            block.contiguous().reshape(1, -1), 0)
        full = block.new_empty(tuple(shape))
        grid = mesh.devices.reshape(-1)
        for pos in range(mesh.size):
            where = _np.argwhere(mesh.devices == grid[pos])[0]
            coords = dict(zip(mesh.axis_names, (int(x) for x in where)))
            piece = every[pos].reshape(block.shape)
            for g, l in self.blocks(shape, coords):
                full[g] = piece[l]
        return full

    def __repr__(self):
        z = f", zero {self.zero_axis}@{self.zero_dim}" \
            if self.zero_dim is not None else ""
        return f"Sharding({self.spec}{z})"


def named_sharding(mesh, *spec):
    return Sharding(mesh, PartitionSpec(*spec))


def replicate(mesh):
    return named_sharding(mesh)


def zero_state_spec(spec, shape, mesh, axis="dp"):
    """ZeRO-1 optimizer-state spec: the parameter's spec with the
    largest still-unsharded dimension that `axis` divides cut over
    `axis`; the parameter's spec unchanged when `axis` is absent, of
    size 1, already used, or nothing divides."""
    dims = list(spec) if spec is not None else []
    dims += [None] * (len(shape) - len(dims))
    if axis not in mesh.axis_names or mesh.shape[axis] <= 1 \
            or axis in dims:
        return PartitionSpec(*dims)
    n = mesh.shape[axis]
    best = None
    for i, d in enumerate(dims):
        if d is None and shape[i] % n == 0 and shape[i] >= n:
            if best is None or shape[i] > shape[best]:
                best = i
    if best is None:
        return PartitionSpec(*dims)
    dims[best] = axis
    return PartitionSpec(*dims)


class ParamRules:
    """Ordered (regex, spec args) rules; the first match wins.  Axes
    absent from the mesh, and dims their size does not divide, degrade
    to replicated, so one rule set serves any mesh."""

    def __init__(self, rules, default=()):
        self._rules = [(re.compile(p), tuple(s)) for p, s in rules]
        self._default = tuple(default)

    def spec_for(self, name, shape, mesh):
        for pat, spec in self._rules:
            if pat.search(name):
                return PartitionSpec(*self._fit(spec, shape, mesh))
        return PartitionSpec(*self._fit(self._default, shape, mesh))

    @staticmethod
    def _fit(spec, shape, mesh):
        out = []
        for i, s in enumerate(spec[:len(shape)]):
            if s is None or s not in mesh.axis_names:
                out.append(None)
            elif shape[i] % mesh.shape[s] != 0:
                out.append(None)          # indivisible dim → replicate
            else:
                out.append(s)
        out += [None] * (len(shape) - len(out))
        return out

    def sharding_for(self, name, shape, mesh):
        return Sharding(mesh, self.spec_for(name, shape, mesh), name=name)


# Megatron-style transformer rules (Shoeybi et al. 2019) for this
# framework's gluon names: QKV column-parallel, the output projection
# row-parallel, FFN in column- and FFN out row-parallel, embeddings
# vocab-parallel.  Dense weights are [out, in], so "column parallel"
# cuts dim 0 and "row parallel" dim 1.
MEGATRON_RULES = ParamRules([
    (r"(query|key|value|qkv|attn_in).*weight$", ("tp", None)),
    (r"(query|key|value|qkv|attn_in).*bias$", ("tp",)),
    (r"(proj|attn_out|out_proj).*weight$", (None, "tp")),
    (r"(ffn_1|ffn_in|inter|fc1).*weight$", ("tp", None)),
    (r"(ffn_1|ffn_in|inter|fc1).*bias$", ("tp",)),
    (r"(ffn_2|ffn_out|fc2).*weight$", (None, "tp")),
    (r"embedding.*weight$", ("tp", None)),
], default=())


# The default multi-axis ruleset (a mesh with a >1 tp or pp axis and no
# explicit rules): Megatron's, plus `pipeline.GPipeStack`'s stacked
# stages (leading stage dim over 'pp', the output dim over 'tp').
TRANSFORMER_RULES = ParamRules([
    (r"pipe_weight$", ("pp", None, "tp")),
    (r"pipe_bias$", ("pp", None)),
    (r"(query|key|value|qkv|attn_in).*weight$", ("tp", None)),
    (r"(query|key|value|qkv|attn_in).*bias$", ("tp",)),
    (r"(proj|attn_out|out_proj).*weight$", (None, "tp")),
    (r"(ffn_1|ffn_in|inter|fc1).*weight$", ("tp", None)),
    (r"(ffn_1|ffn_in|inter|fc1).*bias$", ("tp",)),
    (r"(ffn_2|ffn_out|fc2).*weight$", (None, "tp")),
    (r"embedding.*weight$", ("tp", None)),
], default=())


def shard_params(params, mesh, rules=None, shapes=None):
    """{name: this rank's block} of a {name: global tensor or array}
    dict, per `rules` (default: replicated, a copy of each)."""
    out = {}
    for name, arr in params.items():
        t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(arr)
        sh = replicate(mesh) if rules is None else \
            rules.sharding_for(name, tuple(t.shape), mesh)
        out[name] = sh.local_block(t)
    return out
