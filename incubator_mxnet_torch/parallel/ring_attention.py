"""Ring attention: exact attention over sequences cut across a mesh axis
(counterpart of `incubator_mxnet_tpu/parallel/ring_attention.py`).

Each rank holds a sequence chunk of q, k and v; the k and v chunks go
round the 'sp' ring (`ppermute`) while an online softmax in float32
accumulates the exact result.  The backward is a ring program of its
own (`_Ring`): it recomputes each block's probabilities from the saved
log-sum-exp, keeps dq at home and sends dk and dv round the ring with
their k and v, so no rank ever holds the whole sequence.  Causal
masking is by global position (chunk r holds rows r·T/n ...); a block
whose every score is masked contributes exactly 0.

Three ways in, as in the JAX package:
- `_ring_attention_inner(q, k, v, axis_name, ...)`: on local chunks,
- `ring_attention(q, k, v, mesh, ...)`: on global tensors (shard_map),
- `sequence_parallel_scope(mesh)`: `ops.attention.multi_head_attention`
  runs its core through the ring on the local chunks it is given.

The blocks are torch matmuls (the JAX package uses plain einsums, no
Pallas kernel).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..base import MXNetError
from . import collectives as C

__all__ = ["ring_attention", "sequence_parallel_scope",
           "sequence_parallel_config"]

_state = threading.local()


def _keep(my, kv_idx, tq, tk, device):
    qp = my * tq + torch.arange(tq, device=device)[:, None]
    kp = kv_idx * tk + torch.arange(tk, device=device)[None, :]
    return qp >= kp


class _Ring(torch.autograd.Function):
    """q, k, v: [B, H, T, D] local chunks; returns the float32 output."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale, mask_value):
        n = mesh.axis_size(axis)
        my = mesh.axis_index(axis)
        tq, tk = q.shape[2], k.shape[2]
        qf = q.float() * scale
        acc = torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32,
                          device=q.device)
        row_max = torch.full(q.shape[:3], mask_value, dtype=torch.float32,
                             device=q.device)
        row_sum = torch.zeros(q.shape[:3], dtype=torch.float32,
                              device=q.device)
        kc, vc = k, v
        for i in range(n):
            kv_idx = (my - i) % n
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kc.float())
            if causal:
                keep = _keep(my, kv_idx, tq, tk, q.device)
                s = torch.where(keep, s, mask_value)
            new_max = torch.maximum(row_max, s.amax(-1))
            p = torch.exp(s - new_max[..., None])
            if causal:
                p = torch.where(keep, p, 0.0)
            alpha = torch.exp(row_max - new_max)
            row_sum = row_sum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vc.float())
            row_max = new_max
            if i < n - 1:
                kc = C._permute(mesh, axis, kc, _ring(n))
                vc = C._permute(mesh, axis, vc, _ring(n))
        den = torch.clamp(row_sum, min=1e-20)
        out = acc / den[..., None]
        lse = row_max + torch.log(den)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (mesh, axis, causal, scale, mask_value)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal, scale, mask_value = ctx.cfg
        n = mesh.axis_size(axis)
        my = mesh.axis_index(axis)
        tq, tk = q.shape[2], k.shape[2]
        dout = dout.float()
        qf = q.float() * scale
        delta = (dout * out).sum(-1)
        dq = torch.zeros_like(qf)
        kc, vc = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in range(n):
            kv_idx = (my - i) % n
            kf, vf = kc.float(), vc.float()
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
            p = torch.exp(s - lse[..., None])
            if causal:
                p = torch.where(_keep(my, kv_idx, tq, tk, q.device), p, 0.0)
            dv = dv + torch.einsum("bhqk,bhqd->bhkd", p, dout)
            dp = torch.einsum("bhqd,bhkd->bhqk", dout, vf)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
            dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, qf)
            # dk and dv travel with their block; after n hops they are
            # home, k and v need only n - 1
            dk = C._permute(mesh, axis, dk, _ring(n))
            dv = C._permute(mesh, axis, dv, _ring(n))
            if i < n - 1:
                kc = C._permute(mesh, axis, kc, _ring(n))
                vc = C._permute(mesh, axis, vc, _ring(n))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def _ring(n):
    return [(i, (i + 1) % n) for i in range(n)]


def _ring_attention_inner(q, k, v, axis_name, causal=False, scale=None,
                          mask_value=-1e30, mesh=None):
    """Per-rank body on local chunks. q: [B, H, Tq, D], k/v: [B, H, Tk,
    D]; returns [B, H, Tq, D] in q's dtype."""
    mesh = C.bound_mesh(mesh)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mesh.trivial(axis_name):
        return _one_block(q, k, v, causal, scale, mask_value).to(q.dtype)
    return _Ring.apply(q, k, v, mesh, axis_name, causal, float(scale),
                       float(mask_value)).to(q.dtype)


def _one_block(q, k, v, causal, scale, mask_value):
    """The ring of one rank: the same softmax on its one block, by
    autograd."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        keep = _keep(0, 0, q.shape[2], k.shape[2], q.device)
        s = torch.where(keep, s, mask_value)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(keep, p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / torch.clamp(
        p.sum(-1, keepdim=True), min=1e-20)


def ring_attention(q, k, v, mesh, seq_axis="sp", batch_axis="dp",
                   causal=False, scale=None):
    """Exact attention on global q/k/v [B, H, T, D]: T cut over
    `seq_axis`, B over `batch_axis` (if the mesh has it)."""
    from .sharding import PartitionSpec as P
    bspec = batch_axis if batch_axis in mesh.axis_names else None
    spec = P(bspec, None, seq_axis, None)

    def f(a, b, c):
        return _ring_attention_inner(a, b, c, seq_axis, causal=causal,
                                     scale=scale, mesh=mesh)
    return C.shard_map(f, mesh, (spec, spec, spec), spec)(q, k, v)


def sequence_parallel_config():
    return getattr(_state, "cfg", None)


@contextlib.contextmanager
def sequence_parallel_scope(mesh, seq_axis="sp", batch_axis="dp"):
    """While active, `ops.attention.multi_head_attention` computes its
    softmax(QK^T)V core with ring attention over `seq_axis` of `mesh`,
    on the local sequence chunks it is given; the BERT embedding offsets
    its positions by the chunk and pools the first token from the
    chunk that holds it."""
    if seq_axis not in mesh.axis_names:
        raise MXNetError(f"mesh has no axis {seq_axis!r}")
    prev = getattr(_state, "cfg", None)
    _state.cfg = {"mesh": mesh, "seq_axis": seq_axis,
                  "batch_axis": batch_axis if batch_axis in mesh.axis_names
                  else None}
    try:
        yield
    finally:
        _state.cfg = prev
