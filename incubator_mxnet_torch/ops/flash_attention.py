"""Attention kernels: the CUDA kernels' wrappers and their plain PyTorch
versions.

Counterpart of `incubator_mxnet_tpu/ops/flash_attention.py`.  Two
families, chosen by `flash_attention` as the JAX function chooses them:

* The packed short kernel (`_fwd_short_kernel`, reached through
  `_flash_short`) for self-attention with Tq == Tk <= 512.  Per
  batch-head,

      s = q·kᵀ·scale (f32), keys >= kv_length and (causal) above the
      diagonal masked to -1e30, p = softmax(s) rounded to the input dtype,
      o = p·v with f32 accumulation, cast to the input dtype.

  A row whose kv_length is 0 has every score at -1e30, so its softmax is
  uniform and the row is the mean of v.  The kernel is
  `csrc/flash_short_fwd.cu`, in two forms: `flash_short_fwd`
  (`save_p=False`, inference) returns o; `flash_short_fwd_train`
  (`save_p=True`) also returns p (BH, T, T) in the input dtype, which the
  backward reads.  `FlashShort` is the `torch.autograd.Function` of
  `_flash_short`'s custom VJP: its backward is `_bwd_short` in torch
  matmuls (the JAX package computes it as plain XLA einsums too).

* The streaming FlashAttention-2 kernels (`_fwd_kernel`,
  `_bwd_dq_kernel`, `_bwd_dkv_kernel`, reached through `_flash`) for
  everything else: longer or cross attention, or
  `MXNET_FLASH_ATTENTION_SHORT=0`.  The forward walks the key tiles with
  an online softmax and returns o and the row log-sum-exp lse (f32); the
  backward recomputes p = exp(s − lse) tile by tile.  The kernels are
  `csrc/flash_fwd.cu` (`flash_fwd`) and `csrc/flash_bwd.cu`
  (`flash_bwd_dq`, `flash_bwd_dkv`); `Flash` is `_flash`'s custom VJP.

  The JAX block sizes (after `_fit_block`) are part of the function:
  the TPU kernels skip causal key tiles wholly above the diagonal before
  any mask applies, so a row whose kv_length is 0 (every score -1e30)
  attends, with p = 1, to exactly the keys of the tiles it visits —
  the mean of v over those keys in the forward, and p = 1 (lse rounds
  to -1e30) on each of them in the backward.  The plain versions walk
  the same tiles; the CUDA kernels tile on their own and take bq, bk
  only to reproduce that rule.

* The short kernel in the BTHD layout (`_fwd_short_bthd_kernel`,
  `_bwd_short_bthd_kernel`, reached through `flash_attention_bthd`), the
  route `multi_head_attention` takes with MXNET_FLASH_ATTENTION_BTHD=1.
  Row 1's math on q, k, v of shape (B, T, H, d) read in place, with one
  batch and one row stride per tensor, so the q, k, v column slices of a
  fused (B, T, 3E) projection need no copy; lengths are per batch.  The
  forward is the short kernel itself, which addresses rows with per-tensor
  strides (the (BH, T, d) layout is its H = 1 case), counted apart as
  `flash_short_bthd_fwd` and `flash_short_bthd_fwd_train`; the backward
  reads the saved p in `csrc/flash_short_bthd_bwd.cu`
  (`flash_short_bthd_bwd`); `FlashShortBTHD` is `_flash_short_bthd`'s
  custom VJP.

Each wrapper launches its kernel for a CUDA tensor, takes the plain
version only for a CPU tensor, raises on any other device, and counts
its launches in `launch_counts`.  Rows 1 and 1b launch through the
custom ops `mxnet_torch::flash_short_fwd` and `flash_short_fwd_train`
(`torch.library`), so `torch.export` and `make_fx` record them as one
node each and an AOTInductor package calls them through the dispatcher
(`deploy.export_serving(..., platforms=("cuda",))`, `export_training`);
`csrc/mxtorch_ops.cu` registers the same schemas for a process with no
Python.  The other kernels' wrappers refuse a traced tensor.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch
import torch.utils.flop_counter

from ..base import MXNetError, get_env
from .._kernels import (entry, route as _route, stream as _stream,
                        add_flops as _add_flops)

__all__ = ["flash_attention", "flash_short_fwd", "flash_short_fwd_train",
           "flash_short_reference", "flash_short_bwd", "FlashShort",
           "flash_attention_bthd", "flash_short_bthd_fwd",
           "flash_short_bthd_fwd_train", "flash_short_bthd_bwd",
           "flash_short_bthd_reference", "flash_short_bthd_bwd_reference",
           "FlashShortBTHD",
           "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_fwd_reference", "flash_bwd_dq_reference",
           "flash_bwd_dkv_reference", "Flash", "launch_counts",
           "reset_launch_counts", "MAX_SHORT_LEN", "MAX_HEAD_DIM"]

_NEG_INF = -1e30
MAX_SHORT_LEN = 512
MAX_HEAD_DIM = 256

_count_lock = threading.Lock()
launch_counts = {"flash_short_fwd": 0, "flash_short_fwd_train": 0,
                 "flash_short_bthd_fwd": 0, "flash_short_bthd_fwd_train": 0,
                 "flash_short_bthd_bwd": 0,
                 "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launch_counts():
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


def _count(name):
    with _count_lock:
        launch_counts[name] += 1


@contextlib.contextmanager
def _exact_matmuls():
    """float32 matmuls in full float32 (the JAX kernels ask for
    `Precision.HIGHEST`) and bfloat16 matmuls reduced in float32 only:
    TF32 and reduced-precision split-K reductions off for the duration."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = prev


def _entry(lib, name, n_ptrs, n_ints, tail):
    """The C entry point `name` of kernel library `lib`: `n_ptrs`
    pointers, `n_ints` ints, then `tail` (ctypes types) and the stream."""
    return entry(lib, name, [ctypes.c_void_p] * n_ptrs
                 + [ctypes.c_int] * n_ints + list(tail) + [ctypes.c_void_p])


def _aligned(*ts):
    """The kernels move rows 16 bytes at a time: a view that starts
    mid-allocation gets an aligned copy."""
    for t in ts:
        if not t.is_contiguous():
            raise MXNetError("attention kernels: inputs must be contiguous")
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ts]


def _launched(name, err):
    if err != 0:
        raise MXNetError(f"{name}: kernel launch failed with cudaError {err}")
    _count(name)


# ---------------------------------------------------------------------
# the short kernel (T <= 512)
# ---------------------------------------------------------------------

def flash_short_reference(q, k, v, lengths, scale, causal, save_p=False):
    """The plain version: q, k, v (BH, T, d); lengths (BH,) int.  Returns
    o, or (o, p) with `save_p`."""
    T = q.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    cols = torch.arange(T, device=q.device)
    keep = cols[None, None, :] < lengths.reshape(-1, 1, 1).to(q.device)
    if causal:
        keep = keep & (cols[:, None] >= cols[None, :])[None]
    s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    pn = (p / torch.where(l == 0.0, torch.ones_like(l), l)).to(q.dtype)
    o = torch.einsum("bqk,bkd->bqd", pn.to(torch.float32),
                     v.to(torch.float32)).to(q.dtype)
    return (o, pn) if save_p else o


def _check_inputs(name, q, k, v, lengths, tensors=()):
    """q (BH, Tq, d), k and v (BH, Tk, d), one dtype (bf16 or f32), d <=
    MAX_HEAD_DIM, lengths (BH,) int32, everything on one device."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise MXNetError(
            f"{name}: q must be (BH, Tq, d) and k, v (BH, Tk, d), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, Tq, d = q.shape
    if Tq < 1 or k.shape[1] < 1 or not 1 <= d <= MAX_HEAD_DIM:
        raise MXNetError(f"{name}: needs T >= 1 and 1 <= d <= "
                         f"{MAX_HEAD_DIM}, got {tuple(q.shape)}")
    _check_types(name, q, k, v, (lengths, *tensors))
    _check_lengths(name, lengths, BH)


def _check_types(name, q, k, v, tensors):
    """q, k, v of one dtype (bf16 or f32), everything on one device."""
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(
            f"{name}: q, k, v must all be bfloat16 or float32, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    devs = {t.device for t in (q, k, v, *tensors)}
    if len(devs) != 1:
        raise MXNetError(f"{name}: tensors on several devices "
                         f"{sorted(map(str, devs))}")


def _check_lengths(name, lengths, n):
    if lengths.shape != (n,) or lengths.dtype != torch.int32:
        raise MXNetError(
            f"{name}: lengths must be int32 of shape ({n},), "
            f"got {lengths.dtype} {tuple(lengths.shape)}")


def _check(q, k, v, lengths):
    _check_inputs("flash_short_fwd", q, k, v, lengths)
    if k.shape != q.shape or q.shape[1] > MAX_SHORT_LEN:
        raise MXNetError(
            f"flash_short_fwd: needs Tq == Tk <= {MAX_SHORT_LEN}, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}")


def _bthd_rows(t):
    """(t, batch stride, row stride) for a (B, T, H, d) tensor the
    kernels read in place: the d elements of a head's row contiguous and
    heads d apart, a 16-byte-aligned base, rows and batches that do not
    overlap, and batch and row strides that are multiples of 16 bytes or
    a contiguous tensor (the tensor-core kernels, which move rows 16
    bytes at a time through TMA tensor maps, run only where a contiguous
    tensor's strides are).  Any other tensor is replaced by one
    contiguous copy, which the allocator aligns."""
    B, T, H, d = t.shape
    sb, st, sh, se = t.stride()
    strides_ok = all(s * t.element_size() % 16 == 0
                     for s, n in ((sb, B), (st, T)) if n > 1)
    apart = (T == 1 or st >= H * d) and (B == 1 or sb >= T * st)
    if ((se == 1 or d == 1) and (sh == d or H == 1) and apart
            and t.data_ptr() % 16 == 0 and (strides_ok or t.is_contiguous())):
        return t, sb, st
    return t.clone(memory_format=torch.contiguous_format), T * H * d, H * d


def _launch_short(q, k, v, lengths, scale, causal, save_p, counter):
    """Launch the short kernel on q, k, v (B, T, H, d), any strides, and
    lengths (B,) int32, and count the launch under `counter`.  Returns o
    (B, T, H, d) contiguous, or (o, p) with `save_p`, p (B, H, T, T)."""
    fn = _entry("flash_short_fwd", "flash_short_fwd", 6, 4,
                (ctypes.c_longlong,) * 6 + (ctypes.c_float, ctypes.c_int,
                                            ctypes.c_int))
    B, T, H, d = q.shape
    rows = [_bthd_rows(t) for t in (q, k, v)]
    lengths = _aligned(lengths.contiguous())[0]
    o = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    p = torch.empty((B, H, T, T), dtype=q.dtype, device=q.device) \
        if save_p else None
    if B * H == 0:
        return (o, p) if save_p else o
    err = fn(*(r[0].data_ptr() for r in rows), lengths.data_ptr(),
             o.data_ptr(), p.data_ptr() if save_p else None, B, H, T, d,
             *(s for r in rows for s in r[1:]), float(scale),
             int(bool(causal)), int(q.dtype == torch.bfloat16), _stream(q))
    _launched(counter, err)
    if counter.startswith("flash_short_bthd"):
        # rows 1 and 1b are registered ops with a FLOP formula (below);
        # the BTHD forms are plain ctypes launches: QK^T and PV
        _add_flops(4 * B * H * T * T * d)
    return (o, p) if save_p else o


def _launch_short_bhtd(q, k, v, lengths, scale, causal, save_p):
    """The short kernel on (BH, T, d) tensors: the H = 1 case."""
    out = _launch_short(*(t.unsqueeze(2) for t in (q, k, v)), lengths,
                        scale, causal, save_p,
                        "flash_short_fwd_train" if save_p
                        else "flash_short_fwd")
    return (out[0].squeeze(2), out[1].squeeze(1)) if save_p \
        else out.squeeze(2)


# Rows 1 and 1b as registered custom ops, so that `torch.export` and
# `make_fx` record a launch as one node (their fake forms give only
# shapes) and AOTInductor packages call it through the dispatcher.
# `csrc/mxtorch_ops.cu` registers the same schemas for a process with no
# Python; the two registrations never meet in one process.
SHORT_SCHEMAS = {
    "flash_short_fwd": "(Tensor q, Tensor k, Tensor v, Tensor lengths, "
                       "float scale, bool causal) -> Tensor",
    "flash_short_fwd_train": "(Tensor q, Tensor k, Tensor v, "
                             "Tensor lengths, float scale, bool causal) -> "
                             "(Tensor, Tensor)",
}


def _short_op(name, save_p):
    op = torch.library.custom_op(
        f"mxnet_torch::{name}",
        lambda q, k, v, lengths, scale, causal: _launch_short_bhtd(
            q, k, v, lengths, scale, causal, save_p),
        mutates_args=(), device_types="cuda", schema=SHORT_SCHEMAS[name])

    @op.register_fake
    def _fake(q, k, v, lengths, scale, causal):
        o = q.new_empty(q.shape)
        return (o, q.new_empty((q.shape[0], q.shape[1], q.shape[1]))) \
            if save_p else o
    return op


_SHORT_OPS = {False: _short_op("flash_short_fwd", False),
              True: _short_op("flash_short_fwd_train", True)}


def _short_flops(q_shape, k_shape, *args, out_shape=None, **kwargs):
    """FLOPs of rows 1 and 1b: QK^T and PV over every (query, key) pair,
    masked ones included, as the plain version's two products count."""
    BH, Tq, d = q_shape
    return 4 * BH * Tq * k_shape[1] * d


# torch's FlopCounterMode counts a registered op only by a formula
torch.utils.flop_counter.register_flop_formula(
    [getattr(torch.ops.mxnet_torch, name) for name in SHORT_SCHEMAS])(
        _short_flops)


def _dispatch(q, k, v, lengths, scale, causal, save_p):
    _check(q, k, v, lengths)
    return _route(
        "flash_short_fwd", q,
        lambda: _SHORT_OPS[save_p](q, k, v, lengths, float(scale),
                                   bool(causal)),
        lambda: flash_short_reference(q, k, v, lengths, scale, causal,
                                      save_p), traceable=True)


def flash_short_fwd(q, k, v, lengths, scale, causal=False):
    """o for q, k, v (BH, T, d) and lengths (BH,) int32: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    return _dispatch(q, k, v, lengths, scale, causal, False)


def flash_short_fwd_train(q, k, v, lengths, scale, causal=False):
    """(o, p) for q, k, v (BH, T, d) and lengths (BH,) int32, p (BH, T, T)
    the normalized probabilities in the input dtype (the `save_p=True`
    form): the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    return _dispatch(q, k, v, lengths, scale, causal, True)


def flash_short_bwd(q, k, v, o, p, do, scale):
    """`_bwd_short`: dq, dk, dv from the saved normalized p (BH, T, T) in
    the input dtype.  delta = rowsum(do·o) and dp = do·vᵀ are float32;
    ds = p·(dp − delta)·scale is rounded to the input dtype; dq = ds·k,
    dk = dsᵀ·q and dv = pᵀ·do take input-dtype operands, accumulate in
    float32 and round once, as the JAX einsums with
    `preferred_element_type` and the cast after them.  A row whose
    kv_length is 0 has p = 1/T, so it sends gradient into k as in the
    JAX package; masked columns of other rows have p = 0."""
    f32 = torch.float32
    with _exact_matmuls():
        delta = (do.to(f32) * o.to(f32)).sum(dim=-1, keepdim=True)
        dp = torch.bmm(do.to(f32), v.to(f32).transpose(1, 2))
        ds = (p.to(f32) * (dp - delta) * scale).to(q.dtype)
        dq = torch.bmm(ds, k)
        dk = torch.bmm(ds.transpose(1, 2), q)
        dv = torch.bmm(p.transpose(1, 2), do)
    return dq, dk, dv


class FlashShort(torch.autograd.Function):
    """`_flash_short` with its custom VJP: the forward is the training
    kernel (`flash_short_fwd_train`), which saves p; the backward is
    `flash_short_bwd`.  `lengths` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale, causal):
        o, p = flash_short_fwd_train(q, k, v, lengths, scale, causal)
        ctx.save_for_backward(q, k, v, o, p)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, p = ctx.saved_tensors
        dq, dk, dv = flash_short_bwd(q, k, v, o, p, do.contiguous(),
                                     ctx.scale)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------
# the short kernel in the BTHD layout (T <= 512)
# ---------------------------------------------------------------------

def flash_short_bthd_reference(q, k, v, lengths, scale, causal,
                               save_p=False):
    """The plain version of `_fwd_short_bthd`: q, k, v (B, T, H, d), any
    strides; lengths (B,) int.  Returns o (B, T, H, d) contiguous, or
    (o, p) with `save_p`, p (B, H, T, T) in the input dtype.  Row 1's
    rules for each (b, h): keys >= kv_length and (causal) above the
    diagonal at -1e30, the `safe_l` guard, p rounded before p·v, so a row
    whose kv_length is 0 is the mean of v."""
    f32 = torch.float32
    T = q.shape[1]
    cols = torch.arange(T, device=q.device)
    keep = cols < lengths.reshape(-1, 1, 1, 1).to(q.device)
    if causal:
        keep = keep & (cols[:, None] >= cols[None, :])
    with _exact_matmuls():
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) * scale
        s = torch.where(keep, s, _NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        pn = (p / torch.where(l == 0.0, torch.ones_like(l), l)).to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", pn.to(f32), v.to(f32))
    o = o.to(q.dtype).contiguous()
    return (o, pn) if save_p else o


def flash_short_bthd_bwd_reference(q, k, v, do, delta, p, scale):
    """The plain version of `_bwd_short_bthd_kernel`: q, k, v, do (B, T,
    H, d), any strides; delta (B, H, T) float32; p (B, H, T, T) in the
    input dtype.  dp = do·vᵀ in float32; ds = (p·(dp − delta))·scale
    rounded to the input dtype; dq = ds·k, dk = dsᵀ·q and dv = pᵀ·do take
    input-dtype operands, accumulate in float32 and round once.  Returns
    dq, dk, dv (B, T, H, d) contiguous."""
    f32 = torch.float32
    with _exact_matmuls():
        dp = torch.einsum("bqhd,bkhd->bhqk", do.to(f32), v.to(f32))
        ds = (p.to(f32) * (dp - delta.unsqueeze(-1)) * scale).to(q.dtype)
        grads = (torch.einsum("bhqk,bkhd->bqhd", ds.to(f32), k.to(f32)),
                 torch.einsum("bhqk,bqhd->bkhd", ds.to(f32), q.to(f32)),
                 torch.einsum("bhqk,bqhd->bkhd", p.to(f32), do.to(f32)))
    return tuple(g.to(q.dtype).contiguous() for g in grads)


def _check_bthd(name, q, k, v, tensors=()):
    """q, k, v (B, T, H, d), one shape and dtype (bf16 or f32), 1 <= T <=
    MAX_SHORT_LEN, 1 <= d <= MAX_HEAD_DIM, everything on one device."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise MXNetError(f"{name}: q, k, v must all be (B, T, H, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    T, d = q.shape[1], q.shape[3]
    if not (1 <= T <= MAX_SHORT_LEN and 1 <= d <= MAX_HEAD_DIM):
        raise MXNetError(f"{name}: needs 1 <= T <= {MAX_SHORT_LEN} and "
                         f"1 <= d <= {MAX_HEAD_DIM}, got {tuple(q.shape)}")
    _check_types(name, q, k, v, tensors)


def _dispatch_bthd(q, k, v, lengths, scale, causal, save_p):
    _check_bthd("flash_short_bthd_fwd", q, k, v, (lengths,))
    _check_lengths("flash_short_bthd_fwd", lengths, q.shape[0])
    return _route(
        "flash_short_bthd_fwd", q,
        lambda: _launch_short(q, k, v, lengths, scale, causal, save_p,
                              "flash_short_bthd_fwd_train" if save_p
                              else "flash_short_bthd_fwd"),
        lambda: flash_short_bthd_reference(q, k, v, lengths, scale, causal,
                                           save_p))


def flash_short_bthd_fwd(q, k, v, lengths, scale, causal=False):
    """o (B, T, H, d) for q, k, v (B, T, H, d), any strides, and lengths
    (B,) int32: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    return _dispatch_bthd(q, k, v, lengths, scale, causal, False)


def flash_short_bthd_fwd_train(q, k, v, lengths, scale, causal=False):
    """(o, p) for q, k, v (B, T, H, d) and lengths (B,) int32, p (B, H, T,
    T) the normalized probabilities in the input dtype (the `save_p=True`
    form): the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    return _dispatch_bthd(q, k, v, lengths, scale, causal, True)


def _launch_short_bthd_bwd(q, k, v, do, delta, p, scale):
    fn = _entry("flash_short_bthd_bwd", "flash_short_bthd_bwd", 9, 4,
                (ctypes.c_longlong,) * 8 + (ctypes.c_float, ctypes.c_int))
    B, T, H, d = q.shape
    rows = [_bthd_rows(t) for t in (q, k, v, do)]
    delta, p = _aligned(delta.contiguous(), p.contiguous())
    outs = tuple(torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
                 for _ in range(3))
    if B * H == 0:
        return outs
    err = fn(*(r[0].data_ptr() for r in rows), delta.data_ptr(),
             p.data_ptr(), *(t.data_ptr() for t in outs), B, H, T, d,
             *(s for r in rows for s in r[1:]), float(scale),
             int(q.dtype == torch.bfloat16), _stream(q))
    _launched("flash_short_bthd_bwd", err)
    # dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q
    _add_flops(8 * B * H * T * T * d)
    return outs


def flash_short_bthd_bwd(q, k, v, do, delta, p, scale):
    """dq, dk, dv (B, T, H, d) of `_bwd_short_bthd_kernel` from q, k, v, do
    (B, T, H, d), any strides, delta = rowsum(do·o) (B, H, T) float32 and
    the saved p (B, H, T, T): the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    name = "flash_short_bthd_bwd"
    _check_bthd(name, q, k, v, (do, delta, p))
    B, T, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise MXNetError(f"{name}: do must match q, got {do.dtype} "
                         f"{tuple(do.shape)}")
    if delta.shape != (B, H, T) or delta.dtype != torch.float32:
        raise MXNetError(f"{name}: delta must be float32 of shape "
                         f"{(B, H, T)}, got {delta.dtype} "
                         f"{tuple(delta.shape)}")
    if p.shape != (B, H, T, T) or p.dtype != q.dtype:
        raise MXNetError(f"{name}: p must be {q.dtype} of shape "
                         f"{(B, H, T, T)}, got {p.dtype} {tuple(p.shape)}")
    return _route(
        name, q,
        lambda: _launch_short_bthd_bwd(q, k, v, do, delta, p, scale),
        lambda: flash_short_bthd_bwd_reference(q, k, v, do, delta, p, scale))


class FlashShortBTHD(torch.autograd.Function):
    """`_flash_short_bthd` with its custom VJP: the forward is the BTHD
    training form (`flash_short_bthd_fwd_train`), which saves p; the
    backward takes delta = rowsum(do·o) per (b, h) in float32 (plain
    torch, as `_bwd_short_bthd` computes it outside its kernel), then
    `flash_short_bthd_bwd`.  `lengths` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale, causal):
        o, p = flash_short_bthd_fwd_train(q, k, v, lengths, scale, causal)
        ctx.save_for_backward(q, k, v, o, p)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, p = ctx.saved_tensors
        do = do.to(q.dtype)
        delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
        dq, dk, dv = flash_short_bthd_bwd(
            q, k, v, do, delta.transpose(1, 2).contiguous(), p, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_bthd(q, k, v, *, causal=False, scale=None,
                         kv_length=None):
    """softmax(q·kᵀ·scale)·v on (B, T, H, d) tensors, the JAX package's
    `flash_attention_bthd`: the layout a fused qkv projection gives by a
    free reshape, read in place; the output is (B, T, H, d) contiguous,
    so its reshape to (B, T, H·d) is free.  Tq == Tk <= 512 only.
    `kv_length` ((B,) int) masks key positions >= length.  Under autograd
    (an input requiring grad) the route is `FlashShortBTHD`, otherwise
    the inference form alone."""
    B, T, H, d = q.shape
    if k.shape[1] != T or T > MAX_SHORT_LEN:
        raise MXNetError(f"flash_attention_bthd: requires Tq == Tk <= "
                         f"{MAX_SHORT_LEN}, got {T} and {k.shape[1]}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if kv_length is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=q.device)
    else:
        kv_length = torch.as_tensor(kv_length, device=q.device).reshape(-1)
        if kv_length.shape[0] != B:
            raise MXNetError(
                f"flash_attention_bthd: kv_length has {kv_length.shape[0]} "
                f"entries, expected {B}")
        lengths = kv_length.to(torch.int32).contiguous()
    args = (q, k, v, lengths, float(scale), bool(causal))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashShortBTHD.apply(*args)
    return flash_short_bthd_fwd(*args)


# ---------------------------------------------------------------------
# the streaming FlashAttention-2 kernels
# ---------------------------------------------------------------------

def _fit_block(block, T):
    """Largest 128-multiple <= block that divides T (T=1152 → 384 for
    a 512 request).  T <= 128 runs as one block; larger T must be
    128-divisible — otherwise 128 is returned so the caller's explicit
    multiples-of-block error fires."""
    if T <= 128:
        return min(block, T)
    cand = min((block // 128) * 128, (T // 128) * 128)
    while cand >= 128:
        if T % cand == 0:
            return cand
        cand -= 128
    return 128


def _key_tiles(q, k, lengths, scale, causal, block_q, block_k):
    """For each key tile [c0, c0 + block_k) of the TPU kernels' grid:
    (c0, c1, s2, visited).  s2 (BH, Tq, c1 - c0) f32 is the tile's
    scaled scores with keys >= kv_length and (causal) rows < cols set to
    -1e30, in the kernels' order; visited (1, Tq, 1) bool, or None
    without causal, says which query rows' tiles run this key tile (the
    causal skip `j*bk <= i*bq + bq - 1`)."""
    f32 = torch.float32
    Tq, Tk = q.shape[1], k.shape[1]
    rows = torch.arange(Tq, device=q.device)
    lens = lengths.reshape(-1, 1, 1).to(q.device)
    qf = q.to(f32)
    for c0 in range(0, Tk, block_k):
        c1 = min(c0 + block_k, Tk)
        s = torch.einsum("bqd,bkd->bqk", qf, k[:, c0:c1].to(f32)) * scale
        cols = torch.arange(c0, c1, device=q.device)
        s2 = torch.where(cols[None, None, :] < lens, s, _NEG_INF)
        visited = None
        if causal:
            s2 = torch.where((rows[:, None] >= cols[None, :])[None], s2,
                             _NEG_INF)
            visited = (c0 <= (rows // block_q) * block_q + block_q - 1)
            visited = visited.reshape(1, Tq, 1)
        yield c0, c1, s2, visited


def flash_fwd_reference(q, k, v, lengths, scale, causal, block_q, block_k):
    """The plain version of `_fwd`: q (BH, Tq, d), k, v (BH, Tk, d),
    lengths (BH,) int.  Returns o (BH, Tq, d) in the input dtype and lse
    (BH, Tq, 1) float32.  Walks the key tiles as `_fwd_kernel` does:
    running max m (from -1e30), sum l and f32 accumulator; each tile's
    unnormalised p is rounded to v's dtype before p·v; o = acc / l at the
    end (l == 0 guarded), lse = m + log(l)."""
    f32 = torch.float32
    BH, Tq, d = q.shape
    m = torch.full((BH, Tq, 1), _NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((BH, Tq, 1), dtype=f32, device=q.device)
    acc = torch.zeros((BH, Tq, d), dtype=f32, device=q.device)
    with _exact_matmuls():
        for c0, c1, s2, visited in _key_tiles(q, k, lengths, scale, causal,
                                              block_q, block_k):
            m_new = torch.maximum(m, s2.amax(dim=-1, keepdim=True))
            p = torch.exp(s2 - m_new)
            corr = torch.exp(m - m_new)
            l_new = l * corr + p.sum(dim=-1, keepdim=True)
            acc_new = acc * corr + torch.einsum(
                "bqk,bkd->bqd", p.to(v.dtype).to(f32), v[:, c0:c1].to(f32))
            if visited is None:
                m, l, acc = m_new, l_new, acc_new
            else:
                m = torch.where(visited, m_new, m)
                l = torch.where(visited, l_new, l)
                acc = torch.where(visited, acc_new, acc)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / safe_l).to(q.dtype), m + torch.log(safe_l)


def _bwd_tiles(q, k, v, do, lse, delta, lengths, scale, causal, block_q,
               block_k):
    """For each key tile: (c0, c1, p, ds) as `_bwd_dq_kernel` and
    `_bwd_dkv_kernel` compute them: p = exp(s2 − lse) (0 on the tiles a
    row's tile skips), ds = p·(dp − delta)·scale, both f32."""
    f32 = torch.float32
    dof = do.to(f32)
    for c0, c1, s2, visited in _key_tiles(q, k, lengths, scale, causal,
                                          block_q, block_k):
        p = torch.exp(s2 - lse)
        if visited is not None:
            p = torch.where(visited, p, torch.zeros_like(p))
        dp = torch.einsum("bqd,bkd->bqk", dof, v[:, c0:c1].to(f32))
        yield c0, c1, p, p * (dp - delta) * scale


def flash_bwd_dq_reference(q, k, v, do, lse, delta, lengths, scale, causal,
                           block_q, block_k):
    """The plain version of `_bwd_dq_kernel`: dq (BH, Tq, d) in q's dtype
    from lse and delta (BH, Tq, 1) f32.  ds is rounded to k's dtype before
    ds·k, accumulated in f32."""
    f32 = torch.float32
    acc = torch.zeros(q.shape, dtype=f32, device=q.device)
    with _exact_matmuls():
        for c0, c1, _p, ds in _bwd_tiles(q, k, v, do, lse, delta, lengths,
                                         scale, causal, block_q, block_k):
            acc = acc + torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).to(f32),
                                     k[:, c0:c1].to(f32))
    return acc.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, lengths, scale, causal,
                            block_q, block_k):
    """The plain version of `_bwd_dkv_kernel`: (dk, dv), each (BH, Tk, d)
    in the input dtype.  dv = pᵀ·do with p rounded to do's dtype, dk =
    dsᵀ·q with ds rounded to q's dtype, both accumulated in f32."""
    f32 = torch.float32
    dk, dv = [], []
    with _exact_matmuls():
        qf, dof = q.to(f32), do.to(f32)
        for _c0, _c1, p, ds in _bwd_tiles(q, k, v, do, lse, delta, lengths,
                                          scale, causal, block_q, block_k):
            dv.append(torch.einsum("bqk,bqd->bkd",
                                   p.to(do.dtype).to(f32), dof))
            dk.append(torch.einsum("bqk,bqd->bkd",
                                   ds.to(q.dtype).to(f32), qf))
    return torch.cat(dk, 1).to(k.dtype), torch.cat(dv, 1).to(v.dtype)


def _check_blocks(name, block_q, block_k):
    if block_q < 1 or block_k < 1:
        raise MXNetError(f"{name}: block sizes must be >= 1, got "
                         f"({block_q}, {block_k})")


def _geometry(q, k, scale, causal, block_q, block_k):
    """The ints and floats every streaming entry point takes after its
    pointers: bh, tq, tk, d, causal, block_q, block_k, is_bf16, then
    scale."""
    BH, Tq, d = q.shape
    return (BH, Tq, k.shape[1], d, int(bool(causal)), int(block_q),
            int(block_k), int(q.dtype == torch.bfloat16), float(scale))


def _launch_fwd(q, k, v, lengths, scale, causal, block_q, block_k):
    fn = _entry("flash_fwd", "flash_fwd", 6, 8, (ctypes.c_float,))
    q, k, v, lengths = _aligned(q, k, v, lengths)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2] + (1,), dtype=torch.float32,
                      device=q.device)
    if q.shape[0] == 0:
        return o, lse
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             o.data_ptr(), lse.data_ptr(),
             *_geometry(q, k, scale, causal, block_q, block_k), _stream(q))
    _launched("flash_fwd", err)
    # QK^T and PV over every (query, key) pair, masked ones included
    _add_flops(4 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2])
    return o, lse


def flash_fwd(q, k, v, lengths, scale, causal, block_q, block_k):
    """(o, lse) of `_fwd` for q (BH, Tq, d), k, v (BH, Tk, d) and lengths
    (BH,) int32, with the JAX block sizes: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    _check_inputs("flash_fwd", q, k, v, lengths)
    _check_blocks("flash_fwd", block_q, block_k)
    return _route(
        "flash_fwd", q,
        lambda: _launch_fwd(q, k, v, lengths, scale, causal, block_q,
                            block_k),
        lambda: flash_fwd_reference(q, k, v, lengths, scale, causal,
                                    block_q, block_k))


def _check_bwd(name, q, k, v, do, lse, delta, lengths, block_q, block_k):
    _check_inputs(name, q, k, v, lengths, (do, lse, delta))
    _check_blocks(name, block_q, block_k)
    rows = q.shape[:2] + (1,)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise MXNetError(f"{name}: do must match q, got {do.dtype} "
                         f"{tuple(do.shape)}")
    for what, t in (("lse", lse), ("delta", delta)):
        if t.shape != rows or t.dtype != torch.float32:
            raise MXNetError(f"{name}: {what} must be float32 of shape "
                             f"{rows}, got {t.dtype} {tuple(t.shape)}")


def _launch_bwd(name, n_out, q, k, v, do, lse, delta, lengths, scale,
                causal, block_q, block_k):
    fn = _entry("flash_bwd", name, 7 + n_out, 8, (ctypes.c_float,))
    q, k, v, do, lse, delta, lengths = _aligned(q, k, v, do, lse, delta,
                                                lengths)
    outs = [torch.empty_like(t) for t in ((q,) if n_out == 1 else (k, v))]
    if q.shape[0] == 0:
        return outs
    err = fn(*(t.data_ptr() for t in (q, k, v, do, lse, delta, lengths)),
             *(t.data_ptr() for t in outs),
             *_geometry(q, k, scale, causal, block_q, block_k), _stream(q))
    _launched(name, err)
    # dq recomputes S = QK^T and dP = dO V^T, then dS K (3 products);
    # dkv recomputes S^T and dP^T, then P^T dO and dS^T Q (4)
    _add_flops((6 if n_out == 1 else 8) * q.shape[0] * q.shape[1]
               * k.shape[1] * q.shape[2])
    return outs


def flash_bwd_dq(q, k, v, do, lse, delta, lengths, scale, causal, block_q,
                 block_k):
    """dq of `_bwd_dq_kernel`: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  lse and delta are (BH, Tq, 1)
    float32."""
    args = (q, k, v, do, lse, delta, lengths)
    _check_bwd("flash_bwd_dq", *args, block_q, block_k)
    return _route(
        "flash_bwd_dq", q,
        lambda: _launch_bwd("flash_bwd_dq", 1, *args, scale, causal,
                            block_q, block_k)[0],
        lambda: flash_bwd_dq_reference(*args, scale, causal, block_q,
                                       block_k))


def flash_bwd_dkv(q, k, v, do, lse, delta, lengths, scale, causal, block_q,
                  block_k):
    """(dk, dv) of `_bwd_dkv_kernel`: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    args = (q, k, v, do, lse, delta, lengths)
    _check_bwd("flash_bwd_dkv", *args, block_q, block_k)
    return _route(
        "flash_bwd_dkv", q,
        lambda: tuple(_launch_bwd("flash_bwd_dkv", 2, *args, scale, causal,
                                  block_q, block_k)),
        lambda: flash_bwd_dkv_reference(*args, scale, causal, block_q,
                                        block_k))


class Flash(torch.autograd.Function):
    """`_flash` with its custom VJP: the forward is `flash_fwd` and saves
    q, k, v, lengths, o and lse; the backward takes delta = rowsum(do·o)
    in float32 (plain torch, as `_bwd` computes it outside its kernels),
    then `flash_bwd_dq` and `flash_bwd_dkv`.  `lengths` gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale, causal, block_q, block_k):
        o, lse = flash_fwd(q, k, v, lengths, scale, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, lengths, o, lse)
        ctx.args = (scale, causal, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = (do.to(torch.float32) * o.to(torch.float32)).sum(
            dim=-1, keepdim=True)
        args = (q, k, v, do, lse, delta, lengths, *ctx.args)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=False, scale=None, block_q=512,
                    block_k=1024, kv_length=None):
    """softmax(q·kᵀ·scale)·v, the JAX package's `flash_attention`.

    q: (B, Tq, d) or (B, H, Tq, d); k, v likewise with Tk.  Tq and Tk
    must divide by the block sizes after `_fit_block` clamps them.
    `kv_length` ((B,) int) masks key positions >= length.  Self-attention
    with Tq == Tk <= 512 takes the short kernel unless
    `MXNET_FLASH_ATTENTION_SHORT=0`; everything else the streaming
    kernels.  Under autograd (an input requiring grad) the route is the
    custom-VJP function (`FlashShort` or `Flash`), otherwise the forward
    kernel alone."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    H = 1
    out_shape = q.shape
    if q.ndim == 4:
        B, H, Tq, d = q.shape
        q, k, v = (t.reshape(B * H, t.shape[2], t.shape[3])
                   for t in (q, k, v))
    Tq, Tk = q.shape[1], k.shape[1]
    block_q = _fit_block(block_q, Tq)
    block_k = _fit_block(block_k, Tk)
    if Tq % block_q or Tk % block_k:
        raise MXNetError(
            f"flash_attention: seq lens ({Tq}, {Tk}) must be multiples "
            f"of the block sizes ({block_q}, {block_k})")
    BH = q.shape[0]
    if kv_length is None:
        lengths = torch.full((BH,), Tk, dtype=torch.int32, device=q.device)
    else:
        kv_length = torch.as_tensor(kv_length, device=q.device).reshape(-1)
        if kv_length.shape[0] * H != BH:
            raise MXNetError(
                f"flash_attention: kv_length has {kv_length.shape[0]} "
                f"entries, expected one per batch element ({BH // H})")
        lengths = kv_length.to(torch.int32).repeat_interleave(H)
    args = (q.contiguous(), k.contiguous(), v.contiguous(),
            lengths.contiguous(), float(scale), bool(causal))
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if Tq == Tk and Tq <= MAX_SHORT_LEN and \
            get_env("MXNET_FLASH_ATTENTION_SHORT", "1") != "0":
        out = FlashShort.apply(*args) if grad else flash_short_fwd(*args)
    elif grad:
        out = Flash.apply(*args, block_q, block_k)
    else:
        out = flash_fwd(*args, block_q, block_k)[0]
    return out.reshape(out_shape[:-2] + (Tq, v.shape[-1]))
