"""Short-sequence self-attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of the packed short kernel of
`incubator_mxnet_tpu/ops/flash_attention.py` (`_fwd_short_kernel`,
reached through `_flash_short` and `flash_attention`).  For
Tq == Tk <= 512 it computes, per batch-head,

    s = q·kᵀ·scale (f32), keys >= kv_length and (causal) above the
    diagonal masked to -1e30, p = softmax(s) rounded to the input dtype,
    o = p·v with f32 accumulation, cast to the input dtype.

A row whose kv_length is 0 has every score at -1e30, so its softmax is
uniform and the row is the mean of v, as in the JAX kernel and its XLA
path alike.

The kernel is `csrc/flash_short_fwd.cu`, in two forms: `flash_short_fwd`
(`save_p=False`, inference) returns o; `flash_short_fwd_train`
(`save_p=True`) also returns p (BH, T, T) in the input dtype, which the
backward reads.  `FlashShort` is the `torch.autograd.Function` of
`_flash_short`'s custom VJP: its forward is the training form, its
backward `_bwd_short` in torch matmuls (the JAX package computes it as
plain XLA einsums, outside any Pallas kernel).  `flash_attention` takes
`FlashShort` when autograd records and an input requires grad, the
inference form otherwise.  Each wrapper launches its kernel for a CUDA
tensor and takes the plain version only for a CPU tensor.  The streaming
FlashAttention-2 kernels for longer or cross attention and the
BTHD-layout kernels are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_short_fwd", "flash_short_fwd_train",
           "flash_short_reference", "flash_short_bwd", "FlashShort",
           "launch_counts", "reset_launch_counts", "MAX_SHORT_LEN",
           "MAX_HEAD_DIM"]

_NEG_INF = -1e30
MAX_SHORT_LEN = 512
MAX_HEAD_DIM = 256

_count_lock = threading.Lock()
launch_counts = {"flash_short_fwd": 0, "flash_short_fwd_train": 0}


def reset_launch_counts():
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


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


def _check(q, k, v, lengths):
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise MXNetError(
            f"flash_short_fwd: q, k, v must share one (BH, T, d) shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, T, d = q.shape
    if not 1 <= T <= MAX_SHORT_LEN or not 1 <= d <= MAX_HEAD_DIM:
        raise MXNetError(
            f"flash_short_fwd: needs 1 <= T <= {MAX_SHORT_LEN} and "
            f"1 <= d <= {MAX_HEAD_DIM}, got T={T}, d={d}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(
            f"flash_short_fwd: q, k, v must all be bfloat16 or float32, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    devs = {t.device for t in (q, k, v, lengths)}
    if len(devs) != 1:
        raise MXNetError(f"flash_short_fwd: tensors on several devices "
                         f"{sorted(map(str, devs))}")
    if lengths.shape != (BH,) or lengths.dtype != torch.int32:
        raise MXNetError(
            f"flash_short_fwd: lengths must be int32 of shape ({BH},), "
            f"got {lengths.dtype} {tuple(lengths.shape)}")


_kernel = None


def _kernel_fn():
    """The C entry point `flash_short_fwd`, built and loaded at first use."""
    global _kernel
    if _kernel is None:
        from .._kernels import library
        fn = library("flash_short_fwd").flash_short_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel = fn
    return _kernel


def _launch(q, k, v, lengths, scale, causal, save_p):
    """Launch the kernel; returns o, or (o, p) with `save_p`."""
    fn = _kernel_fn()
    for t in (q, k, v, lengths):
        if not t.is_contiguous():
            raise MXNetError("flash_short_fwd: inputs must be contiguous")
    # the kernel moves rows 16 bytes at a time: a view that starts
    # mid-allocation gets an aligned copy
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    BH, T, d = q.shape
    o = torch.empty_like(q)
    p = torch.empty((BH, T, T), dtype=q.dtype, device=q.device) \
        if save_p else None
    if BH == 0:
        return (o, p) if save_p else o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             o.data_ptr(), p.data_ptr() if save_p else None, BH, T, d,
             float(scale), int(bool(causal)),
             int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise MXNetError(f"flash_short_fwd: kernel launch failed with "
                         f"cudaError {err}")
    name = "flash_short_fwd_train" if save_p else "flash_short_fwd"
    with _count_lock:
        launch_counts[name] += 1
    return (o, p) if save_p else o


def _dispatch(q, k, v, lengths, scale, causal, save_p):
    _check(q, k, v, lengths)
    if q.device.type == "cuda":
        return _launch(q, k, v, lengths, scale, causal, save_p)
    if q.device.type == "cpu":
        return flash_short_reference(q, k, v, lengths, scale, causal,
                                     save_p)
    raise MXNetError(f"flash_short_fwd: no kernel for device {q.device}")


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


@contextlib.contextmanager
def _exact_matmuls():
    """float32 matmuls in full float32 (the JAX backward asks for
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


def flash_attention(q, k, v, *, causal=False, scale=None, kv_length=None):
    """softmax(q·kᵀ·scale)·v for self-attention of length <= 512.

    q, k, v: (B, T, d) or (B, H, T, d).  `kv_length` ((B,) int) masks key
    positions >= length.  Longer or cross attention (the JAX package's
    streaming kernel) is not ported yet and raises."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    H = 1
    out_shape = q.shape
    if q.ndim == 4:
        B, H, Tq, d = q.shape
        q, k, v = (t.reshape(B * H, t.shape[2], d) for t in (q, k, v))
    Tq, Tk = q.shape[1], k.shape[1]
    if Tq != Tk or Tq > MAX_SHORT_LEN:
        raise MXNetError(
            f"flash_attention: only self-attention with T <= "
            f"{MAX_SHORT_LEN} is ported (the short kernel); got "
            f"Tq={Tq}, Tk={Tk}")
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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        out = FlashShort.apply(*args)
    else:
        out = flash_short_fwd(*args)
    return out.reshape(out_shape)
