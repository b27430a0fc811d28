"""Transformer attention ops (counterpart of
`incubator_mxnet_tpu/ops/attention.py`: `multi_head_attention` and
`gelu_fused`).

`multi_head_attention` routes to the CUDA kernels behind the same gate
as the JAX dispatcher, with "the query is a CUDA tensor" in place of
"the platform is a TPU" (`attention_route`): no additive mask, no
attention dropout in train mode, Tq and Tk multiples of 128, d <= 256,
and either max(Tq, Tk) >= MXNET_FLASH_ATTENTION_MIN_LEN (1024; the
streaming FlashAttention-2 kernels) or self-attention with T <= 512
(the short kernel, unless MXNET_FLASH_ATTENTION_SHORT=0), with
MXNET_FLASH_ATTENTION=0 turning the route off.  With
MXNET_FLASH_ATTENTION_BTHD=1 (default 0, as in the JAX package) the
short case takes the BTHD route instead: `flash_attention_bthd` reads
q, k and v as (N, T, H, d) views of their (N, T, E) inputs, so the head
split and merge are free reshapes with no transposes; a kernel that
fails there raises, nothing falls back.  Inside `autograd.record()` the
kernel route carries its backward (`FlashShort`, `FlashShortBTHD` or
`Flash`).  Everything else, lengths between 512 and the crossover
included, takes the einsum path, which applies attention dropout to the
probabilities in train mode.  Ring attention is not ported
(ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register
from .. import autograd
from ..base import get_env
from ..random import generator


def attention_route(is_cuda, Tq, Tk, d, has_mask, train_dropout):
    """"flash" (the kernels of `flash_attention`), "bthd"
    (`flash_attention_bthd`) or "einsum": the JAX dispatcher's gate, with
    `is_cuda` for "the platform is a TPU"."""
    min_len = int(get_env("MXNET_FLASH_ATTENTION_MIN_LEN", "1024"))
    short_ok = (get_env("MXNET_FLASH_ATTENTION_SHORT", "1") != "0"
                and Tq == Tk and Tq <= 512)
    if (get_env("MXNET_FLASH_ATTENTION", "1") != "0"
            and not has_mask and not train_dropout and is_cuda
            and (max(Tq, Tk) >= min_len or short_ok)
            and Tq % 128 == 0 and Tk % 128 == 0 and d <= 256):
        if short_ok and get_env("MXNET_FLASH_ATTENTION_BTHD", "0") == "1":
            return "bthd"
        return "flash"
    return "einsum"


@register("multi_head_attention")
def multi_head_attention(query, key, value, mask=None, kv_length=None, *,
                         num_heads, causal=False, dropout=0.0, scale=None):
    """Fused MHA on batch-major (N, T, E) tensors.  `dropout` drops
    attention probabilities in train mode (`autograd.is_training()`)."""
    N, Tq, E = query.shape
    d = E // num_heads
    Tk = key.shape[1]

    def split(t, T):
        return t.reshape(N, T, num_heads, d).transpose(1, 2)
    s = scale if scale is not None else 1.0 / (d ** 0.5)

    train_dropout = dropout > 0.0 and autograd.is_training()
    route = attention_route(query.is_cuda, Tq, Tk, d, mask is not None,
                            train_dropout)
    if route == "bthd":
        from .flash_attention import flash_attention_bthd
        out = flash_attention_bthd(
            query.reshape(N, Tq, num_heads, d),
            key.reshape(N, Tk, num_heads, d),
            value.reshape(N, Tk, num_heads, d), causal=causal, scale=s,
            kv_length=kv_length)
        return out.reshape(N, Tq, E)
    if route == "flash":
        from .flash_attention import flash_attention
        out = flash_attention(split(query, Tq), split(key, Tk),
                              split(value, Tk), causal=causal, scale=s,
                              kv_length=kv_length)
        return out.transpose(1, 2).reshape(N, Tq, E)
    q, k, v = split(query, Tq), split(key, Tk), split(value, Tk)
    if kv_length is not None:
        # fold the key-padding lengths into a mask for the einsum path
        ar = torch.arange(Tk, device=query.device)
        len_mask = ar[None, :] < kv_length.reshape(-1, 1).to(query.device)
        len_mask = len_mask[:, None, None, :]
        mask = len_mask if mask is None else (mask.to(torch.bool) & len_mask)
    logits = torch.einsum("nhqd,nhkd->nhqk", q * s, k)
    big_neg = torch.tensor(-1e9 if logits.dtype != torch.float16 else -1e4,
                           dtype=logits.dtype, device=logits.device)
    if causal:
        cm = torch.ones((Tq, Tk), dtype=torch.bool,
                        device=query.device).tril()
        logits = torch.where(cm[None, None], logits, big_neg)
    if mask is not None:
        m = mask.to(torch.bool)
        while m.ndim < 4:
            m = m.unsqueeze(1)
        logits = torch.where(m, logits, big_neg)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(query.dtype)
    if train_dropout:
        keep = torch.rand(probs.shape, generator=generator(probs.device),
                          device=probs.device) < 1.0 - dropout
        probs = torch.where(keep, probs / (1.0 - dropout),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device)).to(probs.dtype)
    out = torch.einsum("nhqk,nhkd->nhqd", probs, v)
    return out.transpose(1, 2).reshape(N, Tq, E)


@register("gelu_fused")
def gelu_fused(data, *, approximate=True):
    return F.gelu(data, approximate="tanh" if approximate else "none")
