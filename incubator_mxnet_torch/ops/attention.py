"""Transformer attention ops (counterpart of
`incubator_mxnet_tpu/ops/attention.py`: `multi_head_attention`,
`gelu_fused` and GluonNLP's four interleaved attention products).

The interleaved ops read the fused projection of MXNet's
`transformer.cc`: (T, N, 3E) with each head's q, k and v side by side,
(T, N, 2E) for encoder-decoder keys and values.  `_qk` gives the scaled
scores (N·heads, Tq, Tk) and `_valatt` the attention-weighted values
(Tq, N, E) from given probabilities, with `torch.matmul`, as the JAX
ops use `jnp.matmul` outside any Pallas kernel: they return the score
matrix, so the flash kernels do not apply.  The scale 1/sqrt(d) is
computed in the data's dtype, as `1 / jnp.sqrt(jnp.asarray(d, dtype))`.

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


def _scale(d, dtype):
    """1/sqrt(d) rounded as the JAX ops round it: sqrt and reciprocal
    in `dtype`."""
    return torch.tensor(float(d), dtype=dtype).sqrt().reciprocal().item()


def _heads(t, T, N, heads, d):
    """(T, N, heads, d) → (N·heads, T, d)."""
    return t.permute(1, 2, 0, 3).reshape(N * heads, T, d)


def _merge(out, heads):
    """(N·heads, T, d) → (T, N, heads·d)."""
    NH, T, d = out.shape
    return out.reshape(NH // heads, heads, T, d).permute(2, 0, 1, 3) \
        .reshape(T, NH // heads, heads * d)


def _split_interleaved(qkv, heads):
    """(T, N, 3E), each head's q, k, v side by side → q, k, v each
    (N·heads, T, E/heads), and the head width."""
    T, N, E3 = qkv.shape
    d = E3 // 3 // heads
    x = qkv.reshape(T, N, heads, 3, d)
    return tuple(_heads(x[:, :, :, i], T, N, heads, d) for i in range(3)) \
        + (d,)


@register("_contrib_interleaved_matmul_selfatt_qk",
          aliases=("interleaved_matmul_selfatt_qk",))
def interleaved_matmul_selfatt_qk(queries_keys_values, *, heads):
    q, k, _v, d = _split_interleaved(queries_keys_values, heads)
    return torch.matmul(q * _scale(d, q.dtype), k.transpose(-1, -2))


@register("_contrib_interleaved_matmul_selfatt_valatt",
          aliases=("interleaved_matmul_selfatt_valatt",))
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, *,
                                      heads):
    _q, _k, v, _d = _split_interleaved(queries_keys_values, heads)
    return _merge(torch.matmul(attention, v), heads)


@register("_contrib_interleaved_matmul_encdec_qk",
          aliases=("interleaved_matmul_encdec_qk",))
def interleaved_matmul_encdec_qk(queries, keys_values, *, heads):
    Tq, N, E = queries.shape
    d = E // heads
    q = _heads(queries.reshape(Tq, N, heads, d), Tq, N, heads, d)
    Tk = keys_values.shape[0]
    k = _heads(keys_values.reshape(Tk, N, heads, 2, d)[:, :, :, 0], Tk, N,
               heads, d)
    return torch.matmul(q * _scale(d, q.dtype), k.transpose(-1, -2))


@register("_contrib_interleaved_matmul_encdec_valatt",
          aliases=("interleaved_matmul_encdec_valatt",))
def interleaved_matmul_encdec_valatt(keys_values, attention, *, heads):
    Tk, N, E2 = keys_values.shape
    d = E2 // 2 // heads
    v = _heads(keys_values.reshape(Tk, N, heads, 2, d)[:, :, :, 1], Tk, N,
               heads, d)
    return _merge(torch.matmul(attention, v), heads)


@register("gelu_fused")
def gelu_fused(data, *, approximate=True):
    return F.gelu(data, approximate="tanh" if approximate else "none")
