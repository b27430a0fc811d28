"""The port's short attention with its backward, against the JAX package.

Same inputs (numpy, seeded) through the JAX `flash_attention(...,
interpret=True)` — `_flash_short`, whose forward under differentiation
is the packed kernel with `save_p=True` run in interpret mode and whose
backward is `_bwd_short` — with `jax.grad` through it, and through the
port's `flash_attention` on CPU tensors that require grad, which takes
`FlashShort` (the training form's plain version, then
`flash_short_bwd`).  Tolerance float32 1e-5 absolute: both sides
accumulate in float32, in another order, and the gradients here are
O(1).

The CUDA kernel's training form is compared with its plain version on
the card by `chip_smoke.py` and `tests/test_torch_kernels_cuda.py`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention, _fwd_short)

from incubator_mxnet_torch.ops.flash_attention import (
    FlashShort, flash_attention, flash_short_bwd, flash_short_fwd_train,
    flash_short_reference, launch_counts, reset_launch_counts)

B, H, T, D = 2, 2, 32, 16
KV_LENGTH = np.array([T, 0], np.int32)      # full, and a fully masked row
ATOL = 1e-5


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, T, D).astype(np.float32)
                   for _ in range(4))
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, kv_length):
    def f(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, kv_length=kv_length,
                                interpret=True)
        return jnp.sum(o * do), o
    (_, o), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (o, *grads)]


def _torch_grads(q, k, v, do, causal, kv_length):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention(qt, kt, vt, causal=causal,
                        kv_length=torch.from_numpy(kv_length))
    (o * torch.from_numpy(do)).sum().backward()
    return [t.detach().numpy() for t in (o, qt.grad, kt.grad, vt.grad)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grads_match_jax(causal):
    q, k, v, do = _inputs()
    ref = _jax_grads(q, k, v, do, causal, KV_LENGTH)
    got = _torch_grads(q, k, v, do, causal, KV_LENGTH)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)
    # the fully masked batch element sends gradient into k, as in JAX
    assert np.abs(got[2][1]).max() > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_training_form_p_matches_jax_save_p(dtype, causal):
    """o and the saved p of the training form against `_fwd_short(...,
    save_p=True)`: float32 1e-6; bfloat16 2e-2 (o) and one bf16 ulp of
    p's scale, 2^-8 (p is rounded to bfloat16 on both sides from f32
    scores summed in another order)."""
    q, k, v, _ = _inputs(1)
    bh = B * H
    lengths = np.repeat(KV_LENGTH, H)
    jq, jk, jv = (jnp.asarray(a.reshape(bh, T, D)).astype(getattr(jnp, dtype))
                  for a in (q, k, v))
    jo, jp = _fwd_short(jq, jk, jv, jnp.asarray(lengths).reshape(bh, 1, 1),
                        D ** -0.5, causal, True, True)
    tq, tk, tv = (torch.from_numpy(a.reshape(bh, T, D)).to(getattr(torch, dtype))
                  for a in (q, k, v))
    to, tp = flash_short_fwd_train(tq, tk, tv, torch.from_numpy(lengths),
                                   D ** -0.5, causal)
    assert to.dtype == tp.dtype == tq.dtype and tp.shape == (bh, T, T)
    f32 = dtype == "float32"
    np.testing.assert_allclose(
        to.float().numpy(), np.asarray(jo.astype(jnp.float32)),
        atol=1e-6 if f32 else 2e-2, rtol=0)
    np.testing.assert_allclose(
        tp.float().numpy(), np.asarray(jp.astype(jnp.float32)),
        atol=1e-6 if f32 else 2 ** -8, rtol=0)
    # a fully masked row's p is uniform, masked columns otherwise exactly 0
    assert torch.all(tp[H:].float() == 1.0 / T)
    assert not f32 or torch.all(tp[0].float().sum(-1).sub(1).abs() < 1e-5)


def test_flash_short_matches_autograd_through_plain_version():
    """With every kv_length > 0 the custom backward equals torch autograd
    through the plain forward (float32, 1e-5)."""
    q, k, v, do = (torch.from_numpy(a.reshape(B * H, T, D))
                   for a in _inputs(2))
    lengths = torch.tensor([T, 5, 1, 17], dtype=torch.int32)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    o1 = FlashShort.apply(*a, lengths, 0.25, True)
    o2 = flash_short_reference(*b, lengths, 0.25, True)
    (o1 * do).sum().backward()
    (o2 * do).sum().backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=ATOL, rtol=0)


def test_route_follows_grad_mode():
    """`flash_attention` takes the training form only when autograd
    records and an input requires grad; CPU tensors never count a
    kernel launch."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs())
    reset_launch_counts()
    with torch.no_grad():
        o = flash_attention(q.requires_grad_(), k, v)
    assert o.grad_fn is None
    o = flash_attention(q, k, v)
    fn = o.grad_fn                              # the reshape back to 4-d
    assert type(fn.next_functions[0][0]).__name__ == "FlashShortBackward"
    assert not any(launch_counts.values())


def test_flash_short_bwd_bfloat16_rounds_like_jax():
    """bfloat16 inputs: ds is rounded to bfloat16 and dq, dk, dv come back
    in bfloat16, against `_bwd_short` on the same saved (o, p):
    atol 2e-2 (one bf16 rounding of O(1) values)."""
    from incubator_mxnet_tpu.ops.flash_attention import _bwd_short
    q, k, v, do = (a.reshape(B * H, T, D) for a in _inputs(3))
    lengths = np.repeat(KV_LENGTH, H)
    jt = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do)]
    jlen = jnp.asarray(lengths).reshape(-1, 1, 1)
    jo, jp = _fwd_short(*jt[:3], jlen, 0.25, False, True, True)
    jd = _bwd_short(0.25, False, True, (*jt[:3], jlen, jo, jp), jt[3])[:3]
    tt = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    to = torch.from_numpy(np.asarray(jo.astype(jnp.float32))).to(torch.bfloat16)
    tp = torch.from_numpy(np.asarray(jp.astype(jnp.float32))).to(torch.bfloat16)
    got = flash_short_bwd(*tt[:3], to, tp, tt[3], 0.25)
    for name, a, b in zip(("dq", "dk", "dv"), got, jd):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   atol=2e-2, rtol=0, err_msg=name)
