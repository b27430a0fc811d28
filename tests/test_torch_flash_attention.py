"""The port's short attention against the JAX package's Pallas kernel.

Same inputs (numpy, seeded) through the JAX `flash_attention(...,
interpret=True)` — the packed short kernel `_fwd_short_kernel` run in
interpret mode, as the JAX package's own tests run it — and through the
port's plain version `flash_short_reference` and `flash_attention` on
CPU tensors (the wrapper's CPU dispatch).  Tolerances: float32 1e-5
(both accumulate in f32, in another order); bfloat16 2e-2 (p is rounded
to bfloat16 before p·v on both sides, and a rounding that flips on a
last-bit difference moves an output by up to ~2^-8 of its scale).

The CUDA kernel itself is compared with the plain version on the card
by `chip_smoke.py` and by `tests/test_torch_kernels_cuda.py`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from incubator_mxnet_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention)
from incubator_mxnet_tpu.ops.attention import (
    multi_head_attention as jax_mha)

import incubator_mxnet_torch as mx
from incubator_mxnet_torch.ops.attention import multi_head_attention
from incubator_mxnet_torch.ops.flash_attention import (
    flash_attention, flash_short_fwd, flash_short_reference, launch_counts,
    reset_launch_counts)

BH, T, D = 4, 128, 64
LENGTHS = np.array([T, 37, 0, 1], np.int32)
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(seed=0, shape=(BH, T, D)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _jax(arrs, dtype, **kw):
    jt = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    out = jax_flash_attention(*jt, interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_short_attention_matches_jax_kernel(dtype, causal):
    arrs = _qkv()
    ref = _jax(arrs, dtype, causal=causal, kv_length=LENGTHS)
    q, k, v = _torch(arrs, dtype)
    lengths = torch.from_numpy(LENGTHS)
    plain = flash_short_reference(q, k, v, lengths, D ** -0.5, causal)
    wrapped = flash_attention(q, k, v, causal=causal, kv_length=lengths)
    assert plain.dtype == wrapped.dtype == q.dtype
    for out in (plain, wrapped):
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                                   atol=ATOL[dtype])
    # kv_length 0: every score is masked, the row is the mean of v —
    # in the JAX kernel and in the port alike, never 0 or NaN
    mean_v = v[2].float().mean(dim=0).numpy()
    row0 = slice(None) if not causal else slice(0, 1)
    np.testing.assert_allclose(ref[2][row0], np.broadcast_to(
        mean_v, ref[2][row0].shape), atol=ATOL[dtype])
    np.testing.assert_allclose(wrapped[2].float().numpy(), ref[2],
                               rtol=0, atol=ATOL[dtype])
    assert torch.isfinite(wrapped.float()).all()


def test_four_dim_layout_and_default_lengths():
    arrs = _qkv(1, (2, 2, T, 32))
    ref = _jax(arrs, "float32", causal=False)
    out = flash_attention(*_torch(arrs, "float32"))
    assert out.shape == (2, 2, T, 32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_cpu_dispatch_launches_no_kernel():
    reset_launch_counts()
    flash_attention(*_torch(_qkv(), "float32"))
    assert launch_counts["flash_short_fwd"] == 0


@pytest.mark.parametrize("shape", [(1, 513, 8), (1, 64, 257)])
def test_wrapper_rejects_long_or_wide(shape):
    q = torch.zeros(shape)
    with pytest.raises(mx.MXNetError):
        flash_attention(q, q, q)


def test_wrapper_rejects_cross_attention_and_bad_dtypes():
    """Cross attention is no longer rejected: it takes the streaming
    kernels' plain version and matches the JAX kernel.  Other dtypes and
    int64 lengths are still rejected."""
    arrs = [np.random.RandomState(4).randn(1, t, 16).astype(np.float32)
            for t in (128, 256, 256)]
    ref = _jax(arrs, "float32")
    q, k, v = _torch(arrs, "float32")
    np.testing.assert_allclose(flash_attention(q, k, v).numpy(), ref,
                               rtol=0, atol=1e-5)
    h = q.to(torch.float16)
    with pytest.raises(mx.MXNetError, match="bfloat16 or float32"):
        flash_attention(h, h, h)
    with pytest.raises(mx.MXNetError, match="int32"):
        flash_short_fwd(q, q, q, torch.zeros(1, dtype=torch.int64), 1.0)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_matches_jax(causal):
    """The op around the kernel, on the CPU: both packages take their
    einsum path there (the kernel route needs a TPU / a CUDA tensor)."""
    rng = np.random.RandomState(2)
    N, L, E, H = 3, 128, 64, 4
    x = [rng.randn(N, L, E).astype(np.float32) for _ in range(3)]
    valid = np.array([L, 9, 0], np.int32)
    ref = np.asarray(jax_mha(*[jnp.asarray(a) for a in x], None,
                             jnp.asarray(valid), num_heads=H, causal=causal))
    out = multi_head_attention(*[torch.from_numpy(a) for a in x], None,
                               torch.from_numpy(valid), num_heads=H,
                               causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # the kernel route computes the same function (-1e30 vs the einsum
    # path's -1e9 mask changes nothing, fully masked rows included)
    split = [torch.from_numpy(a).reshape(N, L, H, E // H).transpose(1, 2)
             for a in x]
    fl = flash_attention(*split, causal=causal,
                         kv_length=torch.from_numpy(valid))
    np.testing.assert_allclose(fl.transpose(1, 2).reshape(N, L, E).numpy(),
                               ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh", [1, 7, 131, 133])
def test_short_attention_matches_jax_kernel_at_odd_batch_heads(bh, causal):
    """Batch-head counts that the JAX kernel's packing does not divide
    (and, on the card, fewer than and just above the persistent kernel's
    grid), kv_length 0, 1 and T among the rows where there are enough:
    the port's wrapper on CPU tensors against the JAX kernel, bf16."""
    rng = np.random.RandomState(bh)
    arrs = [rng.randn(bh, T, D).astype(np.float32) for _ in range(3)]
    lengths = rng.randint(0, T + 1, bh).astype(np.int32)
    lengths[0] = 0
    lengths[1 % bh] = 1
    lengths[-1] = T
    ref = _jax(arrs, "bfloat16", causal=causal, kv_length=lengths)
    q, k, v = _torch(arrs, "bfloat16")
    out = flash_attention(q, k, v, causal=causal,
                          kv_length=torch.from_numpy(lengths))
    assert out.shape == (bh, T, D) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=ATOL["bfloat16"])
