"""The port's bottleneck-backward tool (`incubator_mxnet_torch/tools/
bottleneck_bwd.py`) against the JAX tool (`tools/pallas_bottleneck_bwd.py`)
on the CPU, where the port's wrappers take their plain versions and the
Pallas kernels run in interpret mode.

Inputs come from numpy with a seed, rounded to bfloat16 once and handed
to both.  Tolerances, with their reasons:

- `bottleneck_bwd` against `pallas_bwd`: atol 1e-3 of the largest value
  for dx, dW, dgamma, dbeta.  Both take the same bf16 inputs and (m, inv)
  and keep z, s1, s2 and dW in float32, summed in another order; dz is
  rounded to bf16 on both sides, and a rounding that flips on a last-bit
  difference of z moves one element of dx by one bf16 step.  Measured:
  2e-6 of the largest value on dW, exact on most of dx.
- `Conv1x1BN` against JAX `conv1x1_bn`, and a ragged M against torch
  autograd of `bn_dot`: the JAX test's mean relative error 2e-2 (dz is
  rounded to bf16 before dx and dW; autograd keeps it in float32).
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_torch.tools import bottleneck_bwd as bnb

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

ATOL_OF_MAX = 1e-3
REL_TOL = 2e-2


def _inputs(M, C, K, seed):
    """bf16-rounded x, w, dy and float32 gamma, as numpy float32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, C).astype(np.float32)
    w = (rng.randn(C, K) * 0.1).astype(np.float32)
    dy = rng.randn(M, K).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, K).astype(np.float32)
    x, w, dy = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in (x, w, dy))
    return x, w, dy, gamma


def _bf16(a):
    return torch.from_numpy(np.array(a)).to(torch.bfloat16)


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return np.abs(ref - got).mean() / (np.abs(ref).mean() + 1e-9)


# the last two at the widths of the persistent apply kernel (ResNet-50
# stage 1's expand and its reverse)
@pytest.mark.parametrize("M,C,K,bm", [(256, 32, 128, 64),
                                      (512, 16, 256, 128),
                                      (256, 64, 256, 128),
                                      (256, 256, 64, 128)])
def test_bottleneck_bwd_matches_pallas_bwd(M, C, K, bm):
    from pallas_bottleneck_bwd import bn_dot, pallas_bwd
    x, w, dy, gamma = _inputs(M, C, K, seed=M)
    jx, jw, jdy = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, dy))
    _, (_z, m, inv) = bn_dot(jx, jw, jnp.asarray(gamma), jnp.zeros(K))
    ref = pallas_bwd(jdy, jx, jw, m, inv, jnp.asarray(gamma), bm=bm,
                     interpret=True)
    got = bnb.bottleneck_bwd(_bf16(dy), _bf16(x), _bf16(w),
                             torch.from_numpy(np.array(m)),
                             torch.from_numpy(np.array(inv)),
                             torch.from_numpy(gamma))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for name, a, b in zip(("dx", "dw", "dgamma", "dbeta"), ref, got):
        a = np.asarray(a, np.float32)
        b = b.float().numpy()
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=ATOL_OF_MAX * np.abs(a).max(),
                                   err_msg=name)


def test_bn_dot_forward_matches_jax():
    """y, m and inv of the port's `bn_dot` (float32 product) against the
    JAX one (`preferred_element_type=f32`)."""
    from pallas_bottleneck_bwd import bn_dot
    x, w, _dy, gamma = _inputs(256, 32, 128, seed=3)
    beta = np.linspace(-1, 1, 128).astype(np.float32)
    jy, (_jz, jm, jinv) = bn_dot(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(w, jnp.bfloat16),
                                 jnp.asarray(gamma), jnp.asarray(beta))
    ty, (_tz, tm, tinv) = bnb.bn_dot(_bf16(x), _bf16(w),
                                     torch.from_numpy(gamma),
                                     torch.from_numpy(beta))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-5)
    # y in bf16: one bf16 step (2^-8 relative) where the f32 values round
    # differently
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), rtol=2 ** -8,
                               atol=1e-2)


def test_conv1x1bn_grads_match_jax_conv1x1_bn():
    """Gradients through sum(y²) of the port's `Conv1x1BN` (plain versions
    on the CPU) against the JAX `conv1x1_bn` (interpret-mode Pallas
    backward), from the same bf16 inputs."""
    import pallas_bottleneck_bwd as PB
    M, C, K = 256, 32, 128
    x, w, _dy, _g = _inputs(M, C, K, seed=4)
    gamma, beta = np.ones(K, np.float32), np.zeros(K, np.float32)

    orig = PB.pallas_bwd
    PB.pallas_bwd = lambda *a, **k: orig(*a, bm=64, interpret=True)
    try:
        ref = jax.grad(lambda *a: jnp.sum(PB.conv1x1_bn(*a).astype(
            jnp.float32) ** 2), argnums=(0, 1, 2, 3))(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
            jnp.asarray(gamma), jnp.asarray(beta))
    finally:
        PB.pallas_bwd = orig
    leaves = [_bf16(x).requires_grad_(), _bf16(w).requires_grad_(),
              torch.from_numpy(gamma).requires_grad_(),
              torch.from_numpy(beta).requires_grad_()]
    loss = bnb.Conv1x1BN.apply(*leaves).float().square().sum()
    got = torch.autograd.grad(loss, leaves)
    for name, a, b, leaf in zip(("dx", "dw", "dgamma", "dbeta"), ref, got,
                                leaves):
        assert b.dtype == leaf.dtype, name
        assert _rel(a, b.float().numpy()) < REL_TOL, name


@pytest.mark.parametrize("M", [777, 100])
def test_ragged_rows_match_autograd_of_bn_dot(M):
    """M not a multiple of any row tile (the JAX tool would drop the
    tail): every row's dx and all rows' sums against torch autograd."""
    C, K = 32, 128
    x, w, dy, gamma = _inputs(M, C, K, seed=M + 1)
    tx, tw, tdy = _bf16(x), _bf16(w), _bf16(dy)
    g, b = torch.from_numpy(gamma), torch.zeros(K)
    leaves = [t.clone().requires_grad_() for t in (tx, tw, g, b)]
    ref = torch.autograd.grad(bnb.bn_dot(*leaves)[0], leaves, tdy)
    _, (_z, m, inv) = bnb.bn_dot(tx, tw, g, b)
    got = bnb.bottleneck_bwd(tdy, tx, tw, m, inv, g)
    for name, a, b_ in zip(("dx", "dw", "dgamma", "dbeta"), ref, got):
        assert a.shape == b_.shape, name
        assert _rel(a.float().numpy(), b_.float().numpy()) < REL_TOL, name
    # the last rows are covered: their dx agrees as well as the rest
    tail = slice(M - M % 64 if M % 64 else M - 64, M)
    assert _rel(ref[0][tail].float().numpy(),
                got[0][tail].float().numpy()) < REL_TOL


def test_wrappers_count_no_launch_on_cpu_and_check_shapes():
    x, w, dy, gamma = _inputs(64, 16, 32, seed=5)
    bnb.reset_launch_counts()
    m, inv = torch.zeros(32), torch.ones(32)
    bnb.bottleneck_bwd(_bf16(dy), _bf16(x), _bf16(w), m, inv,
                       torch.from_numpy(gamma))
    assert bnb.launch_counts == {"bottleneck_bwd_reduce": 0,
                                 "bottleneck_bwd_apply": 0}
    with pytest.raises(Exception, match="float32"):
        bnb.bottleneck_bwd_reduce(_bf16(dy), _bf16(x), _bf16(w),
                                  m.double(), inv)
    with pytest.raises(Exception, match="expected"):
        bnb.bottleneck_bwd_reduce(_bf16(dy), _bf16(x), _bf16(w).t(), m, inv)


def test_full_block_compare_runs_on_the_cpu_at_a_tiny_size():
    """The 3-block stack runs both variants and reports how far their
    gradients differ, without times on the CPU.  The plain variant rounds
    z to bf16 before its BN statistics, as the JAX tool's does, where
    `Conv1x1BN` keeps z in float32, so the two differ by more than the
    kernels' own error (which the tests above bound)."""
    out = bnb.full_block_compare(batch=2, size=6, channels=16, device="cpu")
    assert set(out) == {"max_rel_err"}
    assert np.isfinite(out["max_rel_err"]) and out["max_rel_err"] > 0
