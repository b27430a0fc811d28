"""The port's streaming FlashAttention-2 against the JAX package's Pallas
kernels.

Same inputs (numpy, seeded) through the JAX kernels in interpret mode —
`_fwd` for o and lse, `_bwd` for dq, dk and dv, and `flash_attention`
with `MXNET_FLASH_ATTENTION_SHORT=0` — and through the port's wrappers on
CPU tensors, which take the plain versions (`flash_fwd_reference`,
`flash_bwd_dq_reference`, `flash_bwd_dkv_reference`).

Tolerances: float32 o and lse 1e-5 absolute, gradients 1e-4 of the
largest (both sides accumulate in f32, in another order); bfloat16 2e-2
absolute, gradients 2e-2 of the largest (p and ds are rounded to
bfloat16 on both sides, and a rounding that flips on a last-bit
difference of an f32 score moves a value by up to ~2^-8 of its scale).
A row with kv_length 0 gets lse exactly -1e30 on both sides.

The CUDA kernels are compared with these plain versions on the card by
`tests/test_torch_kernels_cuda.py` and `chip_smoke.py`.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu.ops import flash_attention as jfa

import incubator_mxnet_torch as mx
from incubator_mxnet_torch.ops import flash_attention as tfa
from incubator_mxnet_torch.ops.attention import attention_route

ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _arrays(seed, bh, tq, tk, d):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(bh, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(bh, tk, d).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_kernels(arrs, lengths, dtype, scale, causal, bq, bk):
    """o, lse, dq, dk, dv of the Pallas kernels in interpret mode."""
    q, k, v, do = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs)
    lens = jnp.asarray(lengths).reshape(-1, 1, 1)
    o, lse = jfa._fwd(q, k, v, lens, scale, causal, bq, bk, True)
    dq, dk, dv, _ = jfa._bwd(scale, causal, bq, bk, True,
                             (q, k, v, lens, o, lse), do)
    return [_f32(x) for x in (o, lse, dq, dk, dv)]


@functools.lru_cache(maxsize=None)
def _masked_row_case(causal):
    """One batch-head with kv_length 0 at T = 256, 128-blocks: the
    inputs, the port's and the JAX kernels' outputs."""
    arrs = _arrays(3, 1, 256, 256, 64)
    lengths = np.zeros(1, np.int32)
    kw = dict(dtype="float32", scale=0.125, causal=causal, bq=128, bk=128)
    return (arrs, _port_kernels(arrs, lengths, **kw),
            _jax_kernels(arrs, lengths, **kw))


def _port_kernels(arrs, lengths, dtype, scale, causal, bq, bk):
    q, k, v, do = (torch.from_numpy(a).to(getattr(torch, dtype))
                   for a in arrs)
    lens = torch.from_numpy(lengths)
    o, lse = tfa.flash_fwd(q, k, v, lens, scale, causal, bq, bk)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, lse, delta, lens, scale, causal, bq, bk)
    dq = tfa.flash_bwd_dq(*args)
    dk, dv = tfa.flash_bwd_dkv(*args)
    for t in (o, dq, dk, dv):
        assert t.dtype == q.dtype
    assert lse.dtype == torch.float32
    return [t.float().numpy() for t in (o, lse, dq, dk, dv)]


def _assert_match(got, ref, lengths, dtype):
    live = lengths > 0
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=ATOL[dtype],
                               err_msg="o")
    np.testing.assert_allclose(got[1][live], ref[1][live], rtol=0,
                               atol=1e-5, err_msg="lse")
    assert np.all(got[1][~live] == np.float32(-1e30))
    assert np.all(ref[1][~live] == np.float32(-1e30))
    for name, a, b in zip(("dq", "dk", "dv"), got[2:], ref[2:]):
        np.testing.assert_allclose(
            a, b, rtol=0, atol=GRAD_RTOL[dtype] * np.abs(b).max(),
            err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,bh,d", [("float32", 2, 32), ("float32", 4, 64),
                                        ("bfloat16", 4, 64)])
def test_kernels_match_jax(dtype, causal, bh, d):
    """o, lse, dq, dk, dv at T = 256 with 128-blocks, kv_length 0 and T
    among the rows."""
    arrs = _arrays(bh + d, bh, 256, 256, d)
    lengths = np.array([0, 256, 131, 17][:bh], np.int32)
    kw = dict(dtype=dtype, scale=d ** -0.5, causal=causal, bq=128, bk=128)
    _assert_match(_port_kernels(arrs, lengths, **kw),
                  _jax_kernels(arrs, lengths, **kw), lengths, dtype)


@pytest.mark.parametrize("dtype,causal", [("float32", True),
                                          ("bfloat16", False)])
def test_cross_attention_matches_jax(dtype, causal):
    """Tq = 128, Tk = 256: causal is top-left aligned (rows >= cols)."""
    arrs = _arrays(7, 2, 128, 256, 32)
    lengths = np.array([0, 200], np.int32)
    kw = dict(dtype=dtype, scale=0.2, causal=causal, bq=128, bk=128)
    _assert_match(_port_kernels(arrs, lengths, **kw),
                  _jax_kernels(arrs, lengths, **kw), lengths, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("blocks", [(128, 384), (384, 128)],
                         ids=["bq128-bk384", "bq384-bk128"])
def test_backward_at_blocks_unlike_the_kernel_tiles(blocks, causal, dtype):
    """T = 384 with JAX blocks whose tiles the CUDA kernels' own (128
    query rows, 128 keys, 64-row steps) cross: the plain versions, the
    card's yardstick, against `_bwd`; under causal a row with kv_length 0
    averages the key tiles of its JAX query tile."""
    arrs = _arrays(19, 3, 384, 384, 16)
    lengths = np.array([0, 384, 200], np.int32)
    kw = dict(dtype=dtype, scale=0.25, causal=causal, bq=blocks[0],
              bk=blocks[1])
    _assert_match(_port_kernels(arrs, lengths, **kw),
                  _jax_kernels(arrs, lengths, **kw), lengths, dtype)


@pytest.mark.parametrize("causal", [False, True])
def test_default_blocks_fit_1152(causal, monkeypatch):
    """T = 1152 at the default blocks: `_fit_block` gives 384 for both,
    and `flash_attention` with its gradients matches the JAX function."""
    assert tfa._fit_block(512, 1152) == jfa._fit_block(512, 1152) == 384
    assert tfa._fit_block(1024, 1152) == jfa._fit_block(1024, 1152) == 384
    q, k, v, do = _arrays(11, 2, 1152, 1152, 16)
    lengths = np.array([1152, 0], np.int32)
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_SHORT", "0")

    def jf(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, kv_length=lengths,
                                interpret=True)
        return jnp.sum(o * do), o
    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    tt = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    to = tfa.flash_attention(*tt, causal=causal,
                             kv_length=torch.from_numpy(lengths))
    (to * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)
    for t, g in zip(tt, jg):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max())


@pytest.mark.parametrize("block", [1, 64, 128, 300, 512, 1024, 4096])
@pytest.mark.parametrize("T", [7, 100, 128, 256, 640, 1152, 2048, 2049])
def test_fit_block_is_the_jax_rule(block, T):
    assert tfa._fit_block(block, T) == jfa._fit_block(block, T)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row_averages_visited_key_tiles(causal):
    """Fact 1: with kv_length 0, every score is -1e30 and a row is the
    mean of v over the key tiles its grid step visits.  Causal with
    128-blocks at T = 256: row 0 (query tile 0) visits key tile 0 only,
    so it is the mean of v[:128], not of all v (the short kernel's
    answer); row 200 visits both.  Without causal every tile is
    visited."""
    (_q, _k, v, _do), got, ref = _masked_row_case(causal)
    first = v[0, :128].mean(0) if causal else v[0].mean(0)
    for o in (got[0], ref[0]):
        np.testing.assert_allclose(o[0, 0], first, atol=1e-6)
        np.testing.assert_allclose(o[0, 200], v[0].mean(0), atol=1e-6)
    if causal:
        assert np.abs(got[0][0, 0] - v[0].mean(0)).max() > 1e-2
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row_backward_has_p_one(causal):
    """Fact 2: lse = -1e30 + log(l) rounds to exactly -1e30, so the
    backward takes p = exp(-1e30 - lse) = 1 on every visited key: dv of a
    key is the sum of do over the rows that visit its tile, not a mean.
    Causal with 128-blocks: key 200 (tile 1) is visited by rows 128-255
    only."""
    (_q, _k, _v, do), got, ref = _masked_row_case(causal)
    assert np.all(got[1] == np.float32(-1e30))
    rows = slice(128, 256) if causal else slice(None)
    for dv in (got[4], ref[4]):
        np.testing.assert_allclose(dv[0, 200], do[0, rows].sum(0),
                                   rtol=0, atol=2e-5)
        np.testing.assert_allclose(dv[0, 5], do[0].sum(0), rtol=0,
                                   atol=2e-5)
    np.testing.assert_allclose(got[4], ref[4], rtol=0, atol=1e-4)


def test_wrappers_raise_on_other_devices_and_bad_inputs():
    q = torch.empty(2, 128, 64, device="meta")
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(mx.MXNetError, match="no kernel for device meta"):
        tfa.flash_fwd(q, q, q, lens, 0.125, False, 128, 128)
    lse = torch.empty(2, 128, 1, device="meta")
    for fn in (tfa.flash_bwd_dq, tfa.flash_bwd_dkv):
        with pytest.raises(mx.MXNetError, match="no kernel for device"):
            fn(q, q, q, q, lse, lse, lens, 0.125, False, 128, 128)
    c = torch.zeros(2, 128, 64)
    lc = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(mx.MXNetError, match="float32 of shape"):
        tfa.flash_bwd_dq(c, c, c, c, torch.zeros(2, 128),
                         torch.zeros(2, 128, 1), lc, 0.125, False, 128, 128)
    with pytest.raises(mx.MXNetError, match="int32"):
        tfa.flash_fwd(c, c, c, lc.long(), 0.125, False, 128, 128)
    with pytest.raises(mx.MXNetError, match="multiples of the block"):
        tfa.flash_attention(torch.zeros(1, 640, 8), torch.zeros(1, 200, 8),
                            torch.zeros(1, 200, 8))


def _function_of(out):
    """The autograd function under the reshape back to the input rank."""
    return type(out.grad_fn.next_functions[0][0]).__name__


def test_flash_routes_follow_grad_mode_and_kill_switch(monkeypatch):
    """`flash_attention` takes `Flash` under autograd and `flash_fwd`
    otherwise for T > 512; the short route at T <= 512 unless
    MXNET_FLASH_ATTENTION_SHORT=0.  CPU tensors count no launch."""
    q = torch.zeros(1, 1024, 8, requires_grad=True)
    tfa.reset_launch_counts()
    assert _function_of(tfa.flash_attention(q, q, q)) == "FlashBackward"
    with torch.no_grad():
        assert tfa.flash_attention(q, q, q).grad_fn is None
    s = torch.zeros(1, 128, 8, requires_grad=True)
    assert _function_of(tfa.flash_attention(s, s, s)) == "FlashShortBackward"
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_SHORT", "0")
    assert _function_of(tfa.flash_attention(s, s, s)) == "FlashBackward"
    assert not any(tfa.launch_counts.values())


@pytest.mark.parametrize("T,route", [(128, "flash"), (512, "flash"),
                                     (640, "einsum"), (1024, "flash"),
                                     (2048, "flash"), (1000, "einsum")])
def test_route_by_length(T, route):
    assert attention_route(True, T, T, 64, False, False) == route
    assert attention_route(False, T, T, 64, False, False) == "einsum"
    assert attention_route(True, T, T, 64, True, False) == "einsum"
    assert attention_route(True, T, T, 64, False, True) == "einsum"


def test_route_cross_attention_and_width():
    assert attention_route(True, 128, 256, 64, False, False) == "einsum"
    assert attention_route(True, 1024, 2048, 64, False, False) == "flash"
    assert attention_route(True, 128, 1024, 64, False, False) == "flash"
    assert attention_route(True, 1024, 1000, 64, False, False) == "einsum"
    assert attention_route(True, 2048, 2048, 257, False, False) == "einsum"


def test_route_switches(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_SHORT", "0")
    assert attention_route(True, 128, 128, 64, False, False) == "einsum"
    assert attention_route(True, 2048, 2048, 64, False, False) == "flash"
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_MIN_LEN", "256")
    assert attention_route(True, 640, 640, 64, False, False) == "flash"
    assert attention_route(True, 128, 128, 64, False, False) == "einsum"
    monkeypatch.setenv("MXNET_FLASH_ATTENTION", "0")
    assert attention_route(True, 2048, 2048, 64, False, False) == "einsum"
