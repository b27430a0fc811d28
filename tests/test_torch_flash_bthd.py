"""The port's BTHD attention route against the JAX package.

Same inputs (numpy, seeded) through the JAX `flash_attention_bthd(...,
interpret=True)` — `_flash_short_bthd`, whose forward is
`_fwd_short_bthd_kernel` and whose backward is `_bwd_short_bthd_kernel`,
both run in interpret mode as the JAX package's own tests run them — and
through the port's `flash_attention_bthd` on CPU tensors, which takes the
kernels' plain versions (`flash_short_bthd_reference`,
`flash_short_bthd_bwd_reference`).  The port gets q, k and v as strided
(B, T, H, d) views cut from one (B, T, 3E) buffer, as BERT's fused
projection gives them, and its gradients land in that buffer.

Tolerances, with their reasons:

- float32: o 1e-5 absolute, gradients 1e-4 of the largest — both sides
  accumulate in float32, in another order;
- bfloat16: one bfloat16 step of the largest value compared (2^-7 of the
  power of two below it) — both sides round p and ds to bfloat16 from
  float32 sums taken in another order, so a rounding can flip on a
  last-bit difference, and every output is rounded to bfloat16 once.

The CUDA kernels themselves are compared with the plain versions on the
card by `chip_smoke.py` and `tests/test_torch_kernels_cuda.py`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu.ops import registry as jax_registry
from incubator_mxnet_tpu.ops.flash_attention import (
    flash_attention_bthd as jax_flash_attention_bthd, _fwd_short_bthd,
    _bwd_short_bthd)
from incubator_mxnet_tpu.models.bert import (
    get_bert_model as jax_get_bert_model, BERTClassifier as JaxClassifier)

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import gluon, nd, parallel
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.models import get_model
from incubator_mxnet_torch.ops import attention as port_attention
from incubator_mxnet_torch.ops import flash_attention as fa
from incubator_mxnet_torch.ops.attention import attention_route
from incubator_mxnet_torch.ops.flash_attention import (
    FlashShortBTHD, flash_attention_bthd, flash_short_bthd_bwd,
    flash_short_bthd_fwd, flash_short_bthd_fwd_train,
    flash_short_bthd_reference, launch_counts, reset_launch_counts)

SHAPES = [(2, 128, 4, 64), (1, 256, 3, 32), (3, 48, 2, 32)]
SHAPE_IDS = ["x".join(map(str, s)) for s in SHAPES]


def _bf16_step(x):
    """One bfloat16 step at the largest magnitude of x."""
    top = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def _close(got, ref, dtype, grad=False):
    if dtype == "bfloat16":
        atol = _bf16_step(ref)
    else:
        atol = 1e-4 * float(np.abs(ref).max()) if grad else 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _inputs(shape, seed):
    """A (B, T, 3E) buffer and do (B, T, H, d), float32 numpy."""
    B, T, H, d = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 3 * H * d).astype(np.float32),
            rng.randn(B, T, H, d).astype(np.float32))


def _lengths(kv, B, T):
    """None, or kv_length 0, ~T/3 and T in turn over the batch."""
    return None if kv is None else np.resize(
        np.array([0, T // 3, T], np.int32), B)


def _views(buf, shape):
    E = shape[2] * shape[3]
    return [buf[..., i * E:(i + 1) * E].reshape(shape) for i in range(3)]


def _jax(buf, do, shape, dtype, causal, lengths):
    """o and (dq, dk, dv) of sum(o·do) through the JAX kernels."""
    q, k, v = (jnp.asarray(np.ascontiguousarray(a), getattr(jnp, dtype))
               for a in _views(buf, shape))

    def f(q, k, v):
        o = jax_flash_attention_bthd(q, k, v, causal=causal,
                                     kv_length=lengths, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * do), o
    (_, o), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        q, k, v)
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _port(buf, do, shape, dtype, causal, lengths):
    """o and (dq, dk, dv) through the port, on strided views of one
    buffer; the gradients are read back out of the buffer's gradient."""
    t = torch.from_numpy(buf).to(getattr(torch, dtype)).requires_grad_()
    views = _views(t, shape)
    assert not views[0].is_contiguous()
    kv = None if lengths is None else torch.from_numpy(lengths)
    o = flash_attention_bthd(*views, causal=causal, kv_length=kv)
    (o.float() * torch.from_numpy(do)).sum().backward()
    grads = [g.float().numpy() for g in _views(t.grad, shape)]
    return [o.detach().float().numpy(), *grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", [None, "mixed"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_bthd_matches_jax_kernels(shape, causal, kv, dtype):
    """o and the gradients of sum(o·do), kv_length 0 rows included."""
    buf, do = _inputs(shape, sum(shape))
    lengths = _lengths(kv, shape[0], shape[1])
    ref = _jax(buf, do, shape, dtype, causal, lengths)
    got = _port(buf, do, shape, dtype, causal, lengths)
    assert got[0].shape == shape
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, dtype, grad=i > 0)
    if lengths is not None:
        # a kv_length 0 batch element is the mean of v and sends gradient
        # into k (p = 1/T), as in the JAX kernel
        v = _views(buf, shape)[2][0]
        np.testing.assert_allclose(got[0][0], np.broadcast_to(
            v.mean(0), got[0][0].shape), atol=2e-2, rtol=0)
        assert np.abs(got[2][0]).max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_training_form_p_matches_jax_save_p(dtype, causal):
    """o and the saved p (B, H, T, T) of the training form against
    `_fwd_short_bthd(..., save_p=True)` in interpret mode."""
    shape = (3, 48, 2, 32)
    buf, _ = _inputs(shape, 1)
    lengths = _lengths("mixed", 3, 48)
    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(a), getattr(jnp, dtype))
                  for a in _views(buf, shape))
    jlen = jnp.asarray(lengths).reshape(3, 1, 1)
    jo, jp = _fwd_short_bthd(jq, jk, jv, jlen, 32 ** -0.5, causal, True, True)
    views = _views(torch.from_numpy(buf).to(getattr(torch, dtype)), shape)
    tlen = torch.from_numpy(lengths)
    to, tp = flash_short_bthd_fwd_train(*views, tlen, 32 ** -0.5, causal)
    assert to.dtype == tp.dtype == views[0].dtype
    assert tp.shape == (3, 2, 48, 48)
    _close(to.float().numpy(), np.asarray(jo.astype(jnp.float32)), dtype)
    _close(tp.float().numpy(), np.asarray(jp.astype(jnp.float32)), dtype)
    # a fully masked batch element's p is uniform
    assert torch.all(tp[0] == torch.tensor(1.0 / 48).to(tp.dtype))
    assert torch.equal(
        flash_short_bthd_fwd(*views, tlen, 32 ** -0.5, causal), to)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_on_the_same_residuals(dtype):
    """`flash_short_bthd_bwd` against `_bwd_short_bthd` (interpret mode)
    from the same saved (o, p) and do: ds rounds where the JAX kernel
    rounds it."""
    shape = (2, 128, 4, 64)
    buf, do = _inputs(shape, 2)
    lengths = _lengths("mixed", 2, 128)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(a), jdt)
                  for a in _views(buf, shape))
    jlen = jnp.asarray(lengths).reshape(2, 1, 1)
    jo, jp = _fwd_short_bthd(jq, jk, jv, jlen, 0.125, False, True, True)
    jdo = jnp.asarray(do).astype(jdt)
    ref = _bwd_short_bthd(0.125, False, True, (jq, jk, jv, jlen, jo, jp),
                          jdo)[:3]
    tdt = getattr(torch, dtype)
    views = _views(torch.from_numpy(buf).to(tdt), shape)
    to, tp = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
              for x in (jo, jp))
    tdo = torch.from_numpy(do).to(tdt)
    delta = (tdo.float() * to.float()).sum(-1).transpose(1, 2).contiguous()
    got = flash_short_bthd_bwd(*views, tdo, delta, tp, 0.125)
    for a, b in zip(got, ref):
        assert a.dtype == tdt and a.is_contiguous()
        _close(a.float().numpy(), np.asarray(b.astype(jnp.float32)), dtype,
               grad=True)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_at_the_kernel_shape_follows_the_jax_rules(causal):
    """The backward at the persistent kernel's shape (bf16, T = 128,
    d = 64, H = 12), kv_length 0, T/3 and T over the batch, against
    `_bwd_short_bthd` (interpret mode) from the same saved (o, p) and do:
    causal needs no mask in the backward, and a row with kv_length 0
    (p = 1/T) sends gradient into k as the JAX kernel does."""
    shape = (3, 128, 12, 64)
    buf, do = _inputs(shape, 4)
    lengths = _lengths("mixed", 3, 128)
    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(a), jnp.bfloat16)
                  for a in _views(buf, shape))
    jlen = jnp.asarray(lengths).reshape(3, 1, 1)
    jo, jp = _fwd_short_bthd(jq, jk, jv, jlen, 0.125, causal, True, True)
    jdo = jnp.asarray(do).astype(jnp.bfloat16)
    ref = _bwd_short_bthd(0.125, causal, True, (jq, jk, jv, jlen, jo, jp),
                          jdo)[:3]
    views = _views(torch.from_numpy(buf).to(torch.bfloat16), shape)
    to, tp = (torch.from_numpy(np.array(x.astype(jnp.float32)))
              .to(torch.bfloat16) for x in (jo, jp))
    tdo = torch.from_numpy(do).to(torch.bfloat16)
    delta = (tdo.float() * to.float()).sum(-1).transpose(1, 2).contiguous()
    got = flash_short_bthd_bwd(*views, tdo, delta, tp, 0.125)
    dk_dead = got[1][0].float().abs().max().item()
    assert dk_dead > 0          # kv_length 0: gradient reaches k
    for a, b in zip(got, ref):
        _close(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
               "bfloat16", grad=True)


def test_grads_match_autograd_through_plain_version():
    """With every kv_length > 0, `FlashShortBTHD` equals torch autograd
    through the plain forward (float32, 1e-5)."""
    shape = (3, 48, 2, 32)
    buf, do = _inputs(shape, 3)
    lengths = torch.tensor([48, 5, 1], dtype=torch.int32)
    grads = []
    for fn in (FlashShortBTHD.apply, flash_short_bthd_reference):
        t = torch.from_numpy(buf).requires_grad_()
        (fn(*_views(t, shape), lengths, 0.25, True)
         * torch.from_numpy(do)).sum().backward()
        grads.append(t.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=0)


def test_cpu_dispatch_launches_no_kernel_and_follows_grad_mode():
    shape = (2, 48, 2, 32)
    buf, _ = _inputs(shape, 4)
    t = torch.from_numpy(buf).requires_grad_()
    reset_launch_counts()
    with torch.no_grad():
        assert flash_attention_bthd(*_views(t, shape)).grad_fn is None
    o = flash_attention_bthd(*_views(t, shape))
    assert type(o.grad_fn).__name__ == "FlashShortBTHDBackward"
    assert not any(launch_counts.values())


def test_entry_point_rejects_what_the_jax_one_rejects():
    q = torch.zeros(2, 128, 2, 8)
    with pytest.raises(mx.MXNetError, match="Tq == Tk"):
        flash_attention_bthd(q, torch.zeros(2, 64, 2, 8), torch.zeros(
            2, 64, 2, 8))
    long = torch.zeros(1, 513, 1, 8)
    with pytest.raises(mx.MXNetError, match="Tq == Tk"):
        flash_attention_bthd(long, long, long)
    with pytest.raises(mx.MXNetError, match="kv_length has 3 entries"):
        flash_attention_bthd(q, q, q, kv_length=torch.tensor([1, 2, 3]))
    with pytest.raises(mx.MXNetError, match="bfloat16 or float32"):
        h = q.to(torch.float16)
        flash_attention_bthd(h, h, h)
    with pytest.raises(mx.MXNetError, match="int32"):
        flash_short_bthd_fwd(q, q, q, torch.zeros(2, dtype=torch.int64), 1.0)
    with pytest.raises(mx.MXNetError, match="delta must be"):
        flash_short_bthd_bwd(q, q, q, q, torch.zeros(2, 128, 2), torch.zeros(
            2, 2, 128, 128), 1.0)


def test_wrappers_raise_on_other_devices():
    q = torch.zeros(1, 16, 1, 8, device="meta")
    with pytest.raises(mx.MXNetError, match="no kernel for device meta"):
        flash_short_bthd_fwd(q, q, q, torch.zeros(1, dtype=torch.int32,
                                                  device="meta"), 1.0)


def _strided(shape, strides):
    """A (B, T, H, d) bf16 view with these element strides over a
    16-byte-aligned buffer large enough for it."""
    n = 1 + sum((k - 1) * s for k, s in zip(shape, strides))
    return torch.zeros(n + 8, dtype=torch.bfloat16).as_strided(shape, strides)


@pytest.mark.parametrize("shape,strides,in_place", [
    # q of BERT's fused (B, T, 3E) projection, E = H*d
    ((4, 128, 12, 64), (128 * 3 * 768, 3 * 768, 64, 1), True),
    # one batch element: its batch stride is never read
    ((1, 128, 2, 64), (7, 2 * 64, 64, 1), True),
    # rows overlapping one another, or batches overlapping each other
    ((2, 128, 2, 64), (128 * 64, 64, 64, 1), False),
    ((2, 128, 2, 64), (8, 2 * 64, 64, 1), False),
    # a row stride that is no multiple of 16 bytes
    ((2, 128, 2, 64), (128 * 132, 132, 64, 1), False)],
    ids=["fused", "one-batch", "rows-overlap", "batches-overlap",
         "odd-row-stride"])
def test_bthd_rows_reads_in_place_only_what_a_tensor_map_can(
        shape, strides, in_place):
    """The kernels read q, k and v in place through TMA tensor maps of
    (B, T, H*d) with the tensor's batch and row strides; anything a map
    cannot describe is copied once into a contiguous tensor."""
    t = _strided(shape, strides)
    got, bs, ts = fa._bthd_rows(t)
    assert (got.data_ptr() == t.data_ptr()) == in_place
    if in_place:
        assert (bs, ts) == strides[:2]
    else:
        assert got.is_contiguous() and torch.equal(got, t)
        B, T, H, d = shape
        assert (bs, ts) == (T * H * d, H * d)


# ---------------------------------------------------------------------
# attention_route
# ---------------------------------------------------------------------
@pytest.mark.parametrize("T", [128, 256, 512])
def test_route_bthd_only_when_set(T, monkeypatch):
    assert attention_route(True, T, T, 64, False, False) == "flash"
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_BTHD", "1")
    assert attention_route(True, T, T, 64, False, False) == "bthd"
    assert attention_route(False, T, T, 64, False, False) == "einsum"
    assert attention_route(True, T, T, 64, True, False) == "einsum"
    assert attention_route(True, T, T, 64, False, True) == "einsum"
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_BTHD", "0")
    assert attention_route(True, T, T, 64, False, False) == "flash"


def test_route_bthd_needs_short_self_attention(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_BTHD", "1")
    # T > 512 and cross attention keep the streaming kernels or einsum
    assert attention_route(True, 1024, 1024, 64, False, False) == "flash"
    assert attention_route(True, 640, 640, 64, False, False) == "einsum"
    assert attention_route(True, 128, 1024, 64, False, False) == "flash"
    assert attention_route(True, 128, 256, 64, False, False) == "einsum"
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_SHORT", "0")
    assert attention_route(True, 128, 128, 64, False, False) == "einsum"
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_SHORT", "1")
    monkeypatch.setenv("MXNET_FLASH_ATTENTION", "0")
    assert attention_route(True, 128, 128, 64, False, False) == "einsum"


# ---------------------------------------------------------------------
# the slice at a small size: bert_tiny at T = 128 on the BTHD route
# ---------------------------------------------------------------------
VOCAB, SLICE_T = 50, 128
SLICE_VALID = np.array([SLICE_T, 50, 0], np.float32)


def _slice_batch():
    rng = np.random.RandomState(5)
    n = len(SLICE_VALID)
    return (rng.randint(0, VOCAB, (n, SLICE_T)).astype(np.float32),
            rng.randint(0, 2, (n, SLICE_T)).astype(np.float32),
            SLICE_VALID, rng.randint(0, 2, n).astype(np.float32))


def _weights(net):
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


@pytest.fixture
def bthd_routes(monkeypatch):
    """Both packages on their BTHD route on the CPU.  The port: its
    `attention_route` answers "bthd" (the program has no switch for the
    CPU).  The JAX package: its `multi_head_attention` op runs its own
    BTHD branch (`ops/attention.py`, the `flash_attention_bthd` call) in
    interpret mode, which its TPU gate would otherwise reserve for the
    TPU; MXNET_FLASH_ATTENTION_BTHD=1 keeps these executables apart in
    its executable cache, and the ones made here are dropped after."""
    monkeypatch.setattr(port_attention, "attention_route",
                        lambda *args: "bthd")
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_BTHD", "1")
    op = jax_registry.get_op("multi_head_attention")

    def bthd_branch(query, key, value, mask=None, kv_length=None, *,
                    num_heads, causal=False, dropout=0.0, scale=None,
                    _key=None, _train=False):
        N, T, E = query.shape
        d = E // num_heads
        s = scale if scale is not None else 1.0 / (d ** 0.5)
        out = jax_flash_attention_bthd(
            query.reshape(N, T, num_heads, d), key.reshape(N, T, num_heads, d),
            value.reshape(N, T, num_heads, d), causal=causal, scale=s,
            kv_length=kv_length, interpret=True)
        return out.reshape(N, T, E)
    monkeypatch.setattr(op, "impl", bthd_branch)
    before = set(jax_registry._CACHE)
    yield
    for key in set(jax_registry._CACHE) - before:
        del jax_registry._CACHE[key]


def test_bert_tiny_on_bthd_route_matches_jax(bthd_routes):
    """bert_tiny at T = 128, valid lengths 128, 50 and 0, both packages on
    their BTHD route: logits, then one ParallelTrainer Adam step (loss
    and weights), from the same weights.  Tolerances as
    `tests/test_torch_train.py` (float32 through 2 layers)."""
    mxj.random.seed(0)
    jnet = JaxClassifier(jax_get_bert_model("bert_tiny", vocab_size=VOCAB,
                                            max_length=SLICE_T, dropout=0.0),
                         num_classes=2, dropout=0.0)
    jnet.initialize(mxj.init.Normal(0.02), ctx=mxj.cpu())
    batch = _slice_batch()
    jd = [mxj.nd.array(a, ctx=mxj.cpu()) for a in batch]
    jlogits = jnet(*jd[:3]).asnumpy()
    tnet = get_model("bert_classifier", model_name="bert_tiny",
                     num_classes=2, dropout=0.0, vocab_size=VOCAB,
                     max_length=SLICE_T)
    tnet.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    params_from_jax(tnet, _weights(jnet))
    with mx.cpu():
        td = [nd.array(a) for a in batch]
    with torch.no_grad():
        tlogits = tnet(*[t.data for t in td[:3]]).numpy()
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)

    jloss = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    jtr = jpar.ParallelTrainer(jnet, lambda o, y: jloss(o, y), "adam",
                               {"learning_rate": 1e-3},
                               mesh=jpar.default_mesh(1))
    ttr = parallel.ParallelTrainer(tnet, lambda o, y: tloss(o, y), "adam",
                                   {"learning_rate": 1e-3},
                                   mesh=parallel.default_mesh(ctx=mx.cpu()))
    reset_launch_counts()
    jl = float(jtr.step(*jd).asnumpy())
    tl = ttr.step(*td).asscalar()
    assert not any(launch_counts.values())
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    got, ref = _weights(tnet), _weights(jnet)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
