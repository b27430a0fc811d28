"""The training slice: BERT fine-tuning in the port against the JAX package.

Both packages build the `bert_tiny` classifier (dropout 0, float32); the
JAX weights go into the port through `convert.params_from_jax`, and the
same seeded numpy tokens, token types and labels go through both.  The
JAX side runs its `ParallelTrainer` on `default_mesh(1)` of the CPU and
its eager `autograd.record()` / `backward()` / `gluon.Trainer.step` loop;
on the CPU both packages take their einsum attention path (the kernel
route is held against the JAX kernel by
`tests/test_torch_attention_grad.py`).

Tolerances, with their reasons:

- losses: rtol 1e-4 — float32 through 2 layers and up to 8 updates, sums
  in another order;
- weights: rtol 1e-4, atol 1e-5 for the same reason.  Under Adam, atol
  1e-5 is lr/100: Adam divides the mean gradient by its root mean
  square, so where a gradient is ~0 a difference in its last bits could
  grow into an update of up to ~lr; at these sizes the weights agree to
  5e-7 after 8 steps, and resuming without the optimizer states misses
  by 2e-3, so the bound both holds and tells the two apart.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu.models.bert import (
    get_bert_model as jax_get_bert_model, BERTClassifier as JaxClassifier)

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd, parallel
from incubator_mxnet_torch.convert import (params_from_jax,
                                           optimizer_states_from_jax)
from incubator_mxnet_torch.models import get_model

VOCAB, T, N = 50, 16, 4
LOSS_TOL = dict(rtol=1e-4, atol=0)
WEIGHT_TOL = dict(rtol=1e-4, atol=1e-5)
OPT = {"sgd": {"learning_rate": 0.1, "momentum": 0.9},
       "adam": {"learning_rate": 1e-3}}


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, VOCAB, (N, T)).astype(np.float32),
            rng.randint(0, 2, (N, T)).astype(np.float32),
            rng.randint(0, 2, N).astype(np.float32))


def _weights(net):
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def _pair():
    """(JAX net, port net) with the same initial weights."""
    mxj.random.seed(0)
    jnet = JaxClassifier(jax_get_bert_model("bert_tiny", vocab_size=VOCAB,
                                            max_length=T, dropout=0.0),
                         num_classes=2, dropout=0.0)
    jnet.initialize(mxj.init.Normal(0.02), ctx=mxj.cpu())
    tok, typ, _ = _batch()
    jnet(mxj.nd.array(tok, ctx=mxj.cpu()), mxj.nd.array(typ, ctx=mxj.cpu()))
    tnet = get_model("bert_classifier", model_name="bert_tiny",
                     num_classes=2, dropout=0.0, vocab_size=VOCAB,
                     max_length=T)
    tnet.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    params_from_jax(tnet, _weights(jnet))
    return jnet, tnet


def _jax_data():
    return [mxj.nd.array(a, ctx=mxj.cpu()) for a in _batch()]


def _torch_data():
    with mx.cpu():
        return [nd.array(a) for a in _batch()]


def _close_weights(got, ref):
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **WEIGHT_TOL)


def _parallel_trainers(kind, jnet, tnet):
    jloss = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    jtr = jpar.ParallelTrainer(jnet, lambda o, y: jloss(o, y),
                               optimizer=kind, optimizer_params=OPT[kind],
                               mesh=jpar.default_mesh(1))
    ttr = parallel.ParallelTrainer(tnet, lambda o, y: tloss(o, y),
                                   optimizer=kind, optimizer_params=OPT[kind],
                                   mesh=parallel.default_mesh(ctx=mx.cpu()))
    return jtr, ttr


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_parallel_trainer_matches_jax(kind):
    """5 `step`s then `run_steps(3)`: the loss of every call and the
    final weights."""
    jnet, tnet = _pair()
    jtr, ttr = _parallel_trainers(kind, jnet, tnet)
    jd, td = _jax_data(), _torch_data()
    jl = [float(jtr.step(*jd).asnumpy()) for _ in range(5)]
    tl = [ttr.step(*td).asscalar() for _ in range(5)]
    jl.append(float(jtr.run_steps(3, *jd).asnumpy()))
    tl.append(ttr.run_steps(3, *td).asscalar())
    assert ttr.num_update == jtr.num_update == 8
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    assert tl[-1] < tl[0]
    _close_weights(_weights(tnet), _weights(jnet))


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_imperative_gluon_trainer_loop_matches_jax(kind):
    """5 iterations of record → loss → backward → Trainer.step(N)."""
    jnet, tnet = _pair()
    jloss = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    jtr = mxj.gluon.Trainer(jnet.collect_params(), kind, OPT[kind])
    ttr = gluon.Trainer(tnet.collect_params(), kind, OPT[kind])
    (jx, jt, jy), (tx, tt, ty) = _jax_data(), _torch_data()
    jl, tl = [], []
    for _ in range(5):
        with mxj.autograd.record():
            l = jloss(jnet(jx, jt), jy)
        l.backward()
        jtr.step(N)
        jl.append(l.asnumpy())
        with autograd.record():
            l = tloss(tnet(tx, tt), ty)
        l.backward()
        ttr.step(N)
        tl.append(l.asnumpy())
    np.testing.assert_allclose(np.array(tl), np.array(jl), **LOSS_TOL)
    _close_weights(_weights(tnet), _weights(jnet))


@pytest.mark.parametrize("trainer", ["parallel", "gluon"])
def test_resume_from_jax_optimizer_states(trainer):
    """After 2 Adam steps in the JAX package, its weights, optimizer
    states and step count go into a fresh port trainer; the port's
    step 3 matches the JAX package's step 3."""
    jnet, tnet = _pair()
    jd, td = _jax_data(), _torch_data()
    if trainer == "parallel":
        jtr, ttr = _parallel_trainers("adam", jnet, tnet)
        for _ in range(2):
            jtr.step(*jd)
        params_from_jax(tnet, _weights(jnet))
        optimizer_states_from_jax(ttr, jtr._states, jtr.num_update)
        jl = float(jtr.step(*jd).asnumpy())
        tl = ttr.step(*td).asscalar()
        assert ttr.num_update == 3
    else:
        jloss = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
        tloss = gluon.loss.SoftmaxCrossEntropyLoss()
        jtr = mxj.gluon.Trainer(jnet.collect_params(), "adam", OPT["adam"])

        def jstep():
            with mxj.autograd.record():
                l = jloss(jnet(*jd[:2]), jd[2])
            l.backward()
            jtr.step(N)
            return l.asnumpy()
        for _ in range(2):
            jstep()
        params_from_jax(tnet, _weights(jnet))
        ttr = gluon.Trainer(tnet.collect_params(), "adam", OPT["adam"])
        optimizer_states_from_jax(ttr, jtr._fused_state,
                                  jtr._optimizer.num_update)
        jl = jstep()
        with autograd.record():
            l = tloss(tnet(*td[:2]), td[2])
        l.backward()
        ttr.step(N)
        tl = l.asnumpy()
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    _close_weights(_weights(tnet), _weights(jnet))


def test_parallel_trainer_rejects_what_is_not_ported():
    """What a world of one device cannot take raises; ZeRO, a sequence
    axis the mesh lacks and model-parallel rules are taken, each a no-op
    on one device as in the JAX package (meshes of several ranks:
    tests/test_torch_parallel*.py)."""
    net = get_model("bert_classifier", model_name="bert_tiny",
                    vocab_size=VOCAB, max_length=T)
    mesh = parallel.default_mesh(ctx=mx.cpu())
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    for kw in (dict(zero=1), dict(seq_axis="sp"),
               dict(rules=parallel.MEGATRON_RULES)):
        tr = parallel.ParallelTrainer(net, loss, "adam", mesh=mesh, **kw)
        assert tr.seq_axis is None and tr.rules is None
        assert tr.zero_level == kw.get("zero", 0)
    with pytest.raises(mx.MXNetError, match="needs 2 devices, have 1"):
        parallel.ParallelTrainer(net, loss, "adam", mesh_shape=(2, 1, 1))
    with pytest.raises(mx.MXNetError, match="sgd/adam"):
        parallel.ParallelTrainer(net, loss, "rmsprop", mesh=mesh)
    with pytest.raises(mx.MXNetError, match="a world of one device"):
        parallel.default_mesh(2)


# ---------------------------------------------------------------------
# the long-sequence slice at a small size: bert_tiny at T = 1024
# ---------------------------------------------------------------------
LONG_T, LONG_N = 1024, 3
LONG_VALID = np.array([LONG_T, 300, 0], np.float32)


def _long_batch():
    rng = np.random.RandomState(1)
    return (rng.randint(0, VOCAB, (LONG_N, LONG_T)).astype(np.float32),
            rng.randint(0, 2, (LONG_N, LONG_T)).astype(np.float32),
            LONG_VALID, rng.randint(0, 2, LONG_N).astype(np.float32))


def _long_pair():
    """(JAX net, port net) of bert_tiny at max_length 1024, same weights."""
    mxj.random.seed(0)
    jnet = JaxClassifier(jax_get_bert_model("bert_tiny", vocab_size=VOCAB,
                                            max_length=LONG_T, dropout=0.0),
                         num_classes=2, dropout=0.0)
    jnet.initialize(mxj.init.Normal(0.02), ctx=mxj.cpu())
    jnet(*[mxj.nd.array(a, ctx=mxj.cpu()) for a in _long_batch()[:3]])
    tnet = get_model("bert_classifier", model_name="bert_tiny",
                     num_classes=2, dropout=0.0, vocab_size=VOCAB,
                     max_length=LONG_T)
    tnet.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    params_from_jax(tnet, _weights(jnet))
    return jnet, tnet


def test_long_sequence_forward_and_adam_step_match_jax():
    """The T = 1024 slice on the CPU, valid lengths T, 300 and 0: logits,
    then one ParallelTrainer Adam step (loss and weights).  Both packages
    take their einsum attention path on the CPU."""
    jnet, tnet = _long_pair()
    batch = _long_batch()
    jd = [mxj.nd.array(a, ctx=mxj.cpu()) for a in batch]
    with mx.cpu():
        td = [nd.array(a) for a in batch]
    jlogits = jnet(*jd[:3]).asnumpy()
    with torch.no_grad():
        tlogits = tnet(*[t.data for t in td[:3]]).numpy()
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    jtr, ttr = _parallel_trainers("adam", jnet, tnet)
    jl = float(jtr.step(*jd).asnumpy())
    tl = ttr.step(*td).asscalar()
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    _close_weights(_weights(tnet), _weights(jnet))


def test_long_sequence_flash_attention_matches_jax_kernels():
    """Layer 0's q, k, v of that model through the port's
    `flash_attention` (the streaming kernels' plain versions on the CPU)
    and the JAX `flash_attention` in interpret mode (`_flash`: T > 512),
    o and the gradients of sum(o·do): float32, atol 1e-5 for o and 1e-4
    of the largest gradient (sums in another order)."""
    from incubator_mxnet_tpu.ops.flash_attention import (
        flash_attention as jax_flash_attention)
    from incubator_mxnet_torch.ops.flash_attention import flash_attention
    _, tnet = _long_pair()
    batch = _long_batch()
    seen = []
    hook = tnet.bert.encoder.layers[0].attention.qkv.register_forward_hook(
        lambda mod, args, out: seen.append(out.data.detach()))
    with torch.no_grad():
        tnet(*[torch.from_numpy(a) for a in batch[:3]])
    hook.remove()
    E, H = 128, 2
    qkv = seen[0].reshape(LONG_N, LONG_T, 3, H, E // H).permute(2, 0, 3, 1, 4)
    q, k, v = (t.contiguous().numpy() for t in qkv)
    do = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    valid = LONG_VALID.astype(np.int32)

    def jf(q, k, v):
        o = jax_flash_attention(q, k, v, kv_length=valid, interpret=True)
        return jnp.sum(o * do), o
    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    tt = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    to = flash_attention(*tt, kv_length=torch.from_numpy(valid))
    (to * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)
    for t, g in zip(tt, jg):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max())
