"""The port's loss, optimizers and learning-rate schedules against the JAX
package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason:

- loss values and input gradients, float32: 1e-6 absolute (the same
  float32 formulas; exp/log and sums in another order);
- optimizer steps: rtol 1e-6, atol 1e-7 after 5 steps (the same
  elementwise float32 arithmetic; Adam's bias-corrected lr is a scalar
  computed in double on both sides but rounded at another point);
- learning-rate schedules: exact (the same Python arithmetic);
- the port's fused multi-tensor Trainer update against its own per-key
  Updater: bit for bit (the same pass, on lists of one).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu.ops.nn import sparse_softmax_ce as jax_sparse_ce

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import gluon, nd, optimizer as topt
from incubator_mxnet_torch.ops.nn import sparse_softmax_ce

LOSS_TOL = dict(atol=1e-6, rtol=0)
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = [(7, 3), (5,), (2, 3, 4)]


def _logits(seed=0, n=6, c=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c).astype(np.float32) * 3
    y = np.array([0, 4, 2, 7, -2, 1], np.float32)[:n]    # two out of range
    return x, y


def test_sparse_softmax_ce_matches_jax_with_out_of_range_labels():
    x, y = _logits()
    g = np.random.RandomState(1).randn(len(y)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax_sparse_ce(a, jnp.asarray(y)),
                       jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = sparse_softmax_ce(xt, torch.from_numpy(y))
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **LOSS_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx),
                               **LOSS_TOL)


def test_sparse_softmax_ce_bfloat16_grad_keeps_dtype():
    x, y = _logits(2)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    out = sparse_softmax_ce(xt, torch.from_numpy(y))
    out.sum().backward()
    assert out.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("sparse_label", [True, False])
def test_softmax_ce_loss_block_matches_jax(sparse_label):
    """Loss values and the input gradient through `autograd.record()` /
    `backward()` in both packages; in-range labels (the JAX package's
    eager composition gives NaN for a label past the last class and
    wraps a negative one, where its traced step and the port clamp —
    that case is held against `sparse_softmax_ce` above)."""
    x, _ = _logits(3)
    y = np.array([0, 4, 2, 3, 1, 1], np.float32)
    if not sparse_label:
        y = np.eye(5, dtype=np.float32)[y.astype(int)] * 0.7 + 0.06
    jx = mxj.nd.array(x, ctx=mxj.cpu())
    jx.attach_grad()
    with mxj.autograd.record():
        jl = mxj.gluon.loss.SoftmaxCrossEntropyLoss(
            sparse_label=sparse_label)(jx, mxj.nd.array(y, ctx=mxj.cpu()))
    jl.backward()
    with mx.cpu():
        tx = nd.array(x)
        tx.attach_grad()
        with mx.autograd.record():
            tl = gluon.loss.SoftmaxCrossEntropyLoss(
                sparse_label=sparse_label)(tx, nd.array(y))
        tl.backward()
    np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), **LOSS_TOL)
    np.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(),
                               **LOSS_TOL)


@pytest.mark.parametrize("name", ["L2Loss", "L1Loss"])
def test_regression_losses_match_jax(name):
    rng = np.random.RandomState(4)
    pred, label = rng.randn(4, 3).astype(np.float32), \
        rng.randn(4, 3).astype(np.float32)
    jl = getattr(mxj.gluon.loss, name)()(mxj.nd.array(pred, ctx=mxj.cpu()),
                                         mxj.nd.array(label, ctx=mxj.cpu()))
    with mx.cpu():
        tl = getattr(gluon.loss, name)()(nd.array(pred), nd.array(label))
    np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), **LOSS_TOL)


def _run_optimizer(pkg, name, params, steps=5):
    """`steps` updates of `Optimizer.update` on each shape, the same
    weights and a fresh gradient per step; returns the final weights."""
    rng = np.random.RandomState(5)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
          for _ in range(steps)]
    if pkg == "jax":
        o = jopt.create(name, **params)
        arr = lambda a: mxj.nd.array(a, ctx=mxj.cpu())     # noqa: E731
    else:
        o = topt.create(name, **params)
        arr = lambda a: nd.array(a, ctx=mx.cpu())          # noqa: E731
    weights = [arr(w) for w in ws]
    states = [o.create_state(i, w) for i, w in enumerate(weights)]
    for step in gs:
        for i, (w, g) in enumerate(zip(weights, step)):
            o.update(i, w, arr(g), states[i])
    return [w.asnumpy() for w in weights]


@pytest.mark.parametrize("name,params", [
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("sgd", dict(learning_rate=0.05, momentum=0.5, rescale_grad=0.5,
                 clip_gradient=0.8)),
    ("adam", dict(learning_rate=0.01)),
    ("adam", dict(learning_rate=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                  wd=1e-2, rescale_grad=0.25, clip_gradient=1.5)),
], ids=["sgd", "sgd_mom_wd", "sgd_clip", "adam", "adam_wd_clip"])
def test_optimizer_update_matches_jax(name, params):
    ref = _run_optimizer("jax", name, params)
    got = _run_optimizer("torch", name, params)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **OPT_TOL)


def test_optimizer_bfloat16_weights_update_in_float32():
    with mx.cpu():
        w = nd.array(np.linspace(-1, 1, 12, dtype=np.float32)).astype(
            "bfloat16")
        g = nd.array(np.full(12, 0.5, np.float32)).astype("bfloat16")
    o = topt.create("adam", learning_rate=0.1)
    st = o.create_state(0, w)
    before = w.asnumpy().copy()
    o.update(0, w, g, st)
    assert w.dtype == "bfloat16" and st[0].dtype == np.float32
    np.testing.assert_allclose(before - w.asnumpy(), 0.1, atol=1e-2)


@pytest.mark.parametrize("sched,kw", [
    ("FactorScheduler", dict(step=3, factor=0.5, base_lr=1.0,
                             warmup_steps=2)),
    ("MultiFactorScheduler", dict(step=[2, 5, 9], factor=0.1, base_lr=0.3)),
    ("PolyScheduler", dict(max_update=12, base_lr=0.2, pwr=2, final_lr=0.01,
                           warmup_steps=3, warmup_mode="constant")),
    ("CosineScheduler", dict(max_update=10, base_lr=0.5, final_lr=0.05,
                             warmup_steps=2, warmup_begin_lr=0.1)),
])
def test_lr_schedulers_match_jax(sched, kw):
    a = getattr(jopt.lr_scheduler, sched)(**kw)
    b = getattr(topt.lr_scheduler, sched)(**kw)
    assert [b(n) for n in range(15)] == [a(n) for n in range(15)]


@pytest.mark.parametrize("name,params", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("adam", dict(learning_rate=0.01, wd=1e-2, clip_gradient=0.5)),
])
def test_fused_trainer_update_equals_per_key_updater(name, params,
                                                     monkeypatch):
    """gluon.Trainer's multi-tensor update, bf16 and float32 weights, one
    with an lr_mult, against the per-key `Updater`: bit for bit."""
    rng = np.random.RandomState(6)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
          for _ in range(4)]

    def run(fused):
        monkeypatch.setenv("MXNET_FUSED_TRAINER", "1" if fused else "0")
        ps = []
        for i, w in enumerate(ws):
            p = gluon.Parameter(f"w{i}", shape=w.shape,
                                dtype="bfloat16" if i == 1 else "float32")
            p.initialize(ctx=mx.cpu())
            p.set_data(torch.from_numpy(w))
            ps.append(p)
        ps[2].lr_mult = 0.5
        tr = gluon.Trainer(ps, name, params)
        for step in gs:
            for p, g in zip(ps, step):
                p.grad()[:] = torch.from_numpy(g)
            tr.step(3)
        return [p.data().asnumpy() for p in ps], tr._states

    (wf, sf), (wk, sk) = run(True), run(False)
    for a, b in zip(wf, wk):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(sf, sk):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())


def test_updater_states_round_trip_and_update_flat():
    o = topt.create("adam", learning_rate=0.1)
    up = topt.get_updater(o)
    with mx.cpu():
        w = nd.array(np.ones((2, 3), np.float32))
        g = nd.array(np.full((2, 3), 0.5, np.float32))
    up(0, g, w)
    blob = up.get_states()
    up2 = topt.get_updater(topt.create("adam", learning_rate=0.1))
    up2.set_states(blob, ctx=mx.cpu())
    np.testing.assert_array_equal(up2.states[0][0].asnumpy(),
                                  up.states[0][0].asnumpy())
    flat = nd.NDArray(w.data.reshape(-1).clone())
    assert up.update_flat(1, nd.NDArray(g.data.reshape(-1)), flat)
    assert flat.shape == (6,)


def test_trainer_rejects_what_is_not_ported():
    p = gluon.Parameter("w", shape=(2,))
    p.initialize(ctx=mx.cpu())
    for kv in ("dist_sync", "nccl", "dist_async"):
        with pytest.raises(mx.MXNetError, match="not ported"):
            gluon.Trainer([p], "sgd", kvstore=kv)
    with pytest.raises(mx.MXNetError, match="unknown optimizer"):
        gluon.Trainer([p], "nonesuch")


def test_trainer_save_and_load_states_round_trip(tmp_path):
    """`save_states` then `load_states` into a fresh Trainer: the same
    states and step count, so the next updates are the same bits."""
    rng = np.random.RandomState(7)

    def make():
        p = gluon.Parameter("w", shape=(4, 3))
        p.initialize(ctx=mx.cpu())
        p.set_data(torch.from_numpy(rng.randn(4, 3).astype(np.float32)))
        return p, gluon.Trainer([p], "adam", {"learning_rate": 0.01})
    p, tr = make()
    g = torch.from_numpy(rng.randn(4, 3).astype(np.float32))
    for _ in range(3):
        p.grad()[:] = g
        tr.step(2)
    path = str(tmp_path / "states.pkl")
    tr.save_states(path)
    q, tr2 = make()
    q.set_data(p.data())
    tr2.load_states(path)
    assert tr2.optimizer.num_update == tr.optimizer.num_update == 3
    for a, b in ((p, tr), (q, tr2)):
        a.grad()[:] = g
        b.step(2)
    np.testing.assert_array_equal(q.data().asnumpy(), p.data().asnumpy())
