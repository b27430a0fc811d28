"""The port's autograd, gradient buffers, user `autograd.Function`s,
`mark_variables` and train-mode Dropout, against the JAX package where
the two can be compared.

Gradients: the same numpy inputs through both packages' `record()` /
`backward()` / `grad()`, float32, 1e-6 absolute (the same products and
sums, in another order).  Dropout draws its masks from the port's own
generator (JAX's PRNG streams cannot be reproduced in torch), so it is
held to its definition instead: the keep rate within 4 standard
deviations of 1 - p over 20000 draws, kept values scaled by exactly
1 / (1 - p), and the identity outside train mode.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd
from incubator_mxnet_torch.models import get_model
from incubator_mxnet_torch.ops.attention import multi_head_attention

TOL = dict(atol=1e-6, rtol=0)


def _x(seed=0, shape=(3, 4)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_scopes_set_recording_and_training():
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        with autograd.pause():
            assert not autograd.is_recording()
            assert not autograd.is_training()
        with autograd.predict_mode():
            assert autograd.is_recording() and not autograd.is_training()
    with autograd.record(train_mode=False):
        assert autograd.is_recording() and not autograd.is_training()
    with autograd.train_mode():
        assert not autograd.is_recording() and autograd.is_training()
    assert autograd.set_recording(True) is False
    assert autograd.set_recording(False) is True
    assert autograd.set_training(True) is False
    assert autograd.set_training(False) is True
    assert not autograd.is_recording() and not autograd.is_training()


def test_no_graph_is_kept_outside_record():
    with mx.cpu():
        x = nd.array(_x())
    x.attach_grad()
    y = x * 2 + 1
    assert y.data.grad_fn is None
    with autograd.record():
        z = x * 2 + 1
        with autograd.pause():
            w = x * 3
    assert z.data.grad_fn is not None and w.data.grad_fn is None
    with pytest.raises(mx.MXNetError, match="not produced by a recorded"):
        y.backward()


def _jax_backward(a, head_grad):
    x = mxj.nd.array(a, ctx=mxj.cpu())
    x.attach_grad()
    with mxj.autograd.record():
        y = x * x * 3 + x
    y.backward(mxj.nd.array(head_grad, ctx=mxj.cpu()))
    return y.asnumpy(), x.grad.asnumpy()


def test_backward_with_head_grads_matches_jax():
    a, hg = _x(1), _x(2)
    ref_y, ref_g = _jax_backward(a, hg)
    with mx.cpu():
        x = nd.array(a)
        x.attach_grad()
        with autograd.record():
            y = x * x * 3 + x
        y.backward(nd.array(hg))
    np.testing.assert_allclose(y.asnumpy(), ref_y, **TOL)
    np.testing.assert_allclose(x.grad.asnumpy(), ref_g, **TOL)


def test_grad_returns_without_touching_buffers():
    a = _x(3)
    jx = mxj.nd.array(a, ctx=mxj.cpu())
    jx.attach_grad()
    with mxj.autograd.record():
        jy = (jx * jx).sum() if hasattr(jx, "sum") else mxj.nd.sum(jx * jx)
    ref = mxj.autograd.grad(jy, [jx])[0].asnumpy()
    with mx.cpu():
        x = nd.array(a)
    x.attach_grad()
    with autograd.record():
        y = x * x
    (g,) = autograd.grad(y, [x], head_grads=[nd.ones_like(y)])
    np.testing.assert_allclose(g.asnumpy(), ref, **TOL)
    assert np.all(x.grad.asnumpy() == 0)
    with autograd.record():
        y = x * x * x
    g2 = autograd.grad(y, x, create_graph=True)
    assert g2.data.grad_fn is not None          # differentiable again


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_grad_req_write_overwrites_and_add_accumulates(grad_req):
    """Two backward calls: "write" keeps the last gradient, "add" their
    sum, in both packages."""
    a = _x(4)
    outs = []
    for pkg, mod in (("jax", mxj), ("torch", mx)):
        x = mod.nd.array(a, ctx=mod.cpu())
        x.attach_grad(grad_req=grad_req)
        for scale in (2.0, 5.0):
            with mod.autograd.record():
                y = x * scale
            y.backward()
        outs.append(x.grad.asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    np.testing.assert_allclose(outs[1], 7.0 if grad_req == "add" else 5.0)


def test_parameter_grad_req_write_vs_add_through_a_block():
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mx.cpu())
    assert np.all(net.weight.grad().asnumpy() == 0)
    with mx.cpu():
        x = nd.array(_x(5, (2, 4)))
    for req, factor in (("write", 1), ("add", 2)):
        net.weight.grad_req = req
        net.collect_params().zero_grad()
        for _ in range(2):
            with autograd.record():
                y = net(x)
            y.backward()
        np.testing.assert_allclose(net.weight.grad().asnumpy(),
                                   factor * np.tile(x.asnumpy().sum(0),
                                                    (3, 1)), atol=1e-5)
    net.weight.grad_req = "null"
    with pytest.raises(mx.MXNetError, match="grad_req is 'null'"):
        net.weight.grad()


def test_dropout_acts_only_in_train_mode():
    mx.seed(7)
    drop = gluon.nn.Dropout(0.3)
    with mx.cpu():
        x = nd.array(np.ones((200, 100), np.float32))
    assert np.all(drop(x).asnumpy() == 1)                 # predict mode
    with autograd.record():
        y = drop(x).asnumpy()
    kept = y != 0
    rate, n = kept.mean(), y.size
    assert abs(rate - 0.7) < 4 * np.sqrt(0.7 * 0.3 / n)
    np.testing.assert_allclose(y[kept], 1 / 0.7, rtol=1e-6)
    with autograd.predict_mode():
        assert np.all(drop(x).asnumpy() == 1)
    with autograd.train_mode():
        assert (drop(x).asnumpy() == 0).any()


def test_attention_dropout_only_in_train_mode():
    mx.seed(8)
    x = torch.from_numpy(_x(9, (2, 8, 16)))
    ref = multi_head_attention(x, x, x, num_heads=2)
    with autograd.train_mode():
        out = multi_head_attention(x, x, x, num_heads=2, dropout=0.5)
    assert torch.equal(multi_head_attention(x, x, x, num_heads=2,
                                            dropout=0.5), ref)
    assert not torch.allclose(out, ref)


def test_trainer_built_before_cast_updates_the_cast_weights():
    """`cast()` makes fresh tensors; a trainer built before it reads the
    parameters at each step, so it updates the new ones."""
    net = get_model("bert_classifier", model_name="bert_tiny",
                    vocab_size=20, max_length=8, dropout=0.0)
    net.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    with mx.cpu():
        x = nd.array(np.ones((2, 8), np.float32))
        net(x, x)                                  # finish deferred init
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 1.0})
        net.cast("bfloat16")
        before = net.classifier[1].weight.data().asnumpy().copy()
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                net(x, x).astype("float32"), nd.array([0.0, 1.0]))
        loss.backward()
        tr.step(2)
    w = net.classifier[1].weight
    assert w.data().dtype == "bfloat16" and w.grad().dtype == "bfloat16"
    assert not np.array_equal(w.data().asnumpy(), before)


# ------------------------------------- autograd.Function, mark_variables
def _sigmoid_function(pkg):
    """MXNet's documented example of a user `autograd.Function`."""
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + pkg.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)
    return Sigmoid


def _split_scale_function(pkg):
    """Two inputs and two outputs, one output unused downstream."""
    class SplitScale(pkg.autograd.Function):
        def forward(self, a, b):
            self.save_for_backward(a, b)
            return a * b, a + b * 2

        def backward(self, d_prod, d_sum):
            a, b = self.saved_tensors
            return d_prod * b + d_sum, d_prod * a + d_sum * 2
    return SplitScale


def _run_function(pkg, which, arrays, use_second):
    ctx = pkg.cpu()
    xs = [pkg.nd.array(a, ctx=ctx) for a in arrays]
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        out = which(pkg)()(*xs)
        if isinstance(out, tuple):
            head = out[0] * 3 + (out[1] if use_second else 0)
        else:
            head = out * out
    head.backward()
    vals = out if isinstance(out, tuple) else (out,)
    return [v.asnumpy() for v in vals], [x.grad.asnumpy() for x in xs]


@pytest.mark.parametrize("case", ["sigmoid", "two_outputs",
                                  "one_output_unused"])
def test_user_function_matches_jax(case):
    """A user `Function` inside a recorded graph: its outputs and the
    gradients its backward gives the inputs."""
    which = _sigmoid_function if case == "sigmoid" else _split_scale_function
    arrays = [_x(5)] if case == "sigmoid" else [_x(6), _x(7)]
    use_second = case == "two_outputs"
    ref = _run_function(mxj, which, arrays, use_second)
    got = _run_function(mx, which, arrays, use_second)
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_allclose(a, b, **TOL)


def test_user_function_outside_record_and_bad_backward():
    sig = _sigmoid_function(mx)
    with mx.cpu():
        x = nd.array(_x(8))
    y = sig()(x)
    np.testing.assert_allclose(y.asnumpy(), 1 / (1 + np.exp(-_x(8))),
                               rtol=1e-6)
    assert y.data.grad_fn is None

    class TooMany(autograd.Function):
        def forward(self, x):
            return x * 2

        def backward(self, dy):
            return dy, dy
    x.attach_grad()
    with autograd.record():
        y = TooMany()(x)
    with pytest.raises(mx.MXNetError, match="returned 2 grads for 1"):
        y.backward()


@pytest.mark.parametrize("req", ["write", "add"])
def test_mark_variables_matches_jax(req):
    """`mark_variables` makes the given arrays the gradient buffers: two
    backward calls write or add into them, as in the JAX package."""
    a = _x(9)
    got = {}
    for pkg in (mxj, mx):
        ctx = pkg.cpu()
        x = pkg.nd.array(a, ctx=ctx)
        g = pkg.nd.array(np.zeros_like(a), ctx=ctx)
        pkg.autograd.mark_variables([x], [g], grad_reqs=req)
        for k in (1, 2):
            with pkg.autograd.record():
                y = x * x * k
            y.backward()
        got[pkg] = (g.asnumpy(), x.grad.asnumpy())
    np.testing.assert_allclose(got[mx][0], got[mxj][0], **TOL)
    np.testing.assert_allclose(got[mx][1], got[mxj][1], **TOL)
    np.testing.assert_allclose(got[mx][0], a * (4 if req == "write" else 6),
                               rtol=1e-6)
