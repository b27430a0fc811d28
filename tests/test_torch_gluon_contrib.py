"""The port's `gluon.contrib.cnn` and `gluon.contrib.rnn` against the
JAX package's on the CPU: DeformableConvolution (with its offset branch
drawn away from zero, so the taps move), and each of the nine
convolutional recurrent cells, one step and `unroll`, forward and
gradients, from one set of weights carried by `convert.params_from_jax`.

Tolerance: rtol 1e-6 with atol 1e-6 of the largest reference value (the
same float32 arithmetic; the convolutions and the deformable op's
contraction sum in another order).
"""
import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401
import incubator_mxnet_tpu as mxj

import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import params_from_jax

TOL = dict(rtol=1e-6, atol_of_max=1e-6)


def _np(a):
    return np.asarray(a.asnumpy()).astype(np.float64)


def _close(got, ref, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(
        got, ref, rtol=TOL["rtol"],
        atol=TOL["atol_of_max"] * max(np.abs(ref).max(initial=0), 1e-30),
        err_msg=what)


def _carry(jblock, tblock, rng, spread=None):
    """JAX weights (those named in `spread` redrawn uniform in ±spread)
    into the port's block."""
    arrays = {}
    for k, p in jblock._collect_params_with_prefix().items():
        if spread and k in spread:
            p.set_data(mxj.nd.array(rng.uniform(
                -spread[k], spread[k], p.shape).astype(np.float32),
                ctx=mxj.cpu()))
        arrays[k] = p.data().asnumpy()
    assert sorted(arrays) == sorted(tblock._collect_params_with_prefix())
    params_from_jax(tblock, arrays)


def _grads(block):
    return {k: p.grad() for k, p in block._collect_params_with_prefix()
            .items()}


# --------------------------------------------------- DeformableConvolution
DCN = {
    "plain": dict(channels=4, kernel_size=3, padding=1),
    "strided": dict(channels=5, kernel_size=(3, 3), strides=2, padding=1,
                    activation="relu"),
    "dilated no bias": dict(channels=3, kernel_size=3, dilation=2,
                            padding=2, use_bias=False),
}


@pytest.mark.parametrize("cfg", sorted(DCN))
def test_deformable_convolution_matches_jax(cfg):
    kw = DCN[cfg]
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 3, 7, 7)).astype(np.float32)
    outs = {}
    jnet = mxj.gluon.contrib.cnn.DeformableConvolution(**kw)
    jnet.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    jnet(mxj.nd.array(x, ctx=mxj.cpu()))
    tnet = mx.gluon.contrib.cnn.DeformableConvolution(**kw)
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    spread = {"offset_weight": 0.3, "offset_bias": 1.5}
    _carry(jnet, tnet, rng, spread)
    for pkg, net in (("jax", jnet), ("port", tnet)):
        m = mxj if pkg == "jax" else mx
        with m.cpu():
            data = m.nd.array(x)
        data.attach_grad()
        with m.autograd.record():
            y = net(data)
        cot = np.random.RandomState(1).randn(*y.shape).astype(np.float32)
        y.backward(m.nd.array(cot, ctx=m.cpu()))
        outs[pkg] = {"out": y, "data grad": data.grad, **_grads(net)}
    for k in outs["jax"]:
        _close(outs["port"][k], outs["jax"][k], f"{cfg}: {k}")


def test_deformable_convolution_groups_raise():
    with pytest.raises(mx.MXNetError):
        mx.gluon.contrib.cnn.DeformableConvolution(4, 3, groups=2)


# ------------------------------------------------------- Conv RNN cells
CELLS = [f"Conv{d}D{k}Cell" for d in (1, 2, 3) for k in ("RNN", "LSTM",
                                                           "GRU")]
SPATIAL = {1: (6,), 2: (5, 5), 3: (3, 4, 4)}


def _cell_run(pkg, cell, x, T):
    """One step from zero states, then `unroll` over T steps from them,
    merged; the gradient of the sum of everything with seeded weights."""
    m = mxj if pkg == "jax" else mx
    with m.cpu():
        data = m.nd.array(x)
        data.attach_grad()
        states = cell.begin_state(x.shape[0])
        with m.autograd.record():
            step, step_states = cell(data[:, 0], states)
            seq, last = cell.unroll(T, data, begin_state=states,
                                    layout="NTC", merge_outputs=True)
            rng = np.random.RandomState(2)
            heads = [step] + list(step_states) + [seq] + list(last)
            loss = None
            for h in heads:
                w = m.nd.array(rng.randn(*h.shape).astype(np.float32))
                term = (h * w).sum()
                loss = term if loss is None else loss + term
        loss.backward()
    out = {"step": step, "seq": seq, "data grad": data.grad}
    out.update({f"state {i}": s for i, s in enumerate(last)})
    out.update(_grads(cell))
    return out


@pytest.mark.parametrize("name", CELLS)
def test_conv_rnn_cell_matches_jax(name):
    ndim = int(name[4])
    T, N, C, hidden = 3, 2, 2, 3
    shape = (C,) + SPATIAL[ndim]
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (N, T) + shape).astype(np.float32)
    jcell = getattr(mxj.gluon.contrib.rnn, name)(hidden, 3,
                                                 input_shape=shape)
    jcell.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    tcell = getattr(mx.gluon.contrib.rnn, name)(hidden, 3,
                                                input_shape=shape)
    tcell.initialize(mx.init.Xavier(), ctx=mx.cpu())
    spread = {k: 0.5 for k in ("i2h_bias", "h2h_bias")}
    _carry(jcell, tcell, rng, spread)
    ref = _cell_run("jax", jcell, x, T)
    got = _cell_run("port", tcell, x, T)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k], f"{name}: {k}")


def test_conv_rnn_cell_deferred_shape_and_even_kernel():
    """Without `input_shape` the state shape is unknown until a step has
    run; an even h2h kernel raises, as in the JAX cells."""
    cell = mx.gluon.contrib.rnn.Conv2DLSTMCell(3, 3)
    with pytest.raises(mx.MXNetError):
        cell.begin_state(2)
    with pytest.raises(mx.MXNetError):
        mx.gluon.contrib.rnn.Conv2DGRUCell(3, 2)
    cell.initialize(ctx=mx.cpu())
    with mx.cpu():
        x = mx.nd.ones((2, 2, 5, 5))
        h = mx.nd.zeros((2, 3, 5, 5))
        out, _ = cell(x, [h, h])
        assert out.shape == (2, 3, 5, 5)
        assert cell.begin_state(4)[0].shape == (4, 3, 5, 5)
