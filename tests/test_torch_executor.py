"""The port's `Executor` against the JAX package's on the CPU: forward
values in predict and train mode, gradients under `grad_req` "write",
"add" and "null", BatchNorm's moving statistics updated in a training
forward, `simple_bind`, `copy_params_from` and the monitor callback.

The same graph is built in both packages and bound to the same numpy
arrays (made from a seed).  Tolerances: outputs and gradients rtol
1e-5 with atol 1e-5 of the largest value (float32 products and
reductions of width at most 64 in another summation order), the
gradients' atol 1e-5 of the largest gradient of any argument (the conv
bias's gradient through train-mode BatchNorm is zero up to rounding,
~1e-7 in both packages); moving statistics as the outputs (one float32
fold of batch statistics).
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.symbol import symbol as jsymmod

import incubator_mxnet_torch as mx
from incubator_mxnet_torch.symbol import symbol as tsymmod

PKGS = (mxj, mx)
RTOL = 1e-5


def _close(got, ref, what="", scale=None):
    got = np.asarray(got.asnumpy(), np.float64)
    ref = np.asarray(ref.asnumpy(), np.float64)
    scale = np.abs(ref).max(initial=0.0) if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _graph(sym):
    data = sym.var("data")
    c = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                        name="conv")
    b = sym.BatchNorm(c, name="bn", fix_gamma=False, momentum=0.8)
    a = sym.Activation(b[0], act_type="relu", name="relu")
    f = sym.FullyConnected(sym.Flatten(a), num_hidden=5, name="fc")
    return sym.SoftmaxOutput(f, name="softmax")


def _bind(pkg, grad_req, seed=0):
    jsymmod._COUNTER.table = {}
    tsymmod._COUNTER.table = {}
    s = _graph(pkg.sym)
    shapes = dict(data=(4, 3, 6, 6), softmax_label=(4,))
    arg_shapes, _, aux_shapes = s.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    with pkg.cpu():
        args = {}
        for n, shp in zip(s.list_arguments(), arg_shapes):
            v = rng.randint(0, 5, shp) if n == "softmax_label" \
                else rng.randn(*shp) * 0.5
            args[n] = pkg.nd.array(v.astype(np.float32))
        aux = {n: pkg.nd.array((rng.rand(*shp) + 0.5).astype(np.float32))
               for n, shp in zip(s.list_auxiliary_states(), aux_shapes)}
        grads = {n: pkg.nd.array(rng.randn(*a.shape).astype(np.float32))
                 for n, a in args.items()}
        return s.bind(ctx=pkg.cpu(), args=args, args_grad=grads,
                      grad_req=grad_req, aux_states=aux), grads


def test_forward_predict_matches_jax():
    ref, got = (_bind(p, "write")[0] for p in PKGS)
    assert got.arg_names == ref.arg_names
    assert got.aux_names == ref.aux_names
    for a, b in zip(got.forward(is_train=False), ref.forward(is_train=False)):
        _close(a, b)
    for n in ref.aux_names:     # predict mode leaves the stats alone
        _close(got.aux_dict[n], ref.aux_dict[n])


@pytest.mark.parametrize("req", ["write", "add", "null",
                                 "mixed"])
def test_backward_grad_req_matches_jax(req):
    """Gradients written, added to the bound buffers, or left alone;
    "mixed" gives each argument its own request."""
    if req == "mixed":
        req = {"data": "null", "conv_weight": "add", "conv_bias": "write",
               "bn_gamma": "add", "bn_beta": "null", "fc_weight": "write",
               "fc_bias": "add", "softmax_label": "null"}
    execs = [_bind(p, req) for p in PKGS]
    before = [{n: g.asnumpy().copy() for n, g in grads.items()}
              for _ex, grads in execs]
    for pkg, (ex, _g) in zip(PKGS, execs):
        ex.forward(is_train=True)
        if req == "null":       # nothing takes a gradient: both raise
            with pytest.raises(pkg.MXNetError):
                ex.backward()
        else:
            ex.backward()
    (ref, rg), (got, tg) = execs
    if req == "null":
        for n in ref.arg_names:
            np.testing.assert_array_equal(tg[n].asnumpy(), before[1][n])
    for a, b in zip(got.outputs, ref.outputs):
        _close(a, b, "output")
    scale = max(np.abs(g.asnumpy()).max() for g in rg.values())
    for n in ref.arg_names:
        _close(tg[n], rg[n], n, scale)


def test_batchnorm_moving_stats_update_matches_jax():
    """A training forward folds the batch statistics into the moving
    mean and variance with the node's momentum; two forwards fold twice."""
    execs = [_bind(p, "write")[0] for p in PKGS]
    for _ in range(2):
        for ex in execs:
            ex.forward(is_train=True)
    ref, got = execs
    for n in ref.aux_names:
        _close(got.aux_dict[n], ref.aux_dict[n], n)
    assert not np.allclose(got.aux_dict["bn_moving_mean"].asnumpy(),
                           _bind(mx, "write")[0].aux_dict[
                               "bn_moving_mean"].asnumpy())


def test_feed_and_copy_params_from_match_jax():
    """`forward(data=...)` feeds the batch; `copy_params_from` loads new
    weights; `outputs` follow both."""
    execs = [_bind(p, "write")[0] for p in PKGS]
    rng = np.random.RandomState(5)
    x = rng.randn(4, 3, 6, 6).astype(np.float32)
    w = rng.randn(5, 144).astype(np.float32)
    outs = []
    for pkg, ex in zip(PKGS, execs):
        with pkg.cpu():
            ex.copy_params_from({"fc_weight": pkg.nd.array(w)})
            outs.append(ex.forward(is_train=False, data=pkg.nd.array(x))[0])
    _close(outs[1], outs[0])


def test_simple_bind_and_monitor():
    """`simple_bind` makes zero arrays of the inferred shapes; the
    monitor callback sees every node output by name."""
    seen = {}
    res = []
    for pkg in PKGS:
        jsymmod._COUNTER.table = {}
        tsymmod._COUNTER.table = {}
        s = _graph(pkg.sym)
        with pkg.cpu():
            ex = s.simple_bind(ctx=pkg.cpu(), data=(2, 3, 6, 6),
                               softmax_label=(2,))
        res.append({n: a.shape for n, a in ex.arg_dict.items()})
    assert res[0] == res[1]
    s = _graph(mx.sym)
    ex = s.simple_bind(ctx=mx.cpu(), data=(2, 3, 6, 6), softmax_label=(2,))
    ex.set_monitor_callback(lambda name, arr: seen.setdefault(name, arr))
    ex.forward(is_train=False)
    assert {"conv_output", "relu_output", "fc_output",
            "softmax_output"} <= set(seen)
    assert seen["fc_output"].shape == (2, 5)


def test_backward_without_training_forward_raises():
    ex = _bind(mx, "write")[0]
    ex.forward(is_train=False)
    with pytest.raises(mx.MXNetError):
        ex.backward()
