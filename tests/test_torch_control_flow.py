"""The port's control-flow operators (`nd.contrib.foreach`,
`while_loop`, `cond`) against the JAX package's, on the cases of JAX
`tests/test_control_flow.py`: eager, under `autograd.record()`, and
inside a hybridized block, with the body's output structure kept.

Each case runs in both packages on the same inputs; results are
compared exactly (the same float32 additions and products in the same
order) and with the values the JAX tests expect.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx

PKGS = (mxj, mx)


def _foreach_cumsum(pkg):
    nd = pkg.nd
    data = nd.array(np.arange(12, dtype=np.float32).reshape(4, 3))

    def body(x, s):
        s2 = s + x
        return s2, s2
    outs, final = nd.contrib.foreach(body, data, nd.zeros((3,)))
    return [outs, final]


def _foreach_autograd(pkg):
    nd = pkg.nd
    data = nd.array(np.ones((3, 2), np.float32))
    w = nd.array(np.array([2.0, 3.0], np.float32))
    w.attach_grad()

    def body(x, s):
        out = x * w + s
        return out, out
    with pkg.autograd.record():
        _outs, final = nd.contrib.foreach(body, data, nd.zeros((2,)))
        loss = final.sum()
    loss.backward()
    return [final, w.grad]


def _foreach_lists(pkg):
    nd = pkg.nd
    a = nd.array(np.ones((2, 2), np.float32))
    b = nd.array(np.full((2, 2), 2.0, np.float32))

    def body(xs, states):
        x, y = xs
        s1, s2 = states
        return [x + y, x - y], [s1 + x, s2 + y]
    outs, finals = nd.contrib.foreach(body, [a, b],
                                      [nd.zeros((2,)), nd.zeros((2,))])
    assert isinstance(outs, list) and len(outs) == 2 and len(finals) == 2
    return outs + finals


def _foreach_hybrid(pkg):
    class Cum(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            def body(xt, s):
                s2 = s + xt
                return s2, s2
            outs, _ = pkg.nd.contrib.foreach(
                body, x.swapaxes(0, 1),
                pkg.nd.zeros((x.shape[0],), dtype=x.dtype))
            return outs.swapaxes(0, 1)
    net = Cum()
    x = pkg.nd.array(np.random.RandomState(0).rand(2, 5).astype(np.float32))
    eager = net(x)
    net.hybridize()
    return [eager, net(x)]


def _while_eager(pkg):
    nd = pkg.nd
    outs, (i_f, s_f) = nd.contrib.while_loop(
        lambda i, s: i < 4, lambda i, s: (s + i, [i + 1, s + i]),
        [nd.array([0.0]), nd.array([0.0])], max_iterations=6)
    return [outs, i_f, s_f]


def _while_hybrid(pkg):
    class Pow2(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            _outs, (_i, v_f) = pkg.nd.contrib.while_loop(
                lambda i, v: i < 3, lambda i, v: (v, [i + 1, v * 2]),
                [pkg.nd.zeros((1,)), x], max_iterations=5)
            return v_f
    net = Pow2()
    x = pkg.nd.array(np.array([3.0], np.float32))
    eager = net(x)
    net.hybridize()
    return [eager, net(x)]


def _while_false_on_entry(pkg):
    outs, (v,) = pkg.nd.contrib.while_loop(
        lambda i: i < 0, lambda i: (i * 2, [i + 1]),
        [pkg.nd.array([5.0])], max_iterations=3)
    return [outs, v]


def _while_record(pkg):
    nd = pkg.nd
    x = nd.array(np.array([1.5], np.float32))
    x.attach_grad()
    with pkg.autograd.record():
        outs, (_i, v) = nd.contrib.while_loop(
            lambda i, v: i < 3, lambda i, v: (v * v, [i + 1, v * x]),
            [nd.zeros((1,)), nd.ones((1,))], max_iterations=4)
        loss = outs.sum() + v.sum()
    loss.backward()
    return [outs, v, x.grad]


def _cond(pkg):
    nd = pkg.nd
    a, b = nd.array([1.0]), nd.array([2.0])
    t = nd.contrib.cond(nd.array([1.0]), lambda: a + b, lambda: a - b)
    f = nd.contrib.cond(nd.array([0.0]), lambda: a + b, lambda: a - b)
    lst = nd.contrib.cond(nd.array([1.0]), lambda: [a + 1], lambda: [a - 1])
    assert isinstance(lst, list)

    class Abs(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return pkg.nd.contrib.cond(x.sum() > 0, lambda: x * 1.0,
                                       lambda: x * -1.0)
    net = Abs()
    net.hybridize()
    return [t, f, lst[0], net(nd.array(np.array([-2.0, -1.0], np.float32))),
            net(nd.array(np.array([2.0, 1.0], np.float32)))]


def _structure_hybrid(pkg):
    class ListCum(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            def body(xs, states):
                s2 = states[0] + xs[0]
                return [s2], [s2]
            outs, finals = pkg.nd.contrib.foreach(
                body, [x.swapaxes(0, 1)],
                [pkg.nd.zeros((x.shape[0],), dtype=x.dtype)])
            assert isinstance(outs, list) and isinstance(finals, list)
            return outs[0].swapaxes(0, 1)
    net = ListCum()
    x = pkg.nd.array(np.random.RandomState(2).rand(2, 4).astype(np.float32))
    eager = net(x)
    net.hybridize()
    return [eager, net(x)]


CASES = {
    "foreach_cumsum": (_foreach_cumsum, [
        np.cumsum(np.arange(12).reshape(4, 3), axis=0),
        np.cumsum(np.arange(12).reshape(4, 3), axis=0)[-1]]),
    "foreach_autograd": (_foreach_autograd, [[6.0, 9.0], [3.0, 3.0]]),
    "foreach_lists": (_foreach_lists, [np.full((2, 2), 3.0),
                                       np.full((2, 2), -1.0), [2.0, 2.0],
                                       [4.0, 4.0]]),
    "foreach_hybrid": (_foreach_hybrid, None),
    "while_eager": (_while_eager, [[[0], [1], [3], [6], [0], [0]], [4.0],
                                   [6.0]]),
    "while_hybrid": (_while_hybrid, [[24.0], [24.0]]),
    "while_false_on_entry": (_while_false_on_entry, [np.zeros((3, 1)),
                                                     [5.0]]),
    "while_record": (_while_record, None),
    "cond": (_cond, [[3.0], [-1.0], [2.0], [2.0, 1.0], [2.0, 1.0]]),
    "structure_hybrid": (_structure_hybrid, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_flow_matches_jax(case):
    fn, want = CASES[case]
    res = []
    for pkg in PKGS:
        with pkg.cpu():
            res.append([np.asarray(o.asnumpy()) for o in fn(pkg)])
    ref, got = res
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    if want is not None:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w, np.float64).reshape(
                g.shape))


def test_control_flow_exported_from_contrib():
    assert mx.contrib.foreach is mx.nd.contrib.foreach
    assert mx.contrib.while_loop is mx.nd.contrib.while_loop
    assert mx.contrib.cond is mx.nd.contrib.cond
    assert mx.contrib.amp is mx.amp
    with mx.cpu(), pytest.raises(mx.MXNetError):
        mx.nd.contrib.while_loop(lambda i: i < 1, lambda i: (i, [i]),
                                 [mx.nd.zeros((1,))], max_iterations=0)
