"""The port's amp, monitor, visualization and subgraph modules against
the JAX package's on the CPU: amp's cast policy (FullyConnected in
bfloat16, softmax forced to float32, `amp_exclude`), the loss scaler,
`Monitor` on a Module, `print_summary`'s table and parameter count,
`plot_network` without graphviz, and the subgraph cases of JAX
`tests/test_subgraph.py:30-115`.

Inputs are made with numpy from a seed and given to both packages.
Tolerances: dtypes, names, the summary text and the partitioned graphs'
structure exact; amp's bfloat16 products rtol 2^-7 (one bfloat16
rounding of a float32-accumulated product of width 8); the monitor's
float32 means rtol 1e-6; partitioned graphs against the original rtol
1e-6 (the same ops in the same order).
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import subgraph as jsg
from incubator_mxnet_tpu.symbol import symbol as jsymmod

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import subgraph as tsg
from incubator_mxnet_torch.symbol import symbol as tsymmod

PKGS = (mxj, mx)
SG = {mxj: jsg, mx: tsg}


def _reset():
    jsymmod._COUNTER.table = {}
    tsymmod._COUNTER.table = {}


# ------------------------------------------------------------------ amp
def _amp_case(pkg):
    rng = np.random.RandomState(0)
    with pkg.cpu():
        a = pkg.nd.array(rng.randn(4, 8).astype(np.float32))
        w = pkg.nd.array(rng.randn(16, 8).astype(np.float32))
        q = pkg.nd.array(rng.randn(2, 128, 64).astype(np.float32))
        kv = pkg.nd.array(np.array([100, 128], np.float32))
        try:
            pkg.amp.init("bfloat16")
            out = pkg.nd.FullyConnected(a, w, num_hidden=16, no_bias=True)
            s = out.softmax()
            att = pkg.nd.multi_head_attention(q, q, q, None, kv, num_heads=1)
            plain = pkg.nd.relu(a)
        finally:
            pkg.amp.disable()
        after = pkg.nd.FullyConnected(a, w, num_hidden=16, no_bias=True)
    return out, s, att, plain, after


def test_amp_policy_matches_jax():
    """Under `amp.init("bfloat16")` FullyConnected and attention run in
    bfloat16, softmax in float32, other ops untouched; `disable`
    restores float32."""
    (jo, js, ja, jp, jf), (to, ts, ta, tp, tf) = (_amp_case(p) for p in PKGS)
    for g, r in ((to, jo), (ts, js), (ta, ja), (tp, jp), (tf, jf)):
        assert str(g.dtype) == str(r.dtype)
    assert str(to.dtype) == "bfloat16" and str(ts.dtype) == "float32"
    assert str(tf.dtype) == "float32"
    for g, r in ((to, jo), (ts, js), (ta, ja)):
        ref = r.astype("float32").asnumpy()
        np.testing.assert_allclose(g.astype("float32").asnumpy(), ref,
                                   rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(ref).max())


def test_amp_scaler_and_helpers():
    """`LossScaler` halves on overflow and doubles after its window, as
    the JAX one; `scale_loss` divides the trainer's `rescale_grad`;
    `convert_model` casts; only bfloat16 and float16 are targets."""
    for pkg in PKGS:
        s = pkg.amp.LossScaler(init_scale=1024.0, scale_factor=2.0,
                               scale_window=2)
        s.update_scale(overflow=True)
        assert s.loss_scale == 512.0
        s.update_scale(False)
        s.update_scale(False)
        assert s.loss_scale == 1024.0
        with pytest.raises(pkg.MXNetError):
            pkg.amp.init("int8")
    with mx.cpu():
        net = mx.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
        mx.amp.init_trainer(tr)
        loss = net(mx.nd.ones((1, 3))).sum()
        with mx.amp.scale_loss(loss, tr) as scaled:
            assert float(scaled.asnumpy()) == pytest.approx(
                float(loss.asnumpy()) * 2.0 ** 16)
        assert tr._optimizer.rescale_grad == pytest.approx(2.0 ** -16)
        mx.amp.convert_model(net, "bfloat16")
        assert str(net.weight.data().dtype) == "bfloat16"
    assert mx.contrib.amp is mx.amp


# -------------------------------------------------------------- monitor
def test_monitor_matches_jax():
    """A Monitor installed on a Module collects mean(|x|) of the matched
    weights and outputs, by name, as the JAX one does."""
    res = []
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype(np.float32)
    w = {"fc_weight": rng.randn(2, 4).astype(np.float32),
         "fc_bias": rng.randn(2).astype(np.float32)}
    for pkg in PKGS:
        _reset()
        data = pkg.sym.Variable("data")
        out = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            data, name="fc", num_hidden=2), name="softmax")
        with pkg.cpu():
            mod = pkg.mod.Module(out, context=pkg.cpu())
            it = pkg.io.NDArrayIter(x, np.zeros(8, np.float32), batch_size=8)
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params(arg_params={k: pkg.nd.array(v)
                                        for k, v in w.items()})
            mon = pkg.monitor.Monitor(interval=1,
                                      pattern=".*weight|output.*")
            mon.install(mod)
            mon.tic()
            mod.forward(next(iter(it)), is_train=False)
            res.append(mon.toc())
    ref, got = res
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in ref]
    np.testing.assert_allclose([float(v) for _, _, v in got],
                               [float(v) for _, _, v in ref], rtol=1e-6)


# -------------------------------------------------------- visualization
def test_print_summary_matches_jax(capsys):
    """The same table, and the JAX package's parameter count."""
    outs = []
    for pkg in PKGS:
        _reset()
        data = pkg.sym.Variable("data")
        h = pkg.sym.Activation(pkg.sym.FullyConnected(
            data, name="fc", num_hidden=10), act_type="relu")
        net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            h, name="fc2", num_hidden=3), name="softmax")
        outs.append(pkg.viz.print_summary(net, shape={"data": (1, 20)}))
    assert outs[1] == outs[0]
    assert "Total params: 243" in outs[1]
    assert outs[1] in capsys.readouterr().out


def test_plot_network_without_graphviz(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "graphviz", None)
    with pytest.raises(mx.MXNetError, match="graphviz"):
        mx.viz.plot_network(mx.sym.relu(mx.sym.var("x")))


# ------------------------------------------------------------- subgraph
class _Elemwise:
    name = "test_elemwise"
    OPS = {"relu", "tanh", "sigmoid", "exp", "negative"}

    def select(self, node):
        return node._op in self.OPS


class _Greedy:
    name = "test_greedy"

    def select(self, node):
        return node._op in ("broadcast_add", "relu", "tanh")


class _Doubler:
    name = "test_doubler"

    def select(self, node):
        return node._op in ("relu", "tanh")

    def rewrite(self, subgraph):
        return subgraph * 2.0


for _sg in (jsg, tsg):
    for _cls in (_Elemwise, _Greedy, _Doubler):
        _sg.register_subgraph_property(
            type(_cls.__name__, (_cls, _sg.SubgraphProperty), {})())


def _count(s, op):
    return sum(1 for n in s._topo() if n._op == op)


def _chain(sym):
    return sym.tanh(sym.relu(sym.negative(sym.var("x")))), {"x": (3, 4)}


def _boundary(sym):
    h = sym.relu(sym.var("x"))
    return sym.tanh(sym.relu(sym.dot(h, sym.var("w")))), \
        {"x": (3, 4), "w": (4, 5)}


def _multi_output(sym):
    parts = sym.split(sym.var("x"), num_outputs=2, axis=1)
    return sym.tanh(sym.relu(parts[1])), {"x": (2, 4)}


def _var_input(sym):
    return sym.tanh(sym.relu(sym.broadcast_add(sym.var("a"),
                                               sym.var("b")))), \
        {"a": (2, 2), "b": (2, 2)}


def _computed_input(sym):
    return sym.tanh(sym.relu(sym.broadcast_add(
        sym.var("a"), sym.exp(sym.var("b"))))), {"a": (2, 2), "b": (2, 2)}


def _rewrite(sym):
    return sym.tanh(sym.relu(sym.var("x"))), {"x": (1, 2)}


SG_CASES = {
    "chain": (_chain, "test_elemwise", {"_subgraph": 1, "relu": 0}),
    "boundary": (_boundary, "test_elemwise",
                 {"_subgraph": 1, "relu": 1, "dot": 1}),
    "multi_output": (_multi_output, "test_elemwise", {"_subgraph": 1}),
    "var_input": (_var_input, "test_greedy",
                  {"_subgraph": 1, "broadcast_add": 0}),
    "computed_input": (_computed_input, "test_greedy",
                       {"_subgraph": 1, "broadcast_add": 1}),
    "rewrite": (_rewrite, "test_doubler", {"_subgraph": 1}),
}


@pytest.mark.parametrize("case", sorted(SG_CASES))
def test_partition_matches_jax(case):
    """The partitioned graph's node counts and its values (against the
    original graph, and against JAX's partition of the same graph)."""
    build, backend, counts = SG_CASES[case]
    rng = np.random.RandomState(3)
    res = []
    for pkg in PKGS:
        _reset()
        y, shapes = build(pkg.sym)
        vals = {k: rng.randn(*s).astype(np.float32)
                for k, s in sorted(shapes.items())}
        rng = np.random.RandomState(3)
        part = SG[pkg].partition_graph(y, backend)
        for op, n in counts.items():
            assert _count(part, op) == n, (pkg.__name__, op)
        with pkg.cpu():
            b = {k: pkg.nd.array(v) for k, v in vals.items()}
            ref = y.eval_with(b).asnumpy()
            out = part.eval_with(b).asnumpy()
        if case == "rewrite":
            ref = ref * 2
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
        res.append(out)
    np.testing.assert_allclose(res[1], res[0], rtol=1e-6, atol=1e-7)


def test_backend_symbol_env_and_registry(monkeypatch):
    """`get_backend_symbol`, the `MXNET_SUBGRAPH_BACKEND` default, an
    unknown backend's error and the backend list."""
    y = mx.sym.exp(mx.sym.sigmoid(mx.sym.var("x")))
    assert _count(y.get_backend_symbol("test_elemwise"), "_subgraph") == 1
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "test_elemwise")
    assert _count(tsg.partition_graph(y), "_subgraph") == 1
    monkeypatch.delenv("MXNET_SUBGRAPH_BACKEND")
    assert tsg.partition_graph(y) is y
    with pytest.raises(mx.MXNetError, match="no subgraph backend"):
        tsg.get_subgraph_property("bogus")
    assert "test_elemwise" in tsg.list_subgraph_backends()
    part = tsg.partition_graph(y, "test_elemwise")
    assert part.infer_shape(x=(2, 3))[1] == [(2, 3)]
