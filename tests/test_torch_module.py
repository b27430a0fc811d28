"""The port's legacy training API against the JAX package's on the CPU:
`Module` (steps, `fit`/`score`/`predict`, checkpoints both ways),
`BucketingModule`, `FeedForward`, the legacy symbolic RNN cells, and
`HybridBlock.export` / `SymbolBlock.imports` across the packages (an
MLP, LeNet and a narrow ResNet-50 v1b; a bfloat16 block).

Weights are made with numpy from a seed and given to both packages
(`arg_params`), or carried across in the exported files.  Tolerances:
- one forward, or files read back: rtol 1e-5 with atol 1e-5 of the
  largest value (float32 products of width at most 128 in another
  summation order); a graph run by both packages on the same file of
  weights the same;
- weights and outputs after several SGD or Adam steps, `fit` epochs or
  bucket steps: rtol 1e-4 with atol 1e-4 of the largest value (the
  forward's rounding carried through the updates);
- the narrow ResNet: rtol 1e-4 with atol 1e-4 of the largest value
  (17 convolutions and BatchNorms deep in float32);
- the port's `SymbolBlock` of a block the port exported: bit for bit
  (the same ops on the same weights in the same order).
"""
import os

import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.symbol import symbol as jsymmod

import incubator_mxnet_torch as mx
from incubator_mxnet_torch.symbol import symbol as tsymmod

PKGS = (mxj, mx)


def _reset():
    jsymmod._COUNTER.table = {}
    tsymmod._COUNTER.table = {}


def _np(a):
    return np.asarray(a.asnumpy(), np.float64)


def _close(got, ref, rtol, what=""):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max(initial=0.0),
                               err_msg=what)


def _mlp(sym, classes=4):
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, name="fc1", num_hidden=32)
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, name="fc2", num_hidden=classes)
    return sym.SoftmaxOutput(fc2, name="softmax")


def _toy(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 10).astype(np.float32)
    y = (np.abs(x[:, :4]).argmax(1)).astype(np.float32)
    return x, y


def _params(sym_t, shapes, seed=1):
    rng = np.random.RandomState(seed)
    args, _o, aux = sym_t.infer_shape(**shapes)
    names = sym_t.list_arguments()
    arg = {n: (rng.randn(*s) * 0.3).astype(np.float32)
           for n, s in zip(names, args) if n not in shapes}
    auxp = {n: np.ones(s, np.float32) if n.endswith("var")
            else np.zeros(s, np.float32)
            for n, s in zip(sym_t.list_auxiliary_states(), aux)}
    return arg, auxp


def _nd(pkg, d):
    return {k: pkg.nd.array(v) for k, v in d.items()}


@pytest.mark.parametrize("opt", [("sgd", (("learning_rate", 0.1),
                                          ("momentum", 0.9))),
                                 ("adam", (("learning_rate", 0.01),))],
                         ids=["sgd", "adam"])
def test_module_steps_match_jax(opt):
    """bind → init_params(arg_params) → init_optimizer → three
    forward_backward + update steps: outputs and weights after each."""
    x, y = _toy(32)
    res = []
    for pkg in PKGS:
        _reset()
        s = _mlp(pkg.sym)
        with pkg.cpu():
            arg, aux = _params(s, {"data": (32, 10), "softmax_label": (32,)})
            it = pkg.io.NDArrayIter(x, y, batch_size=32)
            mod = pkg.mod.Module(s, context=pkg.cpu())
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params(arg_params=_nd(pkg, arg),
                            aux_params=_nd(pkg, aux))
            mod.init_optimizer(optimizer=opt[0], optimizer_params=opt[1])
            batch = next(iter(it))
            trace = []
            for _ in range(3):
                mod.forward_backward(batch)
                mod.update()
                trace.append([mod.get_outputs()[0]] + [
                    mod.get_params()[0][n] for n in sorted(arg)])
        res.append(trace)
    for step, (ref, got) in enumerate(zip(*res)):
        for i, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, 1e-4, f"step {step} item {i}")


def test_module_fit_score_predict_match_jax():
    """`fit` for two epochs from the same weights (no shuffle), then
    `score` and `predict`."""
    x, y = _toy(128, seed=3)
    res = []
    for pkg in PKGS:
        _reset()
        s = _mlp(pkg.sym)
        with pkg.cpu():
            arg, aux = _params(s, {"data": (32, 10), "softmax_label": (32,)})
            train = pkg.io.NDArrayIter(x, y, batch_size=32)
            mod = pkg.mod.Module(s, context=pkg.cpu())
            mod.fit(train, eval_data=train, num_epoch=2,
                    arg_params=_nd(pkg, arg), aux_params=_nd(pkg, aux),
                    optimizer_params=(("learning_rate", 0.5),))
            score = dict(mod.score(train, "acc"))["accuracy"]
            pred = mod.predict(train)
            res.append((score, pred, mod.get_params()[0]))
    (js, jp, ja), (ts, tp, ta) = res
    assert ts == pytest.approx(js, abs=1.0 / 128)
    assert ts > 0.6
    _close(tp, jp, 1e-4)
    for n in ja:
        _close(ta[n], ja[n], 1e-4, n)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_both_ways(tmp_path, writer):
    """`save_checkpoint` of one package, `Module.load` /
    `load_checkpoint` of the other: the same symbol, parameters and
    predictions."""
    x, y = _toy(32)
    src, dst = (mxj, mx) if writer == "jax" else (mx, mxj)
    prefix = str(tmp_path / "m")
    outs = []
    for pkg in (src, dst):
        _reset()
        with pkg.cpu():
            it = pkg.io.NDArrayIter(x, y, batch_size=32)
            if pkg is src:
                s = _mlp(pkg.sym)
                arg, aux = _params(s, {"data": (32, 10),
                                       "softmax_label": (32,)})
                mod = pkg.mod.Module(s, context=pkg.cpu())
                mod.bind(data_shapes=it.provide_data,
                         label_shapes=it.provide_label)
                mod.init_params(arg_params=_nd(pkg, arg))
                mod.save_checkpoint(prefix, 3)
            else:
                mod = pkg.mod.Module.load(prefix, 3, context=pkg.cpu())
                mod.bind(data_shapes=it.provide_data,
                         label_shapes=it.provide_label)
                mod._maybe_load_preloaded()
                s2, a2, _ = pkg.model.load_checkpoint(prefix, 3)
                assert s2.list_arguments() == mod.symbol.list_arguments()
                for k, v in arg.items():
                    np.testing.assert_array_equal(a2[k].asnumpy(), v)
            mod.forward(next(iter(it)), is_train=False)
            outs.append(mod.get_outputs()[0])
    _close(outs[1], outs[0], 1e-5)


def test_do_checkpoint_callback(tmp_path):
    """`callback.do_checkpoint` as `fit`'s epoch-end callback writes
    prefix-symbol.json and prefix-000N.params every period."""
    x, y = _toy(64)
    prefix = str(tmp_path / "cb")
    with mx.cpu():
        it = mx.io.NDArrayIter(x, y, batch_size=32)
        mod = mx.mod.Module(_mlp(mx.sym), context=mx.cpu())
        mod.fit(it, num_epoch=2, epoch_end_callback=[
            mx.callback.do_checkpoint(prefix)])
    assert os.path.exists(prefix + "-symbol.json")
    for e in (1, 2):
        assert os.path.exists(f"{prefix}-{e:04d}.params")
    _s, arg, _aux = mxj.model.load_checkpoint(prefix, 2)
    assert sorted(arg) == ["fc1_bias", "fc1_weight", "fc2_bias", "fc2_weight"]


def test_ndarrayiter_shuffle_follows_seed():
    """Without a `shuffle_seed`, `NDArrayIter`'s order follows
    `mx.random.seed` (what `run --seed` relies on); with one, the seed."""
    x = np.arange(64, dtype=np.float32).reshape(32, 2)

    def order(seed=None, shuffle_seed=None):
        if seed is not None:
            mx.random.seed(seed)
        with mx.cpu():
            it = mx.io.NDArrayIter(x, batch_size=8, shuffle=True,
                                   shuffle_seed=shuffle_seed)
            return np.concatenate([b.data[0].asnumpy()[:, 0] for b in it])
    assert np.array_equal(order(3), order(3))
    assert not np.array_equal(order(3), order(4))
    assert np.array_equal(order(shuffle_seed=5), order(9, shuffle_seed=5))
    assert sorted(order(3)) == list(range(0, 64, 2))


def test_dist_kvstore_raises():
    with mx.cpu():
        mod = mx.mod.Module(_mlp(mx.sym), context=mx.cpu())
        mod.bind(data_shapes=[("data", (4, 10))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params()
        with pytest.raises(mx.MXNetError, match="item 10"):
            mod.init_optimizer(kvstore="dist_sync")


def _bucket_sym(sym):
    def sym_gen(seq_len):
        data = sym.Variable("data")
        proj = sym.FullyConnected(data, name="step_fc", num_hidden=8,
                                  flatten=False)
        pooled = sym.mean(proj, axis=1)
        out = sym.FullyConnected(pooled, name="out_fc", num_hidden=3)
        return sym.SoftmaxOutput(out, name="softmax"), ("data",), \
            ("softmax_label",)
    return sym_gen


def test_bucketing_module_matches_jax():
    """Buckets 8, 4, 12, 8, 4 share one weight set and optimizer: the
    outputs and the weights after the steps agree with JAX, and the
    bucket modules hold the same arrays."""
    rng = np.random.RandomState(0)
    batches = [(T, rng.randn(16, T, 4).astype(np.float32),
                rng.randint(0, 3, (16,)).astype(np.float32))
               for T in (8, 4, 12, 8, 4)]
    w = {"step_fc_weight": rng.randn(8, 4).astype(np.float32) * 0.3,
         "step_fc_bias": np.zeros(8, np.float32),
         "out_fc_weight": rng.randn(3, 8).astype(np.float32) * 0.3,
         "out_fc_bias": np.zeros(3, np.float32)}
    res = []
    for pkg in PKGS:
        with pkg.cpu():
            mod = pkg.mod.BucketingModule(_bucket_sym(pkg.sym),
                                          default_bucket_key=8,
                                          context=pkg.cpu())
            mod.bind(data_shapes=[("data", (16, 8, 4))],
                     label_shapes=[("softmax_label", (16,))])
            mod.init_params(arg_params=_nd(pkg, w))
            mod.init_optimizer(optimizer_params=(("learning_rate", 0.1),))
            outs = []
            for T, x, y in batches:
                b = pkg.io.DataBatch(
                    [pkg.nd.array(x)], [pkg.nd.array(y)], bucket_key=T,
                    provide_data=[pkg.io.DataDesc("data", (16, T, 4))],
                    provide_label=[pkg.io.DataDesc("softmax_label", (16,))])
                mod.forward(b, is_train=True)
                mod.backward()
                mod.update()
                outs.append(mod.get_outputs()[0])
            assert mod._buckets[8]._arg_params["step_fc_weight"] is \
                mod._buckets[4]._arg_params["step_fc_weight"]
            res.append((outs, mod.get_params()[0]))
    (jo, jw), (to, tw) = res
    for g, r in zip(to, jo):
        _close(g, r, 1e-4)
    for n in jw:
        _close(tw[n], jw[n], 1e-4, n)


def test_feedforward_matches_jax(tmp_path):
    """`FeedForward.fit` (Adam) from the same weights, `predict`, and
    `save`/`load`."""
    rng = np.random.RandomState(0)
    X = rng.rand(64, 10).astype(np.float32)
    Y = (X.sum(1) > 5).astype(np.float32)
    res = []
    for pkg in PKGS:
        _reset()
        fx = pkg.sym.var("data")
        h = pkg.sym.Activation(pkg.sym.FullyConnected(
            fx, num_hidden=16, name="fc1"), act_type="relu")
        out = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            h, num_hidden=2, name="fc2"), name="softmax")
        with pkg.cpu():
            arg, _ = _params(out, {"data": (64, 10), "softmax_label": (64,)})
            ff = pkg.model.FeedForward(out, ctx=pkg.cpu(), num_epoch=5,
                                       optimizer="adam", learning_rate=0.02,
                                       arg_params=_nd(pkg, arg))
            ff.fit(X, Y)
            pred = ff.predict(X)
            prefix = str(tmp_path / pkg.__name__)
            ff.save(prefix, 5)
            ff2 = pkg.model.FeedForward.load(prefix, 5, ctx=pkg.cpu())
            np.testing.assert_allclose(ff2.predict(X), pred, atol=1e-6)
        res.append(pred)
    np.testing.assert_allclose(res[1], res[0], rtol=1e-4,
                               atol=1e-4 * np.abs(res[0]).max())


def _cells(pkg, kind):
    rnn, sym = pkg.rnn, pkg.sym
    B, T, H = 3, 4, 6
    if kind == "lstm":
        cell = rnn.LSTMCell(H, prefix="l_")
        begin = [sym.zeros((B, H)), sym.zeros((B, H))]
    elif kind == "rnn":
        cell = rnn.RNNCell(H, prefix="r_")
        begin = [sym.zeros((B, H))]
    elif kind == "gru":
        cell = rnn.GRUCell(H, prefix="g_")
        begin = [sym.zeros((B, H))]
    elif kind == "stack":
        cell = rnn.SequentialRNNCell()
        cell.add(rnn.GRUCell(H, prefix="g0_"))
        cell.add(rnn.DropoutCell(0.0))
        cell.add(rnn.ResidualCell(rnn.GRUCell(H, prefix="g1_")))
        begin = [sym.zeros((B, H)), sym.zeros((B, H))]
    elif kind == "bidir":
        cell = rnn.BidirectionalCell(rnn.LSTMCell(H, prefix="bl_"),
                                     rnn.LSTMCell(H, prefix="br_"))
        begin = [sym.zeros((B, H))] * 4
    else:
        cell = rnn.FusedRNNCell(H, num_layers=2, mode=kind[6:],
                                prefix="f_")
        begin = None
    outs, _states = cell.unroll(T, sym.var("x"), begin_state=begin,
                                layout="NTC", merge_outputs=True)
    return outs, {"x": (B, T, H)}


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "stack", "bidir",
                                  "fused_lstm", "fused_gru"])
def test_legacy_cells_unroll_match_jax(kind):
    """The legacy cells' unrolled graphs: argument names, shapes and the
    forward on the same weights."""
    res = []
    for pkg in PKGS:
        _reset()
        outs, shapes = _cells(pkg, kind)
        arg_shapes = outs.infer_shape(**shapes)[0]
        rng = np.random.RandomState(7)
        vals = {n: (rng.randn(*s) * 0.3).astype(np.float32)
                for n, s in zip(outs.list_arguments(), arg_shapes)}
        with pkg.cpu():
            out = outs.eval_with(_nd(pkg, vals))
        res.append((outs.list_arguments(), arg_shapes, out))
    (jn, js, jo), (tn, ts, to) = res
    assert tn == jn and ts == js
    _close(to, jo, 1e-5)


# ------------------------------------------------- export / SymbolBlock
def _gluon_net(pkg, kind):
    nn = pkg.gluon.nn
    if kind == "mlp":
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
        return net, (3, 8)
    if kind == "lenet":
        net = nn.HybridSequential()
        net.add(nn.Conv2D(6, 5, activation="tanh"), nn.MaxPool2D(2, 2),
                nn.Conv2D(8, 5, activation="tanh"), nn.MaxPool2D(2, 2),
                nn.Flatten(), nn.Dense(10))
        return net, (2, 1, 28, 28)
    r = pkg.models.resnet
    net = r.ResNetV1(r.BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128],
                     classes=10, thumbnail=True, v1b=True)
    return net, (2, 3, 32, 32)


def _init_net(pkg, net, shape, seed=0):
    with pkg.cpu():
        net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
        x = pkg.nd.array(np.random.RandomState(seed).randn(*shape)
                         .astype(np.float32))
        net(x)                       # finish deferred shapes
        rng = np.random.RandomState(seed + 1)
        for name, p in sorted(net._collect_params_with_prefix().items()):
            v = rng.randn(*p.shape).astype(np.float32) * 0.2
            if "var" in name:
                v = np.abs(v) + 0.5
            p.set_data(pkg.nd.array(v))
        return x


@pytest.mark.parametrize("kind", ["mlp", "lenet", "resnet"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_export_imports_across_packages(tmp_path, kind, writer):
    """`HybridBlock.export` of one package, `SymbolBlock.imports` of
    the other: the same outputs as the exporting block; in the port
    itself, bit for bit (the JAX package's own SymbolBlock runs the ops
    outside their per-op jit and differs by rounding, rtol 1e-5)."""
    src, dst = (mxj, mx) if writer == "jax" else (mx, mxj)
    _reset()
    net, shape = _gluon_net(src, kind)
    x = _init_net(src, net, shape)
    with src.cpu():
        ref = net(x)
    prefix = str(tmp_path / kind)
    sf, pf = net.export(prefix)
    with src.cpu():
        same = src.gluon.SymbolBlock.imports(sf, ["data"], pf,
                                             ctx=src.cpu())(x)
    if src is mx:
        np.testing.assert_array_equal(same.asnumpy(), ref.asnumpy())
    else:
        _close(same, ref, 1e-5)
    with dst.cpu():
        blk = dst.gluon.SymbolBlock.imports(sf, ["data"], pf, ctx=dst.cpu())
        got = blk(dst.nd.array(x.asnumpy()))
    _close(got, ref, 1e-4 if kind == "resnet" else 1e-5)


def test_resnet_export_graph_matches_jax(tmp_path):
    """The exported graph of the narrow ResNet-50 v1b: the same node
    counts by op and the same argument names in both packages."""
    from collections import Counter
    out = []
    for pkg in PKGS:
        _reset()
        net, shape = _gluon_net(pkg, "resnet")
        _init_net(pkg, net, shape)
        s = pkg.sym.load(net.export(str(tmp_path / pkg.__name__))[0])
        out.append((Counter(n._op for n in s._topo() if n._op),
                    s.list_arguments(), s.list_auxiliary_states()))
    assert out[1] == out[0]


def test_symbolblock_keeps_bf16_and_parameter_var(tmp_path):
    """A bfloat16 block exported and imported stays bfloat16 (JAX
    `test_gluon.py:557`); `Parameter.var` carries name, shape and dtype;
    `autograd.get_symbol` raises as in JAX."""
    with mx.cpu():
        net = mx.gluon.nn.Dense(4, in_units=3)
        net.initialize()
        net.cast("bfloat16")
        x = mx.nd.array(np.random.RandomState(0).rand(2, 3)
                        .astype(np.float32)).astype("bfloat16")
        want = net(x)
        sf, pf = net.export(str(tmp_path / "m"))
        blk = mx.gluon.SymbolBlock.imports(sf, "data", pf, ctx=mx.cpu())
        for p in blk.collect_params().values():
            assert str(p.data().dtype) == "bfloat16"
        out = blk(x)
    assert str(out.dtype) == "bfloat16"
    np.testing.assert_array_equal(out.astype("float32").asnumpy(),
                                  want.astype("float32").asnumpy())
    v = net.weight.var()
    assert v.name == net.weight.name
    assert v.infer_shape()[0] == [(4, 3)]
    assert [np.dtype(t).name for t in v.infer_type()[0]] == ["bfloat16"]
    with pytest.raises(mx.MXNetError):
        mx.autograd.get_symbol(want)
