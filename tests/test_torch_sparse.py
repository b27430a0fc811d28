"""Row-sparse storage and gradients in the port against the JAX package:
`RowSparseNDArray` and its functions, `Embedding(sparse_grad=True)`'s
gradient, the lazy row updates of SGD and Adam (through the update
functions and through `gluon.Trainer`), and `ParallelTrainer`'s lazy
row update (counterparts of `tests/test_lazy_sparse_update.py`).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason:

- storage, indices, gathered and scatter-added rows, dense forms:
  exact (the same values copied, or summed in the same order);
- lazy updates: rtol 1e-6, atol 1e-7 in float32 (the same elementwise
  float32 arithmetic), one bf16 ulp in bf16; rows the gradient lacks:
  bitwise unchanged;
- whole Trainer and ParallelTrainer steps: rtol 1e-5, atol 1e-6
  (`STEP_TOL`): the same arithmetic, but XLA fuses multiply-adds the
  port rounds twice, and Adam divides by √v, which grows a last-bit
  difference where v is small (3e-6 relative seen after 3 steps); the
  ParallelTrainer's weights at lr 0.1 take atol 1e-5, lr·1e-4, as a
  gradient element near 0 still moves its weight by up to lr;
- ParallelTrainer, dense against lazy on touched rows: rtol and atol
  2e-5, as the JAX test has it (the same update computed on gathered
  rows); untouched rows: exact.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.ndarray import sparse as jsp

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd, parallel as par
from incubator_mxnet_torch.gluon.block import record_rows
from incubator_mxnet_torch.ndarray import sparse as tsp

V, E = 12, 3
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(a):
    return np.asarray(a.asnumpy(), np.float32)


def _rsp_pair(seed=0, rows=(7, 2, 9, 4)):
    vals = np.random.RandomState(seed).randn(len(rows), E).astype(np.float32)
    j = jsp.row_sparse_array((vals, np.array(rows)), shape=(V, E),
                             ctx=mxj.cpu())
    t = tsp.row_sparse_array((vals, np.array(rows)), shape=(V, E),
                             ctx=mx.cpu())
    return j, t


def _same_rsp(t, j):
    assert t.stype == j.stype == "row_sparse"
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy())
    np.testing.assert_array_equal(_np(t.data), _np(j.data))
    np.testing.assert_array_equal(_np(t), _np(j))


def test_row_sparse_array_and_its_functions_match_jax():
    j, t = _rsp_pair()
    _same_rsp(t, j)
    assert t.dtype == j.dtype == np.float32
    _same_rsp(t.retain([9, 0, 2]), j.retain([9, 0, 2]))
    _same_rsp(t * 2.0, j * 2.0)
    j2, t2 = _rsp_pair(1, rows=(2, 11))
    _same_rsp(t + t2, j + j2)
    _same_rsp(t - t2, j - j2)
    _same_rsp(tsp.multiply(t, t2), jsp.multiply(j, j2))
    dense = np.random.RandomState(3).randn(V, E).astype(np.float32)
    np.testing.assert_array_equal(
        _np(t + nd.array(dense, ctx=mx.cpu())),
        _np(j + mxj.nd.array(dense, ctx=mxj.cpu())))
    dense[[0, 5, 6]] = 0
    _same_rsp(tsp.cast_storage(nd.array(dense, ctx=mx.cpu()), "row_sparse"),
              jsp.cast_storage(mxj.nd.array(dense, ctx=mxj.cpu()),
                               "row_sparse"))
    _same_rsp(tsp.zeros("row_sparse", (V, E), ctx=mx.cpu()),
              jsp.zeros("row_sparse", (V, E), ctx=mxj.cpu()))
    np.testing.assert_array_equal(_np(tsp.cast_storage(t, "default")),
                                  _np(jsp.cast_storage(j, "default")))
    with pytest.raises(mx.MXNetError, match="indexing"):
        t[0]
    assert nd.sparse is tsp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_grad_embedding_matches_jax(dtype):
    """The recorded backward of `Embedding(sparse_grad=True)`: the
    sorted unique ids and the head gradient's rows summed onto them,
    duplicates included, and its dense form."""
    rng = np.random.RandomState(2)
    ids = rng.randint(0, V, (3, 5)).astype(np.float32)
    head = np.round(rng.randn(3, 5, E) * 8).astype(np.float32) / 8
    w = rng.randn(V, E).astype(np.float32)
    got = {}
    for pkg in (mxj, mx):
        emb = pkg.gluon.nn.Embedding(V, E, sparse_grad=True)
        emb.initialize(ctx=pkg.cpu())
        emb.weight.set_data(pkg.nd.array(w, ctx=pkg.cpu()))
        emb.cast(dtype)
        assert emb.weight.grad_stype == "row_sparse"
        x = pkg.nd.array(ids, ctx=pkg.cpu())
        with pkg.autograd.record():
            out = emb(x)
        out.backward(pkg.nd.array(head, ctx=pkg.cpu()).astype(dtype))
        got[pkg] = (out, emb.weight.grad())
    (jo, jg), (to, tg) = got[mxj], got[mx]
    np.testing.assert_array_equal(_np(to), _np(jo))
    _same_rsp(tg, jg)
    assert tg.dtype == dtype
    np.testing.assert_array_equal(tg.indices.asnumpy(),
                                  np.unique(ids.astype(np.int64)))


def test_sparse_grad_becomes_dense_when_added():
    """grad_req "add" accumulates a row-sparse cotangent into the dense
    buffer; a dense use of the table in the same sweep densifies too."""
    ids = nd.array([[1, 4, 1]], ctx=mx.cpu())
    emb = gluon.nn.Embedding(6, 2, sparse_grad=True)
    emb.initialize(ctx=mx.cpu())
    emb.weight.grad_req = "add"
    for _ in range(2):
        with autograd.record():
            out = emb(ids)
        out.backward()
    g = emb.weight.grad()
    assert g.stype == "default"
    np.testing.assert_array_equal(g.asnumpy()[[1, 4, 0]],
                                  [[4, 4], [2, 2], [0, 0]])
    emb.weight.grad_req = "write"
    with autograd.record():
        out = emb(ids).sum() + emb.weight.data().sum()
    out.backward()
    assert emb.weight.grad().stype == "default"
    with autograd.record():
        out = emb(ids)
    out.backward()
    assert emb.weight.grad().stype == "row_sparse"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sgd", "sgd_mom", "adam"])
def test_lazy_update_functions_match_jax(kind, dtype):
    """3 lazy updates: the gradient's rows against the JAX kernels, every
    other row of the weight and the states bitwise unchanged."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(V, E).astype(np.float32)
    rows = np.array([2, 5, 9])
    res = {}
    for pkg, sp in ((mxj, jsp), (mx, tsp)):
        ctx = pkg.cpu()
        w = pkg.nd.array(w0, ctx=ctx).astype(dtype)
        states = [pkg.nd.zeros((V, E), ctx=ctx) for _ in range(
            {"sgd": 0, "sgd_mom": 1, "adam": 2}[kind])]
        for s in states:
            s[:] = 0.25
        g_rng = np.random.RandomState(8)
        for t in range(1, 4):
            g = sp.row_sparse_array(
                (g_rng.randn(3, E).astype(np.float32), rows), shape=(V, E),
                ctx=ctx)
            args = dict(lr=0.1, wd=1e-3, rescale_grad=0.5, clip_gradient=1.0)
            if kind == "sgd":
                sp.sgd_update_rsp(w, g, *args.values())
            elif kind == "sgd_mom":
                sp.sgd_mom_update_rsp(w, states[0], g, 0.1, 0.9, 1e-3, 0.5,
                                      1.0)
            else:
                sp.adam_update_rsp(w, states[0], states[1], g, 0.01 * t, 0.9,
                                   0.999, 1e-8, 1e-3, 0.5, 1.0)
        res[pkg] = [_np(w)] + [_np(s) for s in states]
    others = np.setdiff1d(np.arange(V), rows)
    (jw, *js), (tw, *ts) = res[mxj], res[mx]
    if dtype == "float32":
        np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(jw))) - 7)
        assert (np.abs(tw - jw) <= ulp).all()
    np.testing.assert_array_equal(
        tw[others], np.asarray(nd.array(w0, ctx=mx.cpu()).astype(dtype)
                               .asnumpy())[others])
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(a[others], 0.25)


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01})], ids=["sgd", "sgd_mom", "adam"])
def test_trainer_with_sparse_embedding_matches_jax(opt, params):
    """Embedding(sparse_grad=True) then Dense, 3 imperative iterations of
    `gluon.Trainer` in both packages: the step takes the per-key path,
    the table's rows the lazy update."""
    rng = np.random.RandomState(6)
    batches = [rng.randint(0, V, (2, 4)).astype(np.float32)
               for _ in range(3)]
    w_emb = rng.randn(V, E).astype(np.float32)
    w_out = rng.randn(2, E).astype(np.float32)
    final = {}
    for pkg in (mxj, mx):
        ctx = pkg.cpu()
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(pkg.gluon.nn.Embedding(V, E, sparse_grad=True),
                    pkg.gluon.nn.Dense(2, flatten=False, in_units=E,
                                       use_bias=False))
        net.initialize(ctx=ctx)
        net[0].weight.set_data(pkg.nd.array(w_emb, ctx=ctx))
        net[1].weight.set_data(pkg.nd.array(w_out, ctx=ctx))
        tr = pkg.gluon.Trainer(net.collect_params(), opt, dict(params))
        for b in batches:
            with pkg.autograd.record():
                loss = pkg.nd.square(net(pkg.nd.array(b, ctx=ctx))).sum()
            loss.backward()
            tr.step(2)
        final[pkg] = [_np(net[0].weight.data()), _np(net[1].weight.data())]
    for a, b in zip(final[mx], final[mxj]):
        np.testing.assert_allclose(a, b, **STEP_TOL)
    untouched = np.setdiff1d(np.arange(V), np.concatenate(batches))
    np.testing.assert_array_equal(final[mx][0][untouched], w_emb[untouched])


# ---------------------- counterparts of tests/test_lazy_sparse_update.py
def _build(sparse, optimizer, V=64, E=16):
    mx.random.seed(0)
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Embedding(V, E, sparse_grad=sparse))
        net.add(gluon.nn.Dense(2, flatten=False))
    net.initialize(mx.init.Normal(0.1), ctx=mx.cpu())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    tr = par.ParallelTrainer(
        net, lambda o, y: loss_fn(o.astype("float32"), y),
        optimizer=optimizer,
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9}
        if optimizer == "sgd" else {"learning_rate": 0.1},
        mesh=par.default_mesh(ctx=mx.cpu()))
    return net, tr


def _cpu(a):
    return nd.array(a, ctx=mx.cpu())


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_lazy_rows_match_dense_on_touched_rows(optimizer):
    V = 64
    rng = np.random.RandomState(0)
    x = _cpu(rng.randint(0, 32, (4, 8)).astype(np.float32))
    y = _cpu(rng.randint(0, 2, (4, 8)).astype(np.float32))
    weights = {}
    for sparse in (False, True):
        net, tr = _build(sparse, optimizer)
        for _ in range(3):
            tr.step(x, y)
        assert tr.lazy_params == ([tr.params[0].name] if sparse else [])
        weights[sparse] = tr.params[0].data().asnumpy()
    touched = np.unique(x.asnumpy().astype(np.int64))
    untouched = np.setdiff1d(np.arange(V), touched)
    np.testing.assert_allclose(weights[False][touched],
                               weights[True][touched], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(weights[False][untouched],
                               weights[True][untouched], rtol=0, atol=0)


def test_lazy_untouched_rows_frozen_under_decay():
    """Dense SGD keeps moving rows a step lacks (momentum), the lazy
    update freezes them."""
    rng = np.random.RandomState(1)
    x1 = _cpu(rng.randint(0, 32, (4, 8)).astype(np.float32))
    x2 = _cpu((rng.randint(0, 16, (4, 8)) + 32).astype(np.float32))
    y = _cpu(rng.randint(0, 2, (4, 8)).astype(np.float32))
    final = {}
    for sparse in (False, True):
        net, tr = _build(sparse, "sgd")
        tr.step(x1, y)
        w1 = tr.params[0].data().asnumpy().copy()
        tr.step(x2, y)
        final[sparse] = (w1, tr.params[0].data().asnumpy())
    lo = np.arange(32)
    np.testing.assert_array_equal(final[True][1][lo], final[True][0][lo])
    assert np.abs(final[False][1][lo] - final[False][0][lo]).max() > 1e-6


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_tied_decoder_forces_dense_fallback(optimizer):
    """A table also read by a tied decoder takes the dense update."""
    V, E = 32, 8

    class TiedLM(gluon.HybridBlock):
        def __init__(self, sparse):
            super().__init__()
            with self.name_scope():
                self.emb = gluon.nn.Embedding(V, E, sparse_grad=sparse)

        def hybrid_forward(self, F, x):
            h = self.emb(x)
            w = self.emb.weight.data()    # the tied decoder's read
            return F.FullyConnected(h, w, num_hidden=V, flatten=False,
                                    no_bias=True)

    rng = np.random.RandomState(3)
    x = _cpu(rng.randint(0, 8, (2, 4)).astype(np.float32))
    y = _cpu(rng.randint(0, V, (2, 4)).astype(np.float32))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    weights = {}
    for sparse in (False, True):
        mx.random.seed(0)
        net = TiedLM(sparse)
        net.initialize(mx.init.Normal(0.1), ctx=mx.cpu())
        tr = par.ParallelTrainer(
            net, lambda o, y: loss_fn(o.astype("float32"), y),
            optimizer=optimizer,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9}
            if optimizer == "sgd" else {"learning_rate": 0.1},
            mesh=par.default_mesh(ctx=mx.cpu()))
        for _ in range(2):
            tr.step(x, y)
        assert tr.lazy_params == []
        weights[sparse] = tr.params[0].data().asnumpy()
    np.testing.assert_allclose(weights[False], weights[True], rtol=2e-5,
                               atol=2e-5)


def test_rows_recorded_only_for_sparse_grad_params():
    net, _tr = _build(True, "sgd")
    x = _cpu(np.zeros((2, 4), np.float32))
    net(x)
    params = list(net.collect_params().values())
    with record_rows(params, {}) as rows:
        net(x)
    assert list(rows) == [0]
    assert rows[0].shape == (8,)
    assert params[0]._rows_lookups == 1 == params[0]._trace_reads
    assert params[0]._rows_sink is None
    out = net(x)                      # nothing recorded outside the scope
    assert out.shape == (2, 4, 2) and list(rows) == [0]


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_lazy_parallel_trainer_matches_jax(optimizer):
    """The lazy step in both packages from the same weights and batch."""
    from incubator_mxnet_tpu import parallel as jpar
    from incubator_mxnet_torch.convert import params_from_jax
    rng = np.random.RandomState(0)
    x = rng.randint(0, 32, (4, 8)).astype(np.float32)
    y = rng.randint(0, 2, (4, 8)).astype(np.float32)
    mxj.random.seed(0)
    jnet = mxj.gluon.nn.HybridSequential()
    with jnet.name_scope():
        jnet.add(mxj.gluon.nn.Embedding(64, 16, sparse_grad=True))
        jnet.add(mxj.gluon.nn.Dense(2, flatten=False))
    jnet.initialize(mxj.init.Normal(0.1), ctx=mxj.cpu())
    jnet(mxj.nd.array(x, ctx=mxj.cpu()))
    jl = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    params = ({"learning_rate": 0.1, "momentum": 0.9} if optimizer == "sgd"
              else {"learning_rate": 0.1})
    jtr = jpar.ParallelTrainer(jnet, lambda o, t: jl(o.astype("float32"), t),
                               optimizer=optimizer, optimizer_params=params,
                               mesh=jpar.default_mesh(1))
    net, tr = _build(True, optimizer)
    net(_cpu(x))
    params_from_jax(net, {k: v.data().asnumpy() for k, v in
                          jnet._collect_params_with_prefix().items()})
    jd = [mxj.nd.array(a, ctx=mxj.cpu()) for a in (x, y)]
    for _ in range(3):
        jloss = float(jtr.step(*jd).asnumpy())
        tloss = tr.step(_cpu(x), _cpu(y)).asscalar()
        np.testing.assert_allclose(tloss, jloss, rtol=STEP_TOL["rtol"])
    for k, p in jnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(
            net._collect_params_with_prefix()[k].data().asnumpy(),
            p.data().asnumpy(), err_msg=k, rtol=STEP_TOL["rtol"], atol=1e-5)
