"""The port's int8 path against the JAX package's on the CPU: the 18
quantized op names, `calib_threshold`, `quantize_net` (native and fake)
and `quantize_model`, with the same numpy inputs and float weights.

The port's ops take their plain versions here (CPU tensors), which widen
int8 to float64 for the products (exact); the JAX ops are XLA's int8
products with int32 accumulation.  Tolerances, with their reasons:

- int8 and int32 outputs and the (min, max) ranges: equal;
- float outputs of one op: 1e-6 relative to the largest value (the same
  float32 operations in the same order; the bfloat16 ones are one
  rounding of equal float32 values, so equal too);
- thresholds, int8 weights and scales of `quantize_net`: equal where the
  calibration samples are equal; a layer fed by float layers (the
  Dense after GlobalAvgPool, every Dense of BERT after LayerNorm and
  GELU) sees activations that XLA's and PyTorch's float32 kernels round
  differently by an ulp or so, so its threshold is held to 1e-6
  relative;
- a quantized net's logits: 1e-5 relative to the largest logit (the
  CNN: int8 layers equal, one float32 mean between them; `bert_tiny`:
  LayerNorm, GELU and softmax in float32 between the int8 layers, which
  XLA and PyTorch round apart by an ulp or so).  An int8 value of the
  two packages may differ by one step where such an activation lands
  within an ulp of a rounding boundary; at these inputs none does
  (logits ~1e-7 apart), at other seeds one such step moved the logits
  by up to 6e-3 of the largest (1 seed of 4 tried).  The mechanism is
  held apart: at least 99% of the int8 activations of the first qkv
  product equal.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (the JAX package needs jax loaded)
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.contrib import quantization as jq

import incubator_mxnet_torch as mxt
from incubator_mxnet_torch.contrib import quantization as tq
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.ndarray import NDArray
from incubator_mxnet_torch.ops import registry as TR
from incubator_mxnet_torch.ops import quantized as tqops

F_RTOL = 1e-6


def _q8(rng, shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


# name: (positional arrays, keyword arrays, attributes, bf16 data)
def _cases():
    r = np.random.RandomState(11)
    x = (r.randn(3, 5, 7) * 3).astype(np.float32)
    img = (r.randn(2, 4, 9, 9) * 2).astype(np.float32)
    rng3 = [np.float32(v) for v in (-1.5, 2.0, -0.7, 0.4, -0.3, 0.9)]
    return {
        "_contrib_quantize_v2": ([x], {}, {}, False),
        "quantize_v2": ([x], {}, {"min_calib_range": -2.5,
                                  "max_calib_range": 3.0}, False),
        "_contrib_dequantize": ([_q8(r, (4, 6)), rng3[0], rng3[1]], {}, {},
                                False),
        "dequantize": ([(r.randint(-2 ** 30, 2 ** 30, (4, 6))
                         .astype(np.int32)), rng3[2], rng3[3]], {}, {},
                       False),
        "_contrib_requantize": ([r.randint(-2 ** 28, 2 ** 28, (5, 6))
                                 .astype(np.int32), rng3[0], rng3[1]],
                                {}, {}, False),
        "requantize": ([r.randint(-2 ** 28, 2 ** 28, (5, 6))
                        .astype(np.int32), rng3[0], rng3[1]], {},
                       {"min_calib_range": -0.5, "max_calib_range": 0.8},
                       False),
        "_contrib_quantized_conv": (
            [_q8(r, (2, 4, 9, 9)), _q8(r, (6, 4, 3, 3)), _q8(r, (6,)),
             *rng3], {},
            {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
             "num_filter": 6, "no_bias": False}, False),
        "quantized_conv": (
            [_q8(r, (2, 4, 9, 9)), _q8(r, (6, 2, 3, 3))],
            {"min_data": rng3[0], "max_data": rng3[1],
             "min_weight": rng3[2], "max_weight": rng3[3]},
            {"kernel": (3, 3), "dilate": (2, 2), "num_group": 2,
             "num_filter": 6}, False),
        "_contrib_quantized_fully_connected": (
            [_q8(r, (5, 2, 3, 4)), _q8(r, (7, 24)), _q8(r, (7,)), *rng3],
            {}, {"num_hidden": 7, "no_bias": False}, False),
        "quantized_fully_connected": (
            [_q8(r, (5, 3, 24)), _q8(r, (4, 24)), None, *rng3[:4]],
            {}, {"num_hidden": 4, "flatten": False}, False),
        "_contrib_quantized_pooling": (
            [_q8(r, (2, 3, 7, 7)), rng3[0], rng3[1]], {},
            {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
             "pool_type": "avg", "count_include_pad": False}, False),
        "quantized_pooling": (
            [_q8(r, (2, 3, 8, 8)), rng3[0], rng3[1]], {},
            {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
             "pool_type": "max", "pooling_convention": "full"}, False),
        "_contrib_quantized_act": ([_q8(r, (3, 8)), rng3[0], rng3[1]], {},
                                   {}, False),
        "quantized_act": ([_q8(r, (2, 3, 4)), rng3[2], rng3[3]], {}, {},
                          False),
        "_contrib_quantized_flatten": ([_q8(r, (2, 3, 4)), rng3[0],
                                        rng3[1]], {}, {}, False),
        "quantized_flatten": ([_q8(r, (3, 2, 2, 2)), rng3[2], rng3[3]], {},
                              {}, False),
        "_quantized_conv_pc": (
            [img, _q8(r, (8, 4, 3, 3)),
             r.uniform(0.002, 0.02, 8).astype(np.float32),
             r.randn(8).astype(np.float32)], {},
            {"kernel": (3, 3), "stride": (1, 2), "pad": (1, 0),
             "relu": True}, True),
        "_quantized_dense_pc": (
            [x, _q8(r, (6, 7)),
             r.uniform(0.002, 0.02, 6).astype(np.float32),
             r.randn(6).astype(np.float32)], {},
            {"flatten": False, "act_threshold": 4.0}, True),
    }


CASES = _cases()


def test_every_quantized_name_has_a_case():
    from incubator_mxnet_tpu.ops import registry as JR
    names = {n for n, op in JR._REGISTRY.items()
             if op.impl.__module__.endswith(".quantized")}
    assert names == set(CASES) and len(names) == 18


def _jx(a, bf16=False):
    if a is None:
        return None
    arr = mxj.nd.array(a, ctx=mxj.cpu(), dtype=np.asarray(a).dtype)
    return arr.astype("bfloat16") if bf16 else arr


def _tx(a, bf16=False):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return NDArray(t.to(torch.bfloat16) if bf16 else t)


def _outs(o):
    o = list(o) if isinstance(o, (tuple, list)) else [o]
    return [np.asarray(v.asnumpy()) for v in o]


def _compare(got, ref, what):
    assert len(got) == len(ref), what
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, (what, i, g.shape, r.shape)
        if r.dtype.kind in "iu":
            assert g.dtype == r.dtype, (what, i, g.dtype, r.dtype)
            np.testing.assert_array_equal(g, r, err_msg=f"{what} {i}")
        else:
            r64, g64 = r.astype(np.float64), g.astype(np.float64)
            scale = max(np.abs(r64).max(initial=0.0), 1e-30)
            np.testing.assert_allclose(g64, r64, rtol=0,
                                       atol=F_RTOL * scale,
                                       err_msg=f"{what} {i}")


def _run_both(name, data_bf16=False):
    args, kw_arrays, attrs, _ = CASES[name]
    first = lambda i: data_bf16 and i == 0   # noqa: E731
    jargs = [_jx(a, first(i)) for i, a in enumerate(args)]
    targs = [_tx(a, first(i)) for i, a in enumerate(args)]
    ref = getattr(mxj.nd, name)(*jargs, **{k: _jx(v) for k, v in
                                           kw_arrays.items()}, **attrs)
    got = TR.apply_op(name, *targs, **{k: _tx(v) for k, v in
                                       kw_arrays.items()}, **attrs)
    return _outs(got), _outs(ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    got, ref = _run_both(name)
    _compare(got, ref, name)


@pytest.mark.parametrize("name", sorted(n for n in CASES if CASES[n][3]))
def test_fused_op_bfloat16_matches_jax(name):
    got, ref = _run_both(name, data_bf16=True)
    assert "bfloat16" in str(ref[0].dtype)
    _compare([g.astype(np.float32) for g in got],
             [r.astype(np.float32) for r in ref], name)


def test_fused_ops_dynamic_scale_match_jax():
    """Without a threshold the activation's scale is its absolute max."""
    r = np.random.RandomState(3)
    x = (r.randn(4, 1, 5) * 7).astype(np.float32)
    w = _q8(r, (9, 5))
    s = r.uniform(0.001, 0.01, 9).astype(np.float32)
    ref = mxj.nd._quantized_dense_pc(_jx(x), _jx(w), _jx(s), None)
    got = TR.apply_op("_quantized_dense_pc", _tx(x), _tx(w), _tx(s), None)
    _compare(_outs(got), _outs(ref), "dense_pc dynamic")


def test_plain_versions_widen_before_the_product():
    """int8 x int8 products that wrap in int8 are exact in the plain
    version (the kernels' reference): 127 * 127 * K in int32."""
    q = torch.full((2, 64), 127, dtype=torch.int8)
    w = torch.full((3, 64), 127, dtype=torch.int8)
    out = tqops.igemm_plain(q, w)
    assert out.dtype == torch.int32 and int(out[0, 0]) == 127 * 127 * 64
    qc = torch.full((1, 3, 7, 7), -127, dtype=torch.int8)
    wc = torch.full((4, 3, 7, 7), 127, dtype=torch.int8)
    outc = tqops.igemm_plain(qc, wc, ((2, 2), (0, 0), (1, 1), 1))
    assert outc.shape == (1, 4, 1, 1)
    assert int(outc[0, 0, 0, 0]) == -127 * 127 * 147


def test_quantize_rounds_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.5], dtype=torch.float32)
    q, scale, amax = tqops.int8_quantize(x, 127.0)
    assert float(scale) == 1.0 and float(amax) == 127.0
    assert q.tolist() == [0, 2, 2, 0, -2, 126]
    q2, _, _ = tqops.int8_quantize(torch.tensor([300.0, -300.0]), 127.0)
    assert q2.tolist() == [127, -127]


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_calib_threshold_matches_jax(mode):
    rng = np.random.RandomState(8)
    samples = [np.concatenate([rng.randn(20000) * 0.2,
                               rng.uniform(2.0, 3.0, 2000)]),
               (rng.randn(3000) * 0.5).astype(np.float32)]
    assert tq.calib_threshold(samples, mode) == \
        jq.calib_threshold(samples, mode)


def test_quantize_weight_helpers_match_jax():
    rng = np.random.RandomState(2)
    w = (rng.randn(6, 3, 3, 3) * 0.3).astype(np.float32)
    jqw, js = jq.quantize_weight_per_channel(mxj.nd.array(w, ctx=mxj.cpu()))
    tqw, ts = tq.quantize_weight_per_channel(mxt.nd.array(w, ctx=mxt.cpu()))
    assert tqw.dtype == np.int8 and tqw.context == mxt.cpu()
    np.testing.assert_array_equal(tqw.asnumpy(), jqw.asnumpy())
    np.testing.assert_array_equal(ts.asnumpy(), js.asnumpy())
    jf, jscale = jq.quantize_weight(mxj.nd.array(w, ctx=mxj.cpu()))
    tf, tscale = tq.quantize_weight(mxt.nd.array(w, ctx=mxt.cpu()))
    assert tscale == jscale
    np.testing.assert_array_equal(tf.asnumpy(), jf.asnumpy())


# ---------------------------------------------------------------------
# quantize_net
# ---------------------------------------------------------------------

def _example_cnn(pkg):
    """The quantization example's CNN."""
    g = pkg.gluon
    net = g.nn.HybridSequential()
    net.add(g.nn.Conv2D(16, 3, padding=1, activation="relu"),
            g.nn.MaxPool2D(2),
            g.nn.Conv2D(32, 3, padding=1, activation="relu"),
            g.nn.GlobalAvgPool2D(),
            g.nn.Dense(4))
    return net


def _twins(make, x_shape, seed=0):
    """The same net in both packages with the JAX weights, and its
    input."""
    x = np.random.RandomState(seed).rand(*x_shape).astype(np.float32)
    mxj.random.seed(seed)
    jnet = make(mxj)
    jnet.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    jx = mxj.nd.array(x, ctx=mxj.cpu())
    jnet(jx)
    with mxt.cpu():
        tnet = make(mxt)
        tnet.initialize(mxt.init.Xavier())
        tx = mxt.nd.array(x)
        tnet(tx)
    params_from_jax(tnet, {k: v.data().asnumpy() for k, v in
                           jnet._collect_params_with_prefix().items()})
    return jnet, jx, tnet, tx


def _quantized_layers(net):
    out = []

    def walk(b):
        for c in b._children.values():
            if type(c).__name__ == "_QuantizedLayer":
                out.append(c)
            walk(c)
    walk(net)
    return out


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_quantize_net_cnn_matches_jax(mode):
    jnet, jx, tnet, tx = _twins(_example_cnn, (16, 1, 12, 12))
    jq.quantize_net(jnet, calib_data=[jx], calib_mode=mode,
                    num_calib_batches=1)
    with mxt.cpu():
        tq.quantize_net(tnet, calib_data=[tx], calib_mode=mode,
                        num_calib_batches=1)
        got = tnet(tx).asnumpy()
    ref = jnet(jx).asnumpy()
    jl, tl = _quantized_layers(jnet), _quantized_layers(tnet)
    assert len(jl) == len(tl) == 3
    for i, (a, b) in enumerate(zip(jl, tl)):
        np.testing.assert_array_equal(b._qw.asnumpy(), a._qw.asnumpy())
        np.testing.assert_array_equal(b._wscale.asnumpy(),
                                      a._wscale.asnumpy())
        if i < 2:            # int8 layers and max-pool before them: equal
            assert b.act_threshold == a.act_threshold, i
        else:
            assert b.act_threshold == pytest.approx(a.act_threshold,
                                                    rel=F_RTOL)
    assert _rel(got, ref) <= 1e-5


def test_quantize_net_fake_matches_jax():
    jnet, jx, tnet, tx = _twins(_example_cnn, (8, 1, 12, 12), seed=1)
    jq.quantize_net(jnet, backend="fake")
    with mxt.cpu():
        tq.quantize_net(tnet, backend="fake")
        got = tnet(tx).asnumpy()
    assert any(isinstance(b, mxt.gluon.nn.Conv2D)
               for b in tnet._children.values())
    for k, p in jnet._collect_params_with_prefix().items():
        np.testing.assert_array_equal(
            tnet._collect_params_with_prefix()[k].data().asnumpy(),
            p.data().asnumpy(), err_msg=k)
    assert _rel(got, jnet(jx).asnumpy()) <= 1e-5


def test_quantize_net_shared_block_swapped_everywhere():
    def make(pkg):
        shared = pkg.gluon.nn.Dense(8, activation="relu", flatten=False)
        net = pkg.gluon.nn.HybridSequential()
        net.add(shared, shared, pkg.gluon.nn.Dense(3, flatten=False))
        return net
    jnet, jx, tnet, tx = _twins(make, (4, 8), seed=10)
    jq.quantize_net(jnet)
    with mxt.cpu():
        tq.quantize_net(tnet)
        got = tnet(tx).asnumpy()
    c = list(tnet._children.values())
    assert [type(b).__name__ for b in c].count("_QuantizedLayer") == 3
    assert c[0] is c[1]
    # dynamic scales: both packages quantize the same batch the same way
    assert _rel(got, jnet(jx).asnumpy()) <= 1e-5


def test_quantize_net_rejects_uint8_and_uninitialized():
    with mxt.cpu():
        net = mxt.gluon.nn.HybridSequential()
        net.add(mxt.gluon.nn.Dense(2))
        net.initialize()
        with pytest.raises(mxt.base.MXNetError, match="int8"):
            tq.quantize_net(net, quantized_dtype="uint8")
        fresh = mxt.gluon.nn.HybridSequential()
        fresh.add(mxt.gluon.nn.Dense(2))
        with pytest.raises(mxt.base.MXNetError, match="uninitialized"):
            tq.quantize_net(fresh)


def test_quantized_avg_pool_excludes_pad():
    x = np.ones((1, 1, 4, 4), np.float32)
    with mxt.cpu():
        qx, mn, mx_ = mxt.nd._contrib_quantize_v2(mxt.nd.array(x))
        p, pmn, pmx = mxt.nd._contrib_quantized_pooling(
            qx, mn, mx_, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
            pool_type="avg", count_include_pad=False)
        got = mxt.nd._contrib_dequantize(p, pmn, pmx).asnumpy()
    np.testing.assert_allclose(got, np.ones_like(got), atol=0.01)


def _bert_tiny(pkg):
    from importlib import import_module
    bert = import_module(pkg.__name__ + ".models.bert")
    return bert.BERTClassifier(
        bert.get_bert_model("bert_tiny", vocab_size=100, max_length=16,
                            dropout=0.0), num_classes=2, dropout=0.0)


@pytest.mark.parametrize("backend", ["native", "fake"])
def test_quantize_net_bert_tiny_matches_jax(backend):
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 100, (8, 16)).astype(np.float32)
    mxj.random.seed(0)
    jnet = _bert_tiny(mxj)
    jnet.initialize(mxj.init.Normal(0.05), ctx=mxj.cpu())
    jx = mxj.nd.array(toks, ctx=mxj.cpu())
    jnet(jx)
    with mxt.cpu():
        tnet = _bert_tiny(mxt)
        tnet.initialize(mxt.init.Normal(0.05))
        tx = mxt.nd.array(toks)
        tnet(tx)
    params_from_jax(tnet, {k: v.data().asnumpy() for k, v in
                           jnet._collect_params_with_prefix().items()})
    jq.quantize_net(jnet, calib_data=[jx], num_calib_batches=1,
                    backend=backend)
    with mxt.cpu():
        tq.quantize_net(tnet, calib_data=[tx], num_calib_batches=1,
                        backend=backend)
        got = tnet(tx).asnumpy()
    ref = jnet(jx).asnumpy()
    assert _rel(got, ref) <= 1e-5
    if backend == "fake":
        for k, p in jnet._collect_params_with_prefix().items():
            np.testing.assert_array_equal(
                tnet._collect_params_with_prefix()[k].data().asnumpy(),
                p.data().asnumpy(), err_msg=k)
        return
    jl, tl = _quantized_layers(jnet), _quantized_layers(tnet)
    assert len(jl) == len(tl) == 2 * 4 + 2
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b._qw.asnumpy(), a._qw.asnumpy())
        np.testing.assert_array_equal(b._wscale.asnumpy(),
                                      a._wscale.asnumpy())
        assert b.act_threshold == pytest.approx(a.act_threshold, rel=F_RTOL)
    # the first qkv product's int8 activations: the same embedding sum
    # and LayerNorm in float32 on both sides, then one quantization
    emb = jnet.bert.embed_ln(jnet.bert.word_embed(jx)
                             + jnet.bert.position_embed.data()
                             .expand_dims(0)).asnumpy()
    with mxt.cpu():
        temb = tnet.bert.embed_ln(tnet.bert.word_embed(tx)
                                  + tnet.bert.position_embed.data()
                                  .expand_dims(0)).asnumpy()
    thr = tl[0].act_threshold
    jqa = np.asarray(mxj.nd._contrib_quantize_v2(
        mxj.nd.array(emb, ctx=mxj.cpu()), min_calib_range=-thr,
        max_calib_range=thr)[0].asnumpy())
    tqa = tqops.int8_quantize(torch.from_numpy(temb), thr)[0].numpy()
    assert (jqa == tqa).mean() >= 0.99


# ---------------------------------------------------------------------
# quantize_model
# ---------------------------------------------------------------------

def _conv_fc(pkg):
    s = pkg.sym.var("data")
    s = pkg.sym.Convolution(s, kernel=(3, 3), num_filter=8, pad=(1, 1),
                            name="conv1")
    s = pkg.sym.Activation(s, act_type="relu", name="relu1")
    return pkg.sym.FullyConnected(s, num_hidden=10, name="fc1")


def _conv_fc_args():
    from incubator_mxnet_torch.symbol import symbol as tsym
    from incubator_mxnet_tpu.symbol import symbol as jsym
    jsym._COUNTER.table = {}
    tsym._COUNTER.table = {}
    jsymbol, tsymbol = _conv_fc(mxj), _conv_fc(mxt)
    rng = np.random.RandomState(7)
    shapes, _, _ = jsymbol.infer_shape(data=(2, 3, 8, 8))
    args = {n: (rng.randn(*s) * 0.2).astype(np.float32)
            for n, s in zip(jsymbol.list_arguments(), shapes) if n != "data"}
    x = rng.rand(2, 3, 8, 8).astype(np.float32)
    return jsymbol, tsymbol, args, x


def test_quantize_model_matches_jax():
    jsymbol, tsymbol, args, x = _conv_fc_args()
    jqs, jqa, _ = jq.quantize_model(
        jsymbol, {k: mxj.nd.array(v, ctx=mxj.cpu()) for k, v in
                  args.items()}, {})
    with mxt.cpu():
        tqs, tqa, _ = tq.quantize_model(
            tsymbol, {k: mxt.nd.array(v) for k, v in args.items()}, {})
    assert [n._op for n in tqs._topo()] == [n._op for n in jqs._topo()]
    assert [n._name for n in tqs._topo()] == [n._name for n in jqs._topo()]
    assert sorted(tqa) == sorted(jqa)
    for k in jqa:
        a, b = jqa[k].asnumpy(), tqa[k].asnumpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    ref = jqs.eval_with({**jqa, "data": mxj.nd.array(x, ctx=mxj.cpu())})
    with mxt.cpu():
        got = tqs.eval_with({**tqa, "data": mxt.nd.array(x)})
    _compare(_outs(got), _outs(ref), "quantize_model")
    _, qargs2, _ = tq.quantize_model(
        tsymbol, {k: mxt.nd.array(v, ctx=mxt.cpu())
                  for k, v in args.items()}, {},
        excluded_sym_names=("conv1",))
    assert "conv1_weight" in qargs2 and "fc1_weight_quantized" in qargs2
    with pytest.raises(mxt.base.MXNetError, match="int8"):
        tq.quantize_model(tsymbol, {}, {}, quantized_dtype="uint8")


def test_jax_quantized_symbol_and_params_load_in_the_port(tmp_path):
    """A `-quantized-symbol.json` and `.params` written by the JAX
    package load in the port with their int8 dtypes and evaluate to the
    JAX result."""
    jsymbol, _, args, x = _conv_fc_args()
    jqs, jqa, _ = jq.quantize_model(
        jsymbol, {k: mxj.nd.array(v, ctx=mxj.cpu()) for k, v in
                  args.items()}, {})
    prefix = str(tmp_path / "net")
    jqs.save(prefix + "-quantized-symbol.json")
    mxj.nd.save(prefix + "-quantized-0000.params",
                {f"arg:{k}": v for k, v in jqa.items()})
    ref = jqs.eval_with({**jqa, "data": mxj.nd.array(x, ctx=mxj.cpu())})
    with mxt.cpu():
        sym = mxt.sym.load(prefix + "-quantized-symbol.json")
        loaded = mxt.nd.load(prefix + "-quantized-0000.params")
        params = {k.split(":", 1)[1]: v for k, v in loaded.items()}
        assert params["conv1_weight_quantized"].dtype == np.int8
        assert params["fc1_weight_min"].dtype == np.float32
        got = sym.eval_with({**params, "data": mxt.nd.array(x)})
    _compare(_outs(got), _outs(ref), "loaded quantized symbol")


def test_quantize_model_shared_weight():
    data, w = mxt.sym.var("data"), mxt.sym.var("w")
    out = mxt.sym.FullyConnected(data, w, num_hidden=6, no_bias=True,
                                 name="fca") + \
        mxt.sym.FullyConnected(data, w, num_hidden=6, no_bias=True,
                               name="fcb")
    rng = np.random.RandomState(9)
    with mxt.cpu():
        args = {"w": mxt.nd.array(rng.randn(6, 4).astype(np.float32))}
        x = mxt.nd.array(rng.randn(2, 4).astype(np.float32))
        want = out.eval_with({**args, "data": x}).asnumpy()
        qsym, qargs, _ = tq.quantize_model(out, args, {})
        assert "w_quantized" in qargs and "w" not in qargs
        got = qsym.eval_with({**qargs, "data": x}).asnumpy()
    assert np.abs(got - want).max() < 0.05 * np.abs(want).max()


# ---------------------------------------------------------------------
# the task-level gate at bert_tiny size
# ---------------------------------------------------------------------

def test_int8_bert_accuracy_within_one_percent():
    """The port's counterpart of the JAX gate: a trained bert_tiny
    classifier quantized with one static-calibration batch loses < 1%
    held-out accuracy; every Dense (qkv, proj, ffn, pooler, classifier)
    runs as a fused int8 layer."""
    from incubator_mxnet_torch import autograd, gluon, nd
    from incubator_mxnet_torch.models.bert import (BERTClassifier,
                                                   get_bert_model)

    mxt.seed(3)
    rng = np.random.RandomState(3)
    V, T, ntrain, ntest = 100, 16, 512, 256

    def make_xy(n):
        y = rng.randint(0, 2, n)
        toks = np.where(y[:, None] == 0,
                        rng.randint(0, V // 2, (n, T)),
                        rng.randint(V // 2, V, (n, T)))
        return toks.astype(np.float32), y.astype(np.float32)

    Xtr, Ytr = make_xy(ntrain)
    Xte, Yte = make_xy(ntest)
    with mxt.cpu():
        net = BERTClassifier(get_bert_model("bert_tiny", vocab_size=V,
                                            max_length=T, dropout=0.0),
                             num_classes=2, dropout=0.0)
        net.initialize(mxt.init.Normal(0.05))
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
        batch = 64
        for _epoch in range(2):
            for i in range(0, ntrain, batch):
                xb, yb = nd.array(Xtr[i:i + batch]), nd.array(Ytr[i:i + batch])
                with autograd.record():
                    loss = loss_fn(net(xb), yb)
                loss.backward()
                trainer.step(batch)

        def accuracy(model):
            out = model(nd.array(Xte)).asnumpy()
            return float((out.argmax(1) == Yte).mean())

        acc_f = accuracy(net)
        assert acc_f >= 0.95, f"float model failed to train ({acc_f})"
        qnet = tq.quantize_net(net, calib_data=[nd.array(Xtr[:64])],
                               calib_mode="naive", num_calib_batches=1)
        assert len(_quantized_layers(qnet)) == 10
        acc_q = accuracy(qnet)
    assert acc_f - acc_q < 0.01, (acc_f, acc_q)


# ---------------------------------------------------------------------
# serving a quantized net
# ---------------------------------------------------------------------

def test_quantized_bert_is_served_like_a_lone_forward(tmp_path):
    """A calibrated `quantize_net` classifier exported with
    `deploy.export_serving` (its int8 layers in `int8.npz`), loaded by
    `serving.ServingRuntime` and asked over HTTP: each answer equals a
    lone forward of the same rows through the quantized net (static
    thresholds: a row's int8 values do not depend on its batch-mates).
    Equal to 1e-6 of the largest logit: the served batch is padded to
    its capacity, so the float32 products between the int8 layers run
    at another batch size."""
    import json
    import urllib.request
    from incubator_mxnet_torch import deploy
    from incubator_mxnet_torch.models import get_model
    from incubator_mxnet_torch.serving import ServeConfig, ServingRuntime

    rng = np.random.RandomState(6)
    T, cap = 16, 8
    with mxt.cpu():
        mxt.seed(0)
        net = get_model("bert_classifier", model_name="bert_tiny",
                        num_classes=2, dropout=0.0, vocab_size=100,
                        max_length=T)
        net.initialize(mxt.init.Normal(0.05))
        calib = rng.randint(0, 100, (cap, T)).astype(np.float32)
        net(mxt.nd.array(calib))
        tq.quantize_net(net, calib_data=[mxt.nd.array(calib)],
                        num_calib_batches=1)
        art = str(tmp_path / "art")
        deploy.export_serving(net, [calib], art)
        with open(os.path.join(art, "meta.json")) as f:
            assert len(json.load(f)["int8"]) == 10
    rt = ServingRuntime(art, ServeConfig(concurrency=1), ctx=mxt.cpu())
    try:
        port = rt.start(0, "127.0.0.1")
        assert len(_quantized_layers(rt._slot.model.block)) == 10
        for n in (1, 3, 8):
            rows = rng.randint(0, 100, (n, T)).astype(np.float32)
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict",
                data=json.dumps({"inputs": [rows.tolist()]}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                got = np.asarray(json.loads(r.read())["outputs"][0],
                                 np.float32)
            with mxt.cpu(), torch.no_grad():
                ref = net(mxt.nd.array(rows)).asnumpy()
            assert got.shape == (n, 2)
            _compare([got], [ref], f"served {n} rows")
    finally:
        rt.close()


def _division_edge_values(n=12):
    """float32 amax values whose max(amax, 1e-12) / 127 differs between a
    true division and a multiplication by float32(1 / 127)."""
    a = (np.random.RandomState(0).rand(4000) * 10).astype(np.float32)
    true_div = a / np.float32(127)
    recip = a * (np.float32(1) / np.float32(127))
    return a[np.nonzero(true_div != recip)[0][:n]]


def test_scales_divide_as_the_jax_package_does():
    """XLA folds a division of a run-time amax by 127 into a
    multiplication by float32(1 / 127) and folds a static threshold's
    scale exactly; the port's ops equal the JAX ops bit for bit at amax
    values where the two differ (dequantize of q = 1 is its scale; a
    fused dense of one row by a unit weight gives 127 * scale)."""
    one = np.ones((1,), np.int8)
    unit = np.ones((1, 1), np.int8)
    wsc = np.ones((1,), np.float32)
    for v in _division_edge_values():
        lo, hi = np.float32(-v), np.float32(v)
        x = np.array([[v]], np.float32)
        cases = [("_contrib_dequantize", [one, lo, hi], {}),
                 ("_quantized_dense_pc", [x, unit, wsc, None], {}),
                 ("_quantized_dense_pc", [x, unit, wsc, None],
                  {"act_threshold": float(v)})]
        for name, args, attrs in cases:
            ref = getattr(mxj.nd, name)(*[_jx(a) for a in args], **attrs)
            got = TR.apply_op(name, *[_tx(a) for a in args], **attrs)
            np.testing.assert_array_equal(_outs(got)[0], _outs(ref)[0],
                                          err_msg=f"{name} {attrs} {v!r}")


# ---------------------------------------------------------------------
# the shape router of `int8_igemm` (`quantized.igemm_form`)
# ---------------------------------------------------------------------

def _forms_of_forward(monkeypatch, net, *inputs):
    """The device kernel each int8 product of one forward of the
    quantized `net` would take on the card, by `igemm_form` on the shapes
    the fused ops hand the wrappers (the CPU runs the plain versions)."""
    forms = []
    conv, dense = tqops.int8_conv, tqops.int8_dense

    def rec_conv(q, w, stride, pad, dilate, groups=1, **kw):
        forms.append(tqops.igemm_form(conv=(
            q.shape[1], groups, tuple(w.shape[2:]), tuple(stride),
            tuple(pad))))
        return conv(q, w, stride, pad, dilate, groups, **kw)

    def rec_dense(q, w, **kw):
        forms.append(tqops.igemm_form(q.shape[-1]))
        return dense(q, w, **kw)
    monkeypatch.setattr(tqops, "int8_conv", rec_conv)
    monkeypatch.setattr(tqops, "int8_dense", rec_dense)
    net(*inputs)
    return {f: forms.count(f) for f in sorted(set(forms))}


def test_igemm_router_maps_resnet50_and_bert_base(monkeypatch):
    """ResNet-50 v1b's 54 int8 layers and BERT-base's 50 products each
    map to their device kernel: the 33 pointwise convolutions, the
    classifier and the 50 Dense products to `igemm_wgmma`, the 16 3x3
    and 3 strided 1x1 convolutions to `igemm_conv_wgmma`, the stem
    (3 channels) to the byte gather `igemm_kernel<1>`."""
    from incubator_mxnet_torch import nd
    from incubator_mxnet_torch.gluon.model_zoo.vision import get_model
    from incubator_mxnet_torch.models import get_model as get_text_model
    with mxt.cpu():
        net = get_model("resnet50_v1b", classes=1000)
        net.initialize(mxt.init.Xavier())
        x = nd.array(np.random.RandomState(0).uniform(
            size=(1, 3, 32, 32)).astype(np.float32))
        net(x)
        tq.quantize_net(net)
        resnet = _forms_of_forward(monkeypatch, net, x)
        bert = get_text_model("bert_classifier", model_name="bert_12_768_12",
                              num_classes=2, dropout=0.0, max_length=8)
        bert.initialize(mxt.init.Normal(0.02))
        z = nd.array(np.zeros((1, 8), np.float32))
        bert(z, z)
        tq.quantize_net(bert)
        monkeypatch.undo()
        text = _forms_of_forward(monkeypatch, bert, z, z)
    assert resnet == {"igemm_conv_wgmma": 19, "igemm_kernel<1>": 1,
                      "igemm_wgmma": 34}
    assert text == {"igemm_wgmma": 50}


@pytest.mark.parametrize("args,form", [
    ((147,), "igemm_kernel<0>"),
    ((768,), "igemm_wgmma"),
    ((768, None, False), "igemm_kernel<0>"),
    ((None, (64, 1, (3, 3), (1, 1), (1, 1))), "igemm_conv_wgmma"),
    ((None, (64, 1, (1, 1), (1, 1), (0, 0))), "igemm_wgmma"),
    ((None, (64, 1, (1, 1), (1, 1), (0, 0)), False), "igemm_kernel<1>"),
    ((None, (128, 32, (3, 3), (1, 1), (1, 1))), "igemm_kernel<1>"),
    ((None, (256, 16, (3, 3), (1, 1), (1, 1))), "igemm_kernel<2>")],
    ids=["ragged-k", "dense", "unaligned", "3x3", "pointwise",
         "unaligned-conv", "few-channel-groups", "nhwc-groups"])
def test_igemm_router_edge_forms(args, form):
    assert tqops.igemm_form(*args) == form


def test_igemm_forms_are_the_entries_form_indices():
    """The wrappers pass the kernel's entries `IGEMM_FORMS.index(form)`:
    the order is that of `IgemmForm` in csrc/int8_gemm.cu."""
    import re
    src = os.path.join(os.path.dirname(tqops.__file__), os.pardir, "csrc",
                       "int8_gemm.cu")
    with open(src) as f:
        body = re.search(r"enum IgemmForm \{(.*?)\};", f.read(), re.S)[1]
    forms = re.findall(r"k\w+ = (\d+),\s*// (\S+):", body)
    assert [(int(i), name) for i, name in forms] == \
        list(enumerate(tqops.IGEMM_FORMS))
