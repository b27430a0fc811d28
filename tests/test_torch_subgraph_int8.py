"""The int8 subgraph backend (`contrib.quantization.INT8SubgraphProperty`
on `subgraph.partition_graph`) in the port: the three cases of the JAX
package's `tests/test_subgraph.py`, and the partitioned graph's output
against the JAX package's on the same inputs and weights.

Tolerances: the port's partitioned int8 graph against its float graph
0.1 of the largest value (runtime min/max ranges, 7-bit weights), as the
JAX test holds; against the JAX package's partitioned graph 1e-6 of the
largest value (the same int8 arithmetic, equal int32 accumulators, and
one float32 dequantize and bias add).
"""
import numpy as np

import jax.numpy as jnp  # noqa: F401  (the JAX package needs jax loaded)
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.contrib.quantization import (
    INT8SubgraphProperty as JaxINT8)
from incubator_mxnet_tpu.subgraph import partition_graph as jax_partition

import incubator_mxnet_torch as mxt
from incubator_mxnet_torch import nd, sym
from incubator_mxnet_torch.contrib.quantization import INT8SubgraphProperty
from incubator_mxnet_torch.subgraph import partition_graph


def _count_ops(s, opname):
    return sum(1 for n in s._topo() if n._op == opname)


def _mlp(pkg):
    s = pkg.sym
    x = s.Symbol.var("x")
    h = s.FullyConnected(x, s.Symbol.var("w1"), s.Symbol.var("b1"),
                         num_hidden=32, name="fc1")
    h = s.Activation(h, act_type="relu", name="act1")
    return s.FullyConnected(h, s.Symbol.var("w2"), s.Symbol.var("b2"),
                            num_hidden=8, name="fc2")


def _mlp_args():
    rng = np.random.RandomState(0)
    return {"w1": rng.randn(32, 16).astype(np.float32) * 0.3,
            "b1": rng.randn(32).astype(np.float32) * 0.1,
            "w2": rng.randn(8, 32).astype(np.float32) * 0.3,
            "b2": rng.randn(8).astype(np.float32) * 0.1}, \
        rng.randn(4, 16).astype(np.float32)


def test_int8_subgraph_backend_mlp():
    arrays, x = _mlp_args()
    out = _mlp(mxt)
    with mxt.cpu():
        args = {k: nd.array(v) for k, v in arrays.items()}
        prop = INT8SubgraphProperty(args)
        part = partition_graph(out, prop)
        assert _count_ops(part, "_subgraph") == 1
        assert _count_ops(part, "FullyConnected") == 0
        sg = [n for n in part._topo() if n._op == "_subgraph"][0]
        inner_ops = {n._op for n in sg._attrs["__subgraph__"]._topo()}
        assert "_contrib_quantized_fully_connected" in inner_ops
        assert {"w1_quantized", "w1_min", "w1_max", "w2_quantized",
                "w2_min", "w2_max"} <= set(prop.new_args)
        data = nd.array(x)
        ref = out.eval_with({"x": data, **args}).asnumpy()
        got = part.eval_with({"x": data, **args, **prop.new_args}).asnumpy()
    err = np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-6)
    assert err < 0.1, f"int8 subgraph rel err {err}"


def test_int8_subgraph_excluded_layer_stays_float():
    rng = np.random.RandomState(1)
    x = sym.Symbol.var("x")
    out = sym.FullyConnected(x, sym.Symbol.var("w1"), sym.Symbol.var("b1"),
                             num_hidden=8, name="fc1")
    with mxt.cpu():
        args = {"w1": nd.array(rng.randn(8, 16).astype(np.float32)),
                "b1": nd.array(rng.randn(8).astype(np.float32))}
    prop = INT8SubgraphProperty(args, excluded_sym_names=("fc1",))
    part = partition_graph(out, prop)
    assert _count_ops(part, "_subgraph") == 0
    assert _count_ops(part, "FullyConnected") == 1
    assert not prop.new_args


def test_int8_subgraph_vetoes_float_only_regions():
    x = sym.Symbol.var("x")
    out = sym.tanh(sym.relu(x))
    part = partition_graph(out, INT8SubgraphProperty({}))
    assert _count_ops(part, "_subgraph") == 0
    assert _count_ops(part, "relu") == 1


def test_int8_subgraph_matches_jax():
    """The same graph partitioned by both packages: the same carved
    regions and minted arrays (bit for bit) and the same output."""
    from incubator_mxnet_torch.symbol import symbol as tsym
    from incubator_mxnet_tpu.symbol import symbol as jsym
    arrays, x = _mlp_args()
    jsym._COUNTER.table = {}
    tsym._COUNTER.table = {}
    jout, tout = _mlp(mxj), _mlp(mxt)
    jargs = {k: mxj.nd.array(v, ctx=mxj.cpu()) for k, v in arrays.items()}
    jprop = JaxINT8(jargs)
    jpart = jax_partition(jout, jprop)
    with mxt.cpu():
        targs = {k: nd.array(v) for k, v in arrays.items()}
        tprop = INT8SubgraphProperty(targs)
        tpart = partition_graph(tout, tprop)
        got = tpart.eval_with({"x": nd.array(x), **targs,
                               **tprop.new_args}).asnumpy()
    ref = jpart.eval_with({"x": mxj.nd.array(x, ctx=mxj.cpu()), **jargs,
                           **jprop.new_args}).asnumpy()
    assert [n._op for n in tpart._topo()] == [n._op for n in jpart._topo()]
    assert sorted(tprop.new_args) == sorted(jprop.new_args)
    for k, v in jprop.new_args.items():
        a, b = v.asnumpy(), tprop.new_args[k].asnumpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
