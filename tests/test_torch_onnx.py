"""ONNX export and import in the port (`contrib.onnx`, `contrib.onnx_proto`)
against the JAX package's, on the CPU.

- The wire codec round-trips a model at the message level.
- The port's `export_model` of the graphs of the JAX package's
  `tests/test_onnx.py` (the MLP, the convnet with BatchNorm, LeNet, the
  shape and elementwise graph, the open slice with a bfloat16 cast) from
  one `-symbol.json` and `.params`, both written by the JAX package,
  gives the same bytes as the JAX package's export.
- Files written by either package import into the port; their outputs
  are held to 1e-5 relative to the JAX package's evaluation of its own
  import (the same float32 operations, sums in another order), the
  bfloat16 round trip to 1e-2 as there.
- Every importer case of that file (`Gemm` with alpha and beta, the
  reductions, `Dropout` with a ratio input, `MatMul` from `batch_dot`,
  `Gather` from `Embedding`) runs in the port, and `import_to_gluon`
  binds BatchNorm's running statistics.
"""
import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (the JAX package needs jax loaded)
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.contrib import onnx as jonnx

import incubator_mxnet_torch as mxt
from incubator_mxnet_torch import nd
from incubator_mxnet_torch.contrib import onnx as tonnx
from incubator_mxnet_torch.contrib import onnx_proto as P

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mxt.cpu():
        yield


def _eval(sym, bindings):
    out = sym.eval_with({k: nd.array(v) for k, v in bindings.items()})
    if isinstance(out, list):
        return [o.asnumpy() for o in out]
    return out.asnumpy()


def _jeval(sym, bindings):
    out = sym.eval_with({k: mxj.nd.array(v, ctx=mxj.cpu())
                         for k, v in bindings.items()})
    if isinstance(out, list):
        return [o.asnumpy() for o in out]
    return out.asnumpy()


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def test_proto_codec_roundtrip():
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    model = {"ir_version": 8, "opset": 13, "graph": {
        "name": "g",
        "nodes": [{"op_type": "Relu", "name": "r0", "inputs": ["x"],
                   "outputs": ["y"], "attributes": [
                       {"name": "f", "type": P.AT_FLOAT, "value": 1.5},
                       {"name": "i", "type": P.AT_INT, "value": -3},
                       {"name": "s", "type": P.AT_STRING, "value": "ab"},
                       {"name": "ints", "type": P.AT_INTS,
                        "value": [1, -2, 3]}]}],
        "initializers": [{"name": "w", "array": arr}],
        "inputs": [{"name": "x", "elem_type": P.DT_FLOAT,
                    "shape": [1, 3, "H"]}],
        "outputs": [{"name": "y", "elem_type": P.DT_FLOAT,
                     "shape": [1, 3]}]}}
    buf = P.encode_model(model)
    from incubator_mxnet_tpu.contrib import onnx_proto as JP
    assert buf == JP.encode_model(model)
    dec = P.decode_model(buf)
    assert dec["ir_version"] == 8 and dec["opset"] == 13
    node = dec["graph"]["nodes"][0]
    assert node["op_type"] == "Relu"
    assert node["attributes"]["f"]["value"] == pytest.approx(1.5)
    assert node["attributes"]["i"]["value"] == -3
    assert node["attributes"]["s"]["value"] == "ab"
    assert node["attributes"]["ints"]["value"] == [1, -2, 3]
    np.testing.assert_array_equal(dec["graph"]["initializers"][0]["array"],
                                  arr)
    assert dec["graph"]["inputs"][0]["shape"] == [1, 3, "H"]


# ---------------------------------------------------------------------
# the graphs, built by the JAX package and written to disk
# ---------------------------------------------------------------------

def _mlp():
    s = mxj.sym.var("data")
    s = mxj.sym.FullyConnected(s, num_hidden=16, name="fc1")
    s = mxj.sym.Activation(s, act_type="relu", name="relu1")
    s = mxj.sym.FullyConnected(s, num_hidden=10, name="fc2")
    s = mxj.sym.softmax(s, axis=-1, name="prob")
    rng = np.random.RandomState(0)
    params = {"fc1_weight": rng.randn(16, 8).astype(np.float32),
              "fc1_bias": rng.randn(16).astype(np.float32),
              "fc2_weight": rng.randn(10, 16).astype(np.float32),
              "fc2_bias": np.zeros(10, np.float32)}
    return s, params, {"data": rng.randn(4, 8).astype(np.float32)}


def _convnet():
    s = mxj.sym.var("data")
    s = mxj.sym.Convolution(s, kernel=(3, 3), num_filter=8, pad=(1, 1),
                            name="conv1")
    s = mxj.sym.BatchNorm(s, name="bn1")
    s = mxj.sym.Activation(s, act_type="relu", name="act1")
    s = mxj.sym.Pooling(s, kernel=(2, 2), stride=(2, 2), pool_type="max",
                        name="pool1")
    s = mxj.sym.Convolution(s, kernel=(3, 3), num_filter=4, name="conv2")
    s = mxj.sym.Pooling(s, global_pool=True, pool_type="avg", name="gap")
    s = mxj.sym.flatten(s, name="flat")
    s = mxj.sym.FullyConnected(s, num_hidden=10, name="fc")
    rng = np.random.RandomState(1)
    arg_shapes, _, aux_shapes = s.infer_shape(data=(2, 3, 16, 16))
    params = {n: (rng.randn(*shp) * 0.1).astype(np.float32)
              for n, shp in zip(s.list_arguments(), arg_shapes)
              if n != "data"}
    for n, shp in zip(s.list_auxiliary_states(), aux_shapes):
        params[n] = (rng.rand(*shp) * 0.1 + (0.0 if "mean" in n else 1.0)) \
            .astype(np.float32)
    return s, params, {"data": rng.randn(2, 3, 16, 16).astype(np.float32)}


def _elemwise():
    a, b = mxj.sym.var("a"), mxj.sym.var("b")
    t = mxj.sym.transpose(a, axes=(1, 0))
    c = mxj.sym.concat((t + 1.5) * b, b, dim=1)
    m = mxj.sym.mean(mxj.sym.reshape(c, shape=(4, 3)), axis=1,
                     keepdims=True)
    rng = np.random.RandomState(2)
    return mxj.sym.clip(m, a_min=-2.0, a_max=2.0), {}, {
        "a": rng.randn(3, 2).astype(np.float32),
        "b": rng.randn(2, 3).astype(np.float32)}


def _slice_bf16():
    x = mxj.sym.var("x")
    s = mxj.sym.slice(x, begin=(None, 1), end=(None, 3))
    out = mxj.sym.cast(mxj.sym.cast(s, dtype="bfloat16"), dtype="float32")
    return out, {}, {"x": np.arange(12, dtype=np.float32).reshape(3, 4)}


def _batch_dot():
    a, b = mxj.sym.var("a"), mxj.sym.var("b")
    out = mxj.sym.swapaxes(mxj.sym.batch_dot(a, b, transpose_b=True),
                           dim1=1, dim2=2)
    rng = np.random.RandomState(8)
    return out, {}, {"a": rng.randn(2, 3, 4).astype(np.float32),
                     "b": rng.randn(2, 5, 4).astype(np.float32)}


def _embedding():
    t = mxj.sym.var("tokens")
    out = mxj.sym.sum(mxj.sym.Embedding(t, input_dim=50, output_dim=8,
                                        name="embed"), axis=1)
    rng = np.random.RandomState(4)
    return out, {"embed_weight": rng.randn(50, 8).astype(np.float32)}, {
        "tokens": rng.randint(0, 50, (2, 5)).astype(np.float32)}


def _lenet():
    from incubator_mxnet_tpu.models.lenet import LeNet
    mxj.random.seed(3)
    net = LeNet()
    net.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    x = np.random.RandomState(3).rand(2, 1, 28, 28).astype(np.float32)
    net(mxj.nd.array(x, ctx=mxj.cpu()))
    return net, x


GRAPHS = {"mlp": _mlp, "convnet": _convnet, "elemwise": _elemwise,
          "slice_bf16": _slice_bf16, "batch_dot": _batch_dot,
          "embedding": _embedding}
ROUND_TRIP_RTOL = {"slice_bf16": 1e-2}


def _write_jax(tmp_path, name):
    """The graph's `-symbol.json` and `.params` as the JAX package writes
    them, its inputs and the JAX package's output."""
    from incubator_mxnet_tpu.symbol import symbol as jsym
    jsym._COUNTER.table = {}
    if name == "lenet":
        net, x = _lenet()
        sym_file, params_file = net.export(str(tmp_path / "lenet"))
        return sym_file, params_file, {"data": x}, \
            net(mxj.nd.array(x, ctx=mxj.cpu())).asnumpy()
    sym, params, inputs = GRAPHS[name]()
    want = _jeval(sym, {**params, **inputs})
    sym_file = str(tmp_path / f"{name}-symbol.json")
    params_file = str(tmp_path / f"{name}-0000.params")
    sym.save(sym_file)
    mxj.nd.save(params_file, {f"arg:{k}": mxj.nd.array(v, ctx=mxj.cpu())
                              for k, v in params.items()})
    return sym_file, params_file, inputs, want


def _shapes(inputs):
    return [v.shape for v in inputs.values()]


@pytest.mark.parametrize("name", ["mlp", "convnet", "lenet", "elemwise",
                                  "slice_bf16", "batch_dot", "embedding"])
def test_export_gives_the_jax_bytes(tmp_path, name):
    sym_file, params_file, inputs, _ = _write_jax(tmp_path, name)
    jpath, tpath = str(tmp_path / "j.onnx"), str(tmp_path / "t.onnx")
    jonnx.export_model(sym_file, params_file, _shapes(inputs), np.float32,
                       jpath)
    assert tonnx.export_model(sym_file, params_file, _shapes(inputs),
                              np.float32, tpath) == tpath
    with open(jpath, "rb") as f:
        jbytes = f.read()
    with open(tpath, "rb") as f:
        tbytes = f.read()
    assert len(tbytes) == len(jbytes) and tbytes == jbytes


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", ["mlp", "convnet", "elemwise",
                                  "slice_bf16", "batch_dot", "embedding"])
def test_either_packages_file_imports_into_the_port(tmp_path, name, writer):
    sym_file, params_file, inputs, want = _write_jax(tmp_path, name)
    path = str(tmp_path / "m.onnx")
    exporter = jonnx if writer == "jax" else tonnx
    exporter.export_model(sym_file, params_file, _shapes(inputs),
                          np.float32, path)
    jsym, jarg, jaux = jonnx.import_model(path)
    tsym, targ, taux = tonnx.import_model(path)
    assert sorted(targ) == sorted(jarg) and sorted(taux) == sorted(jaux)
    jref = _jeval(jsym, {**{k: v.asnumpy() for k, v in
                            {**jarg, **jaux}.items()}, **inputs})
    got = _eval(tsym, {**{k: v.asnumpy() for k, v in
                          {**targ, **taux}.items()}, **inputs})
    rtol = ROUND_TRIP_RTOL.get(name, RTOL)
    _close(got, jref, rtol)
    _close(got, want, max(rtol, 1e-4))


def test_export_import_mlp_metadata(tmp_path):
    sym_file, params_file, inputs, _ = _write_jax(tmp_path, "mlp")
    path = str(tmp_path / "mlp.onnx")
    tonnx.export_model(sym_file, params_file, [(4, 8)], np.float32, path)
    meta = tonnx.get_model_metadata(path)
    assert meta == jonnx.get_model_metadata(path)
    assert meta["input_tensor_data"] == [("data", (4, 8))]


def test_import_to_gluon_lenet_and_bn_aux(tmp_path):
    """LeNet and a net with BatchNorm through ONNX into a SymbolBlock:
    the running statistics are bound as parameters."""
    sym_file, params_file, inputs, want = _write_jax(tmp_path, "lenet")
    path = str(tmp_path / "lenet.onnx")
    tonnx.export_model(sym_file, params_file, [(2, 1, 28, 28)], np.float32,
                       path)
    block = tonnx.import_to_gluon(path, ctx=mxt.cpu())
    _close(block(nd.array(inputs["data"])).asnumpy(), want, 1e-4)

    sym_file, params_file, inputs, want = _write_jax(tmp_path, "convnet")
    path = str(tmp_path / "cnn.onnx")
    tonnx.export_model(sym_file, params_file, [(2, 3, 16, 16)], np.float32,
                       path)
    _, _, aux = tonnx.import_model(path)
    assert set(aux) == {"bn1_moving_mean", "bn1_moving_var"}
    block = tonnx.import_to_gluon(path, ctx=mxt.cpu())
    params = block.collect_params()
    for k, v in aux.items():
        np.testing.assert_array_equal(params[k].data().asnumpy(),
                                      v.asnumpy())
    _close(block(nd.array(inputs["data"])).asnumpy(), want, 1e-4)


def test_export_transposes_carry_full_rank_perms(tmp_path):
    sym_file, params_file, inputs, _ = _write_jax(tmp_path, "batch_dot")
    path = str(tmp_path / "bd.onnx")
    tonnx.export_model(sym_file, params_file, _shapes(inputs), np.float32,
                       path)
    with open(path, "rb") as f:
        g = P.decode_model(f.read())["graph"]
    perms = [n["attributes"]["perm"]["value"] for n in g["nodes"]
             if n["op_type"] == "Transpose"]
    assert [0, 2, 1] in perms and all(len(p) == 3 for p in perms)


def _write_model(tmp_path, nodes, inputs, outputs, initializers=()):
    model = {"graph": {"name": "g", "nodes": nodes, "inputs": inputs,
                       "outputs": outputs,
                       "initializers": list(initializers)}}
    path = str(tmp_path / "hand.onnx")
    with open(path, "wb") as f:
        f.write(P.encode_model(model))
    return path


@pytest.mark.parametrize("op_type", ["ReduceL1", "ReduceL2"])
def test_import_reduce_l1_vs_l2(tmp_path, op_type):
    x = np.array([[1.0, -2.0, 2.0], [3.0, 4.0, 0.0]], np.float32)
    want = np.abs(x).sum(1) if op_type == "ReduceL1" \
        else np.sqrt((x * x).sum(1))
    path = _write_model(
        tmp_path,
        nodes=[{"op_type": op_type, "name": "r", "inputs": ["x"],
                "outputs": ["y"], "attributes": [
                    {"name": "axes", "type": P.AT_INTS, "value": [1]},
                    {"name": "keepdims", "type": P.AT_INT, "value": 0}]}],
        inputs=[{"name": "x", "elem_type": P.DT_FLOAT, "shape": [2, 3]}],
        outputs=[{"name": "y", "elem_type": P.DT_FLOAT, "shape": [2]}])
    sym, _, _ = tonnx.import_model(path)
    _close(_eval(sym, {"x": x}), want)


def test_import_gemm_alpha_beta(tmp_path):
    rng = np.random.RandomState(7)
    w = rng.randn(5, 4).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    x = rng.randn(2, 4).astype(np.float32)
    path = _write_model(
        tmp_path,
        nodes=[{"op_type": "Gemm", "name": "g0", "inputs": ["x", "w", "b"],
                "outputs": ["y"], "attributes": [
                    {"name": "alpha", "type": P.AT_FLOAT, "value": 0.5},
                    {"name": "beta", "type": P.AT_FLOAT, "value": 2.0},
                    {"name": "transB", "type": P.AT_INT, "value": 1}]}],
        inputs=[{"name": "x", "elem_type": P.DT_FLOAT, "shape": [2, 4]}],
        outputs=[{"name": "y", "elem_type": P.DT_FLOAT, "shape": [2, 5]}],
        initializers=[{"name": "w", "array": w}, {"name": "b", "array": b}])
    sym, arg, _ = tonnx.import_model(path)
    got = _eval(sym, {"x": x, **{k: v.asnumpy() for k, v in arg.items()}})
    _close(got, 0.5 * (x @ w.T) + 2.0 * b)


def test_import_dropout_zero_ratio(tmp_path):
    path = _write_model(
        tmp_path,
        nodes=[{"op_type": "Dropout", "name": "d0", "inputs": ["x", "r"],
                "outputs": ["y"], "attributes": []}],
        inputs=[{"name": "x", "elem_type": P.DT_FLOAT, "shape": [3]}],
        outputs=[{"name": "y", "elem_type": P.DT_FLOAT, "shape": [3]}],
        initializers=[{"name": "r", "array": np.float32(0.0)}])
    sym, _, _ = tonnx.import_model(path)
    node = [n for n in sym._topo() if n._op == "Dropout"][0]
    assert node._attrs["p"] == 0.0
