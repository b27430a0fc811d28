"""The port's Gluon core against the JAX package's: `Constant`,
`ParameterDict` (`get_constant`, `setattr`, `reset_ctx`, `save`/`load`
both ways), `Parameter.list_data`/`list_ctx`/`reset_ctx`,
`load_parameters(..., cast_dtype=True)` and `load_params`,
`SoftmaxOutput`'s gradient for every flag, and the slice as a whole: a
narrow GluonNLP-style encoder (2 layers, 64 units, 4 heads, batch 4,
T = 16) through the interleaved attention ops and a `SoftmaxOutput`
head, weights carried over with `convert.params_from_jax`, trained 3
SGD steps by both packages.

Tolerances: files and constants exact (bitwise); `SoftmaxOutput` rtol
1e-6 with atol 1e-6 of the largest value (one float32 softmax, the
same subtraction); the encoder's outputs and weights after each step
rtol 1e-5 with atol 1e-5 of the largest value (float32 products of
width 64 to 128 in another summation order, carried through three
updates).
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import autograd as jag

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd
from incubator_mxnet_torch.convert import params_from_jax

PKGS = ((mxj, jag), (mx, autograd))


def _np(a):
    return np.asarray(a.asnumpy()).astype(np.float64)


def _close(got, ref, rtol, what=""):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max(initial=0.0),
                               err_msg=what)


# ------------------------------------------------------------ Constant
@pytest.mark.parametrize("value", [
    np.arange(6, dtype=np.float32).reshape(2, 3), [[1.5, 2.5]],
    np.array([3, 4], np.int64), np.array([1.0, 2.0])],
    ids=["float32", "list", "int64", "float64"])
def test_constant_matches_jax(value):
    """A Constant holds its value in its dtype (64-bit as 32-bit), takes
    no gradient, and comes back from `get_constant` by name."""
    out = []
    for pkg, _ in PKGS:
        pd = pkg.gluon.ParameterDict("net_")
        c = pd.get_constant("c", value)
        assert pd.get_constant("c") is c
        assert c.grad_req == "null"
        pd.initialize(ctx=pkg.cpu())
        out.append(c.data())
    assert out[1].dtype == out[0].dtype
    np.testing.assert_array_equal(out[1].asnumpy(), out[0].asnumpy())
    with pytest.raises(mx.MXNetError):
        gluon.ParameterDict("p_").get_constant("missing")


# ------------------------------------------------------- ParameterDict
def _dict(pkg, arrays):
    pd = pkg.gluon.ParameterDict("net_")
    for name, a in arrays.items():
        pd.get(name, shape=a.shape, dtype=str(a.dtype))
    pd.initialize(ctx=pkg.cpu())
    for name, a in arrays.items():
        pd["net_" + name].set_data(pkg.nd.array(a, ctx=pkg.cpu(),
                                                dtype=a.dtype))
    return pd


def _arrays():
    rng = np.random.RandomState(31)
    return {"dense0_weight": rng.randn(4, 3).astype(np.float32),
            "dense0_bias": rng.randn(4).astype(np.float32),
            "emb_weight": rng.randn(5, 2).astype(np.float32)}


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("strip", ["", "net_"])
def test_parameter_dict_files_are_bitwise_jax_files(tmp_path, strip):
    """The same values saved by each package give the same arrays,
    dtype names and parameter names in the `.npz`, and each package
    loads the other's file (`restore_prefix` undoing `strip_prefix`)."""
    paths = {}
    for pkg, _ in PKGS:
        path = str(tmp_path / f"{pkg.__name__}.npz")
        _dict(pkg, _arrays()).save(path, strip_prefix=strip)
        paths[pkg] = path
    a, b = _npz(paths[mxj]), _npz(paths[mx])
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    for pkg, src in ((mx, paths[mxj]), (mxj, paths[mx])):
        fresh = pkg.gluon.ParameterDict("net_")
        for name, v in _arrays().items():
            fresh.get(name, shape=v.shape)
        fresh.load(src, ctx=pkg.cpu(), restore_prefix=strip)
        for name, v in _arrays().items():
            np.testing.assert_array_equal(
                fresh["net_" + name].data().asnumpy(), v)


def test_parameter_dict_load_takes_the_files_dtype_when_uninitialized(
        tmp_path):
    """An uninitialized parameter takes the file's dtype (a bf16 file
    stays bf16), an initialized one keeps its own, in both packages."""
    path = str(tmp_path / "bf16.npz")
    w = np.random.RandomState(2).randn(3, 2).astype(np.float32)
    with mx.cpu():
        nd.save(path, {"w": nd.array(w).astype("bfloat16")})
    for pkg, _ in PKGS:
        pd = pkg.gluon.ParameterDict("")
        pd.get("w", shape=(3, 2))
        pd.load(path, ctx=pkg.cpu())
        assert str(pd["w"].data().dtype) == "bfloat16"
        pd2 = pkg.gluon.ParameterDict("")
        pd2.get("w", shape=(3, 2))
        pd2.initialize(ctx=pkg.cpu())
        pd2.load(path, ctx=pkg.cpu())
        assert pd2["w"].data().dtype == np.float32


def test_setattr_reset_ctx_list_data_list_ctx():
    for pkg, _ in PKGS:
        pd = _dict(pkg, _arrays())
        pd.setattr("grad_req", "null")
        pd.setattr("lr_mult", 0.5)
        assert all(p.grad_req == "null" and p.lr_mult == 0.5
                   for p in pd.values())
        p = pd["net_dense0_weight"]
        before = p.data().asnumpy()
        pd.reset_ctx(pkg.cpu())
        assert p.list_ctx() == [pkg.cpu()]
        assert len(p.list_data()) == 1
        np.testing.assert_array_equal(p.list_data()[0].asnumpy(), before)
    deferred = gluon.Parameter("d", shape=(0, 3), allow_deferred_init=True)
    deferred.initialize(ctx=mx.cpu())
    deferred.reset_ctx(mx.cpu())
    assert deferred.list_ctx() == [mx.cpu()]
    w = gluon.Parameter("w", shape=(2, 3))
    w.initialize(ctx=mx.cpu())
    w.grad()
    w.reset_ctx(mx.cpu())
    assert w.grad().shape == (2, 3)


# ------------------------------------ load_parameters into a bf16 net
def _net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(4, in_units=3))
    net.add(pkg.gluon.nn.Dense(2, in_units=4))
    return net


@pytest.mark.parametrize("how", ["load_parameters", "load_params"])
def test_float32_file_loads_into_bf16_net_as_bf16(tmp_path, how):
    """A JAX-saved float32 file loads into a bf16 net as bf16 through
    `load_parameters(..., cast_dtype=True)` and `load_params`, in both
    packages, with the same bits."""
    mxj.random.seed(5)
    src = _net(mxj)
    src.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    path = str(tmp_path / "f32.params")
    src.save_parameters(path)
    out = []
    for pkg, _ in PKGS:
        net = _net(pkg)
        net.initialize(ctx=pkg.cpu())
        net.cast("bfloat16")
        if how == "load_parameters":
            net.load_parameters(path, ctx=pkg.cpu(), cast_dtype=True,
                                dtype_source="current")
        else:
            net.load_params(path, ctx=pkg.cpu())
        params = net._collect_params_with_prefix()
        assert all(str(p.data().dtype) == "bfloat16"
                   for p in params.values())
        out.append({k: p.data().asnumpy().astype(np.float32)
                    for k, p in params.items()})
    for k in out[0]:
        np.testing.assert_array_equal(out[1][k], out[0][k])
    assert gluon.Block.save_params is gluon.Block.save_parameters


# ------------------------------------------------------ SoftmaxOutput
FLAGS = {
    "default": {},
    "grad_scale": {"grad_scale": 2.5},
    "ignore": {"use_ignore": True, "ignore_label": 1},
    "batch": {"normalization": "batch"},
    "valid_ignore": {"normalization": "valid", "use_ignore": True,
                     "ignore_label": 1},
    "valid_no_ignore": {"normalization": "valid"},
    "smooth": {"smooth_alpha": 0.1},
    "multi_output": {"multi_output": True},
    "multi_output_valid": {"multi_output": True, "use_ignore": True,
                           "ignore_label": 2, "normalization": "valid",
                           "grad_scale": 0.5},
    "alias_Softmax": {},
    "alias_softmax_output": {"normalization": "batch"},
}


@pytest.mark.parametrize("case", sorted(FLAGS))
def test_softmax_output_gradient_matches_jax(case):
    """Forward softmax; the gradient of the data is the fused classifier
    gradient for every flag (the incoming gradient is not used)."""
    rng = np.random.RandomState(9)
    multi = FLAGS[case].get("multi_output", False)
    x = rng.randn(*((2, 5, 3) if multi else (4, 5))).astype(np.float32)
    y = rng.randint(0, 5, (2, 3) if multi else (4,)).astype(np.float32)
    y.flat[0] = FLAGS[case].get("ignore_label", 0)
    op = case.split("_", 1)[1] if case.startswith("alias") \
        else "SoftmaxOutput"
    res = []
    for pkg, ag in PKGS:
        data = pkg.nd.array(x, ctx=pkg.cpu())
        label = pkg.nd.array(y, ctx=pkg.cpu())
        data.attach_grad()
        with ag.record():
            out = getattr(pkg.nd, op)(data, label, **FLAGS[case])
        out.backward(pkg.nd.array(rng.randn(*x.shape).astype(np.float32),
                                  ctx=pkg.cpu()) if pkg is mx else None)
        res.append((out, data.grad))
    (jo, jg), (to, tg) = res
    _close(to, jo, 1e-6, "forward")
    _close(tg, jg, 1e-6, "gradient")


# -------------------------------- the slice: a narrow encoder trained
UNITS, HEADS, LAYERS, BATCH, T, CLASSES = 64, 4, 2, 4, 16, 3


def _encoder(pkg):
    gl = pkg.gluon

    class Layer(gl.HybridBlock):
        def __init__(self):
            super().__init__()
            self.qkv = gl.nn.Dense(3 * UNITS, flatten=False, in_units=UNITS)
            self.proj = gl.nn.Dense(UNITS, flatten=False, in_units=UNITS)
            self.ln1 = gl.nn.LayerNorm(in_channels=UNITS)
            self.ffn1 = gl.nn.Dense(2 * UNITS, flatten=False, in_units=UNITS,
                                    activation="relu")
            self.ffn2 = gl.nn.Dense(UNITS, flatten=False,
                                    in_units=2 * UNITS)
            self.ln2 = gl.nn.LayerNorm(in_channels=UNITS)

        def hybrid_forward(self, F, x, length):
            qkv = self.qkv(x)
            att = F.contrib.interleaved_matmul_selfatt_qk(qkv, heads=HEADS)
            att = F.softmax(att, length, axis=-1, use_length=True)
            ctx = F.contrib.interleaved_matmul_selfatt_valatt(qkv, att,
                                                              heads=HEADS)
            x = self.ln1(x + self.proj(ctx))
            return self.ln2(x + self.ffn2(self.ffn1(x)))

    class Encoder(gl.HybridBlock):
        def __init__(self):
            super().__init__()
            self.layer0 = Layer()
            self.layer1 = Layer()
            self.head = gl.nn.Dense(CLASSES, in_units=UNITS)

        def hybrid_forward(self, F, x, length, label):
            x = self.layer1(self.layer0(x, length), length)
            return F.SoftmaxOutput(self.head(x[0]), label)

    return Encoder()


def _encoder_inputs():
    rng = np.random.RandomState(15)
    x = rng.randn(T, BATCH, UNITS).astype(np.float32)
    valid = np.array([16, 7, 3, 11], np.float32)
    # one length per (example, head) row of the score matrix, as
    # GluonNLP repeats the valid length over the heads
    length = np.repeat(np.repeat(valid, HEADS)[:, None], T, axis=1)
    label = rng.randint(0, CLASSES, BATCH).astype(np.float32)
    return x, length, label


def test_narrow_encoder_trains_like_jax():
    """Three SGD steps (lr 0.1) of the encoder from the same weights and
    batch: outputs at each step and every weight after the last within
    1e-5 of the JAX package's."""
    mxj.random.seed(0)
    jnet = _encoder(mxj)
    jnet.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    arrays = {k: v.data().asnumpy()
              for k, v in jnet._collect_params_with_prefix().items()}
    tnet = _encoder(mx)
    tnet.initialize(ctx=mx.cpu())
    params_from_jax(tnet, arrays)
    inputs = _encoder_inputs()
    nets = {mxj: jnet, mx: tnet}
    trainers = {pkg: pkg.gluon.Trainer(nets[pkg].collect_params(), "sgd",
                                       {"learning_rate": 0.1})
                for pkg, _ in PKGS}
    for step in range(3):
        outs = []
        for pkg, ag in PKGS:
            xs = [pkg.nd.array(a, ctx=pkg.cpu()) for a in inputs]
            with ag.record():
                out = nets[pkg](*xs)
            out.backward()
            trainers[pkg].step(BATCH)
            outs.append(out)
        _close(outs[1], outs[0], 1e-5, f"step {step + 1} output")
    jparams = jnet._collect_params_with_prefix()
    for k, p in tnet._collect_params_with_prefix().items():
        _close(p.data(), jparams[k].data(), 1e-5, k)
        assert not np.array_equal(p.data().asnumpy(), arrays[k]) or \
            k.endswith(("beta", "gamma")), f"{k} did not move"
