"""Places where the port departed from the JAX package, each held
against it on the CPU: parameter files that cross between the packages,
a JAX fused-update states file loaded into the port's Trainer,
`Embedding` with negative ids, `slice_axis` past the end of its axis,
`Pooling` on integer data, `nd.array` (and `Parameter.set_data`)
sharing memory with the source; then `nd.array`'s shapes and dtypes,
`pick` out of range, `mean` of integer data, reductions over
`axis=()`, `backward()` from a head no gradient-taking input reaches,
`Parameter`'s `lr_mult`/`wd_mult`/`stype`/`grad_stype`, NDArray's
`==`, `!=`, `bool()` and in-place operators, 3-D average pooling of
bfloat16 data on the CPU, and `NDArray.dtype`, a numpy dtype as in the
JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, with their reasons:

- files, lookups, slices, integer pooling and copies of a source:
  exact (the same values copied, gathered or summed in integers);
- the float32 mean of integer pooling windows: rtol 1e-6 (one division
  of the same float32 sum, or a mean summed in another order);
- one optimizer step after states loaded from the JAX package: rtol
  1e-6, atol 1e-7 (the same elementwise float32 arithmetic; Adam's
  bias-corrected lr is computed in double on both sides but rounded at
  another point);
- the later tests state theirs where they differ from exact.
"""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.ops import nn as jnn
from incubator_mxnet_tpu.ops import shape as jshape

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.ops import nn as tnn
from incubator_mxnet_torch.ops import shape as tshape

OPT_TOL = dict(rtol=1e-6, atol=1e-7)


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "b16": rng.randn(5).astype(np.float32),
            "ids": rng.randint(-9, 9, (2, 3)).astype(np.int32)}


def _numpy(a):
    """An NDArray of either package as float64 numpy (bf16 exactly)."""
    return np.asarray(a.asnumpy()).astype(np.float64)


# ------------------------------------------------ 1. parameter files
def test_port_file_loads_in_jax(tmp_path):
    src = _arrays()
    with mx.cpu():
        t = {k: nd.array(v) for k, v in src.items()}
    t["b16"] = t["b16"].astype("bfloat16")
    path = str(tmp_path / "port.npz")
    nd.save(path, t)
    got = mxj.nd.load(path)
    assert list(got) == list(t)
    for k in t:
        assert str(got[k].dtype) == str(t[k].dtype).replace("torch.", "")
        np.testing.assert_array_equal(_numpy(got[k]), _numpy(t[k]), err_msg=k)
    nd.save(path, [t["w"], t["b16"]])                     # a list
    got = mxj.nd.load(path)
    assert isinstance(got, list) and len(got) == 2
    np.testing.assert_array_equal(_numpy(got[1]), _numpy(t["b16"]))
    nd.save(path, t["ids"])                               # one NDArray
    np.testing.assert_array_equal(_numpy(mxj.nd.load(path)[0]),
                                  src["ids"])


def test_jax_file_loads_in_port(tmp_path):
    src = _arrays(1)
    j = {k: mxj.nd.array(v, ctx=mxj.cpu(), dtype=v.dtype)
         for k, v in src.items()}
    j["b16"] = j["b16"].astype("bfloat16")
    path = str(tmp_path / "jax.npz")
    mxj.nd.save(path, j)
    with mx.cpu():
        got = nd.load(path)
    assert list(got) == list(j)
    assert all(isinstance(v, nd.NDArray) for v in got.values())
    assert got["b16"].dtype == j["b16"].dtype == "bfloat16"
    assert got["ids"].dtype == j["ids"].dtype == np.int32
    for k in j:
        np.testing.assert_array_equal(_numpy(got[k]), _numpy(j[k]), err_msg=k)
    mxj.nd.save(path, [j["w"]])
    with mx.cpu():
        (w,) = nd.load(path)
    np.testing.assert_array_equal(w.asnumpy(), src["w"])


def _jax_dense(dtype):
    mxj.random.seed(0)
    net = mxj.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mxj.gluon.nn.Dense(6, activation="relu"),
                mxj.gluon.nn.Dense(3))
    net.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    x = np.random.RandomState(2).randn(4, 5).astype(np.float32)
    net(mxj.nd.array(x, ctx=mxj.cpu()))
    net.cast(dtype)
    return net, x


def _port_dense(dtype):
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Dense(6, activation="relu"), gluon.nn.Dense(3))
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    net.cast(dtype)
    return net


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_parameters_cross_both_ways(tmp_path, dtype):
    jnet, x = _jax_dense(dtype)
    jout = _numpy(jnet(mxj.nd.array(x, ctx=mxj.cpu()).astype(dtype)))
    path = str(tmp_path / "jax.params")
    jnet.save_parameters(path)
    tnet = _port_dense(dtype)
    tnet.load_parameters(path, ctx=mx.cpu())
    with mx.cpu():
        tout = _numpy(tnet(nd.array(x).astype(dtype)))
    np.testing.assert_allclose(tout, jout, rtol=1e-6 if dtype == "float32"
                               else 2 ** -7, atol=1e-6)
    # and back: the port's file into a fresh JAX net
    back = str(tmp_path / "port.params")
    tnet.save_parameters(back)
    jnet2, _ = _jax_dense(dtype)
    jnet2.load_parameters(back, ctx=mxj.cpu())
    for k, p in jnet._collect_params_with_prefix().items():
        q = jnet2._collect_params_with_prefix()[k]
        assert q.data().dtype == p.data().dtype
        np.testing.assert_array_equal(_numpy(q.data()), _numpy(p.data()),
                                      err_msg=k)


# ------------------------------------- 2. JAX fused-update states file
@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("sgd", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 0.01})])
def test_trainer_loads_jax_fused_states(tmp_path, opt, params):
    """A few steps in the JAX package, its states saved; the port loads
    the weights and the states, and one more step agrees."""
    jnet, x = _jax_dense("float32")
    y = np.random.RandomState(3).randn(4, 3).astype(np.float32)
    jtr = mxj.gluon.Trainer(jnet.collect_params(), opt, params)
    jx, jy = (mxj.nd.array(a, ctx=mxj.cpu()) for a in (x, y))

    def jstep():
        with jag.record():
            loss = ((jnet(jx) - jy) ** 2).sum()
        loss.backward()
        jtr.step(4)
    for _ in range(3):
        jstep()
    path = str(tmp_path / "states")
    jtr.save_states(path)
    with open(path, "rb") as f:
        assert "fused" in pickle.load(f)      # the JAX default path
    tnet = _port_dense("float32")
    params_from_jax(tnet, {k: v.data().asnumpy() for k, v in
                           jnet._collect_params_with_prefix().items()})
    ttr = gluon.Trainer(tnet.collect_params(), opt, params)
    ttr.load_states(path)
    assert ttr.optimizer.num_update == 3
    jstep()
    with mx.cpu():
        tx, ty = nd.array(x), nd.array(y)
    with autograd.record():
        loss = nd.sum(nd.square(tnet(tx) - ty))
    loss.backward()
    ttr.step(4)
    for k, p in jnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(
            tnet._collect_params_with_prefix()[k].data().asnumpy(),
            p.data().asnumpy(), err_msg=k, **OPT_TOL)


# --------------------------------------------------- 3. Embedding ids
def test_embedding_negative_and_out_of_range_ids():
    rows = 4
    w = np.random.RandomState(4).randn(rows, 3).astype(np.float32)
    ids = np.array([[-1, -rows, -rows - 1, rows, rows + 3, 2, -2.7, 1.9]],
                   np.float32)
    ref = np.asarray(jshape.embedding(jnp.asarray(ids), jnp.asarray(w)))
    got = tshape.embedding(torch.from_numpy(ids), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isnan(ref[0, 2]).all() and not np.isnan(ref[0, 0]).any()


# ------------------------------------------------ 4. slice_axis clamps
@pytest.mark.parametrize("axis,begin,end", [
    (1, 1, 9), (1, -9, 2), (1, -9, 9), (1, 3, 1), (1, 7, 9), (1, 2, 2),
    (-1, -2, None), (0, 1, 100), (-2, -1, 5), (1, 0, -7)])
def test_slice_axis_clamps_like_a_python_slice(axis, begin, end):
    x = np.arange(3 * 5 * 2, dtype=np.float32).reshape(3, 5, 2)
    ref = np.asarray(jshape.slice_axis(jnp.asarray(x), axis=axis,
                                       begin=begin, end=end))
    got = tshape.slice_axis(torch.from_numpy(x), axis=axis, begin=begin,
                            end=end)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    with mx.cpu():
        arr = nd.array(x).slice_axis(axis, begin, end)
    assert arr.shape == ref.shape


# ------------------------------------------------- 5. integer pooling
@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
@pytest.mark.parametrize("pad", [(0, 0), (1, 1)])
@pytest.mark.parametrize("count_include_pad", [True, False])
@pytest.mark.parametrize("convention", ["valid", "full"])
def test_pooling_on_int32_matches_jax(pool_type, pad, count_include_pad,
                                      convention):
    x = np.random.RandomState(5).randint(-1000, 1000, (2, 3, 7, 6)) \
        .astype(np.int32)
    kw = dict(kernel=(3, 2), pool_type=pool_type, stride=(2, 2), pad=pad,
              count_include_pad=count_include_pad,
              pooling_convention=convention)
    ref = np.asarray(jnn.pooling(jnp.asarray(x), **kw))
    got = tnn.pooling(torch.from_numpy(x), **kw)
    assert str(got.dtype).replace("torch.", "") == ref.dtype.name
    assert tuple(got.shape) == ref.shape
    if ref.dtype == np.int32:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
def test_global_pooling_on_int32_matches_jax(pool_type):
    x = np.random.RandomState(6).randint(-1000, 1000, (2, 3, 5, 4)) \
        .astype(np.int32)
    ref = np.asarray(jnn.pooling(jnp.asarray(x), pool_type=pool_type,
                                 global_pool=True))
    got = tnn.pooling(torch.from_numpy(x), pool_type=pool_type,
                      global_pool=True)
    assert str(got.dtype).replace("torch.", "") == ref.dtype.name
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


# ------------------------------------------- 6. nd.array copies its source
def _source(kind, pkg, x):
    """`x` as a source of kind `kind` for package `pkg`; a torch.Tensor
    has no JAX counterpart, so the JAX package gets the numpy array."""
    if kind == "ndarray":
        return pkg.nd.array(x, ctx=pkg.cpu())
    if kind == "tensor" and pkg is mx:
        return torch.from_numpy(x)
    return x


@pytest.mark.parametrize("kind", ["numpy", "ndarray", "tensor"])
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_nd_array_copies_its_source(kind, dtype):
    x = np.random.RandomState(7).randn(3, 4).astype(np.float32)
    for pkg in (mxj, mx):
        src = _source(kind, pkg, x.copy())
        a = pkg.nd.array(src, ctx=pkg.cpu(), dtype=dtype)
        a[:] = 5
        np.testing.assert_array_equal(a.asnumpy(), np.full_like(x, 5))
        held = src.asnumpy() if kind == "ndarray" else np.asarray(src)
        np.testing.assert_array_equal(held, x, err_msg=pkg.__name__)


@pytest.mark.parametrize("kind", ["numpy", "ndarray"])
def test_set_data_copies_its_source(kind):
    """An uninitialized parameter takes a copy of the data it is given:
    writing into the parameter leaves the source alone, as the JAX
    package's (whose arrays cannot be written) does."""
    x = np.random.RandomState(8).randn(2, 3).astype(np.float32)
    src = _source(kind, mx, x.copy())
    p = gluon.Parameter("w", shape=(2, 3))
    p.set_data(src, ctx=mx.cpu())
    with torch.no_grad():
        p.data().data.fill_(5)
    held = src.asnumpy() if kind == "ndarray" else src
    np.testing.assert_array_equal(held, x)
    np.testing.assert_array_equal(p.data().asnumpy(), np.full_like(x, 5))


# ------------------------------------- 7. nd.array's shapes and dtypes
@pytest.mark.parametrize("src", [
    2.5, np.float32(1), np.array(3.0), [1, 2, 3], 5, [True, False],
    (1.5, 2), np.int32(4), np.array(True), np.array([1, 2], np.int32),
    np.array([[1.5, 2.5]]), [[1, 2], [3, 4]], np.arange(3),
    np.array([[7, 8]], np.uint64), np.array([3, 250], np.uint8),
    np.array([True, False]), np.array([0.5, 1.5], np.float16)],
    ids=lambda s: f"{type(s).__name__}:{np.asarray(s).tolist()}")
def test_nd_array_shape_and_dtype_match_jax(src):
    """A 0-d source stays 0-d; Python data and numpy scalars become
    float32; a numpy array keeps its dtype, its 64-bit types as JAX
    stores them without x64 (float64, int64 and uint64 become float32,
    int32 and uint32)."""
    ref = mxj.nd.array(src, ctx=mxj.cpu())
    got = nd.array(src, ctx=mx.cpu())
    assert got.shape == ref.shape
    assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
    np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())


# ------------------------------------------------ 8. pick out of range
@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8"])
@pytest.mark.parametrize("mode", ["clip", "wrap"])
@pytest.mark.parametrize("axis,keepdims", [(-1, False), (0, True), (1, False)])
def test_pick_wraps_negative_and_fills_out_of_range(dtype, mode, axis,
                                                    keepdims):
    """`jnp.take_along_axis`'s rule, whatever `mode` says: -1 is the
    last element, an index past either end gives NaN (float), the
    least value of int32 or the largest of uint8."""
    x = np.arange(12).reshape(3, 4).astype(dtype)
    size = x.shape[axis]
    n = x.shape[1 - (axis % 2)]
    idx = np.array([-1, size, size + 1, -size - 1, -size, 0, 1.9, -1.5,
                    size - 1, 2, 3, -2][:n], np.float32)
    ref = jshape.pick(jnp.asarray(x), jnp.asarray(idx), axis=axis,
                      keepdims=keepdims, mode=mode)
    got = tshape.pick(torch.from_numpy(x), torch.from_numpy(idx), axis=axis,
                      keepdims=keepdims, mode=mode)
    assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------- 9. mean of integer data
@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
def test_mean_of_int_data_is_float32(axis):
    """`jnp.mean` of int32 data is the float32 mean (5.5 for
    arange(12)); `sum` keeps int32.  Exact: small integers."""
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    for name in ("mean", "sum"):
        ref = getattr(mxj.nd, name)(mxj.nd.array(x, ctx=mxj.cpu(),
                                                 dtype="int32"), axis=axis)
        got = getattr(nd, name)(nd.array(x, ctx=mx.cpu()), axis=axis)
        assert str(got.dtype).replace("torch.", "") == str(ref.dtype), name
        np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())


# -------------------------------------------- 10. axis=() reduces nothing
@pytest.mark.parametrize("name", ["sum", "mean"])
@pytest.mark.parametrize("keepdims,exclude", [(False, False), (True, False),
                                              (False, True)])
def test_reduce_over_no_axis(name, keepdims, exclude):
    """`axis=()` gives the input back unchanged; with `exclude` it
    reduces every axis.  rtol 1e-6: a float32 sum of 24 values in
    another order."""
    x = np.random.RandomState(9).randn(2, 3, 4).astype(np.float32)
    ref = getattr(mxj.nd, name)(mxj.nd.array(x, ctx=mxj.cpu()), axis=(),
                                keepdims=keepdims, exclude=exclude)
    got = getattr(nd, name)(nd.array(x, ctx=mx.cpu()), axis=(),
                            keepdims=keepdims, exclude=exclude)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=1e-6)


# ------------------------------ 11. backward with nothing to differentiate
@pytest.mark.parametrize("req", [None, "null"])
def test_backward_without_gradient_inputs_writes_nothing(req):
    """A head recorded from arrays that take no gradient sweeps to
    nothing and does not raise; a "null" leaf's grad is a zero array."""
    x = np.array([1.0, -2.0, 3.0], np.float32)
    grads = []
    for pkg in (mxj, mx):
        a = pkg.nd.array(x, ctx=pkg.cpu())
        if req:
            a.attach_grad(grad_req=req)
        with pkg.autograd.record():
            y = a * 2 + 1
        y.backward()
        grads.append(None if a.grad is None else a.grad.asnumpy())
    if req is None:
        assert grads == [None, None]
    else:
        np.testing.assert_array_equal(grads[1], grads[0])
        np.testing.assert_array_equal(grads[1], np.zeros_like(x))


def test_backward_mixes_null_and_write_leaves():
    """A sweep over a "write" leaf and a "null" one fills the first and
    leaves the second zero, as in the JAX package."""
    x = np.array([1.0, -2.0, 3.0], np.float32)
    out = []
    for pkg in (mxj, mx):
        a, b = pkg.nd.array(x, ctx=pkg.cpu()), pkg.nd.array(-x, ctx=pkg.cpu())
        a.attach_grad()
        b.attach_grad(grad_req="null")
        with pkg.autograd.record():
            y = a * b + b
        y.backward()
        out.append((a.grad.asnumpy(), b.grad.asnumpy()))
    for t, j in zip(out[1], out[0]):
        np.testing.assert_array_equal(t, j)


# ---------------------------------------- 12. lr_mult, wd_mult, stype
def _mult_params(pkg, lr_mult, wd_mult):
    pd = pkg.gluon.ParameterDict("net_")
    w = pd.get("w", shape=(3, 4), lr_mult=lr_mult, wd_mult=wd_mult)
    b = pkg.gluon.Parameter("net_b", shape=(4,), lr_mult=1.0 / lr_mult)
    pd.update({"net_b": b})
    return pd, w, b


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.05, "wd": 0.01})])
def test_trainer_reads_lr_and_wd_mult(opt, params):
    """Two `gluon.Trainer` steps with `lr_mult=0.1` (and 10 on the
    bias) and `wd_mult=2` given to the constructors: the weights agree
    with the JAX package's.  rtol 1e-6: the same float32 elementwise
    arithmetic; for Adam also atol 2e-5 × the largest step (lr 0.05 ×
    10): the two packages round Adam's bias correction at other points,
    which moves each step by up to 1.6e-5 of its size at any lr_mult."""
    rng = np.random.RandomState(10)
    w0, b0 = rng.randn(3, 4).astype(np.float32), rng.randn(4).astype(np.float32)
    x, y = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(np.float32)
    result = []
    for pkg in (mxj, mx):
        pd, w, b = _mult_params(pkg, 0.1, 2.0)
        assert (w.lr_mult, w.wd_mult, b.lr_mult) == (0.1, 2.0, 10.0)
        pd.initialize(ctx=pkg.cpu())
        w.set_data(pkg.nd.array(w0, ctx=pkg.cpu()))
        b.set_data(pkg.nd.array(b0, ctx=pkg.cpu()))
        tr = pkg.gluon.Trainer(pd, opt, dict(params))
        px, py = (pkg.nd.array(a, ctx=pkg.cpu()) for a in (x, y))
        for _ in range(2):
            with pkg.autograd.record():
                loss = pkg.nd.sum(pkg.nd.square(w.data() * px + b.data()
                                                - py))
            loss.backward()
            tr.step(3)
        result.append((w.data().asnumpy(), b.data().asnumpy()))
    atol = 2e-5 * 0.5 if opt == "adam" else 1e-7
    for t, j in zip(result[1], result[0]):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=atol)
    assert not np.allclose(result[1][0], w0)


def test_parallel_trainer_keeps_jax_lr_mult_rule():
    """`ParallelTrainer` applies one learning rate to every parameter,
    as the JAX package's does (its compiled step reads no `lr_mult`):
    with `lr_mult=0.1` on the first layer, two SGD steps agree.
    rtol 1e-5: float32 matmuls summed in another order."""
    jnet, x = _jax_dense("float32")
    tnet = _port_dense("float32")
    params_from_jax(tnet, {k: v.data().asnumpy() for k, v in
                           jnet._collect_params_with_prefix().items()})
    for net in (jnet, tnet):
        next(iter(net.collect_params().values())).lr_mult = 0.1
    y = np.random.RandomState(11).randn(4, 3).astype(np.float32)
    sgd = {"learning_rate": 0.1, "momentum": 0.9}
    jl, tl = mxj.gluon.loss.L2Loss(), gluon.loss.L2Loss()
    jtr = mxj.parallel.ParallelTrainer(jnet, lambda o, t: jl(o, t), "sgd",
                                       sgd, mesh=mxj.parallel.default_mesh(1))
    ttr = mx.parallel.ParallelTrainer(
        tnet, lambda o, t: tl(o, t), "sgd", sgd,
        mesh=mx.parallel.default_mesh(ctx=mx.cpu()))
    jx, jy = (mxj.nd.array(a, ctx=mxj.cpu()) for a in (x, y))
    with mx.cpu():
        tx, ty = nd.array(x), nd.array(y)
    for _ in range(2):
        jtr.step(jx, jy)
        ttr.step(tx, ty)
    for k, p in jnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(
            tnet._collect_params_with_prefix()[k].data().asnumpy(),
            p.data().asnumpy(), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arg", ["stype", "grad_stype"])
def test_parameter_row_sparse_storage_raises(arg):
    """Both packages take `stype`/`grad_stype` "row_sparse" and keep the
    data dense.  A row-sparse gradient then raises in an optimizer with
    no lazy row update, in the port by name (the JAX package fails there
    with an AttributeError)."""
    for pkg in (mxj, mx):
        p = pkg.gluon.Parameter("w", shape=(2,), **{arg: "row_sparse"})
        assert getattr(p, arg) == "row_sparse"
    emb = gluon.nn.Embedding(6, 2, sparse_grad=True)
    emb.initialize(ctx=mx.cpu())
    with autograd.record():
        out = emb(nd.array([1, 4], ctx=mx.cpu()))
    out.backward()
    assert emb.weight.grad().stype == "row_sparse"
    with pytest.raises(mx.MXNetError, match="RMSProp takes no row_sparse"):
        gluon.Trainer(emb.collect_params(), "rmsprop").step(1)


# ------------------------------ 13. ==, !=, bool() and in-place operators
def test_compare_and_truth_match_jax():
    """`==` and `!=` give 1s and 0s in the data's dtype; `bool()` is the
    truth of one element and raises on more; NDArray is unhashable."""
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([1.0, 0.0, 3.0], np.float32)
    i = np.array([1, 2], np.int32)
    for pkg in (mxj, mx):
        x, y = (pkg.nd.array(v, ctx=pkg.cpu()) for v in (a, b))
        n = pkg.nd.array(i, ctx=pkg.cpu())
        for got, want in ((x == y, [1, 0, 1]), (x != y, [0, 1, 0]),
                          (x == 1, [1, 0, 0]), (x != 2.0, [1, 0, 1]),
                          (n == 1.5, [0, 0]), (n == 2, [0, 1])):
            assert str(got.dtype).replace("torch.", "") in ("float32",
                                                            "int32")
            assert got.dtype == (n.dtype if got.shape == (2,) else x.dtype)
            np.testing.assert_array_equal(got.asnumpy(), want)
        assert (x == None) is False and (x != None) is True  # noqa: E711
        assert bool(pkg.nd.array(np.zeros(1), ctx=pkg.cpu())) is False
        assert bool(pkg.nd.array(np.ones((1, 1)), ctx=pkg.cpu())) is True
        with pytest.raises(ValueError, match="ambiguous"):
            bool(x)
        with pytest.raises(TypeError):
            hash(x)


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
def test_inplace_operators_update_the_array(op):
    """`w = p.data(); w op= v` changes the parameter itself in both
    packages, with an array or a scalar operand.  Exact: one float32
    operation."""
    w0 = np.random.RandomState(12).randn(2, 3).astype(np.float32)
    v = np.random.RandomState(13).rand(2, 3).astype(np.float32) + 0.5
    out = []
    for pkg in (mxj, mx):
        p = pkg.gluon.Parameter("w", shape=(2, 3))
        p.initialize(ctx=pkg.cpu())
        p.set_data(pkg.nd.array(w0, ctx=pkg.cpu()))
        w = p.data()
        alias = w
        exec(f"w {op} pkg.nd.array(v, ctx=pkg.cpu())")
        exec(f"w {op} 2.0")
        assert w is alias
        out.append(p.data().asnumpy())
    np.testing.assert_array_equal(out[1], out[0])
    assert not np.array_equal(out[1], w0)


# ---------------------------------- 14. 3-D avg pooling of bf16 data
@pytest.mark.parametrize("attrs", [
    dict(kernel=(2, 2, 2), stride=(2, 2, 2), pool_type="avg"),
    dict(kernel=(2, 3, 2), stride=(1, 2, 2), pad=(1, 1, 0), pool_type="avg",
         count_include_pad=False, pooling_convention="full"),
    dict(kernel=(3, 3, 3), stride=(2, 2, 2), pad=(1, 1, 1), pool_type="sum"),
], ids=["avg", "avg_exclude_pad_full", "sum"])
def test_avg_pooling_3d_bf16_matches_jax(attrs):
    """torch has no bfloat16 `avg_pool3d` on the CPU, where the JAX op
    pools bf16 windows; the port averages them in float32 and rounds
    once.  Tolerance: one bf16 step (rtol and atol 2^-8 of the largest
    value), each side rounding the mean once."""
    x = np.random.RandomState(14).uniform(-2, 2, (2, 3, 5, 6, 4)) \
        .astype(np.float32)
    ref = np.asarray(jnn.pooling(jnp.asarray(x).astype(jnp.bfloat16),
                                 **attrs).astype(jnp.float32))
    got = tnn.pooling(torch.from_numpy(x).bfloat16(), **attrs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -8,
                               atol=2 ** -8 * np.abs(ref).max())


# ------------------------------------------ 15. NDArray.dtype is numpy's
@pytest.mark.parametrize("dtype", ["float16", "float32", "float64", "int8",
                                   "int32", "int64", "uint8", "bool",
                                   "bfloat16"])
def test_nd_array_dtype_matches_jax(dtype):
    """A numpy dtype that compares equal to the numpy type and to its
    name, as the JAX package's; bfloat16 is `ml_dtypes`'.  The JAX
    package runs without 64-bit types, so an explicit float64 or int64
    is stored as float32 or int32 in both packages."""
    src = np.arange(6).reshape(2, 3) % 2
    got = nd.array(src, ctx=mx.cpu(), dtype=dtype)
    stored = {"float64": "float32", "int64": "int32"}.get(dtype, dtype)
    assert isinstance(got.dtype, np.dtype)
    assert got.dtype == stored and got.dtype.name == stored
    assert got.astype(got.dtype).dtype == got.dtype
    ref = mxj.nd.array(src, ctx=mxj.cpu(), dtype=dtype)
    assert got.dtype == ref.dtype
    if dtype != "bfloat16":
        assert got.dtype == getattr(np, stored) == ref.dtype
        assert (got.dtype == np.float32) == (ref.dtype == np.float32)


# ------------------------- 16. views do not alias (writes stay local)
_VIEW_BASE = np.arange(6, dtype=np.float32).reshape(2, 1, 3)
_VIEWS = {
    "getitem": lambda nd, a: a[0],
    "slice": lambda nd, a: a[0:1],
    "reshape": lambda nd, a: nd.reshape(a, shape=(3, 2)),
    "flatten": lambda nd, a: nd.flatten(a),
    "expand_dims": lambda nd, a: a.expand_dims(0),
    "squeeze": lambda nd, a: a.squeeze(axis=1),
    "transpose": lambda nd, a: nd.transpose(a),
    "swapaxes": lambda nd, a: a.swapaxes(0, 2),
    "slice_axis": lambda nd, a: nd.slice_axis(a, axis=2, begin=1, end=3),
    "split": lambda nd, a: nd.split(a, num_outputs=3, axis=2)[1],
    "detach": lambda nd, a: a.detach(),
}


def _write(arr, how):
    if how == "setitem":
        arr[:] = 9
    else:
        arr += 1


@pytest.mark.parametrize("how", ["setitem", "iadd"])
@pytest.mark.parametrize("side", ["view", "base"])
@pytest.mark.parametrize("view", sorted(_VIEWS))
def test_views_do_not_alias(view, side, how):
    """Writing a view leaves its base alone and writing the base leaves
    its views alone, as with the JAX package's immutable arrays; the
    written array itself takes the write.  Exact: the same float32
    values."""
    got = {}
    for pkg in (mxj, mx):
        a = pkg.nd.array(_VIEW_BASE, ctx=pkg.cpu())
        b = _VIEWS[view](pkg.nd, a)
        _write(b if side == "view" else a, how)
        got[pkg.__name__] = (a.asnumpy(), b.asnumpy())
    (ja, jb), (ta, tb) = got[mxj.__name__], got[mx.__name__]
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    untouched = ta if side == "view" else tb
    np.testing.assert_array_equal(
        untouched, _VIEW_BASE if side == "view" else
        _VIEWS[view](mxj.nd, mxj.nd.array(_VIEW_BASE, ctx=mxj.cpu()))
        .asnumpy())


def test_a_view_written_twice_and_its_own_views():
    """A view of a view: writing the middle one leaves both ends alone;
    writing the base afterwards leaves the last view as it was."""
    with mx.cpu():
        a = nd.array(_VIEW_BASE)
        b = a.reshape((6,))
        c = b[2:4]
        b[:] = 5
        np.testing.assert_array_equal(a.asnumpy(), _VIEW_BASE)
        np.testing.assert_array_equal(c.asnumpy(), [2, 3])
        a += 1
        np.testing.assert_array_equal(c.asnumpy(), [2, 3])
        np.testing.assert_array_equal(b.asnumpy(), np.full(6, 5))
        np.testing.assert_array_equal(a.asnumpy(), _VIEW_BASE + 1)


# ------------------------------- 17. assignment inside record() raises
def test_setitem_inside_record_raises():
    """`x[k] = v` inside `autograd.record()` raises MXNetError with the
    JAX package's message, in both packages, and writes nothing."""
    x = np.ones((2, 3), np.float32)
    for pkg, ag in ((mxj, jag), (mx, autograd)):
        a = pkg.nd.array(x, ctx=pkg.cpu())
        a.attach_grad()
        with ag.record():
            with pytest.raises(pkg.MXNetError,
                               match="in-place assignment on an array is "
                                     "not allowed inside autograd.record"):
                a[0] = 5
        np.testing.assert_array_equal(a.asnumpy(), x)


# ------------------------------ 18. softmax of integer data is float32
@pytest.mark.parametrize("op,kw", [
    ("softmax", {}), ("softmax", {"temperature": 2.0}),
    ("softmax", {"dtype": "float16"}), ("softmax", {"axis": 0}),
    ("softmax", {"use_length": True, "length": True}),
    ("softmax", {"use_length": True, "length": True, "temperature": 0.5}),
    ("log_softmax", {}), ("log_softmax", {"temperature": 3.0}),
    ("log_softmax", {"dtype": "float16"})],
    ids=lambda v: v if isinstance(v, str) else "-".join(v) or "plain")
def test_softmax_of_int_data_is_float32(op, kw):
    """int32 data gives float32 (or the asked dtype), as `jax.nn`'s
    softmaxes give.  Tolerance rtol 1e-6 (float32; float16 outputs
    1 ulp, 2^-10)."""
    x = np.random.RandomState(16).randint(-3, 4, (3, 5)).astype(np.int32)
    lengths = np.array([1, 5, 3], np.int32)
    outs = []
    for pkg in (mxj, mx):
        args = [pkg.nd.array(x, ctx=pkg.cpu())]
        kwargs = dict(kw)
        if kwargs.pop("length", False):
            args.append(pkg.nd.array(lengths, ctx=pkg.cpu()))
        outs.append(getattr(pkg.nd, op)(*args, **kwargs))
    ref, got = outs
    assert got.dtype == ref.dtype == np.dtype(kw.get("dtype", "float32"))
    rtol = 2 ** -10 if "dtype" in kw else 1e-6
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=rtol,
                               atol=1e-7)


# ------------------------------------- 19. NumPy's indexing forms
_IDX_BASE = np.arange(60, dtype=np.float32).reshape(4, 5, 3)
_KEYS = {
    "reverse": lambda nd: slice(None, None, -1),
    "neg_step_2": lambda nd: (slice(None), slice(None, None, -2)),
    "neg_step_bounds": lambda nd: (slice(3, 0, -1), 1),
    "neg_step_empty": lambda nd: (slice(0, 3, -1),),
    "step_3": lambda nd: (slice(None), slice(4, None, -3), slice(None, None, 2)),
    "none": lambda nd: (None, 0),
    "none_middle": lambda nd: (1, None, slice(1, 3)),
    "ellipsis": lambda nd: (Ellipsis, 1),
    "ellipsis_none": lambda nd: (0, Ellipsis, None),
    "list": lambda nd: [0, 2],
    "negative_int": lambda nd: (-1, -2),
    "two_ndarrays": lambda nd: (nd.array(np.array([0, 3]), ctx=nd.cpu_ctx),
                                nd.array(np.array([1, 4]), ctx=nd.cpu_ctx)),
    "two_numpy": lambda nd: (np.array([2, 1]), np.array([[0], [4]])),
    "slice_and_array": lambda nd: (slice(1, None), np.array([0, 2, 4])),
    "array_and_reverse": lambda nd: (np.array([3, 0]), slice(None, None, -1)),
    "ellipsis_array": lambda nd: (Ellipsis, [2, 0]),
}


class _NS:
    """A package's `nd` with the CPU context beside it."""

    def __init__(self, pkg):
        self.array, self.cpu_ctx = pkg.nd.array, pkg.cpu()


@pytest.mark.parametrize("key", sorted(_KEYS))
def test_getitem_setitem_forms_match_jax(key):
    """Reads and writes with negative and non-unit steps, None, Ellipsis,
    lists and tuples of NDArray or numpy index arrays, against the JAX
    package.  Exact: the same float32 values gathered and written."""
    reads, writes = [], []
    for pkg in (mxj, mx):
        ns = _NS(pkg)
        a = pkg.nd.array(_IDX_BASE, ctx=pkg.cpu())
        r = a[_KEYS[key](ns)]
        reads.append(r.asnumpy())
        a[_KEYS[key](ns)] = np.arange(r.size, dtype=np.float32).reshape(
            r.shape) + 100
        writes.append(a.asnumpy())
    assert reads[1].shape == reads[0].shape
    np.testing.assert_array_equal(reads[1], reads[0])
    np.testing.assert_array_equal(writes[1], writes[0])


def test_float_index_arrays_raise():
    """A float index array raises TypeError in both packages, read or
    write (a float32 NDArray, the default dtype of `nd.array([0, 1])`)."""
    for pkg in (mxj, mx):
        a = pkg.nd.array(_IDX_BASE, ctx=pkg.cpu())
        idx = pkg.nd.array([0, 1], ctx=pkg.cpu())
        with pytest.raises(TypeError):
            a[idx]
        with pytest.raises(TypeError):
            a[np.array([0.0, 1.0])] = 1


# ------------------------------------ 20. a scalar keeps the dtype
_SCALAR_OPS = {
    "add": lambda x, s: x + s, "radd": lambda x, s: s + x,
    "sub": lambda x, s: x - s, "rsub": lambda x, s: s - x,
    "mul": lambda x, s: x * s, "rmul": lambda x, s: s * x,
    "div": lambda x, s: x / s, "rdiv": lambda x, s: s / x,
    "pow": lambda x, s: x ** s, "rpow": lambda x, s: s ** x,
    "mod": lambda x, s: x % s, "rmod": lambda x, s: s % x,
}


def _iadd(x, s):
    x += s
    return x


_SCALAR_OPS["iadd"] = _iadd
_ULP = {"int32": 0, "float32": 1e-6, "float16": 2 ** -10,
        "bfloat16": 2 ** -7}


_SCALARS = {"int": 3, "float": 2.5, "bool": True, "np_float32": np.float32(1.5)}


@pytest.mark.parametrize("dtype", ["int32", "float16", "bfloat16", "float32"])
@pytest.mark.parametrize("op,scalar", [
    (op, sc) for op in sorted(_SCALAR_OPS) for sc in _SCALARS
    # a numpy scalar on the left is numpy's to handle, in both packages
    if not (op.startswith("r") and sc == "np_float32")])
def test_scalar_operand_keeps_dtype(op, scalar, dtype):
    """A Python or numpy scalar is cast to the array's dtype first (the
    JAX `_scalar_*` ops): int32 + 2.5 is int32 and int32 / 3 float32, in
    both packages, reversed forms and `+=` too.  Tolerance: exact for an
    int32 result, else 1 ulp of the result's dtype (rtol 1e-6 float32,
    2^-10 float16, 2^-7 bfloat16)."""
    scalar = _SCALARS[scalar]
    x = np.array([[1, 2, 3], [4, 5, 7]], np.float32)
    outs = []
    for pkg in (mxj, mx):
        a = pkg.nd.array(x, ctx=pkg.cpu(), dtype=dtype)
        outs.append(_SCALAR_OPS[op](a, scalar))
    ref, got = outs
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_allclose(_numpy(got), _numpy(ref),
                               rtol=_ULP[got.dtype.name], atol=0)


@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16"])
def test_numpy_array_operand_matches_jax(dtype):
    """A numpy array operand becomes an NDArray of its dtype, float64 as
    float32, before the broadcast op: int32 + float64 array is float32.
    Tolerance as above."""
    x = np.array([[1, 2, 3], [4, 5, 7]], np.float32)
    y = np.array([0.5, 1.25, 2.0])
    outs = []
    for pkg in (mxj, mx):
        a = pkg.nd.array(x, ctx=pkg.cpu(), dtype=dtype)
        outs.append([a + y, a * y, a - y.astype(np.int64)])
    for ref, got in zip(*outs):
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(_numpy(got), _numpy(ref),
                                   rtol=_ULP[got.dtype.name], atol=0)


# --------------------------------------------- 21. repr and asscalar
def test_repr_is_numpy_str():
    """`repr`/`str` print numpy's `str` form of the values, as the JAX
    package does."""
    for pkg in (mxj, mx):
        z = pkg.nd.zeros((2, 2), ctx=pkg.cpu())
        assert "[[0. 0.]\n [0. 0.]]" in repr(z)
        assert "[[0. 0.]\n [0. 0.]]" in str(z)
        assert "array(" not in repr(z)


@pytest.mark.parametrize("dtype", ["int32", "float32", "uint8"])
def test_asscalar_keeps_numpy_type(dtype):
    """`asscalar()` gives a numpy scalar of the dtype (np.int32 for
    int32), as the JAX package's, not a Python number."""
    for pkg in (mxj, mx):
        v = pkg.nd.array(np.array([7], dtype), ctx=pkg.cpu()).asscalar()
        assert type(v) is np.dtype(dtype).type and v == 7


def test_views_stay_apart_under_threads():
    """Views made and bases written from 8 threads at once, with the
    interpreter switching threads often: every view keeps its values
    (the registry of views is shared by the threads)."""
    import sys
    import threading
    errors = []

    def work(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(100):
                x = rng.rand(4, 3).astype(np.float32)
                with mx.cpu():
                    a = nd.array(x)
                views = [a[0], a.reshape((3, 4)), a.T]
                a += 1
                views[1][:] = 0
                if not (np.array_equal(views[0].asnumpy(), x[0])
                        and np.array_equal(views[2].asnumpy(), x.T)
                        and np.array_equal(a.asnumpy(), x + 1)):
                    errors.append(seed)
        except Exception as e:   # noqa: BLE001 - reported by the assert
            errors.append(repr(e))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_inplace_inside_record_is_recorded():
    """`y += x` inside `record()` rebinds y to the recorded sum, so the
    gradient flows through it: z = sum((2x + x)^2) gives 18x.  The JAX
    package rebinds y's data but keeps its tape node, so its gradient
    drops the `+= x` (12x here): a reference fact the port does not
    copy (ROADMAP.md).  Exact: float32 products of small integers."""
    x0 = np.arange(3, dtype=np.float32)
    x = nd.array(x0, ctx=mx.cpu())
    x.attach_grad()
    with autograd.record():
        y = x * 2
        y += x
        z = (y * y).sum()
    z.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), 18 * x0)
    jx = mxj.nd.array(x0, ctx=mxj.cpu())
    jx.attach_grad()
    with jag.record():
        jy = jx * 2
        jy += jx
        jz = (jy * jy).sum()
    jz.backward()
    np.testing.assert_array_equal(jx.grad.asnumpy(), 12 * x0)


# ----------------------------------- 22. names the JAX package exports
def test_exported_names_match_jax(tmp_path):
    """`gluon.nn.HybridBlock`/`Block`, `mx.rtc`, `mx.operator`,
    `parallel.save_sharded`/`load_sharded` and `gluon.utils.check_sha1`
    exist in both packages, and `check_sha1` agrees."""
    for pkg in (mxj, mx):
        assert pkg.gluon.nn.HybridBlock is pkg.gluon.HybridBlock
        assert pkg.gluon.nn.Block is pkg.gluon.Block
        assert pkg.rtc.__name__.endswith(".rtc")
        assert pkg.operator.__name__.endswith(".operator")
        assert callable(pkg.parallel.save_sharded)
        assert callable(pkg.parallel.load_sharded)
    path = tmp_path / "blob.bin"
    path.write_bytes(b"mxnet" * 1000)
    import hashlib
    digest = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    for h in (digest, "0" * 40):
        assert mx.gluon.utils.check_sha1(str(path), h) == \
            mxj.gluon.utils.check_sha1(str(path), h) == (h == digest)


# ----------------------- 23. a Python scalar as a binary op's second operand
_SCALAR_SECOND = ["maximum", "minimum", "broadcast_maximum", "add", "subtract",
               "multiply", "divide", "power", "mod", "equal", "not_equal",
               "greater", "greater_equal", "lesser", "lesser_equal",
               "logical_and", "logical_or", "logical_xor",
               "broadcast_equal", "broadcast_greater", "broadcast_hypot"]


@pytest.mark.parametrize("op", _SCALAR_SECOND)
@pytest.mark.parametrize("dtype,scalar", [("float32", 4), ("int32", 4),
                                          ("int32", 4.5), ("float32", 0)])
def test_scalar_second_operand_matches_jax(op, dtype, scalar):
    """`nd.<op>(x, 4)`: the number takes part as a weak scalar (an int
    keeps int32, a float makes it float32), dtype and values exact but
    hypot's, whose libm and XLA forms may differ by one float32 ulp."""
    x = np.array([[1, 5, 2], [7, 3, 9]]).astype(dtype)
    got = getattr(nd, op)(nd.array(x, ctx=mx.cpu(), dtype=dtype), scalar)
    ref = getattr(mxj.nd, op)(mxj.nd.array(x, dtype=dtype), scalar)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    if op == "broadcast_hypot":
        np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(),
                                   rtol=2 ** -23, atol=0)
    else:
        np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())


# ------------------- 24. RowSparseNDArray members inherited from NDArray
def test_row_sparse_members_match_jax():
    """astype and copyto/as_in_context keep row_sparse, detach is dense,
    wait_to_read and attach_grad return None, copyto a dense array
    writes the values, and the indices are int32."""
    v = np.arange(6, dtype=np.float32).reshape(2, 3) + 1
    idx = np.array([0, 2])
    res = {}
    for pkg in (mx, mxj):
        with pkg.cpu():
            a = pkg.nd.sparse.row_sparse_array((v, idx), shape=(4, 3))
            dense = pkg.nd.zeros((4, 3))
        out = [a.astype("float16"), a.copyto(pkg.cpu()),
               a.as_in_context(pkg.cpu())]
        res[pkg] = ([type(o).__name__ for o in out + [a.detach()]],
                    [str(o.dtype) for o in out],
                    [o.asnumpy() for o in out],
                    a.wait_to_read(), a.attach_grad(),
                    a.copyto(dense).asnumpy(), str(a.indices.dtype),
                    a.grad.asnumpy())
    got, ref = res[mx], res[mxj]
    assert got[0] == ref[0] == ["RowSparseNDArray"] * 3 + ["NDArray"]
    # the JAX detach is an NDArray without values; the port's holds them
    np.testing.assert_array_equal(
        mx.nd.sparse.row_sparse_array((v, idx), shape=(4, 3),
                                      ctx=mx.cpu()).detach().asnumpy(),
        ref[2][0].astype(np.float32))
    assert got[1] == ref[1]
    for g, r in zip(got[2], ref[2]):
        np.testing.assert_array_equal(g, r)
    assert got[3] is None and got[4] is None and ref[3] is None
    np.testing.assert_array_equal(got[5], ref[5])
    assert got[6] == ref[6] == "int32"
    np.testing.assert_array_equal(got[7], ref[7])


# ----------------- 25. an explicitly requested 64-bit dtype is 32-bit
_MAKERS = {
    "array": lambda m, dt: m.nd.array(np.arange(4), dtype=dt),
    "zeros": lambda m, dt: m.nd.zeros((2,), dtype=dt),
    "ones": lambda m, dt: m.nd.ones((2,), dtype=dt),
    "full": lambda m, dt: m.nd.full((2,), 3, dtype=dt),
    "arange": lambda m, dt: m.nd.arange(3, dtype=dt),
    "eye": lambda m, dt: m.nd.eye(2, dtype=dt),
    "astype": lambda m, dt: m.nd.array(np.ones(3, np.float32)).astype(dt),
    "cast": lambda m, dt: m.nd.cast(m.nd.array(np.ones(3, np.float32)),
                                    dtype=dt),
    "uniform": lambda m, dt: m.nd.random.uniform(shape=(2,), dtype=dt),
    "normal": lambda m, dt: m.nd.random.normal(shape=(2,), dtype=dt),
    "randint": lambda m, dt: m.nd.random.randint(0, 5, shape=(2,),
                                                 dtype=dt),
}
# the float samplers take float types, randint integer ones (the JAX
# samplers raise otherwise)
_DTYPE_CASES = [(m, dt) for m in sorted(_MAKERS)
                for dt in ("int64", "float64", np.int64, np.float64)
                if not (m in ("uniform", "normal") and "int" in str(dt))
                and not (m == "randint" and "float" in str(dt))]


@pytest.mark.parametrize("maker,dt", _DTYPE_CASES)
def test_explicit_64_bit_dtype_is_32_bit(maker, dt):
    with mx.cpu():
        got = _MAKERS[maker](mx, dt)
    ref = _MAKERS[maker](mxj, dt)
    assert got.dtype == ref.dtype and got.dtype.itemsize == 4, \
        (got.dtype, ref.dtype)


# -------------------- 26. topk(ret_typ="value") takes no gradient
@pytest.mark.parametrize("ret_typ", ["value", "both"])
def test_topk_value_takes_no_gradient(ret_typ):
    """The JAX op is registered non-differentiable: only the other term
    of the loss reaches x."""
    x0 = np.array([[1.0, 4.0, 2.0], [3.0, 0.0, 5.0]], np.float32)
    grads = []
    for pkg in (mx, mxj):
        with pkg.cpu():
            x = pkg.nd.array(x0)
        x.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.topk(x, k=2, ret_typ=ret_typ)
            top = out[0] if ret_typ == "both" else out
            loss = top.sum() + (x * 2).sum()
        loss.backward()
        grads.append(x.grad.asnumpy())
    np.testing.assert_array_equal(grads[0], grads[1])
    np.testing.assert_array_equal(grads[0], np.full_like(x0, 2.0))


# ------------------------------------ 27. the gradient of abs at 0 is 1
def test_abs_gradient_at_zero_matches_jax():
    """d|x|/dx is 1 at 0 (and |-0.0| is 0.0), so L1Loss at a zero
    residual gives the JAX package's gradient."""
    x0 = np.array([0.0, -0.0, -1.5, 2.0], np.float32)
    res = {}
    for pkg in (mx, mxj):
        with pkg.cpu():
            x = pkg.nd.array(x0)
            p = pkg.nd.array(np.array([[1.0, 2.0]], np.float32))
            lab = pkg.nd.array(np.array([[1.0, 3.0]], np.float32))
        x.attach_grad()
        p.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.abs(x)
            loss = pkg.gluon.loss.L1Loss()(p, lab)
        y.backward()
        loss.backward()
        res[pkg] = (y.asnumpy(), x.grad.asnumpy(), p.grad.asnumpy())
    for g, r in zip(res[mx], res[mxj]):
        np.testing.assert_array_equal(g, r)
    assert not np.signbit(res[mx][0]).any()
    np.testing.assert_array_equal(res[mx][1], [1, 1, -1, 1])


# ------------ 28. an out-of-range integer index: reads clamp, writes drop
_OOR_KEYS = [5, -5, (1, 7), (slice(None), 4), (-9, slice(0, 2)),
             [0, 5], [-7, 1], ([1, 3], [0, -8]), (slice(None), [2, 9, -1])]


@pytest.mark.parametrize("key", _OOR_KEYS, ids=[str(k) for k in _OOR_KEYS])
def test_out_of_range_index_matches_jax(key):
    """`x[k]` reads the nearest row where k is past an end, and `x[k] = v`
    drops what lies out of range, as the JAX package's gathers and
    `.at[].set` do."""
    x0 = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = nd.array(x0, ctx=mx.cpu())
    j = mxj.nd.array(x0)
    tk = tuple(np.array(k) if isinstance(k, list) else k for k in key) \
        if isinstance(key, tuple) else (np.array(key)
                                        if isinstance(key, list) else key)
    np.testing.assert_array_equal(t[tk].asnumpy(), j[tk].asnumpy())
    t[tk] = -1
    j[tk] = -1
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


# ------------- 29. casts to integers saturate; integer % 0 is 0
@pytest.mark.parametrize("dtype", ["uint8", "int8", "int32"])
def test_float_to_int_cast_saturates_like_jax(dtype):
    x0 = np.array([300.0, -1.0, np.nan, 255.7, -0.5, 3e9, -3e9, np.inf,
                   -np.inf, 127.9], np.float32)
    for how in ("astype", "cast"):
        with mx.cpu():
            x = nd.array(x0)
            got = x.astype(dtype) if how == "astype" else \
                nd.cast(x, dtype=dtype)
        jx = mxj.nd.array(x0)
        ref = jx.astype(dtype) if how == "astype" else \
            mxj.nd.cast(jx, dtype=dtype)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())


def test_integer_mod_by_zero_matches_jax():
    x0 = np.array([[1, -5, 2], [7, 3, -9]], np.int32)
    d0 = np.array([[0, 2, 0], [-3, 0, 4]], np.int32)
    with mx.cpu():
        x, d = nd.array(x0, dtype="int32"), nd.array(d0, dtype="int32")
        got = [x % 0, nd.broadcast_mod(x, d), x % d, 7 % d]
    jx, jd = mxj.nd.array(x0, dtype="int32"), mxj.nd.array(d0, dtype="int32")
    ref = [jx % 0, mxj.nd.broadcast_mod(jx, jd), jx % jd, 7 % jd]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g.asnumpy(), r.asnumpy())


# ---------------------------------------- 30. Embedding of int weights
@pytest.mark.parametrize("dtype", ["int32", "uint8", "float32"])
def test_embedding_of_integer_weights_matches_jax(dtype):
    """Rows for the ids in range, and `jnp.take`'s fill for the others
    (the least int32, the largest uint8, NaN)."""
    w = np.arange(6).reshape(3, 2).astype(dtype)
    ids = np.array([0, 2, 7, -1, -4], np.int32)
    with mx.cpu():
        got = nd.Embedding(nd.array(ids, dtype="int32"),
                           nd.array(w, dtype=dtype), input_dim=3,
                           output_dim=2)
    ref = mxj.nd.Embedding(mxj.nd.array(ids, dtype="int32"),
                           mxj.nd.array(w, dtype=dtype), input_dim=3,
                           output_dim=2)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())


# ---------------- 31. two places where the port keeps upstream MXNet
@pytest.mark.parametrize("req,fn,jax_grad", [
    ("write", lambda x: (x * 2) * 3, 18.0),
    ("add", lambda x: x * 3, 9.0)], ids=["write", "add"])
def test_second_backward_of_a_retained_graph_departs(req, fn, jax_grad):
    """A second `backward()` of a graph kept with `retain_graph=True`:
    the port gives upstream MXNet's result (6 under "write", 3 + 3
    under "add"); the JAX tape keeps each node's cotangent, so its
    second pass adds to the first (18 and 9).  ROADMAP.md keeps the
    departure; both results are held here."""
    res = {}
    for pkg in (mx, mxj):
        with pkg.cpu():
            x = pkg.nd.array(np.array([1.0], np.float32))
        x.attach_grad(grad_req=req)
        with pkg.autograd.record():
            y = fn(x)
        y.backward(retain_graph=True)
        y.backward()
        res[pkg] = float(x.grad.asnumpy()[0])
    assert res[mx] == 6.0
    assert res[mxj] == jax_grad


def test_grad_with_create_graph_departs():
    """`autograd.grad(create_graph=True)`: the port returns a gradient
    that is itself differentiable (upstream MXNet's), the JAX package
    raises.  ROADMAP.md keeps the departure; both results are held
    here."""
    x0 = np.array([1.0, 2.0], np.float32)
    with mx.cpu():
        x = nd.array(x0)
    x.attach_grad()
    with autograd.record():
        z = (x ** 3).sum()
        g = autograd.grad(z, [x], create_graph=True)[0]
        s = g.sum()
    s.backward()
    np.testing.assert_array_equal(g.asnumpy(), 3 * x0 ** 2)
    np.testing.assert_array_equal(x.grad.asnumpy(), 6 * x0)
    jx = mxj.nd.array(x0)
    jx.attach_grad()
    with pytest.raises(mxj.MXNetError):
        with jag.record():
            jz = (jx ** 3).sum()
            jag.grad(jz, [jx], create_graph=True)


# -- the image paths that needed PIL ------------------------------------------
#
# `imresize` of uint8 data and `recordio.pack_img` / `unpack_img` imported
# PIL, which the card's host does not have.  Each test computes the JAX
# reference (PIL) first, then blocks PIL (`sys.modules["PIL"] = None`
# makes every `import PIL...` raise) and runs the port.  Tolerance: none;
# the port's resampler and JPEG codec reproduce PIL's arithmetic.

def _block_pil(monkeypatch):
    import sys
    for name in [m for m in sys.modules if m.split(".")[0] == "PIL"]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "PIL", None)


def _blocks_image(h, w, c, seed):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (4, 4, c)).astype(np.float32)
    big = np.kron(base, np.ones((h // 4 + 1, w // 4 + 1, 1), np.float32))
    return np.clip(big[:h, :w] + rng.randn(h, w, c) * 12, 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
def test_imresize_uint8_without_pil(monkeypatch, interp):
    from incubator_mxnet_tpu import image as jimage
    from incubator_mxnet_torch import image as timage
    img = _blocks_image(21, 30, 3, interp)
    refs = {size: jimage.imresize(img, *size, interp)
            for size in ((45, 13), (11, 40))}
    _block_pil(monkeypatch)
    for size, ref in refs.items():
        np.testing.assert_array_equal(timage.imresize(img, *size, interp),
                                      ref)


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_without_pil(monkeypatch, fmt):
    from incubator_mxnet_tpu import recordio as jrec
    from incubator_mxnet_torch import recordio as trec
    img = _blocks_image(19, 26, 3, 7)
    ref = jrec.unpack_img(jrec.pack_img(jrec.IRHeader(0, 2.0, 5, 0), img,
                                        quality=85, img_fmt=fmt))[1]
    _block_pil(monkeypatch)
    packed = trec.pack_img(trec.IRHeader(0, 2.0, 5, 0), img, quality=85,
                           img_fmt=fmt)
    hdr, got = trec.unpack_img(packed)
    assert (hdr.label, hdr.id) == (2.0, 5)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("iscolor", [1, 0])
def test_unpack_img_without_pil(monkeypatch, iscolor):
    from incubator_mxnet_tpu import recordio as jrec
    from incubator_mxnet_torch import recordio as trec
    packed = jrec.pack_img(jrec.IRHeader(0, 1.0, 3, 0),
                           _blocks_image(24, 17, 3, 11), quality=90)
    ref = jrec.unpack_img(packed, iscolor)[1]
    _block_pil(monkeypatch)
    got = trec.unpack_img(packed, iscolor)[1]
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if not iscolor:   # PIL's convert("L") weights of the decoded RGB
        rgb = trec.unpack_img(packed)[1].astype(np.uint32)
        np.testing.assert_array_equal(
            got, (rgb[..., 0] * 19595 + rgb[..., 1] * 38470
                  + rgb[..., 2] * 7471 + 0x8000) >> 16)


def test_port_imports_no_pil_cv2_or_jax():
    """Every module of the port imports, and the image paths run, in a
    process where PIL, cv2, jax and the JAX package cannot be imported."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "incubator_mxnet_torch")
    mods = []
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), root)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    code = (
        "import sys, importlib\n"
        "for m in ('PIL', 'cv2', 'jax', 'jaxlib', 'incubator_mxnet_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {sorted(mods)!r}:\n"
        "    importlib.import_module(m)\n"
        "import numpy as np\n"
        "from incubator_mxnet_torch import image, recordio\n"
        "a = np.arange(300, dtype=np.uint8).reshape(10, 10, 3)\n"
        "image.imresize(a, 7, 13, 2)\n"
        "h, b = recordio.unpack_img(recordio.pack_img("
        "recordio.IRHeader(0, 1.0, 0, 0), a))\n"
        "assert b.shape == (10, 10, 3)\n"
        "print('OK', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=root, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout
