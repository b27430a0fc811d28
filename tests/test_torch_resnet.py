"""The ResNet slice: convolution, pooling and BatchNorm, the Gluon layers
over them, ResNet v1/v1b and its training, in the port against the JAX
package on the CPU.

Inputs come from numpy with a seed and go to both packages; weights go
from the JAX package into the port through `convert.params_from_jax`.
Tolerances, with their reasons:

- float32 ops, forward and backward: rtol 1e-5, atol 1e-5 of the
  largest reference value — the same arithmetic, sums (convolution,
  pooling windows, batch statistics) in another order;
- bfloat16 ops: two bf16 steps (rtol 2^-7) plus atol 2^-7 of the largest
  reference value — each side rounds to bf16 after every op, but XLA may
  keep a fused chain in float32 and round once, so an element can land
  one step away, and a sum whose last bit differs can round either way;
- the gradients of a convolution's bias and of BatchNorm's gamma and
  beta in bfloat16, sums over N·H·W positions: rtol and atol 2^-5 of the
  largest value — XLA on the CPU accumulates those sums in bfloat16 (72
  terms of ~1 moved 10.25 to 10.5 here), torch in float32;
- the resnet50_v1b forward (float32, 1 x 3 x 32 x 32): atol 1e-5 on
  logits of ~0.1 through 53 convolutions;
- the narrow v1b net (float32, batch 8 x 3 x 32 x 32): gradients of
  step 1 atol 1e-4 of each parameter's largest (measured 1.3e-5: the
  batch statistics' E[x²] − mean² cancels where a channel's mean is
  large beside its spread, which scales the sums' last-bit differences);
  the 3-step SGD trajectory's losses rtol 1e-4, weights and running stats
  rtol 1e-4, atol 1e-5 (measured at a quarter of that).  The learning
  rate is 0.01: at `bench_resnet50`'s 0.1 the loss falls from 2.5 to 0.8
  in three steps on one batch of 8 and the same 1e-5 differences grow
  past 1e-3 (on both packages' side of the comparison alike).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu.models import resnet as jresnet
from incubator_mxnet_tpu.ops import nn as jnn

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd, parallel
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.gluon import nn
from incubator_mxnet_torch.models import get_model, resnet
from incubator_mxnet_torch.ops import nn as tnn

F32 = dict(rtol=1e-5, atol_of_max=1e-5)
BF16 = dict(rtol=2 ** -7, atol_of_max=2 ** -7)
TOL = {"float32": F32, "bfloat16": BF16}
LOSS_TOL = dict(rtol=1e-4, atol=0)
WEIGHT_TOL = dict(rtol=1e-4, atol=1e-5)
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


BF16_SUM = dict(rtol=2 ** -5, atol_of_max=2 ** -5)


def _close(got, ref, dtype, what="", tol=None):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, what
    tol = tol or TOL[dtype]
    np.testing.assert_allclose(
        got, ref, rtol=tol["rtol"],
        atol=tol["atol_of_max"] * max(np.abs(ref).max(), 1e-30),
        err_msg=what)


def _pair(*arrays, dtype):
    """Each numpy array as a JAX array and a torch leaf of `dtype`."""
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    js = [jnp.asarray(a).astype(jd) for a in arrays]
    ts = [torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(td)
          .requires_grad_() for j in js]
    return js, ts


def _check_fwd_bwd(jfn, tfn, arrays, dtype, seed=0, grad_tols=()):
    """jfn on JAX arrays and tfn on torch tensors: outputs, then the
    gradients of <out, g> with g seeded, for every input (input i held to
    `grad_tols[i]` where one is given)."""
    js, ts = _pair(*arrays, dtype=dtype)
    jout, vjp = jax.vjp(jfn, *js)
    tout = tfn(*ts)
    _close(tout, jout, dtype, "forward")
    g = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    jg = jnp.asarray(g).astype(jout.dtype)
    jgrads = vjp(jg)
    tgrads = torch.autograd.grad(
        tout, ts, torch.from_numpy(np.asarray(jg.astype(jnp.float32))).to(
            tout.dtype), allow_unused=True)
    for i, (a, b) in enumerate(zip(tgrads, jgrads)):
        if a is None:                    # an input the output ignores
            assert not np.asarray(b).any(), i
            continue
        tol = grad_tols[i] if i < len(grad_tols) else None
        _close(a, b, dtype, f"gradient of input {i}", tol)


# ---------------------------------------------------------------- ops
CONV_CASES = [
    # (data shape, weight shape, attrs)
    ((2, 4, 9, 9), (6, 4, 3, 3), dict(kernel=(3, 3), pad=(1, 1))),
    ((2, 4, 10, 10), (6, 4, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                        pad=(1, 1))),
    ((2, 4, 11, 11), (6, 4, 3, 3), dict(kernel=(3, 3), dilate=(2, 2),
                                        pad=(2, 2))),
    ((2, 8, 8, 8), (8, 2, 3, 3), dict(kernel=(3, 3), pad=(1, 1),
                                      num_group=4)),
    ((2, 3, 16, 16), (8, 3, 7, 7), dict(kernel=(7, 7), stride=(2, 2),
                                        pad=(3, 3))),
    ((2, 6, 7, 7), (5, 6, 1, 1), dict(kernel=(1, 1), stride=(2, 2))),
    ((2, 4, 12), (3, 4, 3), dict(kernel=(3,), pad=(1,))),
]


@DTYPES
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_convolution_matches_jax(case, dtype):
    dshape, wshape, attrs = CONV_CASES[case]
    rng = np.random.RandomState(case)
    data = rng.randn(*dshape).astype(np.float32)
    weight = (rng.randn(*wshape) * 0.3).astype(np.float32)
    _check_fwd_bwd(lambda d, w: jnn.convolution(d, w, **attrs),
                   lambda d, w: tnn.convolution(d, w, **attrs),
                   [data, weight], dtype, seed=case)


@DTYPES
def test_convolution_bias_is_added_after(dtype):
    rng = np.random.RandomState(7)
    arrays = [rng.randn(2, 3, 6, 6).astype(np.float32),
              rng.randn(4, 3, 3, 3).astype(np.float32),
              rng.randn(4).astype(np.float32)]
    attrs = dict(kernel=(3, 3), pad=(1, 1), num_filter=4)
    _check_fwd_bwd(lambda d, w, b: jnn.convolution(d, w, b, **attrs),
                   lambda d, w, b: tnn.convolution(d, w, b, **attrs),
                   arrays, dtype,
                   grad_tols=(None, None, BF16_SUM if dtype == "bfloat16"
                              else None))


POOL_CASES = [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(2, 2), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         count_include_pad=False),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         pooling_convention="full", count_include_pad=False),
    dict(kernel=(2, 2), stride=(2, 2), pool_type="avg",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="sum"),
    dict(global_pool=True, pool_type="max"),
    dict(global_pool=True, pool_type="avg"),
    dict(global_pool=True, pool_type="sum"),
    dict(kernel=(3,), stride=(2,), pad=(1,), pool_type="max"),
]


@DTYPES
@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pooling_matches_jax(case, dtype):
    attrs = POOL_CASES[case]
    shape = (2, 3, 9) if len(attrs.get("kernel", (0, 0))) == 1 \
        else (2, 3, 9, 10)
    data = np.random.RandomState(case).randn(*shape).astype(np.float32)
    _check_fwd_bwd(lambda d: jnn.pooling(d, **attrs),
                   lambda d: tnn.pooling(d, **attrs), [data], dtype,
                   seed=case)


def test_pooling_rejects_unknown_pool_type():
    with pytest.raises(mx.MXNetError, match="lp"):
        tnn.pooling(torch.zeros(1, 1, 4, 4), kernel=(2, 2), pool_type="lp")


def _bn_arrays(C=5, seed=0, shape=(4, 5, 6, 6)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) * 2 + 0.5,
            rng.uniform(0.5, 1.5, C).astype(np.float32),
            rng.randn(C).astype(np.float32),
            rng.randn(C).astype(np.float32) * 0.1,
            rng.uniform(0.5, 2.0, C).astype(np.float32)]


@DTYPES
@pytest.mark.parametrize("train", [True, False], ids=["train", "predict"])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_matches_jax(dtype, train, fix_gamma):
    """out (forward and backward into data, gamma, beta) and the batch
    statistics, in train mode (batch stats) and predict mode (moving
    stats); the moving stats in the data's dtype, as after `cast`."""
    arrays = _bn_arrays(seed=int(train) + 2 * int(fix_gamma))
    attrs = dict(eps=1e-5, fix_gamma=fix_gamma)
    js, ts = _pair(*arrays, dtype=dtype)
    mode = autograd.train_mode() if train else autograd.predict_mode()

    def jfn(d, g, b):
        return jnn.batch_norm(d, g, b, js[3], js[4], _train=train,
                              **attrs)[0]

    def tfn(d, g, b):
        with mode:
            return tnn.batch_norm(d, g, b, ts[3].detach(), ts[4].detach(),
                                  **attrs)[0]
    _check_fwd_bwd(jfn, tfn, arrays[:3], dtype,
                   grad_tols=(None,) + (BF16_SUM,) * 2
                   if dtype == "bfloat16" else ())
    _, jmean, jvar = jnn.batch_norm(*js, _train=train, **attrs)
    with mode:
        _, tmean, tvar = tnn.batch_norm(*[t.detach() for t in ts], **attrs)
    assert tmean.dtype == tvar.dtype == getattr(torch, dtype)
    _close(tmean, jmean, dtype, "batch mean")
    _close(tvar, jvar, dtype, "batch var")


def test_batch_norm_variance_is_biased_unlike_f_batch_norm():
    """The batch variance is E[x²] − mean², the biased one;
    `F.batch_norm` would fold the unbiased one into the running stats."""
    x = torch.tensor([[1.0], [3.0]])
    with autograd.train_mode():
        _, mean, var = tnn.batch_norm(x, torch.ones(1), torch.zeros(1),
                                      torch.zeros(1), torch.ones(1), axis=1,
                                      fix_gamma=False)
    assert mean.item() == 2.0 and var.item() == 1.0


# -------------------------------------------------------------- layers
def _jax_bn_layer_pair(dtype, **kw):
    rng = np.random.RandomState(11)
    data = rng.randn(6, 4, 5, 5).astype(np.float32) * 1.5 + 0.3
    j = mxj.gluon.nn.BatchNorm(in_channels=4, **kw)
    j.initialize(ctx=mxj.cpu())
    with mx.cpu():
        t = nn.BatchNorm(in_channels=4, **kw)
        t.initialize()
    j.cast(dtype)
    t.cast(dtype)
    # start the running stats away from (0, 1)
    rm = rng.randn(4).astype(np.float32) * 0.1
    rv = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    for layer, arr in ((j, mxj.nd.array), (t, None)):
        for p, v in ((layer.running_mean, rm), (layer.running_var, rv)):
            p.set_data(arr(v, ctx=mxj.cpu()).astype(dtype) if arr else
                       torch.from_numpy(v))
    return j, t, data


@DTYPES
def test_batchnorm_layer_updates_running_stats_in_train_mode(dtype):
    j, t, data = _jax_bn_layer_pair(dtype)
    jx = mxj.nd.array(data, ctx=mxj.cpu()).astype(dtype)
    with mx.cpu():
        tx = nd.array(data).astype(dtype)
    with jag.record():
        jout = j(jx)
    with autograd.record():
        tout = t(tx)
    _close(tout._data, jout._data, dtype, "out")
    for name in ("running_mean", "running_var"):
        got = getattr(t, name).data()._data
        assert got.dtype == getattr(torch, dtype), name
        assert not got.requires_grad, name
        _close(got, getattr(j, name).data()._data, dtype, name)
    # the update is m·running + (1 − m)·batch: it moved
    assert not np.allclose(t.running_var.data().asnumpy(),
                           _jax_bn_layer_pair(dtype)[1].running_var.data()
                           .asnumpy())


def test_batchnorm_layer_predict_mode_uses_and_keeps_running_stats():
    j, t, data = _jax_bn_layer_pair("float32")
    before = [p.data().asnumpy().copy()
              for p in (t.running_mean, t.running_var)]
    with mx.cpu():
        tx = nd.array(data)
    with autograd.record(train_mode=False):
        tout = t(tx)
    jout = j(mxj.nd.array(data, ctx=mxj.cpu()))
    _close(tout._data, jout._data, "float32", "out")
    for p, b in zip((t.running_mean, t.running_var), before):
        np.testing.assert_array_equal(p.data().asnumpy(), b)
    with autograd.predict_mode():
        t(tx)
    for p, b in zip((t.running_mean, t.running_var), before):
        np.testing.assert_array_equal(p.data().asnumpy(), b)


def test_batchnorm_update_records_nothing_and_keeps_the_graph():
    """Inside `autograd.record()` the running-stat update is outside the
    graph: the output's gradient is the same with or without it, and the
    running stats never require grad."""
    with mx.cpu():
        t = nn.BatchNorm(in_channels=3)
        t.initialize()
        x = nd.array(np.random.RandomState(0).randn(4, 3, 2, 2)
                     .astype(np.float32))
    x.attach_grad()
    with autograd.record():
        y = t(x)
        t.running_mean.set_data(nd.mean(y, axis=(0, 2, 3)) * 2)
    y.backward()
    g1 = x.grad.asnumpy().copy()
    assert not t.running_mean.data()._data.requires_grad
    assert t.running_mean.data()._data.grad_fn is None
    with autograd.record():
        y = t(x)
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), g1, rtol=1e-6, atol=1e-7)


def test_conv_and_batchnorm_shapes_defer_to_the_first_forward():
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Conv2D(6, 3, padding=1, use_bias=False, groups=2),
                nn.BatchNorm(), nn.Activation("relu"), nn.MaxPool2D(),
                nn.GlobalAvgPool2D(), nn.Flatten())
        net.initialize(mx.init.Xavier())
        out = net(nd.zeros((2, 4, 8, 8)))
    assert out.shape == (2, 6)
    assert net[0].weight.shape == (6, 2, 3, 3)
    assert all(p.shape == (6,) for p in net[1].collect_params().values())
    net.cast("bfloat16")
    assert all(p.data().dtype == "bfloat16"
               for p in net.collect_params().values())


@pytest.mark.parametrize("name,value", [("bn_running_mean", 0.0),
                                        ("bn_moving_mean", 0.0),
                                        ("bn_running_var", 1.0),
                                        ("bn_moving_var", 1.0)])
def test_initializer_sets_batchnorm_states(name, value):
    """A BatchNorm state with no initializer of its own takes its
    conventional value under any initializer; Xavier would raise on 1-D."""
    for init in (mx.init.Xavier(), mx.init.Normal(0.5), mx.init.Uniform()):
        arr = torch.full((7,), 3.0)
        init(name, arr)
        assert torch.all(arr == value), (init, name)
    with mx.cpu():
        layer = nn.BatchNorm(in_channels=3, running_mean_initializer=None,
                             running_variance_initializer=None)
        layer.initialize(mx.init.Xavier())
    assert np.all(layer.running_mean.data().asnumpy() == 0)
    assert np.all(layer.running_var.data().asnumpy() == 1)


# -------------------------------------------------------------- models
def _weights(net):
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def test_resnet50_v1b_names_shapes_and_forward_match_jax():
    """267 structural names with their shapes, and the predict-mode
    forward of 1 x 3 x 32 x 32 from the same weights."""
    mxj.random.seed(0)
    jnet = jresnet.resnet50_v1b(classes=1000)
    jnet.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    x = np.random.RandomState(0).uniform(size=(1, 3, 32, 32)) \
        .astype(np.float32)
    jout = jnet(mxj.nd.array(x, ctx=mxj.cpu())).asnumpy()
    jw = _weights(jnet)
    tnet = get_model("resnet50_v1b", classes=1000)
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    names = tnet._collect_params_with_prefix()
    assert len(names) == len(jw) == 267
    assert list(names) == list(jw)
    params_from_jax(tnet, jw, ctx=mx.cpu())
    assert {k: tuple(p.shape) for k, p in names.items()} == \
        {k: v.shape for k, v in jw.items()}
    with mx.cpu():
        tout = tnet(nd.array(x)).asnumpy()
    assert tout.shape == (1, 1000)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,blocks", [("resnet18_v1", 8),
                                         ("resnet50_v1", 16),
                                         ("resnet101_v1b", 33)])
def test_resnet_constructors_match_jax_names(name, blocks):
    tnet = get_model(name, classes=10)
    jnet = getattr(jresnet, name)(classes=10)
    assert list(tnet._collect_params_with_prefix()) == \
        list(jnet._collect_params_with_prefix())
    assert sum(len(stage) for stage in list(tnet.features)[4:8]) == blocks
    assert tnet._model_spec == {"name": name, "kwargs": {"classes": 10}}


def test_model_zoo_get_model_and_unported_variants():
    from incubator_mxnet_torch.gluon.model_zoo.vision import get_model as zoo
    assert isinstance(zoo("resnet50_v1b", classes=10), resnet.ResNetV1)
    assert isinstance(zoo("resnet50_v2", classes=10), resnet.ResNetV2)
    with pytest.raises(mx.MXNetError, match="invalid resnet version"):
        resnet.get_resnet(3, 50)
    with pytest.raises(mx.MXNetError, match="unknown model"):
        get_model("resnet50_v3")


NARROW = dict(block=jresnet.BottleneckV1, layers=[1, 1, 1, 1],
              channels=[8, 16, 32, 64, 128], classes=10, v1b=True)
OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
GRAD_ATOL_OF_MAX = 1e-4


def _narrow_pair():
    """(JAX net, port net, data, label) of the narrow v1b net with the
    same weights, deferred shapes resolved by one predict-mode forward."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.float32)
    mxj.random.seed(0)
    jnet = jresnet.ResNetV1(**NARROW)
    jnet.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    jnet(mxj.nd.array(x, ctx=mxj.cpu()))
    tnet = resnet.ResNetV1(**dict(NARROW, block=resnet.BottleneckV1))
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    params_from_jax(tnet, _weights(jnet))
    return jnet, tnet, x, y


def _close_weights(tnet, jnet):
    got, ref = _weights(tnet), _weights(jnet)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **WEIGHT_TOL)


def test_params_from_jax_carries_running_stats():
    jnet, tnet, _x, _y = _narrow_pair()
    for layer in (jnet.features[1], tnet.features[1]):
        layer.running_var.set_data(layer.running_var.data() * 3.0)
    params_from_jax(tnet, _weights(jnet))
    np.testing.assert_array_equal(
        tnet.features[1].running_var.data().asnumpy(),
        jnet.features[1].running_var.data().asnumpy())
    assert not np.all(tnet.features[1].running_var.data().asnumpy() == 1)


def test_narrow_v1b_parallel_trainer_trajectory_matches_jax():
    """3 steps of SGD (momentum, wd) on the same batch, one `step` then
    `run_steps(2)`: every loss, then every weight and running stat."""
    jnet, tnet, x, y = _narrow_pair()
    jloss = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    jtr = jpar.ParallelTrainer(jnet, lambda o, l: jloss(o, l), "sgd", OPT,
                               mesh=jpar.default_mesh(1))
    ttr = parallel.ParallelTrainer(
        tnet, lambda o, l: tloss(o, l), "sgd", OPT,
        mesh=parallel.default_mesh(ctx=mx.cpu()))
    jd = [mxj.nd.array(a, ctx=mxj.cpu()) for a in (x, y)]
    with mx.cpu():
        td = [nd.array(a) for a in (x, y)]
    rm0 = tnet.features[1].running_mean.data().asnumpy().copy()
    jl = [float(jtr.step(*jd).asnumpy())]
    tl = [ttr.step(*td).asscalar()]
    jl.append(float(jtr.run_steps(2, *jd).asnumpy()))
    tl.append(ttr.run_steps(2, *td).asscalar())
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    assert tl[-1] < tl[0]
    # optimizer state only for the trained parameters
    n_null = sum(p.grad_req == "null"
                 for p in tnet.collect_params().values())
    assert n_null == 2 * 17 and len(ttr._states) == len(ttr._wrt) == \
        len(ttr.params) - n_null
    assert not np.allclose(tnet.features[1].running_mean.data().asnumpy(),
                           rm0)
    _close_weights(tnet, jnet)


def test_narrow_v1b_imperative_loop_matches_jax():
    """Two iterations of record / backward / gluon.Trainer.step: the
    losses, weights and running stats."""
    jnet, tnet, x, y = _narrow_pair()
    jloss = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    jtr = mxj.gluon.Trainer(jnet.collect_params(), "sgd", OPT)
    ttr = gluon.Trainer(tnet.collect_params(), "sgd", OPT)
    jx, jy = (mxj.nd.array(a, ctx=mxj.cpu()) for a in (x, y))
    with mx.cpu():
        tx, ty = (nd.array(a) for a in (x, y))
    for i in range(2):
        with jag.record():
            jl = jloss(jnet(jx), jy)
        jl.backward()
        with autograd.record():
            tl = tloss(tnet(tx), ty)
        tl.backward()
        np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), **LOSS_TOL)
        if i == 0:
            jp = jnet._collect_params_with_prefix()
            for k, p in tnet._collect_params_with_prefix().items():
                if p.grad_req == "null":
                    continue
                ref = jp[k].grad().asnumpy()
                np.testing.assert_allclose(
                    p.grad().asnumpy(), ref, rtol=0, err_msg=k,
                    atol=GRAD_ATOL_OF_MAX * np.abs(ref).max())
        jtr.step(8)
        ttr.step(8)
    _close_weights(tnet, jnet)
