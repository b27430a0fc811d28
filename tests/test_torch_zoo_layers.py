"""The vision zoo's ops and layers in the port against the JAX package on
the CPU: `transpose`, `pad`, `LeakyReLU`, `Deconvolution`,
`InstanceNorm`, the 1-D, 3-D and transposed convolution layers, the 1-D
and 3-D poolings, the activation layers, `Lambda`/`HybridLambda`,
`ReflectionPad2D` and `gluon.contrib.nn`.

Inputs come from numpy with a seed (`tests/test_op_sweep.py::_build_case`
where it has the op) and go to both packages; layer weights go from the
JAX package into the port through `convert.params_from_jax`.
Tolerances, with their reasons:

- float32, forward and backward: rtol 1e-5, atol 1e-5 of the largest
  reference value — the same arithmetic; sums (convolution windows,
  statistics) run in another order;
- bfloat16 forward: one bf16 step (rtol and atol 2^-8 of the largest
  value) — each side rounds once after each op; InstanceNorm, whose
  bf16 chain rounds five times on each side ((x − mean), var + eps,
  rsqrt, · gamma, + beta): four steps (2^-6) — against float64 the JAX
  op is off by up to 0.024 and the port by 0.014 on outputs up to 2.9;
- bfloat16 gradients of the data and of a convolution's weight: two
  steps (2^-7) — XLA computes some derivatives in bfloat16, torch in
  float32 and rounds once;
- bfloat16 gradients that are sums over every position (a bias, gamma,
  beta, PReLU's alpha): rtol and atol 2^-5 of the largest value — XLA on
  the CPU accumulates those sums in bfloat16, torch in float32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.gluon import contrib as jcontrib
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, nd
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.gluon import contrib, nn
from incubator_mxnet_torch.ops import registry as treg

import test_op_sweep as S

F32 = dict(rtol=1e-5, atol_of_max=1e-5)
BF16 = dict(rtol=2 ** -8, atol_of_max=2 ** -8)
BF16_GRAD = dict(rtol=2 ** -7, atol_of_max=2 ** -7)
BF16_NORM = dict(rtol=2 ** -6, atol_of_max=2 ** -6)
BF16_SUM = dict(rtol=2 ** -5, atol_of_max=2 ** -5)
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


def _np(a):
    """float32 numpy of a JAX array, an NDArray of either package or a
    torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "asnumpy"):
        a = a.asnumpy()
    return np.asarray(a).astype(np.float32)


def _close(got, ref, tol, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(
        got.astype(np.float64), ref.astype(np.float64), rtol=tol["rtol"],
        atol=tol["atol_of_max"] * max(np.abs(ref).max(initial=0), 1e-30),
        err_msg=what)


def _u(shape, seed, lo=-1.5, hi=1.5):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _check_op(name, arrays, kwargs, dtype, fwd_tol=None, grad_tols=None):
    """The JAX op (jitted) and the port's on the same inputs, cast to
    `dtype`: the output and its dtype, then the gradient of every input
    under a seeded cotangent.  `grad_tols` maps an input's index to its
    bf16 tolerance."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    js = [jnp.asarray(a).astype(jd) for a in arrays]
    ts = [torch.from_numpy(_np(j).copy()).to(td).requires_grad_()
          for j in js]
    jout, vjp = jax.vjp(
        jax.jit(lambda *xs: jreg._REGISTRY[name].impl(*xs, **kwargs)), *js)
    tout = treg.get_op(name)(*ts, **kwargs)
    assert str(tout.dtype).replace("torch.", "") == jout.dtype.name
    _close(tout, jout, fwd_tol or (F32 if dtype == "float32" else BF16),
           "forward")
    cot = np.random.RandomState(1).randn(*jout.shape).astype(np.float32)
    jcot = jnp.asarray(cot).astype(jout.dtype)
    jgrads = vjp(jcot)
    tgrads = torch.autograd.grad(tout, ts, torch.from_numpy(
        _np(jcot).copy()).to(tout.dtype))
    for i, (a, b) in enumerate(zip(tgrads, jgrads)):
        tol = F32 if dtype == "float32" else \
            (grad_tols or {}).get(i, BF16_GRAD)
        _close(a, b, tol, f"gradient of input {i}")


# ---------------------------------------------------------------- ops
def _sweep(name):
    args, kwargs, _ = S._build_case(name)
    return [a.asnumpy() for a in args], kwargs


OPS = [
    ("transpose", lambda: _sweep("transpose")),
    ("transpose", lambda: ([_u((2, 3, 4, 5), 0)], dict(axes=(0, 2, 3, 1)))),
    ("pad", lambda: _sweep("pad")),
    ("pad", lambda: ([_u((2, 3, 4, 5), 1)],
                     dict(mode="constant", constant_value=0.5,
                          pad_width=(1, 0, 0, 2, 3, 1, 0, 4)))),
    ("pad", lambda: ([_u((2, 3, 4, 5), 2)],
                     dict(mode="edge", pad_width=(0, 0, 0, 0, 2, 1, 1, 3)))),
    ("pad", lambda: ([_u((2, 3, 4, 5), 3)],
                     dict(mode="edge", pad_width=(1, 2, 2, 0, 0, 0, 1, 1)))),
    ("pad", lambda: ([_u((2, 3, 4, 5), 4)],
                     dict(mode="reflect",
                          pad_width=(0, 0, 0, 0, 1, 2, 3, 1)))),
    # widths past the axis reflect again; N and C padded too
    ("pad", lambda: ([_u((2, 3, 4, 5), 5)],
                     dict(mode="reflect",
                          pad_width=(1, 1, 2, 0, 5, 7, 0, 9)))),
    ("LeakyReLU", lambda: ([_u((2, 3, 4), 6)], dict(act_type="leaky",
                                                    slope=0.1))),
    ("LeakyReLU", lambda: ([_u((2, 3, 4), 7)], dict())),
    ("LeakyReLU", lambda: ([_u((2, 3, 4, 5), 8), _u((3,), 9, 0.1, 0.5)],
                           dict(act_type="prelu"))),
    # a gamma of one value broadcasts over every channel
    ("LeakyReLU", lambda: ([_u((2, 3, 4), 10), _u((1,), 11, 0.1, 0.5)],
                           dict(act_type="prelu"))),
    ("LeakyReLU", lambda: ([_u((2, 3, 4), 12)], dict(act_type="elu",
                                                     slope=0.7))),
    ("LeakyReLU", lambda: ([_u((2, 3, 4), 13)], dict(act_type="selu"))),
    ("LeakyReLU", lambda: ([_u((2, 3, 4), 14, -3, 3)],
                           dict(act_type="gelu"))),
    ("Deconvolution", lambda: _sweep("Deconvolution")),
    ("Deconvolution", lambda: ([_u((2, 3, 7), 15), _u((3, 4, 4), 16),
                                _u((4,), 17)],
                               dict(kernel=(4,), stride=(3,), pad=(2,),
                                    dilate=(2,), adj=(1,), num_filter=4))),
    ("Deconvolution", lambda: ([_u((2, 3, 5, 6), 18), _u((3, 4, 3, 3), 19),
                                _u((4,), 20)],
                               dict(kernel=(3, 3), stride=(2, 2),
                                    pad=(1, 1), adj=(1, 1), num_filter=4))),
    ("Deconvolution", lambda: ([_u((2, 3, 5, 6), 21), _u((3, 4, 3, 3), 22)],
                               dict(kernel=(3, 3), stride=(2, 2),
                                    pad=(1, 1), target_shape=(12, 14),
                                    num_filter=4))),
    # adj past the stride: the output grows by zero rows
    ("Deconvolution", lambda: ([_u((2, 3, 5, 6), 23), _u((3, 4, 3, 3), 24)],
                               dict(kernel=(3, 3), stride=(2, 2),
                                    adj=(3, 0), num_filter=4))),
    ("Deconvolution", lambda: ([_u((1, 2, 3, 4, 3), 25),
                                _u((2, 3, 2, 3, 2), 26)],
                               dict(kernel=(2, 3, 2), stride=(2, 1, 2),
                                    pad=(0, 1, 1), dilate=(1, 2, 1),
                                    num_filter=3))),
    ("InstanceNorm", lambda: _sweep("InstanceNorm")),
    ("InstanceNorm", lambda: ([_u((2, 3, 5, 6), 27, -1, 3), _u((3,), 28),
                               _u((3,), 29)], dict(eps=1e-5))),
    ("InstanceNorm", lambda: ([_u((2, 4, 7), 30), _u((4,), 31),
                               _u((4,), 32)], dict())),
]


@DTYPES
@pytest.mark.parametrize("case", range(len(OPS)))
def test_op_matches_jax(case, dtype):
    name, make = OPS[case]
    arrays, kwargs = make()
    fwd = BF16_NORM if name == "InstanceNorm" and dtype == "bfloat16" \
        else None
    grads = None
    if name in ("Deconvolution", "InstanceNorm"):
        # the bias, gamma and beta gradients sum over every position
        grads = {2: BF16_SUM} if name == "Deconvolution" else \
            {0: BF16_GRAD, 1: BF16_SUM, 2: BF16_SUM}
    if name == "LeakyReLU" and len(arrays) == 2:
        grads = {1: BF16_SUM}            # PReLU's gamma
    _check_op(name, arrays, kwargs, dtype, fwd_tol=fwd, grad_tols=grads)


def test_deconvolution_does_not_flip_the_kernel():
    """The JAX op convolves the dilated data with the weight unflipped:
    the port equals torch's `conv_transpose2d` of the flipped weight and
    is far from that of the weight as it is."""
    d, w = _u((2, 3, 5, 6), 40), _u((3, 4, 3, 3), 41)
    attrs = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1))
    ref = np.asarray(jreg._REGISTRY["Deconvolution"].impl(
        jnp.asarray(d), jnp.asarray(w), **attrs))
    td, tw = torch.from_numpy(d), torch.from_numpy(w)
    got = treg.get_op("Deconvolution")(td, tw, **attrs).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    unflipped = torch.nn.functional.conv_transpose2d(
        td, tw, stride=2, padding=1, output_padding=1).numpy()
    assert np.abs(unflipped - ref).max() > 1.0


def test_grouped_deconvolution_raises_on_both_sides():
    """The layer's weight is (in, out // groups, *k); the JAX op rejects
    it for groups > 1 and the port raises."""
    x = _u((2, 4, 5, 5), 42)
    j = jnn.Conv2DTranspose(4, 3, groups=2, in_channels=4)
    j.initialize(ctx=mxj.cpu())
    with pytest.raises(Exception, match="feature_group_count"):
        j(mxj.nd.array(x, ctx=mxj.cpu()))
    t = nn.Conv2DTranspose(4, 3, groups=2, in_channels=4)
    t.initialize(ctx=mx.cpu())
    with mx.cpu(), pytest.raises(mx.MXNetError, match="num_group 2"):
        t(nd.array(x))


def test_unknown_modes_raise_on_both_sides():
    x = _u((2, 3), 43)
    with pytest.raises(Exception, match="unsupported"):
        jreg._REGISTRY["pad"].impl(jnp.asarray(x), mode="symmetric",
                                   pad_width=(0, 0, 1, 1))
    with pytest.raises(mx.MXNetError, match="unsupported"):
        treg.get_op("pad")(torch.from_numpy(x), mode="symmetric",
                           pad_width=(0, 0, 1, 1))
    with pytest.raises(ValueError, match="act_type"):
        jreg._REGISTRY["LeakyReLU"].impl(jnp.asarray(x), act_type="rrelu")
    with pytest.raises(mx.MXNetError, match="act_type"):
        treg.get_op("LeakyReLU")(torch.from_numpy(x), act_type="rrelu")


# -------------------------------------------------------------- layers
def _params(block):
    return {k: v.data().asnumpy()
            for k, v in block._collect_params_with_prefix().items()}


SUMS = ("bias", "gamma", "beta", "alpha")


def _check_layer(make, shape, dtype, seed=0, train=True, fwd_tol=None):
    """A layer built by `make(pkg_nn, pkg_contrib)` in both packages: the
    JAX layer's weights (after a first forward that fixes deferred
    shapes, with parameters drawn away from their initial constants) go
    to the port's; both cast to `dtype`; then the output, the data's
    gradient and every parameter's gradient under a seeded cotangent,
    inside `record(train_mode=train)`; in bf16 the gradients of a bias,
    gamma, beta or alpha, sums over every position, take BF16_SUM.
    `fwd_tol` is the bf16 forward's tolerance (BF16 by default)."""
    x = _u(shape, seed)
    mxj.random.seed(seed)
    j = make(jnn, jcontrib.nn)
    j.initialize(mxj.init.Uniform(0.5), ctx=mxj.cpu())
    jx = mxj.nd.array(x, ctx=mxj.cpu())
    with jag.predict_mode():
        j(jx)
    rng = np.random.RandomState(seed + 100)
    for p in j.collect_params().values():
        if p.grad_req != "null":
            p.set_data(mxj.nd.array(rng.uniform(0.2, 1.2, p.shape).astype(
                np.float32), ctx=mxj.cpu()))
    with mx.cpu():
        t = make(nn, contrib.nn)
    t.initialize(ctx=mx.cpu())
    params_from_jax(t, _params(j), ctx=mx.cpu())
    j.cast(dtype)
    t.cast(dtype)
    jx = jx.astype(dtype)
    with mx.cpu():
        tx = nd.array(x).astype(dtype)
    jx.attach_grad()
    tx.attach_grad()
    with jag.record(train_mode=train):
        jout = j(jx)
    with autograd.record(train_mode=train):
        tout = t(tx)
    bf16 = dtype == "bfloat16"
    _close(tout, jout, fwd_tol if bf16 and fwd_tol else
           (BF16 if bf16 else F32), "forward")
    cot = np.random.RandomState(seed + 1).randn(*jout.shape) \
        .astype(np.float32)
    jout.backward(mxj.nd.array(cot, ctx=mxj.cpu()).astype(dtype))
    with mx.cpu():
        tout.backward(nd.array(cot).astype(dtype))
    _close(tx.grad, jx.grad, BF16_GRAD if bf16 else F32, "data gradient")
    jp = j._collect_params_with_prefix()
    for k, p in t._collect_params_with_prefix().items():
        if p.grad_req == "null":
            continue
        tol = F32 if not bf16 else \
            BF16_SUM if k.rsplit(".", 1)[-1] in SUMS else BF16_GRAD
        _close(p.grad(), jp[k].grad(), tol, f"gradient of {k}")
    return j, t


LAYERS = {
    "Conv1D": (lambda n, c: n.Conv1D(4, 3, strides=2, padding=1,
                                     dilation=2), (2, 3, 11)),
    "Conv1D_grouped": (lambda n, c: n.Conv1D(4, 3, groups=2, use_bias=False,
                                             in_channels=4), (2, 4, 9)),
    "Conv3D": (lambda n, c: n.Conv3D(4, (2, 3, 2), strides=(1, 2, 1),
                                     padding=(1, 1, 0)), (2, 3, 4, 6, 5)),
    "Conv1DTranspose": (lambda n, c: n.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), (2, 3, 6)),
    "Conv2DTranspose": (lambda n, c: n.Conv2DTranspose(
        4, (3, 4), strides=(2, 3), padding=(1, 1), output_padding=(1, 2),
        dilation=(1, 2), in_channels=3), (2, 3, 5, 4)),
    "MaxPool1D": (lambda n, c: n.MaxPool1D(3, 2, ceil_mode=True), (2, 3, 10)),
    "MaxPool3D": (lambda n, c: n.MaxPool3D((2, 3, 2), (2, 2, 1), padding=1),
                  (2, 3, 5, 6, 4)),
    "AvgPool1D": (lambda n, c: n.AvgPool1D(3, 2, 1, count_include_pad=False),
                  (2, 3, 10)),
    "AvgPool3D": (lambda n, c: n.AvgPool3D(2, ceil_mode=True),
                  (2, 3, 5, 6, 4)),
    "GlobalMaxPool1D": (lambda n, c: n.GlobalMaxPool1D(), (2, 3, 7)),
    "GlobalMaxPool3D": (lambda n, c: n.GlobalMaxPool3D(), (2, 3, 3, 4, 2)),
    "GlobalAvgPool1D": (lambda n, c: n.GlobalAvgPool1D(), (2, 3, 7)),
    "GlobalAvgPool3D": (lambda n, c: n.GlobalAvgPool3D(), (2, 3, 3, 4, 2)),
    "InstanceNorm": (lambda n, c: n.InstanceNorm(), (2, 3, 5, 6)),
    "LeakyReLU": (lambda n, c: n.LeakyReLU(0.2), (2, 3, 4)),
    "PReLU": (lambda n, c: n.PReLU(in_channels=3), (2, 3, 4, 5)),
    "PReLU_shared": (lambda n, c: n.PReLU(), (2, 3, 4)),
    "ELU": (lambda n, c: n.ELU(0.5), (2, 3, 4)),
    "SELU": (lambda n, c: n.SELU(), (2, 3, 4)),
    "GELU": (lambda n, c: n.GELU(), (2, 3, 4)),
    "Swish": (lambda n, c: n.Swish(1.5), (2, 3, 4)),
    "ReflectionPad2D": (lambda n, c: n.ReflectionPad2D(2), (2, 3, 4, 5)),
    "ReflectionPad2D_widths": (lambda n, c: n.ReflectionPad2D(
        (0, 0, 0, 0, 1, 3, 4, 0)), (2, 3, 4, 5)),
    "Lambda_str": (lambda n, c: n.Lambda("tanh"), (2, 3, 4)),
    "Lambda_fn": (lambda n, c: n.Lambda(lambda x: x * 2 + 1), (2, 3, 4)),
    "HybridLambda_str": (lambda n, c: n.HybridLambda("relu"), (2, 3, 4)),
    "HybridLambda_fn": (lambda n, c: n.HybridLambda(
        lambda F, x: F.LeakyReLU(x, act_type="leaky", slope=0.3)),
        (2, 3, 4)),
    "Identity": (lambda n, c: c.Identity(), (2, 3, 4)),
    "PixelShuffle1D": (lambda n, c: c.PixelShuffle1D(3), (2, 6, 5)),
    "PixelShuffle2D": (lambda n, c: c.PixelShuffle2D((2, 3)), (2, 12, 3, 4)),
    "PixelShuffle3D": (lambda n, c: c.PixelShuffle3D((1, 2, 2)),
                       (2, 8, 2, 3, 2)),
    "SyncBatchNorm": (lambda n, c: c.SyncBatchNorm(num_devices=4),
                      (4, 3, 5, 5)),
}


def _concurrent(n, c):
    net = c.HybridConcurrent(axis=1)
    net.add(n.Conv2D(4, 3, padding=1), c.Identity(),
            n.Conv2D(2, 1, use_bias=False))
    return net


LAYERS["HybridConcurrent"] = (_concurrent, (2, 3, 6, 6))


@DTYPES
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name, dtype):
    make, shape = LAYERS[name]
    _check_layer(make, shape, dtype, seed=len(name),
                 fwd_tol=BF16_NORM if name == "InstanceNorm" else None)


def test_layer_names_and_shapes_match_jax():
    """Deferred shapes resolve alike, under the same structural names:
    the transposed convolution's weight is (in, out, *k), and
    `__all__` keeps the JAX order."""
    assert nn.conv_layers.__all__ == jnn.conv_layers.__all__
    assert nn.basic_layers.__all__ == jnn.basic_layers.__all__
    assert contrib.nn.__all__ == jcontrib.nn.__all__
    for make, shape in (LAYERS["Conv1DTranspose"], LAYERS["Conv3D"],
                        LAYERS["HybridConcurrent"], LAYERS["PReLU"],
                        LAYERS["InstanceNorm"]):
        j, t = _check_layer(make, shape, "float32")
        assert {k: tuple(p.shape) for k, p in
                t._collect_params_with_prefix().items()} == \
            {k: v.shape for k, v in _params(j).items()}
    assert t.gamma.grad_req == t.beta.grad_req == "write"
    assert contrib.nn.Concurrent is contrib.nn.HybridConcurrent


def test_pixel_shuffle_is_crd_not_depth_to_space():
    """Channel c·f1·f2 + i·f2 + j of the input goes to channel c at
    (h·f1 + i, w·f2 + j): the (C, f1, f2) split."""
    x = np.arange(2 * 8 * 2 * 3, dtype=np.float32).reshape(2, 8, 2, 3)
    with mx.cpu():
        out = contrib.nn.PixelShuffle2D(2)(nd.array(x)).asnumpy()
    for c in range(2):
        for i in range(2):
            for j in range(2):
                np.testing.assert_array_equal(
                    out[:, c, i::2, j::2], x[:, c * 4 + i * 2 + j])
    # torch's pixel_shuffle splits the channels the same way
    assert torch.equal(torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x), 2), torch.from_numpy(out))
    jout = jcontrib.nn.PixelShuffle2D(2)(mxj.nd.array(x, ctx=mxj.cpu()))
    np.testing.assert_array_equal(out, jout.asnumpy())


def test_sync_batch_norm_updates_running_stats_as_batch_norm():
    x = _u((4, 3, 5, 5), 50, -1, 3)
    j, t = _check_layer(LAYERS["SyncBatchNorm"][0], x.shape, "float32",
                        seed=50)
    for name in ("running_mean", "running_var"):
        got = getattr(t, name).data().asnumpy()
        _close(got, getattr(j, name).data(), F32, name)
        assert not np.allclose(got, 0 if name == "running_mean" else 1)
