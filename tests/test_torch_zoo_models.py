"""The vision zoo's model families in the port against the JAX package on
the CPU: each family's predict- and train-mode forward and gradients
(inceptionv3's check runs from `tests/test_torch_zoo_api.py`, which
holds the rest: names, `get_model`, the model store, serving, training
steps, the default device).

The families run at reduced sizes (`DenseNet(8, 4, [2, 2])`,
`VGG([1, 1], [8, 16])`, `MobileNetV2(0.25)`, ...), and `inceptionv3` and
`squeezenet1.1` at 75² and 64²: the JAX references run eagerly per op,
so the full-size models take many seconds each there.  The JAX nets are
hybridized (one XLA program a mode) to keep the file within its time.
Inputs come from numpy with a seed; weights go from the JAX package into
the port through `convert.params_from_jax`.  Every Dropout's rate is set
to 0 on both sides, since the port's draws are not the JAX bits.
Tolerances, with their reasons:

- predict-mode logits, float32: rtol 1e-5, atol 1e-5 of the largest —
  the same arithmetic, sums (convolutions, pooling) in another order;
- gradients (of the data and of every parameter) and running stats are
  held by their relative error ‖port − JAX‖ / ‖JAX‖, the denominator at
  least 1e-3 of the model's largest gradient norm: a parameter whose
  exact gradient is 0 (a bias or beta ahead of a train-mode BatchNorm,
  which removes the mean) is rounding noise on both sides, and only its
  size beside the real gradients can be held;
- in predict mode those errors are held to 1e-3 — measured at most
  5e-6, but a ReLU input within rounding of 0 (1.7e-10 in squeezenet1.0
  at batch 2) takes the other side in one package, and that element's
  share of the gradient flows or not (5.3e-4 of the data gradient's
  norm there);
- in train mode, to 1e-3 as well, and to 1e-1 for MobileNetV2 and
  Inception v3: their 52 and 94 train-mode BatchNorms normalize by
  statistics of few values (4 to 36 per channel in their last blocks
  here) through E[x²] − mean², so each amplifies the last bits of the
  layer before.  The JAX package's own eager and hybridized runs differ
  by 1.6e-3 on MobileNetV2(0.25)'s BatchNorm gammas, the port by 3.7e-2
  from either; the single blocks agree to 1.5e-6 and MobileNet v1's 27
  BatchNorms to 2e-4, so the depth, not a block, sets the spread;
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import models as jmodels

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import models
from incubator_mxnet_torch.convert import params_from_jax

F32 = dict(rtol=1e-5, atol_of_max=1e-5)

# name: (constructor of a package's `models`, input size)
FAMILIES = {
    "resnet_v1_cifar": (lambda M: M.resnet.get_cifar_resnet(1, 8), 16),
    "resnet_v2_cifar": (lambda M: M.resnet.get_cifar_resnet(2, 8), 16),
    "resnet_v2_bottleneck": (lambda M: M.resnet.ResNetV2(
        M.resnet.BottleneckV2, [1, 1], [8, 16, 32], classes=10), 32),
    "vgg": (lambda M: M.vgg.VGG([1, 1], [8, 16], classes=10), 32),
    "vgg_bn": (lambda M: M.vgg.VGG([1, 1], [8, 16], classes=10,
                                   batch_norm=True), 32),
    "alexnet": (lambda M: M.alexnet.alexnet(classes=10), 64),
    "squeezenet1.0": (lambda M: M.squeezenet.squeezenet1_0(classes=10), 64),
    "squeezenet1.1": (lambda M: M.squeezenet.squeezenet1_1(classes=10), 64),
    "mobilenet": (lambda M: M.mobilenet.MobileNet(0.25, classes=10), 64),
    "mobilenetv2": (lambda M: M.mobilenet.MobileNetV2(0.25, classes=10),
                    64),
    "densenet": (lambda M: M.densenet.DenseNet(8, 4, [2, 2], bn_size=2,
                                               dropout=0.2, classes=10), 32),
    "inceptionv3": (lambda M: M.inception.inception_v3(classes=10), 75),
}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "asnumpy"):
        a = a.asnumpy()
    return np.asarray(a).astype(np.float32)


def _close(got, ref, tol, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(
        got, ref, rtol=tol["rtol"],
        atol=tol["atol_of_max"] * max(np.abs(ref).max(initial=0), 1e-30),
        err_msg=what)


def _weights(net):
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def _no_dropout(block):
    """Set every Dropout's rate to 0 (`_children` in both packages)."""
    if hasattr(block, "_rate"):
        block._rate = 0.0
    for child in block._children.values():
        _no_dropout(child)


# BatchNorm's parameters and states drawn away from their initial
# constants: with beta = 0 a BatchNorm followed by ReLU and another
# BatchNorm is scale-invariant in its gamma, whose exact gradient is
# then 0 and both packages' values are rounding noise
BN_DRAWS = {"gamma": (0.5, 1.5), "beta": (-0.5, 0.5),
            "running_mean": (-0.2, 0.2), "running_var": (0.5, 1.5)}


def _pair(family, batch=4, seed=0, size=None):
    """(JAX net, port net, input) of a family from one set of weights:
    Xavier, BatchNorm's drawn from BN_DRAWS.  The JAX net is hybridized
    and its deferred shapes fixed by a first forward inside
    `record(train_mode=False)`, which the predict-mode check then reuses
    compiled."""
    make, family_size = FAMILIES[family]
    size = size or family_size
    x = np.random.RandomState(seed).uniform(-1, 1, (batch, 3, size, size)) \
        .astype(np.float32)
    mxj.random.seed(seed)
    jnet = make(jmodels)
    jnet.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    jnet.hybridize()
    _no_dropout(jnet)
    with mxj.autograd.record(train_mode=False):
        jnet(mxj.nd.array(x, ctx=mxj.cpu()))
    rng = np.random.RandomState(seed + 1)
    for k, p in jnet._collect_params_with_prefix().items():
        lo_hi = BN_DRAWS.get(k.rsplit(".", 1)[-1])
        if lo_hi:
            p.set_data(mxj.nd.array(rng.uniform(*lo_hi, p.shape).astype(
                np.float32), ctx=mxj.cpu()))
    tnet = make(models)
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    _no_dropout(tnet)
    assert list(tnet._collect_params_with_prefix()) == \
        list(jnet._collect_params_with_prefix())
    params_from_jax(tnet, _weights(jnet))
    return jnet, tnet, x


def _run(net, x, cot, train, pkg):
    """Logits, the data's gradient and every parameter's gradient (a
    state's value, after the forward) of one forward of `net` (JAX or
    port, `pkg`) in `record(train_mode=train)` and the backward of
    `cot`, as float32 numpy."""
    with pkg.cpu():
        data, head = pkg.nd.array(x), pkg.nd.array(cot)
    data.attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = net(data)
    out.backward(head)
    res = {"logits": out, "data gradient": data.grad}
    for k, p in net._collect_params_with_prefix().items():
        res[k] = p.data() if p.grad_req == "null" else p.grad()
    return {k: _np(v) for k, v in res.items()}


def _close_rel(got, ref, rtol, what):
    """Each tensor's relative error, the denominator at least 1e-3 of
    the largest gradient norm (module docstring)."""
    floor = 1e-3 * max([np.linalg.norm(v) for k, v in ref.items()
                        if k != "logits" and "running" not in k] or [0])
    for k in ref:
        err = np.linalg.norm(got[k] - ref[k]) / max(np.linalg.norm(ref[k]),
                                                    floor)
        assert err <= rtol, (what, k, err)


TRAIN_RTOL = {"mobilenetv2": 1e-1, "inceptionv3": 1e-1}


def check_family(family):
    """Predict-mode logits, and the data's and every parameter's gradient
    of a seeded cotangent in predict mode; then the same in train mode,
    with the running stats the train-mode forward moves."""
    jnet, tnet, x = _pair(family)
    cot = np.random.RandomState(1).randn(x.shape[0], 10).astype(np.float32)
    for train in (False, True):
        ref = _run(jnet, x, cot, train, mxj)
        got = _run(tnet, x, cot, train, mx)
        if not train:
            _close(got["logits"], ref["logits"], F32, "predict-mode logits")
        _close_rel(got, ref, TRAIN_RTOL.get(family, 1e-3) if train else 1e-3,
                   "train mode" if train else "predict mode")


# inceptionv3, the slowest reference by far, runs in test_torch_zoo_api.py
# so that each file keeps within its time on one worker
@pytest.mark.parametrize("family", sorted(set(FAMILIES) - {"inceptionv3"}))
def test_family_matches_jax(family):
    check_family(family)
