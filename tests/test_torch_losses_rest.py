"""The port's eleven further Gluon losses and the `CTCLoss` op against the
JAX package: values and input gradients through `autograd.record()` /
`backward()` in both packages, with `weight` and `sample_weight` where
the loss takes them, and the CTC op on its own with both blank
conventions and both length forms.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: rtol 1e-5 and atol 1e-5 of the largest value, for values and
gradients alike (the same float32 formulas; exp, log, sums and the CTC
recursion's log-sum-exps evaluated in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.ops.contrib_ops import ctc_loss as jax_ctc

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import nd
from incubator_mxnet_torch.ops.contrib import ctc_loss as port_ctc

N, D = 4, 5


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return rng, (lambda *s: rng.randn(*s).astype(np.float32))


def _ctc_batch(rng, T=12, C=6, L=4):
    pred = rng.randn(N, T, C).astype(np.float32)
    label = rng.randint(0, C - 1, (N, L)).astype(np.float32)
    label[1, 2:] = -1
    label[3, 1:] = -1
    return pred, label


def _case(name, seed=0):
    """(constructor kwargs, inputs, how many of them take a gradient)."""
    rng, randn = _inputs(seed)
    pm = np.sign(randn(N, D)) + (randn(N, D) == 0)
    if name in ("SigmoidBCELoss", "SigmoidBinaryCrossEntropyLoss"):
        return {}, [randn(N, D), rng.rand(N, D).astype(np.float32)], 1
    if name == "SigmoidBCELoss_from_sigmoid":
        return ({"from_sigmoid": True},
                [rng.uniform(0.05, 0.95, (N, D)).astype(np.float32),
                 rng.rand(N, D).astype(np.float32)], 1)
    if name == "KLDivLoss":
        p = rng.dirichlet(np.ones(D), N).astype(np.float32)
        return {}, [np.log(rng.dirichlet(np.ones(D), N)).astype(
            np.float32), p], 1
    if name == "KLDivLoss_logits":
        p = rng.dirichlet(np.ones(D), N).astype(np.float32)
        return {"from_logits": False}, [randn(N, D), p], 1
    if name == "HuberLoss":
        return {"rho": 0.7}, [randn(N, D), randn(N, D)], 1
    if name in ("HingeLoss", "SquaredHingeLoss"):
        return {"margin": 1.5}, [randn(N, D), pm], 1
    if name == "LogisticLoss":
        return {}, [randn(N, D), pm], 1
    if name == "LogisticLoss_binary":
        return ({"label_format": "binary"},
                [randn(N, D), (pm > 0).astype(np.float32)], 1)
    if name == "CosineEmbeddingLoss":
        return ({"margin": 0.2}, [randn(N, D), randn(N, D),
                                  np.array([1, -1, 1, -1], np.float32)], 2)
    if name == "TripletLoss":
        return {"margin": 1.0}, [randn(N, D), randn(N, D), randn(N, D)], 3
    if name == "CTCLoss":
        return {}, list(_ctc_batch(rng)), 1
    if name == "PoissonNLLLoss":
        return {}, [randn(N, D), rng.poisson(2.0, (N, D)).astype(
            np.float32)], 1
    if name == "PoissonNLLLoss_full":
        return ({"from_logits": False, "compute_full": True},
                [rng.uniform(0.5, 3, (N, D)).astype(np.float32),
                 rng.poisson(2.0, (N, D)).astype(np.float32)], 1)
    if name == "SDMLLoss":
        return {"smoothing_parameter": 0.3}, [randn(N, D), randn(N, D)], 2
    raise KeyError(name)


# (case, class name, whether it takes weight=, sample_weight's shape)
CASES = [
    ("SigmoidBCELoss", "SigmoidBCELoss", True, (N, 1)),
    ("SigmoidBCELoss_from_sigmoid", "SigmoidBinaryCrossEntropyLoss", True,
     (N, 1)),
    ("KLDivLoss", "KLDivLoss", True, (N, 1)),
    ("KLDivLoss_logits", "KLDivLoss", True, (N, 1)),
    ("HuberLoss", "HuberLoss", True, (N, 1)),
    ("HingeLoss", "HingeLoss", True, (N, 1)),
    ("SquaredHingeLoss", "SquaredHingeLoss", True, (N, 1)),
    ("LogisticLoss", "LogisticLoss", True, (N, 1)),
    ("LogisticLoss_binary", "LogisticLoss", True, (N, 1)),
    ("CosineEmbeddingLoss", "CosineEmbeddingLoss", True, (N,)),
    ("TripletLoss", "TripletLoss", True, (N,)),
    ("CTCLoss", "CTCLoss", True, (N,)),
    ("PoissonNLLLoss", "PoissonNLLLoss", True, (N, 1)),
    ("PoissonNLLLoss_full", "PoissonNLLLoss", True, (N, 1)),
    ("SDMLLoss", "SDMLLoss", False, None),
]


def _run(pkg, cls, kwargs, inputs, n_grad, sample_weight):
    ctx = pkg.cpu()
    arrs = [pkg.nd.array(a, ctx=ctx) for a in inputs]
    for a in arrs[:n_grad]:
        a.attach_grad()
    extra = [] if sample_weight is None else [pkg.nd.array(sample_weight,
                                                           ctx=ctx)]
    if cls == "CTCLoss" and extra:
        extra = [None, None] + extra       # pred_lengths, label_lengths
    with pkg.autograd.record():
        out = getattr(pkg.gluon.loss, cls)(**kwargs)(*arrs, *extra)
    out.backward()
    return out.asnumpy(), [a.grad.asnumpy() for a in arrs[:n_grad]]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case,cls,takes_weight,sw_shape", CASES,
                         ids=[c[0] for c in CASES])
def test_loss_matches_jax(case, cls, takes_weight, sw_shape, weighted):
    kwargs, inputs, n_grad = _case(case)
    sw = None
    if weighted and takes_weight:
        kwargs = dict(kwargs, weight=0.5)
        sw = np.random.RandomState(7).uniform(0.5, 2, sw_shape) \
            .astype(np.float32)
    ref, ref_g = _run(mxj, cls, kwargs, inputs, n_grad, sw)
    got, got_g = _run(mx, cls, kwargs, inputs, n_grad, sw)
    assert got.shape == ref.shape
    _close(got, ref)
    for a, b in zip(got_g, ref_g):
        _close(a, b)


def test_loss_names_match_jax():
    import incubator_mxnet_tpu.gluon.loss as jl
    from incubator_mxnet_torch.gluon import loss as tl
    assert sorted(tl.__all__) == sorted(jl.__all__)
    assert all(hasattr(tl, n) for n in jl.__all__)


def test_ctc_loss_block_with_lengths_matches_jax():
    """Gluon's CTCLoss with explicit pred and label lengths."""
    rng = np.random.RandomState(5)
    pred, label = _ctc_batch(rng)
    plen = np.array([12, 9, 7, 12], np.float32)
    llen = np.array([4, 2, 3, 1], np.float32)
    outs = []
    for pkg in (mxj, mx):
        ctx = pkg.cpu()
        x = pkg.nd.array(pred, ctx=ctx)
        x.attach_grad()
        with pkg.autograd.record():
            out = pkg.gluon.loss.CTCLoss()(
                x, pkg.nd.array(label, ctx=ctx), pkg.nd.array(plen, ctx=ctx),
                pkg.nd.array(llen, ctx=ctx))
        out.backward()
        outs.append((out.asnumpy(), x.grad.asnumpy()))
    _close(outs[1][0], outs[0][0])
    _close(outs[1][1], outs[0][1])


@pytest.mark.parametrize("lengths", [False, True])
@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_op_matches_jax(blank, lengths):
    """The op at T = 20, N = 4, C = 6, L = 5, labels padded by the blank
    convention's pad (0 or −1), and the lengths given or derived."""
    rng = np.random.RandomState(0)
    T, C, L = 20, 6, 5
    x = rng.randn(T, N, C).astype(np.float32)
    lo, hi = (1, C) if blank == "first" else (0, C - 1)
    lab = rng.randint(lo, hi, (N, L)).astype(np.float32)
    pad = 0 if blank == "first" else -1
    lab[0, 3:] = pad
    lab[2, 1:] = pad
    dl = np.array([20, 15, 9, 20], np.float32)
    ll = np.array([3, 5, 1, 4], np.float32)
    kw = dict(blank_label=blank)
    if lengths:
        kw.update(use_data_lengths=True, use_label_lengths=True)
        extra_j, extra_t = (jnp.asarray(dl), jnp.asarray(ll)), \
            (torch.from_numpy(dl), torch.from_numpy(ll))
    else:
        extra_j = extra_t = ()
    ct = rng.randn(N).astype(np.float32)
    ref, vjp = jax.vjp(lambda d: jax_ctc(d, jnp.asarray(lab), *extra_j, **kw),
                       jnp.asarray(x))
    (ref_g,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    out = port_ctc(xt, torch.from_numpy(lab), *extra_t, **kw)
    out.backward(torch.from_numpy(ct))
    assert out.dtype == torch.float32 and out.shape == (N,)
    _close(out.detach().numpy(), np.asarray(ref))
    _close(xt.grad.numpy(), np.asarray(ref_g))
    for alias in ("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"):
        assert getattr(nd, alias) is not None


def test_ctc_op_length_flags_raise_like_jax():
    x = nd.array(np.zeros((3, 2, 4), np.float32), ctx=mx.cpu())
    lab = nd.array(np.ones((2, 2), np.float32), ctx=mx.cpu())
    n = nd.array(np.array([3, 3], np.float32), ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="use_data_lengths=False"):
        nd.CTCLoss(x, lab, n)
    with pytest.raises(mx.MXNetError, match="needs label_lengths"):
        nd.CTCLoss(x, lab, use_label_lengths=True)
