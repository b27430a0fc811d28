"""Custom operators and the slice that runs kernel row 7 (`rtc`) through
them, the port against the JAX package on the CPU.

- `CustomOp.assign` and the JAX package's `scale2` op
  (`tests/test_contrib_ops.py`), forward and backward, with the "write",
  "add" and "null" requests.
- The softmax head of `incubator_mxnet_torch.softmax_rtc`: on the JAX
  side a `softmax_rtc` CustomOp whose forward and backward launch Pallas
  kernel bodies (`PallasKernel`, interpret mode); on the port's side the
  same op through `CudaKernel`s and their plain versions.  Then `MLP()`
  trained through it for 5 SGD-momentum steps at batch 64 from the same
  weights, and LeNet's forward and 3 `ParallelTrainer` steps at batch 16
  with the plain softmax cross-entropy.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, with their reasons:

- `assign` and `scale2`: exact (x * 2 and its sums in float32 on both
  sides);
- the softmax forward and backward: atol 1e-6 (exp and the row sums in
  another order; probabilities are at most 1); axpy in float32: rtol
  1e-6 (the kernel rounds a·x and the sum apart, XLA may contract them
  into one fma), in bfloat16 one bf16 step (2^-8 of the value), where
  that last-bit difference moves the final rounding;
- MLP, 5 steps: losses rtol 1e-5, weights rtol 1e-5, atol 1e-6 (the
  same float32 arithmetic; Dense's matmul sums in another order give
  ~1e-7 at step 1 and the momentum carries them on);
- LeNet: the forward atol 1e-5 (two convolutions and three matmuls
  summed in another order, on logits of ~1); the 3 steps' losses rtol
  1e-5 and weights rtol 1e-5, atol 1e-6 (the same sums in another
  order; measured 2.2e-8 on weights of ~0.1).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import operator as jop
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu.models.lenet import LeNet as JLeNet
from incubator_mxnet_tpu.models.mlp import MLP as JMLP
from incubator_mxnet_tpu.rtc import PallasModule

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd, operator, parallel
from incubator_mxnet_torch import softmax_rtc
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.models import LeNet, MLP, get_model

SGD = {"learning_rate": 0.1, "momentum": 0.9}
PROB_ATOL = 1e-6
MLP_LOSS_TOL = dict(rtol=1e-5, atol=0)
MLP_WEIGHT_TOL = dict(rtol=1e-5, atol=1e-6)
LENET_LOSS_TOL = dict(rtol=1e-5, atol=0)
LENET_WEIGHT_TOL = dict(rtol=1e-5, atol=1e-6)


def _both(a):
    """(JAX NDArray, port NDArray) of numpy `a` on the CPU."""
    with mx.cpu():
        return mxj.nd.array(a, ctx=mxj.cpu(), dtype=a.dtype), nd.array(a)


# --------------------------------------------------------- scale2
def _register_scale2(mod):
    @mod.register("scale2")
    class Scale2Prop(mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["out"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            class Scale2(mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * 2)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * 2)
            return Scale2()


_register_scale2(jop)
_register_scale2(operator)


@pytest.mark.parametrize("req", ["write", "inplace", "add", "null"])
def test_assign_honours_req(req):
    rng = np.random.RandomState(0)
    dst, src = (rng.randn(2, 3).astype(np.float32) for _ in range(2))
    want = {"write": src, "inplace": src, "add": dst + src, "null": dst}
    (jd, td), (js, ts) = _both(dst.copy()), _both(src.copy())
    jop.CustomOp.assign(jd, req, js)
    operator.CustomOp.assign(td, req, ts)
    np.testing.assert_array_equal(td.asnumpy(), jd.asnumpy())
    np.testing.assert_array_equal(td.asnumpy(), want[req])
    with pytest.raises(mx.MXNetError, match="unknown req"):
        operator.CustomOp.assign(td, "bogus", ts)


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_custom_op_forward_backward_matches_jax(grad_req):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    jx, tx = _both(x)
    np.testing.assert_array_equal(
        nd.Custom(tx, op_type="scale2").asnumpy(),
        mxj.nd.Custom(jx, op_type="scale2").asnumpy())
    jx.attach_grad(grad_req=grad_req)
    tx.attach_grad(grad_req=grad_req)
    for _ in range(2):                     # "add" accumulates the two
        with jag.record():
            jz = mxj.nd.Custom(jx, op_type="scale2")
            jl = (jz * jz).sum()
        jl.backward()
        with autograd.record():
            tz = nd.Custom(tx, op_type="scale2")
            tl = nd.sum(tz * tz)
        tl.backward()
    np.testing.assert_array_equal(tx.grad.asnumpy(), jx.grad.asnumpy())
    np.testing.assert_array_equal(
        tx.grad.asnumpy(), 8 * x * (2 if grad_req == "add" else 1))


@operator.register("scaled_by")
class _ScaledByProp(operator.CustomOpProp):
    """(data, scale) -> data * scale; records the backward's requests."""
    reqs = []

    def list_arguments(self):
        return ["data", "scale"]

    def create_operator(self, ctx, shapes, dtypes):
        class ScaledBy(operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                self.assign(out_data[0], req[0], in_data[0] * in_data[1])

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                _ScaledByProp.reqs.append(list(req))
                self.assign(in_grad[0], req[0], out_grad[0] * in_data[1])
                self.assign(in_grad[1], req[1], out_grad[0] * in_data[0])
        return ScaledBy()


def test_input_without_gradient_gets_req_null():
    """An input that takes no gradient reaches the backward with req
    "null", and the op leaves its gradient buffer alone."""
    with mx.cpu():
        a = nd.array(np.full((2, 2), 3.0, np.float32))
        b = nd.array(np.full((2, 2), 5.0, np.float32))
    a.attach_grad()
    _ScaledByProp.reqs.clear()
    with autograd.record():
        out = nd.Custom(a, b, op_type="scaled_by")
    out.backward()
    assert _ScaledByProp.reqs == [["write", "null"]]
    np.testing.assert_array_equal(a.grad.asnumpy(), np.full((2, 2), 5.0))
    assert b.grad is None


def test_outputs_live_on_the_inputs_device():
    """CPU inputs outside any `with cpu()` scope: the default context is
    gpu(0), which this machine lacks, so buffers made there would raise."""
    x = nd.array(np.ones((2, 3), np.float32), ctx=mx.cpu())
    x.attach_grad()
    with autograd.record():
        y = nd.Custom(x, op_type="scale2")
    y.backward()                          # a non-scalar head: ones
    assert y.context == mx.cpu() and x.grad.context == mx.cpu()
    np.testing.assert_array_equal(x.grad.asnumpy(), np.full((2, 3), 2.0))


def test_unregistered_and_wrong_arity_raise():
    x = nd.array(np.ones(3, np.float32), ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="not registered"):
        nd.Custom(x, op_type="nonesuch")
    with pytest.raises(mx.MXNetError, match="expected 1 inputs"):
        nd.Custom(x, x, op_type="scale2")


# ------------------------------- the softmax head, Pallas bodies vs rtc
def _jax_softmax(x_ref, o_ref):
    x = x_ref[...]
    e = jnp.exp(x - jnp.max(x, axis=1, keepdims=True))
    o_ref[...] = e / jnp.sum(e, axis=1, keepdims=True)


def _jax_softmax_bwd(l_ref, y_ref, o_ref):
    y = y_ref[...]
    cols = jax.lax.broadcasted_iota(jnp.int32, y.shape, 1)
    onehot = cols == l_ref[...].astype(jnp.int32)[:, None]
    o_ref[...] = y - onehot.astype(y.dtype)


_JMOD = PallasModule()
_JFWD = _JMOD.add_kernel(_jax_softmax, out_shape=lambda x:
                         jax.ShapeDtypeStruct(x.shape, x.dtype),
                         interpret=True, name="softmax_fwd")
_JBWD = _JMOD.add_kernel(_jax_softmax_bwd, out_shape=lambda lab, y:
                         jax.ShapeDtypeStruct(y.shape, y.dtype),
                         interpret=True, name="softmax_bwd")


@jop.register("softmax_rtc")
class _JaxSoftmaxRTCProp(jop.CustomOpProp):
    """The JAX package's form of the port's `softmax_rtc`."""

    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shape):
        return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        class SoftmaxRTC(jop.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                self.assign(out_data[0], req[0], _JFWD.launch(in_data[0]))

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                self.assign(in_grad[0], req[0],
                            _JBWD.launch(in_data[1], out_data[0]))
        return SoftmaxRTC()


def _logits(n=16, c=10, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, c).astype(np.float32) * 3,
            rng.randint(0, c, n).astype(np.float32))


def test_softmax_kernels_match_the_pallas_bodies():
    x, lab = _logits()
    jy = _JFWD.launch(mxj.nd.array(x, ctx=mxj.cpu())).asnumpy()
    jdx = _JBWD.launch(mxj.nd.array(lab, ctx=mxj.cpu()),
                       mxj.nd.array(jy, ctx=mxj.cpu())).asnumpy()
    tx, tl = torch.from_numpy(x), torch.from_numpy(lab)
    y, dx = torch.zeros_like(tx), torch.zeros_like(tx)
    softmax_rtc.softmax_fwd(tx, y)
    softmax_rtc.softmax_bwd(tl, y, dx)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=0, atol=PROB_ATOL)
    softmax_rtc.softmax_fwd(tx, y, req="add")
    softmax_rtc.softmax_bwd(tl, y, dx, req="add")
    np.testing.assert_allclose(y.numpy(), 2 * jy, rtol=0,
                               atol=2 * PROB_ATOL)
    np.testing.assert_allclose(dx.numpy(), jdx + 2 * jy - np.eye(10)[
        lab.astype(int)], rtol=0, atol=4 * PROB_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_axpy_matches_a_pallas_body(dtype):
    a = 0.37

    def body(x_ref, y_ref, o_ref):
        o_ref[...] = (a * x_ref[...].astype(jnp.float32)
                      + y_ref[...].astype(jnp.float32)).astype(o_ref.dtype)

    rng = np.random.RandomState(2)
    x, y = (rng.randn(3, 40).astype(np.float32) for _ in range(2))
    jx, jyy = (mxj.nd.array(v, ctx=mxj.cpu()).astype(dtype) for v in (x, y))
    ref = np.asarray(PallasModule().add_kernel(
        body, out_shape=lambda u, v: jax.ShapeDtypeStruct(v.shape, v.dtype),
        interpret=True).launch(jx, jyy).asnumpy()).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ty = torch.from_numpy(y).to(getattr(torch, dtype))
    softmax_rtc.axpy(tx, ty, a)
    got = ty.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=0)


def test_softmax_head_needs_no_head_gradient():
    """`backward()` on the non-scalar head uses ones, and any head
    gradient gives the same p - onehot: the op ignores it."""
    x, lab = _logits(seed=3)
    with mx.cpu():
        tx, tl = nd.array(x), nd.array(lab)
        head = nd.array(np.random.RandomState(4).randn(*x.shape)
                        .astype(np.float32))
    tx.attach_grad()
    grads = []
    for head_grad in (None, head):
        with autograd.record():
            p = nd.Custom(tx, tl, op_type="softmax_rtc")
        p.backward(head_grad)
        grads.append(tx.grad.asnumpy().copy())
    want = p.asnumpy() - np.eye(10, dtype=np.float32)[lab.astype(int)]
    np.testing.assert_array_equal(grads[0], grads[1])
    np.testing.assert_allclose(grads[0], want, rtol=0, atol=PROB_ATOL)


def _weights(net):
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def _jax_net(cls, x):
    mxj.random.seed(0)
    net = cls()
    net.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    net(mxj.nd.array(x[:1], ctx=mxj.cpu()))
    return net


def _close_weights(tnet, jnet, tol):
    got, ref = _weights(tnet), _weights(jnet)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)


def test_mlp_trains_through_the_rtc_head_as_the_jax_package_does():
    """`MLP()` from the same weights, 5 imperative SGD-momentum steps at
    batch 64 with the softmax_rtc head on each side."""
    rng = np.random.RandomState(0)
    x = rng.uniform(size=(64, 1, 28, 28)).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.float32)
    jnet = _jax_net(JMLP, x)
    tnet = MLP()
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    params_from_jax(tnet, _weights(jnet), ctx=mx.cpu())
    jtr = mxj.gluon.Trainer(jnet.collect_params(), "sgd", SGD)
    ttr = gluon.Trainer(tnet.collect_params(), "sgd", SGD)
    (jx, tx), (jy, ty) = _both(x), _both(y)
    jl, tl = [], []
    for _ in range(5):
        with jag.record():
            jp = mxj.nd.Custom(jnet(jx), jy, op_type="softmax_rtc")
        jp.backward()
        jtr.step(64)
        with autograd.record():
            tp = nd.Custom(tnet(tx), ty, op_type="softmax_rtc")
        tp.backward()
        ttr.step(64)
        rows = np.arange(64), y.astype(int)
        jl.append(-np.log(jp.asnumpy()[rows]).mean())
        tl.append(-np.log(tp.asnumpy()[rows]).mean())
    np.testing.assert_allclose(tl, jl, **MLP_LOSS_TOL)
    assert tl[-1] < tl[0]
    _close_weights(tnet, jnet, MLP_WEIGHT_TOL)


def test_lenet_forward_and_parallel_trainer_steps_match_jax():
    """LeNet at `bench_lenet`'s optimizer (SGD lr 0.1, momentum 0.9) and
    batch 16: the forward, then 3 `ParallelTrainer.step`s with softmax
    cross-entropy.  Against the JAX package's `step`, not its
    `run_steps`: on the CPU its compiled loop of two LeNet steps moves
    the convolution weights up to 2.3e-4 away from its own two `step`s
    (ROADMAP, reference facts)."""
    rng = np.random.RandomState(0)
    x = rng.uniform(size=(16, 1, 28, 28)).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.float32)
    jnet = _jax_net(JLeNet, x)
    tnet = get_model("lenet")
    assert isinstance(tnet, LeNet)
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    params_from_jax(tnet, _weights(jnet), ctx=mx.cpu())
    (jx, tx), (jy, ty) = _both(x), _both(y)
    with mx.cpu():
        tout = tnet(tx).asnumpy()
    np.testing.assert_allclose(tout, jnet(jx).asnumpy(), rtol=0, atol=1e-5)
    jloss = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    jtr = jpar.ParallelTrainer(jnet, lambda o, lab: jloss(o, lab), "sgd",
                               SGD, mesh=jpar.default_mesh(1))
    ttr = parallel.ParallelTrainer(
        tnet, lambda o, lab: tloss(o, lab), "sgd", SGD,
        mesh=parallel.default_mesh(ctx=mx.cpu()))
    jl = [float(jtr.step(jx, jy).asnumpy()) for _ in range(3)]
    tl = [ttr.step(tx, ty).asscalar() for _ in range(3)]
    np.testing.assert_allclose(tl, jl, **LENET_LOSS_TOL)
    assert tl[-1] < tl[0]
    _close_weights(tnet, jnet, LENET_WEIGHT_TOL)
    # the port's run_steps(2) is two steps, bit for bit
    again = get_model("lenet")
    again.initialize(mx.init.Xavier(), ctx=mx.cpu())
    params_from_jax(again, _weights(_jax_net(JLeNet, x)), ctx=mx.cpu())
    tr2 = parallel.ParallelTrainer(
        again, lambda o, lab: tloss(o, lab), "sgd", SGD,
        mesh=parallel.default_mesh(ctx=mx.cpu()))
    tr2.step(tx, ty)
    assert tr2.run_steps(2, tx, ty).asscalar() == tl[-1]
    _close_weights(again, tnet, dict(rtol=0, atol=0))
