"""The port's optimizer update ops and the eight optimizers beyond SGD and
Adam against the JAX package: NAG, AdaGrad, RMSProp (plain and
centered), AdaDelta, Ftrl, Signum, LAMB (with and without bias
correction) and DCASGD (momentum 0 and 0.9); the registry, the
elementwise kinds, the row-sparse rejections, and optimizer states
carried in both directions.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason:

- float32 weights and states after 3 updates: rtol 1e-6 with atol 1e-7
  of the largest value (the same elementwise float32 formulas; XLA may
  contract a multiply-add the port rounds twice);
- bfloat16 weights after 3 updates: one bf16 ulp of the JAX value (the
  same float32 arithmetic, rounded once more into bf16 per update;
  a float32 difference near a rounding boundary may round either way);
- one Trainer step after states loaded across: rtol 1e-6, atol 1e-7.
"""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu.ops import optim as jk

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd, optimizer as topt
from incubator_mxnet_torch.convert import optimizer_states_from_jax, \
    params_from_jax
from incubator_mxnet_torch.ops import optim as tk

SHAPES = [(7, 3), (5,), (2, 3, 4)]
STEPS = 3


def _close_f32(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-7 * max(1.0, np.abs(ref).max()))


def _within_bf16_ulp(got, ref):
    """|got − ref| ≤ one bfloat16 step at ref."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    bad = np.abs(got - ref) > ulp
    assert not bad.any(), (f"{bad.sum()} of {bad.size} values more than one "
                           f"bf16 ulp apart; worst {np.abs(got - ref).max()}")


def _check(got, ref, dtype):
    (_close_f32 if dtype == "float32" else _within_bf16_ulp)(got, ref)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


# ----------------------------------------------------------- update ops
OPS = {
    "nag_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=1e-3)),
    "rmsprop_update": (1, dict(lr=0.01, gamma1=0.9, epsilon=1e-8, wd=1e-3,
                               clip_weights=0.9)),
    "rmspropalex_update": (3, dict(lr=0.01, gamma1=0.95, gamma2=0.9,
                                   epsilon=1e-8, rescale_grad=0.5)),
    "adagrad_update": (1, dict(lr=0.1, epsilon=1e-7, clip_gradient=1.0)),
    "adadelta_update": (2, dict(rho=0.9, epsilon=1e-5, wd=1e-2)),
    "ftrl_update": (2, dict(lr=0.1, lamda1=0.01, beta=1.0, wd=1e-3)),
    "signsgd_update": (0, dict(lr=0.01, wd=1e-2)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_update_op_matches_jax(name, dtype):
    """3 updates of each op, float32 states, weights in `dtype`."""
    n_states, kw = OPS[name]
    rng = np.random.RandomState(sorted(OPS).index(name))
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(STEPS)]
    jw = jnp.asarray(w0).astype(getattr(jnp, dtype))
    tw = torch.from_numpy(w0).to(getattr(torch, dtype))
    js = [jnp.zeros((6, 5), jnp.float32) for _ in range(n_states)]
    ts = [torch.zeros(6, 5) for _ in range(n_states)]
    for g in grads:
        jout = getattr(jk, name)(jw, jnp.asarray(g), *js, **kw)
        tout = getattr(tk, name)(tw, torch.from_numpy(g), *ts, **kw)
        if n_states:
            (jw, *js), (tw, *ts) = jout, tout
        else:
            jw, tw = jout, tout
    assert tw.dtype == getattr(torch, dtype)
    _check(_f32(tw), _f32(jw), dtype)
    for a, b in zip(ts, js):
        assert a.dtype == torch.float32
        _close_f32(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_lamb_phases_match_jax(bias_correction, dtype):
    """Phase 1 then ‖w‖ (the weight's dtype) and ‖step‖ then phase 2,
    3 times, with bounds set."""
    rng = np.random.RandomState(11)
    w0 = rng.randn(8, 4).astype(np.float32)
    jw = jnp.asarray(w0).astype(getattr(jnp, dtype))
    tw = torch.from_numpy(w0).to(getattr(torch, dtype))
    jm = jv = jnp.zeros((8, 4), jnp.float32)
    tm = tv = torch.zeros(8, 4)
    for t in range(1, STEPS + 1):
        g = rng.randn(8, 4).astype(np.float32)
        kw = dict(t=t, bias_correction=bias_correction, wd=0.01,
                  rescale_grad=0.5)
        jstep, jm, jv = jk.lamb_update_phase1(jw, jnp.asarray(g), jm, jv, **kw)
        tstep, tm, tv = tk.lamb_update_phase1(tw, torch.from_numpy(g), tm,
                                              tv, **kw)
        _close_f32(tstep.numpy(), np.asarray(jstep))
        from incubator_mxnet_tpu.ops.reduce import norm as jnorm
        from incubator_mxnet_torch.ops.math import norm as tnorm
        bounds = dict(lr=0.05, lower_bound=0.5, upper_bound=5.0)
        jw = jk.lamb_update_phase2(jw, jstep, jnorm(jw), jnorm(jstep),
                                   **bounds)
        tw = tk.lamb_update_phase2(tw, tstep, tnorm(tw), tnorm(tstep),
                                   **bounds)
        _check(_f32(tw), _f32(jw), dtype)


# ---------------------------------------------------------- optimizers
OPTIMIZERS = [
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("adagrad", dict(learning_rate=0.1, eps=1e-6, clip_gradient=2.0)),
    ("rmsprop", dict(learning_rate=0.01, clip_weights=1.5)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, gamma1=0.95,
                     rescale_grad=0.5)),
    ("adadelta", dict(rho=0.9, epsilon=1e-5, wd=1e-3)),
    ("ftrl", dict(learning_rate=0.1, lamda1=0.01, beta=1.0)),
    ("signum", dict(learning_rate=0.01, wd=1e-2)),
    ("lamb", dict(learning_rate=0.01, wd=0.01)),
    ("lamb", dict(learning_rate=0.01, bias_correction=False,
                  lower_bound=0.1, upper_bound=10.0)),
    ("dcasgd", dict(learning_rate=0.1, lamda=0.04, wd=1e-3)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, lamda=0.04)),
]
OPT_IDS = ["nag", "adagrad", "rmsprop", "rmsprop_centered", "adadelta",
           "ftrl", "signum", "lamb", "lamb_no_bias_correction", "dcasgd",
           "dcasgd_momentum"]


def _run(pkg, name, params, dtype, steps=STEPS):
    """`steps` `Optimizer.update`s on each shape from the same weights,
    a fresh gradient per step in the weights' dtype; returns the final
    weights and states as float32 numpy."""
    rng = np.random.RandomState(5)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
          for _ in range(steps)]
    if pkg == "jax":
        o = jopt.create(name, **params)
        arr = lambda a: mxj.nd.array(a, ctx=mxj.cpu()).astype(dtype)  # noqa
    else:
        o = topt.create(name, **params)
        arr = lambda a: nd.array(a, ctx=mx.cpu()).astype(dtype)       # noqa
    weights = [arr(w) for w in ws]
    states = [o.create_state(i, w) for i, w in enumerate(weights)]
    for step in gs:
        for i, (w, g) in enumerate(zip(weights, step)):
            o.update(i, w, arr(g), states[i])

    def flat(s):
        if s is None:
            return []
        if isinstance(s, tuple):
            return [x for v in s for x in flat(v)]
        return [s.astype("float32").asnumpy()]
    return ([w.astype("float32").asnumpy() for w in weights],
            [flat(s) for s in states])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,params", OPTIMIZERS, ids=OPT_IDS)
def test_optimizer_matches_jax(name, params, dtype):
    ref_w, ref_s = _run("jax", name, params, dtype)
    got_w, got_s = _run("torch", name, params, dtype)
    for a, b in zip(got_w, ref_w):
        _check(a, b, dtype)
    for sa, sb in zip(got_s, ref_s):
        assert len(sa) == len(sb)
        for a, b in zip(sa, sb):
            # DCASGD's states are in the weight's dtype
            _check(a, b, "bfloat16" if name == "dcasgd" and
                   dtype == "bfloat16" else "float32")


def test_registry_and_elementwise_kinds_match_jax():
    assert sorted(topt.optimizer._REGISTRY) == sorted(jopt.optimizer._REGISTRY)
    assert topt.ELEMENTWISE_OPTS == jopt.ELEMENTWISE_OPTS
    for name in jopt.optimizer._REGISTRY:
        assert type(topt.create(name)).__name__ == \
            type(jopt.create(name)).__name__
    assert topt.create("adagrad", eps=1e-5).float_stable_eps == 1e-5


@pytest.mark.parametrize("name,params", [
    ("nag", dict(momentum=0.9)), ("adagrad", {}), ("rmsprop", {}),
    ("rmsprop", dict(centered=True)), ("adadelta", {}), ("signum", {})],
    ids=["nag", "adagrad", "rmsprop", "rmsprop_centered", "adadelta",
         "signum"])
def test_update_flat_equals_per_key(name, params):
    """The new elementwise kinds take `update_flat`: the same bits as the
    per-key update of the parameter itself."""
    rng = np.random.RandomState(3)
    w0, g = (rng.randn(4, 3).astype(np.float32) for _ in range(2))
    with mx.cpu():
        a, b = nd.array(w0), nd.array(w0)
        ga = nd.array(g)
    up_key = topt.get_updater(topt.create(name, **params))
    up_flat = topt.get_updater(topt.create(name, **params))
    for _ in range(2):
        up_key(0, ga, a)
        assert up_flat.update_flat(0, ga, b)
    np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
    assert not topt.get_updater(topt.create("lamb")).update_flat(0, ga, b)


# ------------------------------------------------- row-sparse gradients
REJECTING = ["nag", "adagrad", "rmsprop", "adadelta", "ftrl", "signum",
             "lamb"]


@pytest.mark.parametrize("name", REJECTING)
def test_optimizers_without_a_lazy_update_reject_row_sparse(name):
    """The JAX package fails on these at the same point (an
    AttributeError); the port names the optimizer."""
    with mx.cpu():
        w = nd.array(np.ones((6, 2), np.float32))
        g = nd.sparse.row_sparse_array((np.ones((2, 2), np.float32), [1, 4]),
                                       shape=(6, 2))
    o = topt.create(name)
    with pytest.raises(mx.MXNetError, match="takes no row_sparse"):
        o.update(0, w, g, o.create_state(0, w))
    np.testing.assert_array_equal(w.asnumpy(), 1.0)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_dcasgd_row_sparse_is_its_dense_form(momentum):
    """DCASGD computes on a row-sparse gradient as on its dense form."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(6, 2).astype(np.float32)
    vals = rng.randn(2, 2).astype(np.float32)
    with mx.cpu():
        g = nd.sparse.row_sparse_array((vals, [4, 1]), shape=(6, 2))
        a, b = nd.array(w0), nd.array(w0)
    o1 = topt.create("dcasgd", momentum=momentum, learning_rate=0.1)
    o2 = topt.create("dcasgd", momentum=momentum, learning_rate=0.1)
    s1, s2 = o1.create_state(0, a), o2.create_state(0, b)
    for _ in range(2):
        o1.update(0, a, g, s1)
        o2.update(0, b, g.tostype("default"), s2)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


# ------------------------------------------------ states across packages
def _jax_net():
    mxj.random.seed(0)
    net = mxj.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mxj.gluon.nn.Dense(6, activation="relu"),
                mxj.gluon.nn.Dense(3))
    net.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    x = np.random.RandomState(2).randn(4, 5).astype(np.float32)
    net(mxj.nd.array(x, ctx=mxj.cpu()))
    return net, x


def _port_net():
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Dense(6, activation="relu"), gluon.nn.Dense(3))
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    return net


LOADABLE = [(n, p) for n, p in OPTIMIZERS
            if not (n == "dcasgd" and "momentum" not in p)]


@pytest.mark.parametrize("name,params", LOADABLE,
                         ids=[i for i, (n, p) in zip(OPT_IDS, OPTIMIZERS)
                              if (n, p) in LOADABLE])
def test_trainer_loads_jax_per_key_states(tmp_path, name, params):
    """3 JAX Trainer steps, its per-key states saved; the port loads the
    weights and the states file, and one more step agrees.  (The JAX
    package cannot save DCASGD's (None, prev) at momentum 0: it calls
    asnumpy on the None.)"""
    jnet, x = _jax_net()
    y = np.random.RandomState(3).randn(4, 3).astype(np.float32)
    jtr = mxj.gluon.Trainer(jnet.collect_params(), name, dict(params))
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
        assert "states" in pickle.load(f)
    tnet = _port_net()
    params_from_jax(tnet, {k: v.data().asnumpy() for k, v in
                           jnet._collect_params_with_prefix().items()})
    ttr = gluon.Trainer(tnet.collect_params(), name, dict(params))
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
        _close_f32(tnet._collect_params_with_prefix()[k].data().asnumpy(),
                   p.data().asnumpy())


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_dcasgd_states_round_trip_and_convert(tmp_path, momentum):
    """DCASGD's (None or momentum, prev) states survive `save_states` /
    `load_states` and `optimizer_states_from_jax`, in the weights'
    dtype, so the next step is the same bits."""
    rng = np.random.RandomState(9)
    g = rng.randn(4, 3).astype(np.float32)

    def make():
        p = gluon.Parameter("w", shape=(4, 3), dtype="bfloat16")
        p.initialize(ctx=mx.cpu())
        p.set_data(torch.from_numpy(rng.randn(4, 3).astype(np.float32)))
        return p, gluon.Trainer([p], "dcasgd", {"momentum": momentum})
    p, tr = make()
    for _ in range(2):
        p.grad()[:] = torch.from_numpy(g)
        tr.step(1)
    path = str(tmp_path / "dcasgd.pkl")
    tr.save_states(path)
    clones = []
    for load in ("file", "convert"):
        q, tr2 = make()
        q.set_data(p.data())
        if load == "file":
            tr2.load_states(path)
        else:
            with open(path, "rb") as f:
                blob = pickle.load(f)
            optimizer_states_from_jax(tr2, blob["states"], blob["num_update"])
        mom, prev = tr2._states[0]
        assert (mom is None) == (momentum == 0.0)
        assert prev.dtype == "bfloat16"
        clones.append((q, tr2))
    for a, t in [(p, tr)] + clones:
        a.grad()[:] = torch.from_numpy(g)
        t.step(1)
    for q, _ in clones:
        np.testing.assert_array_equal(q.data().asnumpy(), p.data().asnumpy())
