"""The recurrent slice's ops, layers, cells, initializers and utilities in
the port against the JAX package on the CPU.

Inputs come from numpy with a seed (`tests/test_op_sweep.py::_build_case`
where it has a case) and go to both packages; layer and cell weights go
from the JAX package into the port through `convert.params_from_jax`.
Tolerances, with their reasons:

- float32, forward and backward: rtol 1e-5, atol 1e-5 of the largest
  reference value — the same arithmetic; XLA's and torch's elementwise
  functions differ in the last bits and sums run in another order;
- bfloat16 ops, forward: one bf16 step (rtol and atol 2^-8 of the
  largest value) — each side rounds once after each op; backward: two
  steps (2^-7) — XLA computes a derivative such as tanh's 1 - y² in
  bfloat16, torch in float32 and rounds once;
- the RNN op in bfloat16: its forward and the gradients of data and
  states agree to one bf16 step; the gradient of the packed parameters
  to 2^-6 of its largest value — the JAX scan sums each step's
  gradient of the recurrent matrix in bfloat16, the port in float32 and
  rounds once (measured 3.2e-3 at T = 7);
- initializers by value where they are deterministic (exact), by their
  statistics where they draw (the port's draws are not the JAX bits).
"""
import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon import rnn as jrnn
from incubator_mxnet_tpu.gluon import utils as jutils
from incubator_mxnet_tpu.ops import registry as jreg
from incubator_mxnet_tpu.ops import rnn as jrnn_op

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.gluon import rnn
from incubator_mxnet_torch.ops import math as tmath
from incubator_mxnet_torch.ops import registry as treg
from incubator_mxnet_torch.ops import rnn as trnn_op

import test_op_sweep as S

F32 = dict(rtol=1e-5, atol_of_max=1e-5)
BF16 = dict(rtol=2 ** -8, atol_of_max=2 ** -8)
BF16_GRAD = dict(rtol=2 ** -7, atol_of_max=2 ** -7)
BF16_RNN_PARAM_GRAD = dict(rtol=2 ** -7, atol_of_max=2 ** -6)
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


def _np(a):
    """numpy float32 (or the array's own dtype) of a JAX array, NDArray
    or torch tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    if hasattr(a, "asnumpy"):
        a = a.asnumpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(got, ref, tol, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(
        got.astype(np.float64), ref.astype(np.float64), rtol=tol["rtol"],
        atol=tol["atol_of_max"] * max(np.abs(ref).max(initial=0), 1e-30),
        err_msg=what)


def _tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _check_op(jfn, tfn, arrays, kwargs, dtype, diff=None, grads=True,
              fwd_tol=None, grad_tols=None):
    """jfn (JAX) and tfn (port) on the same inputs: every output with its
    dtype, then the gradients of <outputs, seeded cotangents> for the
    inputs `diff` marks (all by default); float inputs take `dtype`.
    `grad_tols` maps an input's index to its tolerance."""
    diff = diff or [True] * len(arrays)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    js, ts = [], []
    for a, d in zip(arrays, diff):
        if d:
            j = jnp.asarray(a).astype(jd)
            js.append(j)
            ts.append(torch.from_numpy(_np(j).copy()).to(td)
                      .requires_grad_())
        else:
            js.append(jnp.asarray(a))
            ts.append(torch.from_numpy(np.array(a)))
    idx = [i for i, d in enumerate(diff) if d]

    def jf(*xs):
        full = list(js)
        for i, x in zip(idx, xs):
            full[i] = x
        return jfn(*full, **kwargs)
    jout, vjp = jax.vjp(jax.jit(jf), *[js[i] for i in idx])
    tout = tfn(*ts, **kwargs)
    jouts, touts = _tuple(jout), _tuple(tout)
    assert len(jouts) == len(touts)
    ftol = fwd_tol or (F32 if dtype == "float32" else BF16)
    for k, (j, t) in enumerate(zip(jouts, touts)):
        assert str(t.dtype).replace("torch.", "") == j.dtype.name, k
        _close(t, j, ftol, f"output {k}")
    if not grads:
        return
    rng = np.random.RandomState(1)
    cots = [np.asarray(rng.randn(*j.shape), np.float32) for j in jouts]
    jcots = tuple(jnp.asarray(c).astype(j.dtype) for c, j in zip(cots, jouts))
    jgrads = vjp(jcots if isinstance(jout, (tuple, list)) else jcots[0])
    tgrads = torch.autograd.grad(
        touts, [ts[i] for i in idx],
        [torch.from_numpy(_np(c).copy()).to(t.dtype)
         for c, t in zip(jcots, touts)], allow_unused=True)
    gtol = F32 if dtype == "float32" else BF16_GRAD
    for i, a, b in zip(idx, tgrads, jgrads):
        if a is None:
            assert not np.asarray(b).any(), i
            continue
        _close(a, b, (grad_tols or {}).get(i, gtol), f"gradient of input {i}")


def _jax_impl(name):
    return jreg._REGISTRY[name].impl


# ------------------------------------------------------ shape, math, sequence
UNARY = sorted(tmath._UNARY)
UNARY_INT = sorted(tmath._UNARY_INT)
SWEEP = UNARY + UNARY_INT + ["relu", "clip", "where", "norm", "swapaxes",
                             "squeeze", "concat", "stack", "split",
                             "SequenceMask", "SequenceLast",
                             "SequenceReverse"]


def test_unary_tables_match_jax_names():
    from incubator_mxnet_tpu.ops import math as jmath
    assert set(UNARY) == set(jmath._UNARY)
    assert set(UNARY_INT) == set(jmath._UNARY_INT)
    for name in UNARY + UNARY_INT + ["relu", "clip", "where", "norm"]:
        assert hasattr(nd, name), name


@DTYPES
@pytest.mark.parametrize("name", SWEEP)
def test_sweep_case_matches_jax(name, dtype):
    """Each new op on its `_build_case` inputs, forward and backward (the
    integer-preserving table has no gradient)."""
    args, kwargs, _ = S._build_case(name)
    arrays = [a.asnumpy() for a in args]
    _check_op(_jax_impl(name), treg.get_op(name), arrays, kwargs, dtype,
              grads=name not in UNARY_INT)


def _u(shape, seed, lo=-1.5, hi=1.5):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


LENS = np.array([5, 2, 0], np.float32)
EXTRA = [
    ("swapaxes", [_u((2, 3, 4), 0)], dict(dim1=0, dim2=2)),
    ("SwapAxis", [_u((2, 3, 4), 1)], dict(dim1=1, dim2=-1)),
    ("squeeze", [_u((2, 1, 4), 2)], dict(axis=1)),
    ("squeeze", [_u((1, 3, 1), 3)], dict()),
    ("squeeze", [_u((1, 3, 1), 4)], dict(axis=(0, 2))),
    ("concat", [_u((2, 3), 5), _u((2, 4), 6)], dict(dim=-1)),
    ("Concat", [_u((1, 3), 7), _u((2, 3), 8), _u((3, 3), 9)], dict(dim=0)),
    ("stack", [_u((2, 3), 10), _u((2, 3), 11)], dict(axis=-1)),
    ("split", [_u((2, 6, 4), 12)], dict(num_outputs=3, axis=1)),
    ("split", [_u((2, 3, 4), 13)], dict(num_outputs=3, axis=1,
                                        squeeze_axis=True)),
    ("SliceChannel", [_u((2, 3, 4), 14)], dict(num_outputs=2, axis=-1)),
    ("clip", [_u((3, 4), 15)], dict(a_min=-0.5, a_max=0.7)),
    ("clip", [_u((3, 4), 16)], dict(a_min=0.1)),
    ("norm", [_u((2, 3, 4), 17)], dict(ord=1, axis=1)),
    ("norm", [_u((2, 3, 4), 18)], dict(ord=2, axis=(0, 2), keepdims=True)),
    ("norm", [_u((2, 3, 4), 19)], dict(ord=3)),
    ("relu", [_u((3, 4), 20)], dict()),
    ("sigmoid", [_u((3, 4), 21, -3, 3)], dict()),
    ("tanh", [_u((3, 4), 22, -3, 3)], dict()),
]
SEQ = [
    ("SequenceMask", dict(use_sequence_length=True, value=-1.0)),
    ("SequenceMask", dict(use_sequence_length=True, axis=1)),
    ("SequenceLast", dict(use_sequence_length=True)),
    ("SequenceLast", dict(use_sequence_length=True, axis=1)),
    ("SequenceLast", dict(axis=1)),
    ("SequenceReverse", dict(use_sequence_length=True)),
    ("SequenceReverse", dict(use_sequence_length=True, axis=1)),
]


@DTYPES
@pytest.mark.parametrize("case", range(len(EXTRA)))
def test_shape_and_math_attrs_match_jax(case, dtype):
    name, arrays, kwargs = EXTRA[case]
    _check_op(_jax_impl(name), treg.get_op(name), arrays, kwargs, dtype)


@DTYPES
@pytest.mark.parametrize("case", range(len(SEQ)))
def test_sequence_ops_with_lengths_match_jax(case, dtype):
    """Lengths 5, 2 and 0 over T = 5 (a length-0 sequence is all
    padding; SequenceLast and SequenceReverse take lengths >= 1)."""
    name, kwargs = SEQ[case]
    lens = LENS if name == "SequenceMask" else np.array([5, 2, 1],
                                                        np.float32)
    shape = (3, 5, 2) if kwargs.get("axis") == 1 else (5, 3, 2)
    _check_op(_jax_impl(name), treg.get_op(name), [_u(shape, case), lens],
              kwargs, dtype, diff=[True, False])


@pytest.mark.parametrize("act_type", ["relu", "sigmoid", "tanh", "softrelu",
                                      "softsign", "gelu", "gelu_tanh",
                                      "silu"])
def test_activation_act_types_match_jax(act_type):
    """Every act_type of the JAX `Activation` op."""
    _check_op(_jax_impl("Activation"), treg.get_op("Activation"),
              [_u((3, 5), 30)], dict(act_type=act_type), "float32")


def test_where_and_integer_dtype_rules_match_jax():
    cond = np.array([[1, 0, 2], [0, 0, 1]], np.float32)
    _check_op(_jax_impl("where"), treg.get_op("where"),
              [cond, _u((2, 3), 0), _u((2, 3), 1)], {}, "float32",
              diff=[False, True, True])
    ints = np.array([1, 2, -3, 0], np.int32)
    bools = np.array([True, False, True, False])
    for name in UNARY_INT + ["abs", "sign", "square", "negative", "_copy",
                             "identity", "relu"]:
        for a in (ints, bools) if name in ("_copy", "abs",
                                           "logical_not") else (ints,):
            j = _jax_impl(name)(jnp.asarray(a))
            t = treg.get_op(name)(torch.from_numpy(a.copy()))
            assert str(t.dtype).replace("torch.", "") == j.dtype.name, name
            np.testing.assert_array_equal(_np(t), np.asarray(j), name)
    j = _jax_impl("clip")(jnp.asarray(ints), a_min=0, a_max=1.5)
    t = treg.get_op("clip")(torch.from_numpy(ints.copy()), a_min=0,
                            a_max=1.5)
    assert t.dtype == torch.float32 and j.dtype.name == "float32"
    np.testing.assert_array_equal(_np(t), np.asarray(j))


def test_split_and_squeeze_reject_what_jax_rejects():
    with pytest.raises(mx.MXNetError, match="equal parts"):
        treg.get_op("split")(torch.zeros(2, 5), num_outputs=2, axis=1)
    with pytest.raises(mx.MXNetError, match="not of size 1"):
        treg.get_op("split")(torch.zeros(2, 4), num_outputs=2, axis=1,
                             squeeze_axis=True)
    with pytest.raises(mx.MXNetError, match="not of size 1"):
        treg.get_op("squeeze")(torch.zeros(2, 3), axis=1)
    one = treg.get_op("split")(torch.zeros(2, 4), num_outputs=1, axis=0)
    assert isinstance(one, tuple) and len(one) == 1


def test_ndarray_methods_and_namespace_match_jax():
    """The NDArray methods `unroll` and the word-LM loop call, and the
    namespace functions, against the JAX NDArray's."""
    a = _u((4, 6, 2), 3)
    with mx.cpu():
        t = nd.array(a)
        lens = nd.array([3, 6, 1, 2])
    j = mxj.nd.array(a, ctx=mxj.cpu())
    jl = mxj.nd.array([3, 6, 1, 2], ctx=mxj.cpu())
    pairs = [
        (t.split(num_outputs=3, axis=1), j.split(num_outputs=3, axis=1)),
        (t.split(num_outputs=6, axis=1, squeeze_axis=True),
         j.split(num_outputs=6, axis=1, squeeze_axis=True)),
        ([t.slice_axis(2, 0, 1).squeeze(axis=2)],
         [j.slice_axis(2, 0, 1).squeeze(axis=2)]),
        ([t.swapaxes(0, 1)], [j.swapaxes(0, 1)]),
        ([t.sum(), t.mean(axis=1), t.norm(), t.clip(-0.2, 0.3)],
         [j.sum(), j.mean(axis=1), j.norm(), j.clip(-0.2, 0.3)]),
        ([t.sigmoid(), t.tanh(), t.relu()], [j.sigmoid(), j.tanh(),
                                             j.relu()]),
        ([t > 0.1, t >= 0.1, t < 0.1, t <= 0.1],
         [j > 0.1, j >= 0.1, j < 0.1, j <= 0.1]),
        ([nd.stack(t, t, axis=1), nd.concat(t, t, dim=2)],
         [mxj.nd.stack(j, j, axis=1), mxj.nd.concat(j, j, dim=2)]),
        ([nd.SequenceMask(t.swapaxes(0, 1), lens, use_sequence_length=True),
          nd.SequenceLast(t.swapaxes(0, 1), lens, use_sequence_length=True)],
         [mxj.nd.SequenceMask(j.swapaxes(0, 1), jl, use_sequence_length=True),
          mxj.nd.SequenceLast(j.swapaxes(0, 1), jl,
                              use_sequence_length=True)]),
    ]
    for got, ref in pairs:
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert isinstance(g, mx.NDArray)
            _close(g, r, F32)


# ------------------------------------------------------------- the RNN op
MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]


def _rnn_arrays(mode, layers, bidirectional, T=7, N=3, I=5, H=6, seed=0):
    D = 2 if bidirectional else 1
    P = jrnn_op.rnn_param_size(layers, I, H, bidirectional, mode)
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(T, N, I).astype(np.float32),
              rng.uniform(-0.4, 0.4, P).astype(np.float32),
              (rng.randn(layers * D, N, H) * 0.5).astype(np.float32)]
    if mode == "lstm":
        arrays.append((rng.randn(layers * D, N, H) * 0.5).astype(np.float32))
    return arrays, dict(state_size=H, num_layers=layers, mode=mode,
                        bidirectional=bidirectional)


@DTYPES
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_jax(mode, bidirectional, layers, dtype):
    """out, hy (and cy) and the gradients of data, parameters and states,
    T = 7, N = 3, I = 5, H = 6."""
    arrays, kwargs = _rnn_arrays(mode, layers, bidirectional)
    _check_op(_jax_impl("RNN"), treg.get_op("RNN"), arrays, kwargs, dtype,
              grad_tols={1: BF16_RNN_PARAM_GRAD} if dtype == "bfloat16"
              else None)


@DTYPES
def test_rnn_sweep_case_matches_jax(dtype):
    """`_build_case`'s RNN (rnn_tanh, T = 5, N = 2, I = 4, H = 8, weights
    in [0.5, 1.5])."""
    args, kwargs, _ = S._build_case("RNN")
    _check_op(_jax_impl("RNN"), treg.get_op("RNN"),
              [a.asnumpy() for a in args], kwargs, dtype,
              grad_tols={1: BF16_RNN_PARAM_GRAD} if dtype == "bfloat16"
              else None)


def test_rnn_op_bf16_products_keep_float32_results(monkeypatch):
    """The gates see unrounded float32 products: a bf16 LSTM's float32
    cell state (float32 states) agrees with the JAX op's to float32
    rounding, where products rounded to bf16 would move it a hundred
    times further."""
    arrays, kwargs = _rnn_arrays("lstm", 1, False, T=3)
    js = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    ts = [torch.from_numpy(_np(j).copy()).to(torch.bfloat16) for j in js]
    for k in (2, 3):
        js[k] = js[k].astype(jnp.float32)
        ts[k] = ts[k].float()
    jcy = np.asarray(_jax_impl("RNN")(*js, **kwargs)[2])
    tcy = trnn_op.rnn(*ts, **kwargs)[2]
    assert tcy.dtype == torch.float32
    err = np.abs(_np(tcy) - jcy).max()
    assert err <= 1e-6, err
    projector = trnn_op._projector

    def rounded(w, cd):
        fn = projector(w, cd)
        return lambda a: fn(a).to(cd).to(torch.float32)
    monkeypatch.setattr(trnn_op, "_projector", rounded)
    rounded_err = np.abs(_np(trnn_op.rnn(*ts, **kwargs)[2]) - jcy).max()
    assert rounded_err > 100 * max(err, 1e-7), (rounded_err, err)


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_param_size_and_unpack_offsets_match_jax(mode, bidirectional):
    for layers, I, H in ((1, 5, 6), (3, 4, 7)):
        n = jrnn_op.rnn_param_size(layers, I, H, bidirectional, mode)
        assert trnn_op.rnn_param_size(layers, I, H, bidirectional, mode) == n
        flat = np.arange(n, dtype=np.float32)
        jl = jrnn_op._unpack(jnp.asarray(flat), layers, I, H, bidirectional,
                             mode)
        tl = trnn_op._unpack(torch.from_numpy(flat), layers, I, H,
                             bidirectional, mode)
        assert len(tl) == len(jl) == layers
        for jdirs, tdirs in zip(jl, tl):
            assert len(tdirs) == len(jdirs) == (2 if bidirectional else 1)
            for jp, tp in zip(jdirs, tdirs):
                for a, b in zip(jp, tp):
                    np.testing.assert_array_equal(_np(b), np.asarray(a))


def test_rnn_dropout_between_layers_keeps_rate_and_scale():
    """p = 0.5 in train mode: the top layer's input is each lower output
    kept with probability 1 - p and scaled by 1 / (1 - p); predict mode
    and the 1-layer op draw nothing."""
    mx.random.seed(3)
    T, N, I, H = 4, 256, 3, 8
    P = trnn_op.rnn_param_size(2, I, H, False, "rnn_relu")
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randn(T, N, I).astype(np.float32))
    params = torch.from_numpy(rng.uniform(0, 0.5, P).astype(np.float32))
    # the top layer is the identity on non-negative inputs: W = I, R = 0
    w1 = P - 2 * H - (H * H + H * H) - 2 * H
    params[w1:w1 + H * H] = torch.eye(H).flatten()
    params[w1 + H * H:w1 + 2 * H * H] = 0
    params[-2 * H:] = 0
    state = torch.zeros(2, N, H)
    kw = dict(state_size=H, num_layers=2, mode="rnn_relu", p=0.5)
    with autograd.predict_mode():
        ref, _hy = trnn_op.rnn(data, params, state, **kw)
    with autograd.train_mode():
        out, _hy = trnn_op.rnn(data, params, state, **kw)
    kept = out != 0
    live = ref != 0
    share = (kept & live).sum().item() / live.sum().item()
    assert abs(share - 0.5) < 0.03, share
    np.testing.assert_allclose(out[kept & live].numpy(),
                               2 * ref[kept & live].numpy(), rtol=1e-6)


def test_rnn_op_rejects_unknown_mode():
    with pytest.raises(mx.MXNetError, match="unknown RNN mode"):
        trnn_op.rnn(torch.zeros(2, 1, 3), torch.zeros(10),
                    torch.zeros(1, 1, 2), state_size=2, num_layers=1,
                    mode="lstmp")


# ------------------------------------------------------------- the layers
def _weights(block):
    return {k: v.data().asnumpy()
            for k, v in block._collect_params_with_prefix().items()}


def _layer_pair(cls, *args, x=None, **kwargs):
    """A JAX layer and the port's, the port's weights copied from the
    JAX layer's after a forward of `x` resolved any deferred shape."""
    mxj.random.seed(0)
    jl = getattr(jrnn, cls)(*args, **kwargs)
    jl.initialize(ctx=mxj.cpu())
    jl(mxj.nd.array(x, ctx=mxj.cpu()))
    tl = getattr(rnn, cls)(*args, **kwargs)
    tl.initialize(ctx=mx.cpu())
    params_from_jax(tl, _weights(jl))
    return jl, tl


LAYERS = [("LSTM", dict(num_layers=2)),
          ("GRU", dict(num_layers=1, bidirectional=True)),
          ("RNN", dict(num_layers=2, activation="tanh")),
          ("RNN", dict(num_layers=1, activation="relu", bidirectional=True))]


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("case", range(len(LAYERS)))
def test_rnn_layers_match_jax(case, layout, explicit):
    """Deferred input size, both layouts, with and without explicit states:
    the return convention and every value."""
    cls, kw = LAYERS[case]
    x = _u((5, 3, 4) if layout == "TNC" else (3, 5, 4), case)
    jl, tl = _layer_pair(cls, 6, layout=layout, x=x, **kw)
    assert tl.parameters_.shape == jl.parameters_.shape
    n = 2 if cls == "LSTM" else 1
    D = 2 if kw.get("bidirectional") else 1
    with mx.cpu():
        tx = nd.array(x)
        tstates = tl.begin_state(batch_size=3)
    jstates = jl.begin_state(batch_size=3, ctx=mxj.cpu())
    assert len(tstates) == len(jstates) == n
    assert tstates[0].shape == (kw["num_layers"] * D, 3, 6)
    jx = mxj.nd.array(x, ctx=mxj.cpu())
    if not explicit:
        tout, jout = tl(tx), jl(jx)
        assert isinstance(tout, mx.NDArray)
        _close(tout, jout, F32)
        return
    rng = np.random.RandomState(7)
    vals = [rng.randn(*s.shape).astype(np.float32) for s in tstates]
    with mx.cpu():
        ts = [nd.array(v) for v in vals]
    js = [mxj.nd.array(v, ctx=mxj.cpu()) for v in vals]
    for tres, jres in ((tl(tx, ts), jl(jx, js)), (tl(tx, *ts), jl(jx, *js))):
        tseq, tnew = tres
        jseq, jnew = jres
        assert isinstance(tnew, list) and len(tnew) == n
        _close(tseq, jseq, F32)
        for a, b in zip(tnew, jnew):
            _close(a, b, F32)


def test_rnn_layer_init_name_and_raise_without_cuda(monkeypatch):
    """The packed vector is `rnn<n>_parameters` in every mode and takes
    Uniform(hidden ** -0.5) under a global Xavier; without ctx on a
    machine without CUDA the layer raises."""
    for cls in ("LSTM", "GRU", "RNN"):
        layer = getattr(rnn, cls)(6, 2, input_size=8)
        assert layer.parameters_.name.startswith("rnn")
        assert layer.parameters_.name.endswith("_parameters")
        assert layer.name.startswith("rnn")
        layer.initialize(mx.init.Xavier(), ctx=mx.cpu())
        w = layer.parameters_.data().asnumpy()
        assert 0.35 < np.abs(w).max() <= 6 ** -0.5
    jlayer = jrnn.LSTM(6, 2, input_size=8)
    assert jlayer.parameters_.name.startswith("rnn")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layer = rnn.LSTM(6, input_size=4)
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        layer.initialize()
        layer(nd.zeros((2, 1, 4)))


def test_rnn_layer_bf16_matches_jax():
    """A cast bf16 LSTM layer (NTC) against the JAX layer's."""
    x = _u((3, 5, 4), 9)
    jl, tl = _layer_pair("LSTM", 6, 2, layout="NTC", x=x)
    jl.cast("bfloat16")
    tl.cast("bfloat16")
    with mx.cpu():
        tout = tl(nd.array(x).astype("bfloat16"))
    jout = jl(mxj.nd.array(x, ctx=mxj.cpu()).astype("bfloat16"))
    assert tout.dtype == jout.dtype == "bfloat16"
    _close(tout, jout, BF16)


# -------------------------------------------------------------- the cells
def _cell_pair(make_j, make_t, x):
    """JAX and port cells, the port's weights copied after a JAX unroll
    of x (N, T, C) resolved the deferred shapes."""
    mxj.random.seed(0)
    jc = make_j()
    jc.initialize(ctx=mxj.cpu())
    jc.unroll(x.shape[1], mxj.nd.array(x, ctx=mxj.cpu()))
    tc = make_t()
    tc.initialize(ctx=mx.cpu())
    params_from_jax(tc, _weights(jc))
    return jc, tc


def _stack(mod):
    s = mod.SequentialRNNCell()
    s.add(mod.LSTMCell(5))
    s.add(mod.ResidualCell(mod.GRUCell(5)))
    s.add(mod.DropoutCell(0.0))
    s.add(mod.RNNCell(4, activation="relu"))
    return s


CELLS = {
    "rnn": lambda m: m.RNNCell(5),
    "lstm": lambda m: m.LSTMCell(5),
    "gru": lambda m: m.GRUCell(5),
    "stack": _stack,
    "zoneout": lambda m: m.ZoneoutCell(m.LSTMCell(5), zoneout_states=0.25),
    "variational": lambda m: m.VariationalDropoutCell(
        m.GRUCell(5), drop_inputs=0.3, drop_states=0.3, drop_outputs=0.3),
    "bidirectional": lambda m: m.BidirectionalCell(m.LSTMCell(4),
                                                   m.GRUCell(3)),
}


def _unroll_both(jc, tc, x, layout, merge, valid_length=None):
    T = x.shape[layout.find("T")]
    with mx.cpu():
        tx = nd.array(x)
        tvl = None if valid_length is None else nd.array(valid_length)
    jvl = None if valid_length is None else mxj.nd.array(valid_length,
                                                         ctx=mxj.cpu())
    tout, tst = tc.unroll(T, tx, layout=layout, merge_outputs=merge,
                          valid_length=tvl)
    jout, jst = jc.unroll(T, mxj.nd.array(x, ctx=mxj.cpu()), layout=layout,
                          merge_outputs=merge, valid_length=jvl)
    tout, jout = _tuple(tout), _tuple(jout)
    assert len(tout) == len(jout) and len(tst) == len(jst)
    for a, b in zip(tout + tuple(tst), jout + tuple(jst)):
        _close(a, b, F32)


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("layout,merge", [("NTC", True), ("TNC", False)])
def test_cell_unroll_matches_jax(name, layout, merge):
    """Predict mode: every cell's outputs and final states over 4 steps
    (zoneout mixes new and old states by its rate; the dropout cells
    are the identity)."""
    x = _u((3, 4, 6), 1)
    jc, tc = _cell_pair(lambda: CELLS[name](jrnn), lambda: CELLS[name](rnn),
                        x)
    if layout == "TNC":
        x = x.swapaxes(0, 1).copy()
    _unroll_both(jc, tc, x, layout, merge)


@pytest.mark.parametrize("name", ["lstm", "gru", "stack", "bidirectional"])
def test_cell_unroll_valid_length_matches_jax(name):
    """Padding past each sample's length is masked and each final state is
    the one at the sample's last valid step."""
    x = _u((3, 4, 6), 2)
    jc, tc = _cell_pair(lambda: CELLS[name](jrnn), lambda: CELLS[name](rnn),
                        x)
    _unroll_both(jc, tc, x, "NTC", True,
                 valid_length=np.array([4, 2, 1], np.float32))


def test_cell_step_and_begin_state_match_jax():
    """One step of each basic cell from explicit states, and begin_state's
    shapes and `func`."""
    x = _u((3, 4, 6), 3)
    for name in ("rnn", "lstm", "gru"):
        jc, tc = _cell_pair(lambda: CELLS[name](jrnn),
                            lambda: CELLS[name](rnn), x)
        with mx.cpu():
            tstates = tc.begin_state(3, func=nd.zeros)
        jstates = jc.begin_state(3, ctx=mxj.cpu())
        assert [s.shape for s in tstates] == [s.shape for s in jstates]
        vals = [_u(s.shape, 4) for s in tstates]
        with mx.cpu():
            tout, tnew = tc(nd.array(x[:, 0]), [nd.array(v) for v in vals])
        jout, jnew = jc(mxj.nd.array(x[:, 0], ctx=mxj.cpu()),
                        [mxj.nd.array(v, ctx=mxj.cpu()) for v in vals])
        for a, b in zip([tout] + list(tnew), [jout] + list(jnew)):
            _close(a, b, F32)
    with pytest.raises(NotImplementedError, match="unroll"):
        rnn.BidirectionalCell(rnn.LSTMCell(2), rnn.LSTMCell(2))(None, [])


def test_dropout_cells_in_train_mode():
    """Train mode: DropoutCell keeps each element with probability 1 - p
    and scales it by 1 / (1 - p); ZoneoutCell keeps each new state or
    the old one; VariationalDropoutCell draws one mask per unroll, the
    same at every step."""
    mx.random.seed(0)
    with mx.cpu():
        x = nd.array(np.ones((64, 8, 32), np.float32))
        drop = rnn.DropoutCell(0.5)
        with autograd.train_mode():
            out, _ = drop.unroll(8, x, merge_outputs=True)
        vals = np.unique(out.asnumpy())
        assert set(vals) == {0.0, 2.0}
        assert abs((out.asnumpy() == 0).mean() - 0.5) < 0.02
        cell = rnn.ZoneoutCell(rnn.RNNCell(16), zoneout_states=0.5)
        cell.initialize(ctx=mx.cpu())
        old = [nd.array(np.full((64, 16), 7.0, np.float32))]
        with autograd.train_mode():
            _out, new = cell(x[:, 0], old)
        kept_old = (new[0].asnumpy() == 7.0).mean()
        assert 0.4 < kept_old < 0.6
        var = rnn.VariationalDropoutCell(rnn.RNNCell(16), drop_inputs=0.5)
        var.initialize(ctx=mx.cpu())
        seen = []
        base = var.base_cell

        def spy(inp, states):
            seen.append(inp.asnumpy() != 0)
            return rnn.RNNCell.forward(base, inp, states)
        base.forward = spy
        with autograd.train_mode():
            var.unroll(8, x)
        assert len(seen) == 8 and all((m == seen[0]).all() for m in seen)
        assert 0.4 < seen[0].mean() < 0.6


# ---------------------------------------------------------- initializers
def _fill(init, shape, name="w_weight", dtype=np.float32):
    """The same initializer on a port tensor and a JAX NDArray."""
    t = torch.zeros(shape)
    init[0](name, t)
    j = mxj.nd.zeros(shape, ctx=mxj.cpu())
    init[1](name, j)
    return t.numpy(), j.asnumpy()


def _both(cls, *args, **kwargs):
    return (getattr(mx.init, cls)(*args, **kwargs),
            getattr(mxj.init, cls)(*args, **kwargs))


def test_deterministic_initializers_match_jax_by_value():
    for init, shape, name in ((_both("Constant", 0.37), (3, 4), "a_weight"),
                              (_both("LSTMBias", 1.5), (12,), "l0_bias"),
                              (_both("LSTMBias"), (8,), "rnn0_parameters"),
                              (_both("Bilinear"), (2, 3, 4, 4), "up_weight"),
                              (_both("Bilinear"), (1, 1, 3, 5), "up_weight")):
        t, j = _fill(init, shape, name)
        np.testing.assert_array_equal(t, j, str(init[0]))
    for name in ("constant", "lstmbias", "bilinear", "orthogonal",
                 "msraprelu"):
        assert type(mx.init.create(name)).__name__.lower() == name


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (4, 2, 3)])
def test_orthogonal_matches_jax_statistics(shape, rand_type):
    """Rows (or columns) orthonormal times `scale`, like the JAX draw."""
    t, j = _fill(_both("Orthogonal", scale=1.5, rand_type=rand_type), shape)
    for a in (t, j):
        m = a.reshape(shape[0], -1)
        g = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(g, 1.5 ** 2 * np.eye(len(g)), atol=1e-5)


def test_msraprelu_matches_jax_statistics():
    mx.random.seed(0)
    mxj.random.seed(0)
    t, j = _fill(_both("MSRAPrelu", "in", 0.25), (400, 250))
    want = math.sqrt(2.0 / (1 + 0.25 ** 2) / 250)
    for a in (t, j):
        assert abs(a.std() / want - 1) < 0.02 and abs(a.mean()) < 3e-3


def test_init_desc_attrs_choose_the_initializer():
    """`attrs["__init__"]` fills the parameter whatever its name and the
    initializer called (Xavier would refuse a 1-D array)."""
    t, j = torch.zeros(8), mxj.nd.zeros((8,), ctx=mxj.cpu())
    desc = mx.init.InitDesc("x_weight", attrs={"__init__": "lstmbias"})
    assert desc == "x_weight" and desc.global_init is None
    mx.init.Xavier()(desc, t)
    mxj.init.Xavier()(mxj.init.InitDesc("x_weight",
                                        {"__init__": "lstmbias"}), j)
    np.testing.assert_array_equal(t.numpy(), j.asnumpy())
    assert t.tolist() == [0, 0, 1, 1, 0, 0, 0, 0]


# -------------------------------------------------------------- utilities
@DTYPES
@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax(max_norm, dtype):
    rng = np.random.RandomState(0)
    arrays = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (5,),
                                                        (2, 2, 2))]
    with mx.cpu():
        ts = [nd.array(a).astype(dtype) for a in arrays]
    js = [mxj.nd.array(a, ctx=mxj.cpu()).astype(dtype) for a in arrays]
    tt = gluon.utils.clip_global_norm(ts, max_norm)
    jt = jutils.clip_global_norm(js, max_norm)
    assert isinstance(tt, float)
    np.testing.assert_allclose(tt, jt, rtol=1e-6)
    for a, b in zip(ts, js):
        _close(a, b, F32 if dtype == "float32" else BF16)
    with mx.cpu():
        bad = [nd.array(np.array([np.inf, 1.0], np.float32))]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert not math.isfinite(gluon.utils.clip_global_norm(bad, 1.0))
    assert any("nan or inf" in str(x.message) for x in w)


def test_split_and_load_and_split_data():
    a = np.arange(24, dtype=np.float32).reshape(6, 4)
    one = gluon.split_and_load(a, [mx.cpu()])
    assert len(one) == 1 and one[0].context == mx.cpu()
    np.testing.assert_array_equal(one[0].asnumpy(), a)
    two = gluon.utils.split_and_load(a, [mx.cpu(0), mx.cpu(1)])
    assert [p.shape for p in two] == [(3, 4), (3, 4)]
    np.testing.assert_array_equal(np.concatenate([p.asnumpy() for p in two]),
                                  a)
    with mx.cpu():
        parts = gluon.utils.split_data(nd.array(a), 4, even_split=False)
    assert [p.shape[0] for p in parts] == [1, 1, 1, 3]
    with pytest.raises(mx.MXNetError, match="evenly"):
        gluon.utils.split_data(one[0], 4)
