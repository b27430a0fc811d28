"""The port's symbolic layer against the JAX package's: the op record
(`OpDef`) of every registered op, the `sym` namespace, argument,
auxiliary and output names, `infer_shape`/`infer_type`, and
`-symbol.json` both ways.

Graphs are built with the same calls in both packages, after both
name counters are reset, so auto-names agree.  Everything compared here
is exact: names, shapes and dtypes, and the JSON a graph round-trips
to.
"""
import json

import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.ops import registry as jreg
from incubator_mxnet_tpu.symbol import symbol as jsymmod

import incubator_mxnet_torch as mx
from incubator_mxnet_torch.ops import registry as treg
from incubator_mxnet_torch.symbol import symbol as tsymmod

PKGS = (mxj, mx)
NAMES = sorted(set(jreg.list_ops()) & set(treg.list_ops()))


def _reset():
    jsymmod._COUNTER.table = {}
    tsymmod._COUNTER.table = {}


@pytest.mark.parametrize("name", NAMES)
def test_opdef_record_matches_jax(name):
    """Every registered op has the JAX op's canonical name, input and
    attribute names, defaults, arity and flags: they become argument
    names (`fc1_weight`) and `-symbol.json` keys."""
    j, t = jreg.get_op(name), treg.get_opdef(name)

    def rec(o):
        return (o.name, o.input_names, o.n_required_inputs, o.attr_names,
                {k: repr(v) for k, v in o.attr_defaults.items()},
                o.variadic, o.needs_rng, o.needs_mode, o.amp_exclude)
    assert rec(t) == rec(j)


def test_registry_covers_jax_but_quantized():
    """The port registers every JAX op name, the 18 quantized ones
    among them, and `sym.X` and `nd.X` exist for every one."""
    missing = set(jreg.list_ops()) - set(treg.list_ops())
    assert missing == set()
    for n in treg.list_ops():
        assert callable(getattr(mx.sym, n)), n
        assert callable(getattr(mx.nd, n)), n


def _mlp(sym):
    data = sym.Variable("data")
    data = sym.Flatten(data=data)
    fc1 = sym.FullyConnected(data=data, name="fc1", num_hidden=32)
    act1 = sym.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = sym.FullyConnected(data=act1, name="fc2", num_hidden=10)
    return sym.SoftmaxOutput(data=fc2, name="softmax")


def _lenet(sym):
    data = sym.Variable("data")
    c1 = sym.Convolution(data=data, kernel=(5, 5), num_filter=6)
    t1 = sym.Activation(data=c1, act_type="tanh")
    p1 = sym.Pooling(data=t1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = sym.Convolution(data=p1, kernel=(5, 5), num_filter=8)
    t2 = sym.Activation(data=c2, act_type="tanh")
    p2 = sym.Pooling(data=t2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    f = sym.Flatten(data=p2)
    fc = sym.FullyConnected(data=f, num_hidden=10)
    return sym.SoftmaxOutput(data=fc, name="softmax")


def _conv_bn(sym):
    data = sym.var("data")
    c = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                        no_bias=True, name="conv")
    b = sym.BatchNorm(c, name="bn", fix_gamma=False)
    r = sym.relu(b[0] if len(b) > 1 else b) + 1.0
    return sym.mean(r * 2.0, axis=(2, 3), name="gap")


def _lstm(sym):
    data = sym.var("data")
    label = sym.var("softmax_label")
    embed = sym.Embedding(data, input_dim=20, output_dim=8, name="embed")
    rnn = sym.RNN(sym.swapaxes(embed, dim1=0, dim2=1), state_size=12,
                  num_layers=1, mode="lstm", name="lstm")
    out = sym.swapaxes(rnn[0], dim1=0, dim2=1)
    out = sym.reshape(out, shape=(-1, 12))
    pred = sym.FullyConnected(out, num_hidden=20, name="fc")
    return sym.SoftmaxOutput(pred, sym.reshape(label, shape=(-1,)),
                             name="softmax")


def _split_group(sym):
    x = sym.var("x")
    parts = sym.split(x, num_outputs=3, axis=1, name="sp")
    return sym.Group([parts[0] * parts[1], sym.tanh(parts[2]), parts[1]])


GRAPHS = {
    "mlp": (_mlp, {"data": (4, 1, 6, 6)}),
    "lenet": (_lenet, {"data": (2, 1, 28, 28)}),
    "conv_bn": (_conv_bn, {"data": (2, 3, 8, 8)}),
    "lstm": (_lstm, {"data": (3, 5), "softmax_label": (3, 5)}),
    "split_group": (_split_group, {"x": (2, 6)}),
}


def _both(name):
    fn, shapes = GRAPHS[name]
    out = []
    for pkg in PKGS:
        _reset()
        out.append(fn(pkg.sym))
    return out, shapes


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_names_and_infer_shape_match_jax(name):
    """Argument, auxiliary and output names, and every shape
    `infer_shape` derives from the data shapes."""
    (j, t), shapes = _both(name)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
    assert [s.name for s in t.get_internals()] == \
        [s.name for s in j.get_internals()]


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_infer_type_matches_jax(name, dtype):
    """`infer_type` from the data's dtype (the parameters adopt it,
    BatchNorm's stay float32; integer ops keep theirs)."""
    (j, t), shapes = _both(name)
    first = next(iter(shapes))
    got = t.infer_type(**{first: dtype})
    ref = j.infer_type(**{first: dtype})
    assert [[np.dtype(x).name for x in part] for part in got] == \
        [[np.dtype(x).name for x in part] for part in ref]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_json_both_ways(name):
    """A graph written by either package loads in the other with the
    same names, shapes and JSON."""
    (j, t), shapes = _both(name)
    tj, jj = t.tojson(), j.tojson()
    assert json.loads(tj) == json.loads(jj)
    from_jax = mx.sym.load_json(jj)
    from_port = mxj.sym.load_json(tj)
    assert from_jax.list_arguments() == j.list_arguments()
    assert from_port.list_arguments() == t.list_arguments()
    assert from_jax.infer_shape(**shapes) == j.infer_shape(**shapes)
    assert json.loads(from_jax.tojson()) == json.loads(jj)


def test_save_load_file_and_const(tmp_path):
    """`save`/`load` by file, with a graph constant (an NDArray operand
    of an `nd` op called on a Symbol) carried in the JAX package's
    `__value__`/`__dtype__` form."""
    out = []
    for pkg in PKGS:
        _reset()
        x = pkg.sym.var("x")
        with pkg.cpu():
            c = pkg.nd.array(np.arange(3, dtype=np.float32))
        y = pkg.nd.broadcast_add(x, c, name="addc")
        f = str(tmp_path / f"{pkg.__name__}.json")
        y.save(f)
        out.append((y, f))
    (jy, jf), (ty, tf) = out
    assert json.loads(open(tf).read()) == json.loads(open(jf).read())
    back = mx.sym.load(jf)
    with mx.cpu():
        r = back.eval_with({"x": mx.nd.ones((2, 3))})
    np.testing.assert_array_equal(r.asnumpy(), np.ones((2, 3)) + np.arange(3))


def test_symbol_operators_and_methods():
    """The operators and methods build the JAX package's nodes."""
    res = []
    for pkg in PKGS:
        _reset()
        s = pkg.sym
        a, b = s.var("a"), s.var("b")
        g = s.Group([a + b, a - 1, 2 - a, a * b, a / 2, 3 / a, a ** 2,
                     -a, a > b, a <= 0.5, a.reshape((2, 3)),
                     a.transpose(), a.sum(axis=1), a.mean(), a.max(),
                     a.astype("float16"), a.expand_dims(0), a.flatten(),
                     a.slice_axis(1, 0, 2), a.swapaxes(0, 1)])
        res.append(g)
    j, t = res
    assert json.loads(t.tojson()) == json.loads(j.tojson())
    assert t.infer_shape(a=(3, 2), b=(3, 2)) == \
        j.infer_shape(a=(3, 2), b=(3, 2))
