"""The port's mesh (`incubator_mxnet_torch/parallel/`) over a world of 4
real ranks (a gloo group of 4 spawned processes, one for the file, each
case sent to every rank) against the JAX package on the forced CPU mesh
of the same shape (its first 4 devices): the cases of
`tests/test_parallel.py` but the trainer's (those are in
`test_torch_parallel_trainer.py`) and `zero_state_spec` and the ZeRO
level of `tests/test_kvstore_zero.py`.

Inputs and weights are made with numpy from seeds (the JAX weights go
into the port through `convert.params_from_jax`).  Tolerances, float32:

- meshes, rules, data movement (gathers, permutations, all-to-all):
  exact;
  sums over ranks against XLA's: 1e-6 (gloo adds in another order);
- ring attention against the JAX ring and full attention: 2e-5 (its
  gradients 1e-4, as the JAX test states);
- the pipeline's gradient, MoE's output and gradients: rtol 1e-4,
  atol 1e-5;
- the attention op under the scope: 2e-5, after it 1e-6.
"""
import os
import sys

import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import parallel as jpar

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import parallel as par

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_world import World  # noqa: E402


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _isolate_mesh_env(monkeypatch):
    monkeypatch.delenv("MXNET_MESH_SHAPE", raising=False)
    monkeypatch.delenv("MXNET_PP_MICROBATCH", raising=False)
    monkeypatch.delenv("MXNET_KV_ZERO", raising=False)


def _jmesh(axes):
    import jax
    return jpar.make_mesh(axes, jax.devices()[:int(np.prod(list(
        axes.values())))])


# -- meshes -------------------------------------------------------------------

def test_make_mesh_and_auto_axes(world):
    infos = world.run("mesh_info", {"dp": 2, "tp": 2})
    jm = _jmesh({"dp": 2, "tp": 2})
    want = [[d.id for d in row] for row in np.asarray(jm.devices)]
    for r, info in enumerate(infos):
        assert info["axis_names"] == jm.axis_names
        assert info["shape"] == dict(jm.shape)
        assert info["devices"] == want
        where = np.argwhere(np.asarray(want) == r)[0]
        assert info["coords"] == {"dp": int(where[0]), "tp": int(where[1])}
        assert info["default_dp"] == 4 and info["size"] == 4
    for n, want_axes in ((8, ("dp", "tp", "sp")), (4, ("dp", "tp")),
                         (6, ("dp", "tp", "sp")), (16, ("dp", "tp", "sp"))):
        assert par.auto_axes(n, want_axes) == jpar.auto_axes(n, want_axes)
    one = par.default_mesh(ctx=mx.cpu())
    assert one.shape == {"dp": 1} and one.transport is None


def test_make_mesh_needs_devices(world):
    msgs = world.run("mesh_too_big", {"dp": 8})
    import jax
    with pytest.raises(Exception) as e:
        jpar.make_mesh({"dp": 8}, jax.devices()[:4])
    assert all(m == str(e.value) for m in msgs), (msgs, str(e.value))


def test_parse_mesh_shape_forms(world):
    for val in ((2, 2, 2), "2,4", "dp=2,pp=2", "tp4,dp2", {"dp": 8},
                "dp2,sp2", (1, 2)):
        assert par.parse_mesh_shape(val) == jpar.parse_mesh_shape(val)
    for bad, match in (("zz=2", "unknown axes"), ("dp2,dp4,tp2", "twice"),
                       ("dp=two", "mesh_shape"), ((1, 2, 3, 4), "mesh_shape")):
        with pytest.raises(mx.MXNetError, match=match):
            par.parse_mesh_shape(bad)
    assert par.mesh_from_shape(None) is None
    infos = world.run("mesh_from_env", "2,1,2")
    assert infos[0] == {"axis_names": ("dp", "pp", "tp"),
                        "shape": {"dp": 2, "pp": 2, "tp": 1}}


@pytest.mark.parametrize("shape_env,want", [
    ("dp2,tp2", {"dp": 2, "pp": 1, "tp": 2}),
    ("2,2", {"dp": 2, "pp": 1, "tp": 2}),
    ("dp2,pp2", {"dp": 2, "pp": 2, "tp": 1})])
def test_mesh_from_shape_env(world, shape_env, want):
    infos = world.run("mesh_from_env", shape_env)
    assert all(i["shape"] == want for i in infos)
    assert want == jpar.parse_mesh_shape(shape_env)


# -- collectives ----------------------------------------------------------------

def _jax_collective(kind, x, n):
    import jax
    import jax.numpy as jnp
    from functools import partial
    from jax.sharding import PartitionSpec as P
    C = jpar.collectives
    mesh = _jmesh({"dp": n})

    def f(v):
        if kind == "allreduce":
            return C.allreduce(v, "dp")
        if kind == "allmean":
            return C.allmean(v, "dp")
        if kind == "allmax":
            return C.allmax(v, "dp")
        if kind == "allgather":
            return C.allgather(v, "dp", axis=0)
        if kind == "reduce_scatter":
            return C.reduce_scatter(v, "dp", axis=0)
        if kind == "ppermute":
            return C.ppermute(v, "dp", [(i, (i + 1) % n) for i in range(n)])
        if kind == "shift2":
            return C.shift(v, "dp", 2)
        if kind == "alltoall":
            return C.alltoall(v, "dp", split_axis=0, concat_axis=1)
        if kind == "axis_index":
            return v * 0 + C.axis_index("dp") + 10 * C.axis_size("dp")
        if kind == "smoke":
            total = C.allreduce(v, "dp")
            shifted = C.shift(v, "dp", 1)
            return total + 0 * shifted
    out_spec = P(None) if kind == "allgather" else P("dp")
    g = C.shard_map(f, mesh=mesh, in_specs=P("dp"), out_specs=out_spec,
                    check_vma=False)
    out = g(jnp.asarray(x))
    w = jnp.linspace(-1, 1, out.size).reshape(out.shape)
    grad = jax.grad(lambda v: (g(v) * w).sum())(jnp.asarray(x))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("kind", ["smoke", "allreduce", "allmean",
                                  "allgather", "reduce_scatter", "ppermute",
                                  "shift2", "alltoall", "axis_index"])
def test_collectives_match_jax(world, kind):
    """Each collective's output and the gradient of a weighted sum of
    it, the backward being the transposed collective: exact."""
    x = np.random.RandomState(5).randn(16, 4).astype(np.float32)
    got = world.run("collective", kind, x, {"dp": 4}, ("dp",))
    out, grad = _jax_collective(kind, x, 4)
    for o, g in got:
        np.testing.assert_allclose(o, out, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, grad, rtol=1e-6, atol=1e-6)


def test_allmax_and_its_gradient(world):
    x = np.random.RandomState(6).randn(16).astype(np.float32)
    got = world.run("collective", "allmax", x, {"dp": 4}, ("dp",))
    blocks = x.reshape(4, 4)
    want = np.tile(blocks.max(0), 4)
    w = np.linspace(-1, 1, 16, dtype=np.float32)
    grad = np.zeros(16, np.float32)
    for j in range(4):
        i = blocks[:, j].argmax()
        grad[i * 4 + j] = w.reshape(4, 4)[:, j].sum()
    for o, g in got:
        np.testing.assert_array_equal(o, want)
        np.testing.assert_allclose(g, grad, rtol=1e-6, atol=1e-6)


# -- ring attention ---------------------------------------------------------------

def _full_attention(q, k, v, causal):
    s = q.shape[-1] ** -0.5
    logits = np.einsum("bhqd,bhkd->bhqk", q * s, k).astype(np.float64)
    if causal:
        T = q.shape[2]
        logits = np.where(np.tril(np.ones((T, T), bool))[None, None],
                          logits, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_full(world, causal):
    rng = np.random.RandomState(0)
    B, H, T, D = 2, 3, 32, 8
    q, k, v = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    got = world.run("ring", q, k, v, {"sp": 4}, causal)
    jout = np.asarray(jpar.ring_attention(q, k, v, _jmesh({"sp": 4}),
                                          seq_axis="sp", causal=causal))
    ref = _full_attention(q, k, v, causal)
    for out in got:
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out, jout, rtol=2e-5, atol=2e-5)


def _full_attention_grads(q, k, v, causal):
    """Gradients of sum(full attention) by hand, in float64."""
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    s = q.shape[-1] ** -0.5
    lg = np.einsum("bhqd,bhkd->bhqk", q * s, k)
    if causal:
        T = q.shape[2]
        lg = np.where(np.tril(np.ones((T, T), bool))[None, None], lg, -1e30)
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    do = np.ones(q.shape[:3] + (v.shape[-1],))
    dv = np.einsum("bhqk,bhqd->bhkd", p, do)
    dp = np.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True))
    dq = np.einsum("bhqk,bhkd->bhqd", ds, k) * s
    dk = np.einsum("bhqk,bhqd->bhkd", ds, q) * s
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_grad_matches_full(world, causal):
    """The ring backward (dk, dv sent round the ring) against full
    attention's gradients (the JAX test's oracle)."""
    rng = np.random.RandomState(1)
    B, H, T, D = 1, 2, 16, 4
    q, k, v = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    got = world.run("ring", q, k, v, {"sp": 4}, causal, grad=True)
    want = _full_attention_grads(q, k, v, causal)
    for out, gq, gk, gv in got:
        for g, gf in zip((gq, gk, gv), want):
            np.testing.assert_allclose(g, gf, rtol=1e-4, atol=1e-4)


def test_ring_attention_over_dp_and_sp(world):
    """q/k/v cut over both dp (batch) and sp (sequence)."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(4, 2, 16, 8).astype(np.float32) for _ in range(3))
    got = world.run("ring", q, k, v, {"dp": 2, "sp": 2}, True)
    ref = _full_attention(q, k, v, True)
    for out in got:
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


# -- pipeline -----------------------------------------------------------------------

def test_pipeline_matches_sequential(world):
    n_stage, n_micro, mb, dim = 4, 8, 2, 16
    rng = np.random.RandomState(2)
    ws = (rng.randn(n_stage, dim, dim) / np.sqrt(dim)).astype(np.float32)
    xs = rng.randn(n_micro, mb, dim).astype(np.float32)
    got = world.run("pipeline", ws, xs, {"pp": 4})
    jout = np.asarray(jpar.pipeline_step(
        lambda w, x: __import__("jax").numpy.tanh(x @ w), ws, xs,
        _jmesh({"pp": 4})))
    ref = xs
    for i in range(n_stage):
        ref = np.tanh(ref @ ws[i])
    for out in got:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)


def test_pipeline_differentiable(world):
    """A {"pp": 2} mesh on ranks 0, 1 (ranks 2, 3 outside it): the
    schedule's gradient against the sequential loop's (the JAX test's
    oracle), by hand in float64."""
    n_stage, n_micro, mb, dim = 2, 4, 2, 8
    rng = np.random.RandomState(4)
    ws = (rng.randn(n_stage, dim, dim) / 3).astype(np.float32)
    xs = rng.randn(n_micro, mb, dim).astype(np.float32)
    got = world.run("pipeline", ws, xs, {"pp": 2}, grad=True)
    ys = [xs.astype(np.float64)]
    for i in range(n_stage):
        ys.append(np.tanh(ys[-1] @ ws[i]))
    dy = np.ones_like(ys[-1])
    gr = np.zeros(ws.shape)
    for i in reversed(range(n_stage)):
        dz = dy * (1 - ys[i + 1] ** 2)
        gr[i] = np.einsum("nbi,nbo->io", ys[i], dz)
        dy = dz @ ws[i].T
    assert got[2] is None and got[3] is None
    for out, g in got[:2]:
        np.testing.assert_allclose(out, ys[-1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, gr, rtol=1e-4, atol=1e-5)


def test_bubble_fraction():
    for pp, n in ((1, 4), (2, 4), (4, 8), (3, 1)):
        assert par.bubble_fraction(pp, n) == jpar.bubble_fraction(pp, n)


# -- MoE ---------------------------------------------------------------------------

_MOE = {}


def _jax_moe(capacity):
    """The JAX layer's parameters, tokens, and its output, aux loss and
    gradients of sum(out^2) / tokens + aux (one device: the mesh only
    adds sharding constraints there)."""
    if capacity not in _MOE:
        import jax
        import jax.numpy as jnp
        from incubator_mxnet_tpu.parallel.moe import moe_apply
        layer = jpar.MoELayer(dim=8, hidden=16, num_experts=4,
                              capacity=capacity)
        params = {k: np.asarray(v) for k, v in layer.params.items()}
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (4, 16, 8)))

        def loss(p, xx):
            out, aux = moe_apply(xx, p["gate_w"], p["w_in"], p["w_out"],
                                 capacity=capacity)
            return (out ** 2).sum() / (4 * 16) + aux, (out, aux)
        (_, (out, aux)), (g, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
        _MOE[capacity] = (params, x, np.asarray(out), float(aux),
                          {k: np.asarray(v) for k, v in g.items()},
                          np.asarray(gx))
    return _MOE[capacity]


@pytest.mark.parametrize("axes", [{"dp": 2, "ep": 2}, {"ep": 4}])
def test_moe_matches_jax(world, axes):
    """Top-1 routing with the experts over 'ep' and tokens sent by
    all-to-all, at a capacity that drops tokens: the output, the aux
    loss and the gradients of sum(out^2) / tokens + aux against the JAX
    `moe_apply`."""
    params, x, jout, jaux, jg, jgx = _jax_moe(3)
    got = world.run("moe", params, x, axes, 3)
    for r in got:
        rows = slice(r["rows"], r["rows"] + 1)
        e = 4 // axes["ep"]
        ex = slice(r["experts"] * e, (r["experts"] + 1) * e)
        np.testing.assert_allclose(r["out"], jout[rows], rtol=1e-4,
                                   atol=1e-5)
        assert r["aux"] == pytest.approx(jaux, rel=1e-5)
        np.testing.assert_allclose(r["x_grad"], jgx[rows], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["gate_w"], jg["gate_w"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["w_in"], jg["w_in"][ex], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["w_out"], jg["w_out"][ex], rtol=1e-4,
                                   atol=1e-5)


def test_moe_routes_all_tokens_when_capacity_allows():
    """One device: every token goes to its argmax expert (the JAX
    test's dense oracle)."""
    layer = par.MoELayer(dim=8, hidden=16, num_experts=4, capacity=64)
    x = np.random.RandomState(6).randn(4, 16, 8).astype(np.float32)
    import torch
    out, aux = layer(torch.tensor(x))
    p = {k: v.numpy() for k, v in layer.params.items()}
    lg = np.einsum("bsm,me->bse", x, p["gate_w"])
    probs = np.exp(lg - lg.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    eidx, gate = probs.argmax(-1), probs.max(-1)
    ref = np.zeros_like(x)
    for e in range(4):
        h = np.maximum(np.einsum("bsm,mf->bsf", x, p["w_in"][e]), 0)
        y = np.einsum("bsf,fm->bsm", h, p["w_out"][e])
        ref += np.where((eidx == e)[..., None], y * gate[..., None], 0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
    assert float(aux) > 0


# -- rules -----------------------------------------------------------------------

def _spec_meshes(axes):
    import torch
    return par.Mesh(torch.device("cpu"), axes), _jmesh(axes) \
        if int(np.prod(list(axes.values()))) <= 8 else None


@pytest.mark.parametrize("rules,name,shape", [
    ("MEGATRON_RULES", "bert0_ffn_1_weight", (64, 16)),
    ("MEGATRON_RULES", "bert0_ffn_2_weight", (16, 64)),
    ("MEGATRON_RULES", "x_ffn_1_weight", (6, 16)),
    ("MEGATRON_RULES", "plain_weight", (8, 8)),
    ("MEGATRON_RULES", "enc_qkv_weight", (96, 32)),
    ("MEGATRON_RULES", "enc_qkv_bias", (96,)),
    ("MEGATRON_RULES", "word_embedding_weight", (100, 8)),
    ("TRANSFORMER_RULES", "stack_pipe_weight", (2, 16, 16)),
    ("TRANSFORMER_RULES", "stack_pipe_bias", (2, 16)),
    ("TRANSFORMER_RULES", "b_ffn_1_weight", (64, 16)),
    ("TRANSFORMER_RULES", "stack_pipe_weight", (3, 16, 16))])
def test_rules_match_jax(rules, name, shape):
    for axes in ({"dp": 2, "tp": 4}, {"dp": 2, "pp": 2, "tp": 2}):
        tm, jm = _spec_meshes(axes)
        got = getattr(par, rules).spec_for(name, shape, tm)
        want = getattr(jpar, rules).spec_for(name, shape, jm)
        assert tuple(got) == tuple(want), (axes, got, want)


def test_shard_params_shape_fitting_falls_back():
    """Rules whose axis does not divide a dim keep it whole."""
    import torch
    tm = par.Mesh(torch.device("cpu"), {"dp": 2, "tp": 4})
    rules = par.ParamRules([(r"w", ("tp", None))])
    placed = par.shard_params(
        {"w_even": torch.arange(32.).reshape(8, 4),
         "w_odd": torch.zeros(6, 4), "w_small": torch.zeros(2, 2)},
        tm, rules=rules)
    assert tuple(placed["w_even"].shape) == (2, 4)
    np.testing.assert_array_equal(placed["w_even"].numpy(),
                                  np.arange(8.).reshape(2, 4))
    assert tuple(placed["w_odd"].shape) == (6, 4)
    assert tuple(placed["w_small"].shape) == (2, 2)


def test_shard_params_qkv_head_aligned():
    """A fused q | k | v cut over tp: rank r holds q_r ; k_r ; v_r."""
    import torch
    U, tp = 8, 2
    w = torch.arange(3 * U * 2, dtype=torch.float32).reshape(3 * U, 2)
    for r in range(tp):
        m = par.Mesh(torch.device("cpu"), {"tp": tp})
        m.coords = {"tp": r}
        got = par.shard_params({"l0_qkv_weight": w}, m,
                               rules=par.MEGATRON_RULES)["l0_qkv_weight"]
        c = U // tp
        want = torch.cat([w[j * U + r * c: j * U + (r + 1) * c]
                          for j in range(3)])
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_zero_state_spec_rules():
    """kvstore_zero's gate: the largest unsharded divisible dim; tp dims
    respected; unchanged when nothing divides or the axis is trivial."""
    from incubator_mxnet_torch.parallel.sharding import (zero_state_spec,
                                                         PartitionSpec as P)
    from incubator_mxnet_tpu.parallel.sharding import zero_state_spec as jz
    from jax.sharding import PartitionSpec as JP
    import torch

    class FakeMesh:
        axis_names = ("dp", "tp")
        shape = {"dp": 2, "tp": 2}
    m1 = par.Mesh(torch.device("cpu"))
    assert zero_state_spec(P(None, None), (4, 4), m1) == P(None, None)
    for spec, shape in (((None, None), (4, 8)), (("tp", None), (4, 8)),
                        ((None,), (7,)), (("dp", None), (4, 8)),
                        ((None, None, None), (6, 8, 8))):
        got = zero_state_spec(P(*spec), shape, FakeMesh())
        assert tuple(got) == tuple(jz(JP(*spec), shape, FakeMesh()))


def test_zero_mode_parsing(monkeypatch):
    from incubator_mxnet_torch.kvstore import zero as tz
    from incubator_mxnet_tpu.kvstore import zero as jz
    for raw in ("0", "1", "2", "3", "true", "no", "garbage"):
        monkeypatch.setenv("MXNET_KV_ZERO", raw)
        assert tz.mode() == jz.mode(), raw
        assert tz.enabled() == jz.enabled()
        assert tz.reduce_scatter() == jz.reduce_scatter()


# -- the attention op under the scope ------------------------------------------------

def test_sequence_parallel_scope_routes_ring(world):
    """`multi_head_attention` under `sequence_parallel_scope` on each
    rank's (batch, sequence) block equals the JAX op under its scope and
    the dense op; outside the scope the dense path is back."""
    from incubator_mxnet_tpu import nd as jnd
    from incubator_mxnet_tpu.ops.registry import apply_op
    rng = np.random.RandomState(3)
    q = rng.randn(2, 16, 32).astype(np.float32)
    got = world.run("mha_scope", q, {"dp": 2, "sp": 2})
    jm = _jmesh({"dp": 2, "sp": 2})
    ref = apply_op("multi_head_attention", jnd.array(q), jnd.array(q),
                   jnd.array(q), num_heads=4, causal=True).asnumpy()
    with jpar.sequence_parallel_scope(jm, "sp", "dp"):
        jout = apply_op("multi_head_attention", jnd.array(q), jnd.array(q),
                        jnd.array(q), num_heads=4, causal=True).asnumpy()
    for r in got:
        np.testing.assert_allclose(r["ring"], jout, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["ring"], ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["after"], ref, rtol=1e-6, atol=1e-6)
        assert "dropout" in r["dropout_error"]
        assert "kv_length" in r["mask_error"]


def test_attention_dropout_applied_in_train_mode():
    from incubator_mxnet_torch import nd, autograd
    from incubator_mxnet_torch.ops.attention import multi_head_attention
    rng = np.random.RandomState(4)
    with mx.cpu():
        q = nd.array(rng.randn(2, 8, 16).astype(np.float32))
        base = multi_head_attention(q.data, q.data, q.data, num_heads=2)
        with autograd.record(train_mode=True):
            dropped = multi_head_attention(q.data, q.data, q.data,
                                           num_heads=2, dropout=0.5)
    assert not np.allclose(base.numpy(), dropped.detach().numpy())
