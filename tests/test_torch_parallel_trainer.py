"""`ParallelTrainer` over a world of 4 real ranks (a gloo group of 4
spawned processes, one for the file, each case sent to every rank)
against the JAX package's trainer on the forced CPU mesh of the same
shape (its first 4 devices): the trainer cases of
`tests/test_parallel.py`, the trainer's ZeRO cases of
`tests/test_kvstore_zero.py`, a 2-layer BERT over dp2 x tp2 and dp2 x
sp2, and a checkpoint crossing between a 4-rank port trainer and the
JAX package.

Inputs and weights are made with numpy from seeds (the JAX weights go
into the port through `convert.params_from_jax`).  Tolerances, float32:

- byte counts, ZeRO-1 against plain dp, run_steps against steps,
  checkpoints both ways: exact;
- trainers against the JAX trainer (the sums over ranks and the tp
  partial sums add in another order than XLA's): losses rtol 2e-4,
  atol 1e-5 (BERT: 1e-5); weights after Adam or SGD rtol 2e-4, atol
  2e-5 (the JAX test's single-device tolerance); ZeRO-2's
  reduce-scatter against the all-reduce: rtol 1e-6 on the losses, atol
  1e-6 on the weights (measured: equal bits on this world).
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


def _weights(net):
    return {k: np.asarray(v.data().asnumpy())
            for k, v in net._collect_params_with_prefix().items()}


def _cpu_mesh():
    return par.default_mesh(ctx=mx.cpu())


# -- trainers -------------------------------------------------------------------------

def _softmax_ce(out, label):
    return mxj.gluon.loss.SoftmaxCrossEntropyLoss()(out, label)


def _jmlp(hidden=32, classes=10):
    net = mxj.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mxj.gluon.nn.Dense(hidden, activation="relu",
                                   prefix="ffn_1_"))
        net.add(mxj.gluon.nn.Dense(classes, prefix="ffn_2_"))
    return net


def _jax_train(net, batch, steps, mesh, run_steps=False, **kw):
    from incubator_mxnet_tpu import nd as jnd
    tr = jpar.ParallelTrainer(net, _softmax_ce, mesh=mesh, **kw)
    arrays = [jnd.array(a) for a in batch]
    if run_steps:
        losses = [float(tr.run_steps(steps, *arrays).asnumpy())]
    else:
        losses = [float(tr.step(*arrays).asnumpy()) for _ in range(steps)]
    return losses, [np.asarray(p.data().asnumpy(), np.float32)
                    for p in tr.params], tr


def _mlp_case(hidden=16, seed=1):
    from incubator_mxnet_tpu import nd as jnd
    rng = np.random.RandomState(seed)
    xs = rng.randn(16, 12).astype(np.float32)
    ys = rng.randint(0, 10, (16,)).astype(np.float32)
    mxj.random.seed(seed)
    net = _jmlp(hidden=hidden)
    net.initialize()
    net(jnd.array(xs))
    return net, _weights(net), (xs, ys)


def _assert_trajectory(got, losses, params, rtol=2e-4, atol=1e-5):
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, rtol=rtol, atol=atol)
        for a, b in zip(r["params"], params):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_parallel_trainer_dp_matches_jax(world):
    """dp = 4 against the JAX trainer on a 4-device dp mesh (SGD, 3
    steps), and the loss falls."""
    net, w, batch = _mlp_case()
    losses, params, _ = _jax_train(net, batch, 3, _jmesh({"dp": 4}),
                                   optimizer="sgd",
                                   optimizer_params={"learning_rate": 0.1})
    got = world.run("train", "mlp", w, batch, 3,
                    {"optimizer": "sgd",
                     "optimizer_params": {"learning_rate": 0.1}},
                    {"hidden": 16}, axes={"dp": 4})
    _assert_trajectory(got, losses, params)
    assert got[0]["losses"][-1] < got[0]["losses"][0]


def test_parallel_trainer_tensor_parallel(world):
    """dp2 x tp2 with MEGATRON_RULES and Adam against the JAX trainer on
    the same mesh; the weights really are cut over tp."""
    net, w, batch = _mlp_case(hidden=32, seed=2)
    opt = {"learning_rate": 0.01}
    losses, params, _ = _jax_train(net, batch, 4, _jmesh({"dp": 2, "tp": 2}),
                                   optimizer="adam", optimizer_params=opt,
                                   rules=jpar.MEGATRON_RULES)
    got = world.run("train", "mlp", w, batch, 4,
                    {"optimizer": "adam", "optimizer_params": opt,
                     "rules": par.MEGATRON_RULES}, {"hidden": 32},
                    axes={"dp": 2, "tp": 2})
    _assert_trajectory(got, losses, params)
    assert got[0]["losses"][-1] < got[0]["losses"][0]
    spec, shape = got[0]["specs"]["ffn_1_weight"]
    assert spec[0] == "tp" and shape == (16, 12)


def _pipe_case(seed, n_stage=2):
    rng = np.random.RandomState(3)
    xs = rng.randn(16, 20).astype(np.float32)
    ys = rng.randint(0, 10, (16,)).astype(np.float32)
    mxj.seed(seed)
    net = mxj.test_utils.pipeline_mlp(n_stage=n_stage)
    return net, _weights(net), (xs, ys)


_DP_ONLY = {}


def _dp_only(seed, n_stage=2, steps=5):
    key = (seed, n_stage, steps)
    if key not in _DP_ONLY:
        net, w, batch = _pipe_case(seed, n_stage)
        losses, params, _ = _jax_train(
            net, batch, steps, _jmesh({"dp": 4}), optimizer="sgd",
            optimizer_params={"learning_rate": 0.2})
        _DP_ONLY[key] = (w, batch, losses, params)
    return _DP_ONLY[key]


@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 1, 2), (1, 2, 2)])
def test_parallel_trainer_multi_axis_matches_dp_only(world, shape):
    """The multi-axis acceptance gate: a dp x tp x pp port trainer tracks
    the JAX dp-only trainer's trajectory, with the parameters cut over
    the model axes."""
    w, batch, losses, params = _dp_only(11)
    got = world.run("train", "pipe", w, batch, 5,
                    {"optimizer": "sgd",
                     "optimizer_params": {"learning_rate": 0.2},
                     "mesh_shape": shape, "n_micro": 4})
    _assert_trajectory(got, losses, params)
    dp, tp, pp = shape
    r = got[0]
    assert r["mesh"] == {"dp": dp, "pp": pp, "tp": tp}
    assert r["pp_active"] == (pp > 1)
    tot, dev = r["param_bytes"]
    assert tot == sum(p.size * 4 for p in params)
    if tp * pp > 1:
        assert dev < tot
    spec, local = r["specs"]["stack_pipe_weight"]
    assert int(np.prod(local)) == 2 * 16 * 16 // (tp * pp)


def test_gpipe_stack_multi_layer_per_stage(world):
    """n_stage a multiple of pp: each pp rank applies its k layers."""
    w, batch, losses, params = _dp_only(14, n_stage=4, steps=4)
    got = world.run("train", "pipe", w, batch, 4,
                    {"optimizer": "sgd",
                     "optimizer_params": {"learning_rate": 0.2},
                     "mesh_shape": (2, 1, 2), "n_micro": 4},
                    {"n_stage": 4})
    _assert_trajectory(got, losses, params)


def test_pp_mesh_with_unstaged_rules_runs_sequential_oracle(world):
    """A pp mesh whose rules leave the stage unstaged (MEGATRON_RULES)
    runs the sequential path: no pipeline, no bubble, no pp.stage."""
    w, batch, losses, params = _dp_only(11)
    got = world.run("train", "pipe", w, batch, 5,
                    {"optimizer": "sgd",
                     "optimizer_params": {"learning_rate": 0.2},
                     "mesh_shape": (2, 1, 2), "n_micro": 4,
                     "rules": par.MEGATRON_RULES}, tracing_on=True)
    _assert_trajectory(got, losses, params)
    r = got[0]
    assert r["pp_active"] is False and r["report"]["pp"] is None
    assert r["rec"]["buckets"]["pp_bubble"] == 0.0
    assert r["stages"] == []
    assert "pp" not in str(r["specs"]["stack_pipe_weight"][0])


def test_parallel_trainer_run_steps_equals_steps(world):
    """run_steps(3) over dp x tp x pp is the 3 steps, bit for bit."""
    w, batch, _, _ = _dp_only(12)
    kw = {"optimizer": "adam", "optimizer_params": {"learning_rate": 0.1},
          "mesh_shape": (1, 2, 2)}
    a = world.run("train", "pipe", w, batch, 3, kw)
    b = world.run("train", "pipe", w, batch, 3, kw, run_steps=True)
    for ra, rb in zip(a, b):
        assert ra["losses"][-1] == rb["losses"][-1]
        for x, y in zip(ra["params"], rb["params"]):
            np.testing.assert_array_equal(x, y)


def test_parallel_trainer_env_mesh_shape_and_microbatch(world):
    w, batch, _, _ = _dp_only(11)
    got = world.run("train", "pipe", w, batch, 4,
                    {"optimizer": "sgd"},
                    env={"MXNET_MESH_SHAPE": "dp2,pp2",
                         "MXNET_PP_MICROBATCH": "2"})
    r = got[0]
    assert r["mesh"] == {"dp": 2, "pp": 2, "tp": 1}
    assert r["n_micro"] == 2 and r["pp_axis"] == "pp" and r["tp_axis"] is None
    assert r["losses"][-1] < r["losses"][0]


def test_multi_axis_zero1_state_shards_over_all_axes(world):
    """ZeRO-1 over dp on a dp x pp mesh: the stage weight's state is cut
    over pp and dp, the trajectory bit for bit the replicated state's."""
    w, batch, _, _ = _dp_only(13)
    kw = {"optimizer": "sgd", "optimizer_params": {"learning_rate": 0.2,
                                                   "momentum": 0.9},
          "mesh_shape": (2, 1, 2)}
    z = world.run("train", "pipe", w, batch, 3, dict(kw, zero=1))
    r = world.run("train", "pipe", w, batch, 3, dict(kw, zero=0))
    for a, b in zip(z, r):
        assert a["losses"] == b["losses"]
        for x, y in zip(a["params"], b["params"]):
            np.testing.assert_array_equal(x, y)
    # the stage weight is the third parameter, its state the third
    assert int(np.prod(z[0]["state_shapes"][2])) == 2 * 16 * 16 // 4
    assert int(np.prod(r[0]["state_shapes"][2])) == 2 * 16 * 16 // 2
    assert z[0]["state_bytes"][1] < r[0]["state_bytes"][1]
    assert z[0]["zero_level"] == 1


@pytest.mark.parametrize("level", [1, 2])
def test_parallel_zero_state_sharded_dp(world, level):
    """kvstore_zero's SPMD gates on 4 dp ranks: ZeRO-1 bit for bit the
    replicated state, ZeRO-2's reduce-scatter within 1e-6 of the
    all-reduce (measured: equal here), state bytes a quarter a rank."""
    net, w, batch = _mlp_case(hidden=16, seed=4)
    kw = {"optimizer": "adam", "optimizer_params": {"learning_rate": 0.01}}
    base = world.run("train", "mlp", w, batch, 4, dict(kw, zero=0),
                     {"hidden": 16}, axes={"dp": 4})
    got = world.run("train", "mlp", w, batch, 4, dict(kw, zero=level),
                    {"hidden": 16}, axes={"dp": 4})
    for a, b in zip(got, base):
        if level == 1:
            assert a["losses"] == b["losses"]
            for x, y in zip(a["params"], b["params"]):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)
            for x, y in zip(a["params"], b["params"]):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    tot, dev = got[0]["state_bytes"]
    assert base[0]["state_bytes"] == (tot, tot)
    assert dev * 4 <= tot + 4 * 128
    assert got[0]["report"]["zero_level"] == level


def test_pp_bubble_in_goodput_ledger(world):
    w, batch, _, _ = _dp_only(11)
    got = world.run("train", "pipe", w, batch, 2,
                    {"optimizer": "sgd", "mesh_shape": (2, 1, 2),
                     "n_micro": 4}, tracing_on=True)
    r = got[0]
    assert r["rec"] is not None and not r["rec"]["untraced"]
    b = r["rec"]["buckets"]
    assert b["pp_bubble"] > 0
    frac = b["pp_bubble"] / (b["pp_bubble"] + b["compute"])
    assert abs(frac - jpar.bubble_fraction(2, 4)) < 1e-6
    assert len(r["stages"]) >= 2
    assert all(a.get("synthetic") for a in r["stages"])


def test_parallel_trainer_statusz_mesh_report(world):
    w, batch, _, _ = _dp_only(11)
    got = world.run("statusz", w, batch)
    for sec in got:
        assert sec["mesh"] == {"dp": 1, "pp": 2, "tp": 2}
        assert sec["pp"]["n_micro"] == 4
        assert sec["pp"]["bubble_fraction"] == pytest.approx(0.2)
        assert sec["param_bytes"]["max_per_device"] < \
            sec["param_bytes"]["total"]
        assert sec["zero_level"] == 0 and sec["steps"] == 1


def test_gpipe_stack_batch_divisibility_error(world):
    w, batch, _, _ = _dp_only(11)
    msgs = world.run("train_error", "pipe", w, batch,
                     {"optimizer": "sgd", "mesh_shape": (2, 1, 2),
                      "n_micro": 3})
    assert all("n_micro" in m for m in msgs)


def test_parallel_trainer_membership_is_fixed_spmd_fleet(world):
    from incubator_mxnet_torch.kvstore import MembershipInfo
    w, batch, _, _ = _dp_only(11)
    got = world.run("train", "pipe", w, batch, 1, {"optimizer": "sgd"},
                    axes={"dp": 4}, gather=False)
    for r, res in enumerate(got):
        assert res["membership"] == (False, 0, 4, r)
    with mx.cpu():
        net = mx.test_utils.pipeline_mlp()
        tr = par.ParallelTrainer(net, lambda o, y: o, mesh=_cpu_mesh())
    assert tr.membership == MembershipInfo(False, 0, 1, 0)


def test_place_batch_reads_current_contents():
    """A re-filled numpy buffer is read anew at each placement."""
    with mx.cpu():
        net = mx.test_utils.pipeline_mlp()
        tr = par.ParallelTrainer(net, lambda o, y: o, mesh=_cpu_mesh())
    buf = np.zeros((4, 20), np.float32)
    buf[:] = 7.0
    assert float(tr._place(buf).data.max()) == 7.0
    buf[:] = 9.0
    assert float(tr._place(buf).data.max()) == 9.0


# -- BERT over the mesh, and its checkpoint ----------------------------------------

_BERT = {"model": "bert_tiny", "vocab": 100, "max_length": 32}


def _bert_case():
    from incubator_mxnet_tpu import nd as jnd
    from incubator_mxnet_tpu.models.bert import get_bert_model, \
        BERTClassifier
    rng = np.random.RandomState(0)
    tok = rng.randint(0, 100, (4, 16)).astype(np.float32)
    typ = np.zeros((4, 16), np.float32)
    y = rng.randint(0, 2, 4).astype(np.float32)
    mxj.random.seed(0)
    bert = get_bert_model("bert_tiny", vocab_size=100, max_length=32,
                          dropout=0.0)
    net = BERTClassifier(bert, num_classes=2, dropout=0.0)
    net.initialize(mxj.init.Normal(0.02))
    net(jnd.array(tok), jnd.array(typ))
    return net, _weights(net), (tok, typ, y)


@pytest.mark.parametrize("axes,extra", [
    ({"dp": 2, "tp": 2}, {"rules": "MEGATRON_RULES"}),
    ({"dp": 2, "sp": 2}, {"seq_axis": "sp"})])
def test_bert_step_matches_jax(world, axes, extra):
    """A 2-layer BERT (float32, Adam) over dp2 x tp2 (head-aligned qkv,
    vocab-parallel embeddings) and dp2 x sp2 (ring attention, chunked
    positions) against the JAX trainer on the same mesh."""
    net, w, batch = _bert_case()
    opt = {"learning_rate": 1e-3}
    jkw = {k: getattr(jpar, v) if k == "rules" else v
           for k, v in extra.items()}
    tkw = {k: getattr(par, v) if k == "rules" else v
           for k, v in extra.items()}
    losses, params, _ = _jax_train(net, batch, 3, _jmesh(axes),
                                   optimizer="adam", optimizer_params=opt,
                                   **jkw)
    got = world.run("train", "bert", w, batch, 3,
                    dict({"optimizer": "adam", "optimizer_params": opt},
                         **tkw), _BERT, axes=axes)
    _assert_trajectory(got, losses, params, rtol=1e-5, atol=1e-5)


def test_checkpoint_crosses_between_4_ranks_and_jax(world, tmp_path):
    """A checkpoint of the port's dp2 x tp2 ZeRO-1 trainer (4 shard
    files) loads into the JAX trainer, which trains a step on and saves;
    that loads back into the 4 ranks: bitwise both ways."""
    from incubator_mxnet_tpu import nd as jnd
    net, w, batch = _bert_case()
    opt = {"learning_rate": 1e-3}
    d1, d2 = str(tmp_path / "port"), str(tmp_path / "jax")
    got = world.run("train", "bert", w, batch, 2,
                    {"optimizer": "adam", "optimizer_params": opt,
                     "rules": par.MEGATRON_RULES, "zero": 1}, _BERT,
                    axes={"dp": 2, "tp": 2}, checkpoint=d1)
    assert sorted(f for f in os.listdir(d1) if f.endswith(".npz")) == \
        [f"shards-{r:05d}.npz" for r in range(4)]
    jtr = jpar.ParallelTrainer(net, _softmax_ce, optimizer="adam",
                               optimizer_params=opt,
                               mesh=_jmesh({"dp": 2, "tp": 2}),
                               rules=jpar.MEGATRON_RULES)
    arrays = [jnd.array(a) for a in batch]
    jtr._ensure_ready(arrays[:-1])
    man = jtr.load_checkpoint(d1)
    assert man["step"] == 2 and man["process_count"] == 4
    for p, want in zip(jtr.params, got[0]["params"]):
        np.testing.assert_array_equal(np.asarray(p.data().asnumpy()), want)
    jtr.step(*arrays)
    jtr.save_checkpoint(d2)
    jparams = [np.asarray(p.data().asnumpy()) for p in jtr.params]
    back = world.run("load_into", "bert", w, batch,
                     {"optimizer": "adam", "optimizer_params": opt,
                      "rules": par.MEGATRON_RULES, "zero": 1,
                      "mesh_shape": {"dp": 2, "tp": 2}}, _BERT, d2, 1)
    for r in back:
        assert r["step"] == 3
        for a, b in zip(r["before"], jparams):
            np.testing.assert_array_equal(a, b)


def test_replica_digests_and_mesh_scope(world):
    """`health.replica_digests` over dp2 x tp2: one digest a dp
    replica, equal while the replicas agree, apart once a weight of one
    replica moves (the JAX package's audit); the trainer takes the
    `mesh_scope` mesh; the goodput ledger counts the mesh's devices."""
    got = world.run("replica_audit", {"dp": 2, "tp": 2})
    for r in got:
        assert sorted(r["same"]) == [0, 1]
        assert r["same"][0] == r["same"][1]
        assert r["diff"][0] != r["diff"][1]
        assert r["scoped"] and r["device_count"] == 4
    dp_only = world.run("replica_audit", {"dp": 4})
    assert all(r["none"] is None for r in dp_only)
