"""The port's gradient buckets and ZeRO placement against the JAX
package.

Mirrors `tests/test_kvstore_bucket.py` case for case and
`tests/test_kvstore_zero.py` but for the live fleet-rebalancing cases
(ROADMAP item 10b) and the device-mesh cases `test_torch_parallel*.py`
already mirror.  Bucket plans and their wire keys are compared with the
JAX package's for the same items; trainers start from the JAX net's
weights (`convert.params_from_jax`).  Tolerances:

- bucketed against per-key, streamed against plain, ZeRO against
  unsharded, the flat server update against the per-key one: bit for bit
  (the same adds and updates in the same order);
- a port trainer against the JAX trainer, 4 steps from the same
  weights on servers of their own: rtol 1e-6, atol 1e-7 (the same
  float32 updates).
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.kvstore import bucket as jbucket
from incubator_mxnet_tpu.kvstore import zero as jzero

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd, optimizer as opt
from incubator_mxnet_torch.base import MXNetError
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.kvstore import dist as tdist
from incubator_mxnet_torch.kvstore import zero as kvzero
from incubator_mxnet_torch.kvstore.bucket import (
    GradientBucketer, build_plan, bucket_target_bytes)

from _torch_kv_cases import (free_ports, make_kv, run_ranks, run_workers,
                             start_servers, stop)

OPT_TOL = dict(rtol=1e-6, atol=1e-7)


def _a(x, dtype=None):
    x = np.asarray(x)
    return nd.NDArray(torch.from_numpy(np.array(x, copy=True)).to(
        getattr(torch, dtype) if dtype else None))


# ---------------------------------------------------------------------
# plans (the same as the JAX package's)
# ---------------------------------------------------------------------

def test_plan_deterministic_and_size_targeted():
    items = [(i, (100, 100), "float32") for i in range(10)]
    p1 = build_plan(items, target_bytes=100 * 1024)
    p2 = build_plan(items, target_bytes=100 * 1024)
    ref = jbucket.build_plan(items, target_bytes=100 * 1024)
    assert [b.wire_key for b in p1] == [b.wire_key for b in p2] \
        == [b.wire_key for b in ref]
    assert [b.indices for b in p1] == [b.indices for b in ref]
    assert all(len(b.keys) <= 2 for b in p1)
    assert sum(len(b.keys) for b in p1) == 10
    for b in p1:
        assert b.size == sum(b.numels)


@pytest.mark.parametrize("bf16", [False, True])
def test_plan_groups_by_dtype_and_isolates_oversize(bf16):
    """The JAX plan's layout and digest, a bfloat16 group included (its
    itemsize 2, as the JAX package resolves it)."""
    half = "bfloat16" if bf16 else "float16"
    items = [(0, (8,), "float32"), (1, (1 << 21,), "float32"),
             (2, (8,), half), (3, (4,), "float32")]
    plan = build_plan(items, target_bytes=4 * 1024 * 1024)
    ref = jbucket.build_plan(items, target_bytes=4 * 1024 * 1024)
    assert [(b.wire_key, b.indices, b.nbytes) for b in plan] == \
        [(b.wire_key, b.indices, b.nbytes) for b in ref]
    assert len(plan) == 4 and {b.dtype for b in plan} == {"float32", half}
    solo = [b for b in plan if b.indices == (1,)]
    assert len(solo) == 1 and solo[0].nbytes > 4 * 1024 * 1024
    other = build_plan(items[:-1], target_bytes=4 * 1024 * 1024)
    assert {b.wire_key for b in other}.isdisjoint({b.wire_key
                                                   for b in plan})
    # a torch dtype names the same plan
    tplan = build_plan([(k, s, getattr(torch, d)) for k, s, d in items],
                       target_bytes=4 * 1024 * 1024)
    assert [b.wire_key for b in tplan] == [b.wire_key for b in plan]


def test_bucket_target_env(monkeypatch):
    monkeypatch.setenv("MXNET_KV_BUCKET_KB", "128")
    assert bucket_target_bytes() == 128 * 1024 \
        == jbucket.bucket_target_bytes()
    monkeypatch.setenv("MXNET_KV_BUCKET_KB", "0")
    assert bucket_target_bytes() == 0


def _rand_set(seed=0):
    rng = np.random.RandomState(seed)
    shapes = [((5, 3), np.float32), ((700,), np.float32),
              ((7,), np.float32), ((6, 2), np.float16)]
    return [rng.randn(*sh).astype(dt) for sh, dt in shapes], shapes


@pytest.mark.parametrize("compression", [None, {"type": "2bit",
                                                "threshold": 0.5}])
def test_local_bucketed_matches_perkey(compression):
    grads, shapes = _rand_set()
    per_dev = [[_a(g * (d + 1)) for d in range(3)] for g in grads]
    kv_pk = mx.kvstore.create("local")
    if compression:
        kv_pk.set_gradient_compression(compression)
    ref = []
    for i, (sh, dt) in enumerate(shapes):
        kv_pk.init(i, _a(np.zeros(sh, dt)))
        kv_pk.push(i, per_dev[i])
        out = _a(np.zeros(sh, dt))
        kv_pk.pull(i, out=out)
        ref.append(out.asnumpy())
    kv_bk = mx.kvstore.create("local")
    if compression:
        kv_bk.set_gradient_compression(compression)
    items = [(i, sh, dt.__name__) for i, (sh, dt) in enumerate(shapes)]
    bucketer = GradientBucketer(kv_bk, items, target_bytes=1024)
    outs = [_a(np.zeros(sh, dt)) for sh, dt in shapes]
    bucketer.allreduce(per_dev, outs=outs)
    for i in range(len(shapes)):
        np.testing.assert_array_equal(ref[i], outs[i].asnumpy())
    # the JAX local store gives the same bits
    jkv = jmx.kvstore.create("local")
    if compression:
        jkv.set_gradient_compression(compression)
    jb = jbucket.GradientBucketer(jkv, items, target_bytes=1024)
    jouts = [jmx.nd.array(np.zeros(sh, dt), dtype=dt) for sh, dt in shapes]
    jb.allreduce([[jmx.nd.array(g * (d + 1), dtype=g.dtype)
                   for d in range(3)] for g in grads], outs=jouts)
    for i in range(len(shapes)):
        np.testing.assert_array_equal(jouts[i].asnumpy(), ref[i])


@pytest.fixture
def cluster(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "64")
    srvs = start_servers(monkeypatch, 2, 2)
    made = []

    def make_worker(rank):
        kv = make_kv(rank)
        made.append(kv)
        return kv

    yield make_worker
    stop(srvs, made)


@pytest.mark.parametrize("compression", [None, {"type": "2bit",
                                                "threshold": 0.5}])
def test_dist_bucketed_matches_perkey(monkeypatch, compression):
    if compression is None:
        grads, shapes = _rand_set(seed=3)
    else:
        rng = np.random.RandomState(3)
        shapes = [((5, 3), np.float32), ((700,), np.float32),
                  ((7,), np.float32)]
        grads = [rng.randn(*sh).astype(dt) for sh, dt in shapes]
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "64")
    results = {}

    def worker(rank, bucketed):
        kv = make_kv(rank)
        if compression:
            kv.set_gradient_compression(compression)
        vals = [_a(g * (rank + 1)) for g in grads]
        if bucketed:
            items = [(i, sh, dt.__name__)
                     for i, (sh, dt) in enumerate(shapes)]
            GradientBucketer(kv, items, target_bytes=1024).allreduce(vals)
        else:
            for i, (sh, dt) in enumerate(shapes):
                kv.init(i, _a(np.zeros(sh, dt)))
            for i, v in enumerate(vals):
                kv.pushpull(i, v, out=v)
        results[(bucketed, rank)] = [v.asnumpy() for v in vals]
        kv.barrier()
        kv.close()

    for bucketed in (False, True):
        srvs = start_servers(monkeypatch, 2, 2)
        run_ranks(lambda r: worker(r, bucketed))
        stop(srvs)
    for i in range(len(shapes)):
        for rank in (0, 1):
            np.testing.assert_array_equal(results[(False, rank)][i],
                                          results[(True, rank)][i])


def test_dist_bucketed_small_inflight_window(monkeypatch):
    monkeypatch.setenv("MXNET_KV_INFLIGHT", "2")
    srvs = start_servers(monkeypatch, 2, 2)
    rng = np.random.RandomState(5)
    grads = [rng.randn(40).astype(np.float32) for _ in range(10)]
    results = {}

    def worker(rank):
        kv = make_kv(rank)
        assert kv._inflight == 2
        b = GradientBucketer(kv, [(i, (40,), "float32") for i in range(10)],
                             target_bytes=256)
        vals = [_a(g * (rank + 1)) for g in grads]
        b.allreduce(vals)
        results[rank] = [v.asnumpy() for v in vals]
        kv.close()

    run_ranks(worker)
    stop(srvs)
    for i in range(10):
        for r in (0, 1):
            np.testing.assert_array_equal(results[r][i], grads[i] * 3.0)


def test_bucket_keys_never_split_across_servers(cluster):
    kv = cluster(0)
    plan = kv._chunk_plan("__bucket__0:deadbeef", 200)
    assert len(plan) == 1 and plan[0][2] is None
    assert len(kv._chunk_plan("w", 200)) == 2


def test_frames_respect_byte_ceiling(monkeypatch):
    monkeypatch.setattr(tdist, "_MAX_FRAME_BYTES", 256)
    monkeypatch.setenv("MXNET_KV_INFLIGHT", "1")
    srvs = start_servers(monkeypatch, 2, 2)
    rng = np.random.RandomState(9)
    grads = [rng.randn(40).astype(np.float32) for _ in range(8)]
    results, sent = {}, {}

    def worker(rank):
        kv = make_kv(rank)
        assert kv._inflight == 1
        before = tdist._tm_wire.labels("push_multi").value
        b = GradientBucketer(kv, [(i, (40,), "float32") for i in range(8)],
                             target_bytes=200)
        vals = [_a(g * (rank + 1)) for g in grads]
        b.allreduce(vals)
        sent[rank] = tdist._tm_wire.labels("push_multi").value - before
        results[rank] = [v.asnumpy() for v in vals]
        kv.close()

    run_ranks(worker)
    stop(srvs)
    assert sent[0] > 2
    for i in range(8):
        np.testing.assert_array_equal(results[0][i], grads[i] * 3.0)


def test_chunk_plan_memoized(cluster):
    kv = cluster(0)
    p1 = kv._chunk_plan("big", 200)
    assert kv._chunk_plan("big", 200) is p1
    assert kv._chunk_plan("big", 300) is not p1


def test_multi_ops_roundtrip_counts(monkeypatch):
    srvs = start_servers(monkeypatch, 2, 1)
    kv = make_kv(0)
    keys = [f"k{i}" for i in range(12)]
    with mx.cpu():
        for k in keys:
            kv.init(k, nd.zeros((4,)))
        before = tdist._tm_wire.labels("push_multi").value
        kv.push_multi(keys, [nd.ones((4,)) for _ in keys])
        assert 0 < tdist._tm_wire.labels("push_multi").value - before \
            <= 2 * kv._inflight
        outs = [nd.zeros((4,)) for _ in keys]
        before = tdist._tm_wire.labels("pull_multi").value
        kv.pull_multi(keys, outs)
        assert 0 < tdist._tm_wire.labels("pull_multi").value - before \
            <= 2 * kv._inflight
    for o in outs:
        np.testing.assert_array_equal(o.asnumpy(), 1.0)
    stop(srvs, [kv])


def test_multi_push_stall_fails_fast(monkeypatch):
    import time as _time
    srvs = start_servers(monkeypatch, 1, 2, timeout=2)
    kv = make_kv(0)
    keys = [f"k{i}" for i in range(8)]
    t0 = _time.monotonic()
    with mx.cpu(), pytest.raises(MXNetError, match="stalled"):
        kv.push_multi(keys, [nd.ones((4,)) for _ in keys])
    assert _time.monotonic() - t0 < 10
    stop(srvs, [kv])


def test_pull_multi_unknown_key_raises(cluster):
    kv = cluster(0)
    with mx.cpu(), pytest.raises(MXNetError, match="not initialized"):
        kv.pull_multi(["never_pushed"], [nd.zeros((4,))])


# ---------------------------------------------------------------------
# trainer integration
# ---------------------------------------------------------------------

def _dense_pair(units=4, in_units=3, init=0.3):
    jnet = jmx.gluon.nn.Dense(units, in_units=in_units)
    jnet.initialize(jmx.init.Constant(init))
    tnet = gluon.nn.Dense(units, in_units=in_units)
    tnet.initialize(ctx=mx.cpu())
    params_from_jax(tnet, {k: v.data().asnumpy() for k, v in
                           jnet._collect_params_with_prefix().items()})
    return jnet, tnet


def _train_dist(m, net, monkeypatch, bucket_kb, pkg, steps=4):
    start_servers(monkeypatch, 1, 1, pkg=pkg)
    monkeypatch.setenv("MXNET_KV_BUCKET_KB", str(bucket_kb))
    tr = m.gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9},
                         kvstore="dist_sync")
    loss_fn = m.gluon.loss.L2Loss()
    x, y = m.nd.ones((2, 3)), m.nd.zeros((2, 4))
    for _ in range(steps):
        with m.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        tr.step(2)
    assert (tr._kv_bucketer is not None) == (bucket_kb > 0)
    tr._kv.close()
    return net.weight.data().asnumpy().copy()


def test_trainer_update_on_kvstore_bucketed_matches_perkey(monkeypatch):
    """Bucketed and per-key update-on-kvstore give the same bits, and the
    JAX trainer (on a JAX server) the same weights within OPT_TOL."""
    got = {}
    for kb in (4096, 0):
        jnet, tnet = _dense_pair()
        with mx.cpu():
            got[kb] = _train_dist(mx, tnet, monkeypatch, kb, "torch")
    np.testing.assert_array_equal(got[4096], got[0])
    jnet, _ = _dense_pair()
    ref = _train_dist(jmx, jnet, monkeypatch, 4096, "jax")
    np.testing.assert_allclose(got[4096], ref, **OPT_TOL)


@pytest.mark.parametrize("case", ["lamb", "lr_mult"])
def test_trainer_per_key_fallbacks(monkeypatch, case):
    """A norm-based optimizer (lamb) and a per-parameter lr_mult keep
    the per-key server update (the JAX package's
    test_trainer_norm_based_optimizer_falls_back and
    test_trainer_nonuniform_multipliers_fall_back)."""
    start_servers(monkeypatch, 1, 1)
    monkeypatch.setenv("MXNET_KV_BUCKET_KB", "4096")
    with mx.cpu():
        net = gluon.nn.Dense(2, in_units=2)
        net.initialize(mx.init.Constant(0.5))
        if case == "lr_mult":
            net.weight.lr_mult = 0.5
        tr = gluon.Trainer(net.collect_params(),
                           "lamb" if case == "lamb" else "sgd",
                           {"learning_rate": 0.01}, kvstore="dist_sync")
        with autograd.record():
            loss = (net(nd.ones((2, 2))) ** 2).sum()
        loss.backward()
        tr.step(2)
    assert tr._kv_bucketer is None
    tr._kv.close()


def test_trainer_allreduce_bucketed_matches_perkey(monkeypatch):
    """update_on_kvstore=False: `_allreduce_grads` sums two workers'
    gradients, bucketed and per key, to the same bits."""
    rng = np.random.RandomState(7)
    base = [rng.randn(4, 3).astype(np.float32),
            rng.randn(4).astype(np.float32)]

    def run(bucket_kb):
        monkeypatch.setenv("MXNET_KV_BUCKET_KB", str(bucket_kb))
        srvs = start_servers(monkeypatch, 1, 2)
        trs = []
        for rank in range(2):
            with mx.cpu():
                net = gluon.nn.Dense(4, in_units=3)
                net.initialize(mx.init.Constant(0.2))
                tr = gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1},
                                   kvstore="dist_sync",
                                   update_on_kvstore=False)
            tr._kv._rank = rank
            for p, g in zip(tr._params, base):
                p.grad()._data.copy_(torch.from_numpy(g * (rank + 1)))
            trs.append(tr)
        results = {}

        def worker(rank):
            trs[rank]._allreduce_grads()
            if bucket_kb > 0:
                assert trs[rank]._bucketer not in (None, False)
            results[rank] = [p.grad().asnumpy() for p in trs[rank]._params]

        run_ranks(worker)
        stop(srvs, [t._kv for t in trs])
        return results

    bucketed, perkey = run(4096), run(0)
    for rank in (0, 1):
        for a, b, g in zip(bucketed[rank], perkey[rank], base):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, g * 3.0)


# ---------------------------------------------------------------------
# ZeRO placement (tests/test_kvstore_zero.py)
# ---------------------------------------------------------------------

def test_balanced_assignment_deterministic_and_balanced():
    sizes = [4096, 4096, 4096, 1024, 8192, 512, 4096, 2048]
    a1 = kvzero.balanced_assignment(sizes, 3)
    assert a1 == kvzero.balanced_assignment(list(sizes), 3) \
        == jzero.balanced_assignment(sizes, 3)
    loads = [0, 0, 0]
    for sz, srv in zip(sizes, a1):
        loads[srv] += sz
    assert kvzero.byte_skew(loads) <= 1.2 and a1[4] == 0
    assert kvzero.balanced_assignment([], 4) == []
    assert kvzero.balanced_assignment([10, 20], 1) == [0, 0]
    assert kvzero.byte_skew([]) == 0.0 and kvzero.byte_skew([0, 0]) == 0.0


def test_placement_for_plan_balances_bert_census():
    items = [(0, (8192, 256), "float32"), (1, (512, 256), "float32")]
    i = 2
    for _ in range(12):
        for _ in range(4):
            items += [(i, (256, 256), "float32"), (i + 1, (256,),
                                                   "float32")]
            i += 2
        items += [(i, (1024, 256), "float32"), (i + 1, (256, 1024),
                                                "float32")]
        i += 2
    plan = build_plan(items, target_bytes=512 * 1024)
    jplan = jbucket.build_plan(items, target_bytes=512 * 1024)
    for nsrv in (2, 3, 4):
        placement = kvzero.placement_for_plan(plan, nsrv)
        assert placement == jzero.placement_for_plan(jplan, nsrv)
        owned = [0] * nsrv
        for b in plan:
            owned[placement[b.wire_key]] += b.nbytes
        assert kvzero.byte_skew(owned) <= 1.2, (nsrv, owned)


def _fake_fleet(monkeypatch, n, rank=0, workers=1):
    monkeypatch.setenv("DMLC_NUM_WORKER", str(workers))
    monkeypatch.setenv("DMLC_WORKER_RANK", str(rank))
    monkeypatch.setenv("DMLC_NUM_SERVER", str(n))
    monkeypatch.setenv("MXNET_KVSTORE_SERVER_ADDRS",
                       ",".join(f"127.0.0.1:{p + 1}" for p in range(n)))


def test_set_bucket_placement_routes_and_invalidates_cache(monkeypatch):
    _fake_fleet(monkeypatch, 4)
    kv = tdist.KVStoreDist("dist_sync")
    key = "__bucket__0:deadbeef"
    default = kv._server_of(key)
    before = kv._chunk_plan(key, 64)
    target = (default + 1) % 4
    kv.set_bucket_placement({key: target})
    assert kv._server_of(key) == target
    after = kv._chunk_plan(key, 64)
    assert after is not before and after[0][1] == target
    assert kv._server_of("w") == kv._server_of("w")


def test_bucketer_registers_placement_under_zero(monkeypatch):
    monkeypatch.setenv("MXNET_KV_ZERO", "1")
    _fake_fleet(monkeypatch, 2)
    kv = tdist.KVStoreDist("dist_sync")
    b = GradientBucketer(kv, [(i, (64,), "float32") for i in range(8)],
                         target_bytes=256)
    expect = kvzero.placement_for_plan(b.plan, 2)
    for bk in b.plan:
        assert kv._server_of(bk.wire_key) == expect[bk.wire_key]
    assert len({kv._server_of(bk.wire_key) for bk in b.plan}) == 2


def test_chunk_plan_slices_are_balanced(monkeypatch):
    _fake_fleet(monkeypatch, 3)
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "64")
    kv = tdist.KVStoreDist("dist_sync")
    from incubator_mxnet_tpu.kvstore.dist import KVStoreDist as J
    plan = kv._chunk_plan("w", 200)
    assert plan == J("dist_sync")._chunk_plan("w", 200)
    sizes = [hi - lo for _wk, _srv, (lo, hi) in plan]
    assert sum(sizes) == 200 and max(sizes) - min(sizes) <= 1
    assert plan[0][2][0] == 0 and plan[-1][2][1] == 200


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, clip_gradient=0.5)),
    ("adam", dict(learning_rate=0.01, wd=0.001)),
    ("nag", dict(momentum=0.9)),
    ("adagrad", dict()),
    ("rmsprop", dict(learning_rate=0.01)),
    ("rmsprop", dict(learning_rate=0.01, centered=True)),
    ("adadelta", dict()),
    ("signum", dict()),
])
def test_update_flat_matches_perkey_bitwise(name, kw):
    rng = np.random.RandomState(0)
    w0 = rng.randn(1000).astype(np.float32)
    u1 = opt.get_updater(opt.create(name, **dict(kw)))
    u2 = opt.get_updater(opt.create(name, **dict(kw)))
    w1, w2 = _a(w0), _a(w0)
    for _ in range(4):
        g = rng.randn(1000).astype(np.float32)
        u1(3, _a(g), w1, state_key="shard")
        assert u2.update_flat(3, _a(g), w2, state_key="shard") is True
    assert w1.asnumpy().tobytes() == w2.asnumpy().tobytes()
    assert u1.state_nbytes() == u2.state_nbytes()


def test_update_flat_lamb_falls_back():
    u = opt.get_updater(opt.create("lamb"))
    w, g = _a(np.ones(8, np.float32)), _a(np.ones(8, np.float32))
    assert u.update_flat(0, g, w) is False
    assert u.state_nbytes() == 0


def test_update_flat_keeps_one_state_slot_across_steps():
    """The JAX package's test_update_flat_traced_lr_never_recompiles_adam
    asks that Adam's per-step lr reuses one compiled update; here the
    flat update reuses one state slot and counts Adam's step."""
    o = opt.create("adam", learning_rate=0.01)
    u = opt.get_updater(o)
    w = _a(np.ones(64, np.float32))
    for _ in range(3):
        assert u.update_flat(0, _a(np.ones(64, np.float32)), w,
                             state_key="s")
    assert list(u.states) == ["s"] and o._index_update_count[0] == 3
    assert u.state_nbytes() == 2 * 64 * 4


def _dist_train(monkeypatch, zero, optimizer="adam", steps=4):
    """A 3-layer net trained with update-on-kvstore over two servers;
    returns (first weight, per-server (owned, state) bytes, the
    worker's resident state bytes, the trainer)."""
    monkeypatch.setenv("MXNET_KV_ZERO", str(zero))
    monkeypatch.setenv("MXNET_KV_BUCKET_KB", "1")
    srvs = start_servers(monkeypatch, 2, 1)
    with mx.cpu():
        mx.random.seed(11)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(32, in_units=24),
                gluon.nn.Dense(32, in_units=32),
                gluon.nn.Dense(16, in_units=32))
        net.initialize(mx.init.Constant(0.3))
        tr = gluon.Trainer(net.collect_params(), optimizer,
                           {"learning_rate": 0.1}, kvstore="dist_sync")
        loss_fn = gluon.loss.L2Loss()
        x, y = nd.ones((2, 24)), nd.zeros((2, 16))
        for _ in range(steps):
            with autograd.record():
                loss = loss_fn(net(x), y).mean()
            loss.backward()
            tr.step(2)
    w = net[0].weight.data().asnumpy().copy()
    stats = [(s.owned_bytes(), s.state_bytes()) for s in srvs]
    resident = tr._resident_state_bytes()
    stop(srvs, [tr._kv])
    return w, stats, resident, tr


def test_zero_dist_bitwise_matches_unsharded_and_shards_state(
        monkeypatch):
    w_plain, _s, _r, _t = _dist_train(monkeypatch, 0)
    w_zero, stats, resident, tr = _dist_train(monkeypatch, 1)
    assert w_plain.tobytes() == w_zero.tobytes()
    assert resident == 0 and tr._kv_bucketer is not None
    owned, state = [s[0] for s in stats], [s[1] for s in stats]
    assert all(o > 0 for o in owned) and all(st > 0 for st in state)
    for o, st in zip(owned, state):
        assert st == 2 * o, (o, st)
    assert kvzero.byte_skew(owned) <= 1.2


def test_zero2_trainer_bitwise_matches_zero1(monkeypatch):
    w_one, _s, _r, _t = _dist_train(monkeypatch, 1)
    w_two, stats, resident, tr = _dist_train(monkeypatch, 2)
    assert w_one.tobytes() == w_two.tobytes() and resident == 0
    assert tr._kv._placement_provider is not None
    assert kvzero.byte_skew([s[0] for s in stats]) <= 1.2


def test_zero_composes_with_overlap_bitwise(monkeypatch):
    w_seq, _s, _r, _t = _dist_train(monkeypatch, 1)
    monkeypatch.setenv("MXNET_KV_OVERLAP", "1")
    w_ov, _s2, resident, tr = _dist_train(monkeypatch, 1)
    assert w_seq.tobytes() == w_ov.tobytes() and resident == 0
    assert tr._last_overlap is not None


def test_zero_requires_bucketed_path(monkeypatch):
    monkeypatch.setenv("MXNET_KV_ZERO", "1")
    srvs = start_servers(monkeypatch, 1, 1)
    with mx.cpu():
        net = gluon.nn.Dense(2, in_units=2)
        net.initialize(mx.init.Constant(0.5))
        tr = gluon.Trainer(net.collect_params(), "lamb",
                           {"learning_rate": 0.01}, kvstore="dist_sync")
        with autograd.record():
            loss = (net(nd.ones((2, 2))) ** 2).sum()
        loss.backward()
        with pytest.raises(MXNetError, match="MXNET_KV_ZERO"):
            tr.step(2)
    stop(srvs, [tr._kv])


def test_zero_server_uses_fused_path_and_accounts_bytes(monkeypatch):
    monkeypatch.setenv("MXNET_KV_ZERO", "1")
    srv = tdist._Server(0, num_workers=1, sync=True)
    try:
        assert srv.zero == 1
        srv.set_optimizer(opt.SGD(learning_rate=0.5, momentum=0.9))
        key = "__bucket__0:cafef00d"
        srv.store[key] = _a(np.ones(256, np.float32))
        srv._account_owned(key)
        assert srv.owned_bytes() == 256 * 4 and srv.state_bytes() == 0
        srv._handle_push(key, torch.full((256,), 2.0), wid="0:tok", seq=1)
        assert key in srv.updater.states
        assert srv.state_bytes() == 256 * 4
        np.testing.assert_allclose(srv.store[key].asnumpy(),
                                   np.zeros(256), atol=1e-6)
    finally:
        srv.stop()
        srv.sock.close()


def test_zero_dist_update_agrees_with_spmd_update_bitwise():
    """The server's flat SGD update against the JAX package's SPMD
    update rule (`parallel.trainer._sgd_update`) on the same gradient
    stream."""
    import jax
    import jax.numpy as jnp
    from incubator_mxnet_tpu.parallel.trainer import _sgd_update
    rng = np.random.RandomState(5)
    w0 = rng.randn(512).astype(np.float32)
    grads = [rng.randn(512).astype(np.float32) for _ in range(4)]
    u = opt.get_updater(opt.create("sgd", learning_rate=0.1,
                                   momentum=0.9, wd=0.01))
    w_kv = _a(w0)
    for g in grads:
        assert u.update_flat(0, _a(g), w_kv, state_key="b")
    step = jax.jit(lambda w, s, g: _sgd_update(w, s, g, 0.1, 0.9, 0.01))
    w_sp, s_sp = jnp.asarray(w0), jnp.zeros(512, jnp.float32)
    for g in grads:
        w_sp, s_sp = step(w_sp, s_sp, jnp.asarray(g))
    np.testing.assert_allclose(w_kv.asnumpy(), np.asarray(w_sp),
                               **OPT_TOL)


def test_placement_for_fleet_maps_balanced_bins_onto_ids():
    items = [(i, (512, 64), "float32") for i in range(12)]
    plan = build_plan(items, target_bytes=256 * 1024)
    placement = kvzero.placement_for_fleet(plan, [0, 2, 5])
    assert placement == jzero.placement_for_fleet(
        jbucket.build_plan(items, target_bytes=256 * 1024), [0, 2, 5])
    assert set(placement.values()) <= {0, 2, 5}
    owned = {0: 0, 2: 0, 5: 0}
    for b in plan:
        owned[placement[b.wire_key]] += b.nbytes
    assert kvzero.byte_skew(owned.values()) <= 1.2
    assert kvzero.placement_for_plan(plan, 2) == \
        kvzero.placement_for_fleet(plan, [0, 1])


def test_perkey_placement_balances_unbucketed_routing(monkeypatch):
    import zlib
    monkeypatch.setenv("MXNET_KV_ZERO", "1")
    _fake_fleet(monkeypatch, 4, rank=1, workers=2)
    kv = tdist.KVStoreDist("dist_sync")
    shapes = [(512, 256)] * 6 + [(256, 256)] * 12 + [(256,)] * 80
    loads, crc_loads = [0] * 4, [0] * 4
    for i, sh in enumerate(shapes):
        key = f"param{i}"
        kv._route_perkey(key, _a(np.zeros(sh, np.float32)))
        nbytes = int(np.prod(sh)) * 4
        loads[kv._server_of(key)] += nbytes
        crc_loads[zlib.crc32(key.encode()) % 4] += nbytes
    assert kvzero.byte_skew(loads) <= 1.2, loads
    before = kv._server_of("param0")
    kv._route_perkey("param0", _a(np.zeros(shapes[0], np.float32)))
    assert kv._server_of("param0") == before
    assert kvzero.byte_skew(crc_loads) > kvzero.byte_skew(loads)
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "1000")
    kv2 = tdist.KVStoreDist("dist_sync")
    kv2._route_perkey("big", _a(np.zeros((64, 64), np.float32)))
    assert "big" not in kv2._bucket_placement


_Z2_SHAPES = [(256, 64)] * 6 + [(64,)] * 6


def _zero2_setup(monkeypatch):
    monkeypatch.setenv("MXNET_KV_ZERO", "2")
    srvs = start_servers(monkeypatch, 2, 1)
    rng = np.random.RandomState(0)
    grads = [_a(rng.randn(*s).astype(np.float32) * 1e-2)
             for s in _Z2_SHAPES]
    kv = make_kv(0)
    with mx.cpu():
        kv.set_optimizer(opt.SGD(learning_rate=0.05, momentum=0.9))
    b = GradientBucketer(kv, [(i, s, "float32")
                              for i, s in enumerate(_Z2_SHAPES)],
                         target_bytes=32 * 1024)
    weights = [_a(np.zeros(s, np.float32)) for s in _Z2_SHAPES]
    b.init(weights)
    return srvs, kv, b, grads, weights


def test_zero2_streamed_overlap_composes_bitwise(monkeypatch):
    srvs, kv, b, grads, w_seq = _zero2_setup(monkeypatch)
    for _ in range(4):
        b.push(grads, scale=0.5)
        b.pull(w_seq)
    stop(srvs, [kv])
    srvs, kv, b, grads, weights = _zero2_setup(monkeypatch)
    for _ in range(4):
        stream = b.stream(lambda j: grads[j], scale=0.5)
        assert stream is not None
        stream.on_backward()
        for j in reversed(range(len(grads))):
            stream.ready(j)
        stream.finish(weights)
    for a, c in zip(w_seq, weights):
        assert a.asnumpy().tobytes() == c.asnumpy().tobytes()
    stop(srvs, [kv])


def test_zero2_relay_update_exchange_delivers_weights(monkeypatch):
    from incubator_mxnet_torch.kvstore.hierarchy import (HostRelayLeader,
                                                         HostRelayMember)
    monkeypatch.setenv("MXNET_KV_ZERO", "2")
    srvs = start_servers(monkeypatch, 2, 1)
    shapes = [(64, 16), (16,), (32, 8)]
    items = [(i, s, "float32") for i, s in enumerate(shapes)]
    gA = [np.random.RandomState(5 + i).randn(*s).astype(np.float32)
          for i, s in enumerate(shapes)]
    gB = [np.random.RandomState(50 + i).randn(*s).astype(np.float32)
          for i, s in enumerate(shapes)]
    relay_port = free_ports(1)[0]
    leader = HostRelayLeader(relay_port, local_size=2)
    member = HostRelayMember(relay_port, rank=1)
    kv = make_kv(0)
    with mx.cpu():
        kv.set_optimizer(opt.SGD(learning_rate=0.1, momentum=0.0))
    bL = GradientBucketer(kv, items, target_bytes=4096)
    bM = GradientBucketer(None, items, target_bytes=4096)
    bL.init([_a(np.zeros(s, np.float32)) for s in shapes])
    outs = {}

    def run(who, end, b, g):
        weights = [_a(np.zeros(s, np.float32)) for s in shapes]
        end.update_exchange(b, [_a(x) for x in g], weights)
        outs[who] = [w.asnumpy() for w in weights]

    run_workers([lambda: run("L", leader, bL, gA),
                 lambda: run("M", member, bM, gB)])
    for i in range(len(shapes)):
        want = (-0.1 * (gA[i] + gB[i])).astype(np.float32)
        np.testing.assert_allclose(outs["L"][i], want, rtol=1e-6,
                                   atol=1e-7)
        assert outs["L"][i].tobytes() == outs["M"][i].tobytes()
    leader.close()
    member.close()
    stop(srvs, [kv])
