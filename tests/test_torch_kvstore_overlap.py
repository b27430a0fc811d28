"""The port's streamed exchange (MXNET_KV_OVERLAP), its grad-ready
watch, and the hierarchical host relay (MXNET_KV_HIERARCHY), against the
JAX package.

Mirrors `tests/test_kvstore_overlap.py` but for its elastic and replay
cases (ROADMAP item 10b).  The watch's events are compared with the JAX
package's on the same graphs; trainers start from the JAX net's weights
(`convert.params_from_jax`).  Tolerances:

- streamed against plain, relay against the flat sum, hybridized
  against imperative: bit for bit (the same adds in the same order);
- a streamed port trainer against the JAX trainer (plain exchange, JAX
  server), 5 steps from the same weights: rtol 1e-6, atol 1e-7.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd
from incubator_mxnet_torch.base import MXNetError
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.kvstore import hierarchy
from incubator_mxnet_torch.kvstore.bucket import GradientBucketer
from incubator_mxnet_torch.kvstore.dist import _tm_wire

from _torch_kv_cases import (free_port, make_kv, run_workers,
                             start_servers, stop)

OPT_TOL = dict(rtol=1e-6, atol=1e-7)


def _a(x):
    return nd.NDArray(torch.from_numpy(np.array(x, np.float32, copy=True)))


# ---------------------------------------------------------------------
# the grad-ready watch
# ---------------------------------------------------------------------

def _watch_events(m, arr, build, n):
    vs = [arr(np.ones(2)) for _ in range(n)]
    for v in vs:
        v.attach_grad()
    events = []
    m.autograd.watch_grad_ready(vs, events.append,
                                on_backward=lambda: events.append("B"))
    try:
        with m.autograd.record():
            loss = build(*vs)
        loss.backward()
    finally:
        m.autograd.unwatch_grad_ready()
    return events, [v.grad.asnumpy() for v in vs]


def _jarr(x):
    return jmx.nd.array(np.asarray(x, np.float32))


@pytest.mark.parametrize("case", ["reverse_order", "unused", "twice"])
def test_grad_ready_events_match_jax(case):
    """The events of the JAX package's three grad-ready cases
    (test_grad_ready_fires_in_reverse_execution_order, ..._fallback_
    fires_unused_params_once, ..._param_used_twice_fires_after_last_use),
    and the same gradients."""
    build, n = {
        "reverse_order": (lambda a, b, c: (((a * 2.0) + b) * c).sum(), 3),
        "unused": (lambda a, b: (a * 3.0).sum(), 2),
        "twice": (lambda a: (a * 2.0 + a * 3.0).sum(), 1)}[case]
    with mx.cpu():
        got, grads = _watch_events(mx, _a, build, n)
    ref, jgrads = _watch_events(jmx, _jarr, build, n)
    assert got == ref
    for g, r in zip(grads, jgrads):
        np.testing.assert_array_equal(g, r)
    if case == "reverse_order":
        assert got == ["B", 2, 1, 0]


def test_autograd_grad_does_not_fire_watch():
    with mx.cpu():
        a = nd.ones((2,))
        a.attach_grad()
        events = []
        autograd.watch_grad_ready([a], events.append)
        try:
            with autograd.record():
                y = (a * 2.0).sum()
            g = autograd.grad(y, a, retain_graph=False)
        finally:
            autograd.unwatch_grad_ready()
    assert events == []
    np.testing.assert_array_equal(g.asnumpy(), np.full(2, 2.0))


def test_grad_ready_watch_is_per_thread():
    """A watch installed on one thread does not fire for another
    thread's backward (the kvstore tests run workers as threads)."""
    events = []
    with mx.cpu():
        a = nd.ones((2,))
        a.attach_grad()
        autograd.watch_grad_ready([a], events.append)
    other = []

    def elsewhere():
        b = nd.ones((2,))
        b.attach_grad()
        autograd.watch_grad_ready([b], other.append)
        with autograd.record():
            loss = (a * b).sum()
        loss.backward()
        autograd.unwatch_grad_ready()

    try:
        run_workers([elsewhere])
    finally:
        autograd.unwatch_grad_ready()
    assert events == [] and other == [0]


# ---------------------------------------------------------------------
# streamed exchange == plain exchange
# ---------------------------------------------------------------------

_SHAPES = [(64, 32), (64,), (32, 16), (16,), (128, 8)]


def _grad_set(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*sh) * scale).astype(np.float32) for sh in _SHAPES]


def test_streamed_matches_plain_single_worker(monkeypatch):
    srvs = start_servers(monkeypatch, 1, 1)
    grads_np = _grad_set()
    items = [(i, sh, "float32") for i, sh in enumerate(_SHAPES)]
    kv = make_kv(0)
    bucketer = GradientBucketer(kv, items, target_bytes=8192)
    warm = [_a(g) for g in grads_np]
    bucketer.allreduce(warm)
    ref = [g.asnumpy().copy() for g in warm]
    grads = [_a(g * 2.0) for g in grads_np]
    stream = bucketer.stream(lambda j: grads[j])
    assert stream is not None
    stream.on_backward()
    for j in reversed(range(len(_SHAPES))):
        stream.ready(j)
    stream.finish(grads)
    for g, r in zip(grads, ref):
        assert g.asnumpy().tobytes() == (2.0 * r).tobytes()
    assert stream.overlap_fraction >= 0.0
    stop(srvs, [kv])


def test_streamed_matches_plain_two_workers(monkeypatch):
    srvs = start_servers(monkeypatch, 1, 2)
    items = [(i, sh, "float32") for i, sh in enumerate(_SHAPES)]
    ga, gb = _grad_set(1), _grad_set(2)
    results = {}

    def worker(rank, grads_np):
        kv = make_kv(rank)
        bucketer = GradientBucketer(kv, items, target_bytes=8192)
        grads = [_a(g) for g in grads_np]
        bucketer._ensure_init()
        stream = bucketer.stream(lambda j: grads[j])
        stream.on_backward()
        for j in reversed(range(len(items))):
            stream.ready(j)
        stream.finish(grads)
        results[rank] = [g.asnumpy().copy() for g in grads]
        kv.close()

    run_workers([lambda: worker(0, ga), lambda: worker(1, gb)])
    stop(srvs)
    for rank in (0, 1):
        for got, want in zip(results[rank], [a + b for a, b in
                                             zip(ga, gb)]):
            assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------
# gluon.Trainer integration
# ---------------------------------------------------------------------

def _train(monkeypatch, overlap, update_on_kvstore, steps=5, pkg="torch"):
    m = mx if pkg == "torch" else jmx
    start_servers(monkeypatch, 1, 1, pkg=pkg)
    monkeypatch.setenv("MXNET_KV_OVERLAP", "1" if overlap else "0")
    jnet = jmx.gluon.nn.Dense(4, in_units=3)
    jnet.initialize(jmx.init.Constant(0.3))
    net = jnet
    if pkg == "torch":
        net = gluon.nn.Dense(4, in_units=3)
        net.initialize(ctx=mx.cpu())
        params_from_jax(net, {k: v.data().asnumpy() for k, v in
                              jnet._collect_params_with_prefix().items()})
    tr = m.gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9},
                         kvstore="dist_sync",
                         update_on_kvstore=update_on_kvstore)
    loss_fn = m.gluon.loss.L2Loss()
    x, y = m.nd.ones((2, 3)), m.nd.zeros((2, 4))
    for _ in range(steps):
        with m.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        tr.step(2)
    frac = tr._last_overlap
    tr._take_stream()
    tr._kv.close()
    return net.weight.data().asnumpy().copy(), frac, tr


def test_trainer_overlap_bitwise_parity_update_on_kvstore(monkeypatch):
    with mx.cpu():
        w_plain, _, _ = _train(monkeypatch, False, True)
        w_over, frac, tr = _train(monkeypatch, True, True)
    assert w_plain.tobytes() == w_over.tobytes()
    assert frac is not None and frac > 0.0
    sz = gluon.trainer.Trainer._statusz_of(tr)
    assert sz["overlap"]["enabled"] is True
    assert sz["overlap"]["last_fraction"] == frac
    ref, _, _ = _train(monkeypatch, False, True, pkg="jax")
    np.testing.assert_allclose(w_over, ref, **OPT_TOL)


def test_trainer_overlap_hybridized_fallback_parity(monkeypatch):
    def train(overlap):
        start_servers(monkeypatch, 1, 1)
        monkeypatch.setenv("MXNET_KV_OVERLAP", "1" if overlap else "0")
        with mx.cpu():
            net = gluon.nn.HybridSequential()
            net.add(gluon.nn.Dense(8, in_units=3, activation="relu"))
            net.add(gluon.nn.Dense(4))
            net.initialize(mx.init.Constant(0.1))
            net.hybridize()
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore="dist_sync")
            loss_fn = gluon.loss.L2Loss()
            x, y = nd.ones((2, 3)), nd.zeros((2, 4))
            for _ in range(4):
                with autograd.record():
                    loss = loss_fn(net(x), y).mean()
                loss.backward()
                tr.step(2)
        tr._take_stream()
        tr._kv.close()
        return [p.data().asnumpy().copy() for p in tr._params]

    for a, b in zip(train(False), train(True)):
        assert a.tobytes() == b.tobytes()


def test_trainer_overlap_two_worker_allreduce_parity(monkeypatch):
    def run(overlap):
        srvs = start_servers(monkeypatch, 1, 2)
        monkeypatch.setenv("MXNET_KV_OVERLAP", "1" if overlap else "0")
        weights, trs = {}, {}
        for rank in range(2):
            with mx.cpu():
                net = gluon.nn.Dense(4, in_units=3)
                net.initialize(mx.init.Constant(0.2))
                tr = gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1},
                                   kvstore="dist_sync",
                                   update_on_kvstore=False)
            tr._kv._rank = rank
            trs[rank] = (net, tr)

        def worker(rank):
            net, tr = trs[rank]
            loss_fn = gluon.loss.L2Loss()
            x, y = nd.ones((2, 3)) * (rank + 1), nd.zeros((2, 4))
            for _ in range(4):
                with autograd.record():
                    loss = loss_fn(net(x), y).mean()
                loss.backward()
                tr.step(2)
            if overlap:
                assert tr._last_overlap is not None
            weights[rank] = [p.data().asnumpy().copy() for p in tr._params]
            tr._take_stream()
            tr._kv.close()

        run_workers([lambda: worker(0), lambda: worker(1)], timeout=120)
        stop(srvs)
        for a, b in zip(weights[0], weights[1]):
            assert a.tobytes() == b.tobytes()
        return weights[0]

    for a, b in zip(run(False), run(True)):
        assert a.tobytes() == b.tobytes()


def test_trainer_overlap_flight_attribution(monkeypatch):
    from incubator_mxnet_torch import introspect
    with mx.cpu():
        _train(monkeypatch, True, True)
    evs = [e for e in introspect.flight_events()
           if e.get("kind") == "step"
           and e.get("overlap_wire_seconds") is not None]
    assert evs
    for e in evs:
        assert e["overlap_wire_seconds"] > 0.0
        if "compute_seconds" in e:
            assert e["compute_seconds"] >= 0.0


def _overlap_trainer(monkeypatch):
    start_servers(monkeypatch, 1, 1)
    monkeypatch.setenv("MXNET_KV_OVERLAP", "1")
    net = gluon.nn.Dense(4, in_units=3)
    net.initialize(mx.init.Constant(0.3))
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1}, kvstore="dist_sync")
    return net, tr, gluon.loss.L2Loss()


def test_trainer_overlap_batch_size_change_is_clean_error(monkeypatch):
    with mx.cpu():
        net, tr, loss_fn = _overlap_trainer(monkeypatch)
        x, y = nd.ones((2, 3)), nd.zeros((2, 4))

        def one_step(bs):
            with autograd.record():
                loss = loss_fn(net(x), y).mean()
            loss.backward()
            tr.step(bs)

        one_step(2)
        one_step(2)
        with pytest.raises(MXNetError, match="constant batch size"):
            one_step(4)
    tr._take_stream()
    tr._kv.close()


def test_trainer_overlap_double_backward_is_clean_error(monkeypatch):
    with mx.cpu():
        net, tr, loss_fn = _overlap_trainer(monkeypatch)
        x, y = nd.ones((2, 3)), nd.zeros((2, 4))
        for _ in range(2):
            with autograd.record():
                loss = loss_fn(net(x), y).mean()
            loss.backward()
            tr.step(2)
        for _ in range(2):
            with autograd.record():
                loss = loss_fn(net(x), y).mean()
            loss.backward()
        with pytest.raises(MXNetError, match="second backward"):
            tr.step(2)
    tr._take_stream()
    tr._kv.close()


def test_local_kvstore_overlap_is_noop(monkeypatch):
    monkeypatch.setenv("MXNET_KV_OVERLAP", "1")
    assert mx.kvstore.create("local").stream_exchange() is None
    with mx.cpu():
        net = gluon.nn.Dense(2, in_units=2)
        net.initialize(mx.init.Constant(0.5))
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore="device")
        with autograd.record():
            loss = (net(nd.ones((2, 2))) ** 2).sum()
        loss.backward()
        tr.step(2)
    assert tr._stream is None


# ---------------------------------------------------------------------
# the hierarchy
# ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_reduce_flats_declines_without_several_cards(n):
    """reduce_flats sums only flats on several CUDA devices; CPU flats
    (or one flat) leave the host-side sum to the caller, as the JAX
    package declines on one local device."""
    flats = [_a(np.arange(8) * (i + 1)) for i in range(n)]
    assert hierarchy.reduce_flats(flats) is None


def test_relay_leader_member_allreduce(monkeypatch):
    from incubator_mxnet_torch.kvstore.hierarchy import (HostRelayLeader,
                                                         HostRelayMember)
    srvs = start_servers(monkeypatch, 1, 1)

    def wire_pushes():
        return sum(_tm_wire.labels(op).value for op in ("push_multi",
                                                        "push"))

    shapes = [(32, 16), (16,), (8, 8)]
    items = [(i, sh, "float32") for i, sh in enumerate(shapes)]
    gA = [np.random.RandomState(5 + i).randn(*sh).astype(np.float32)
          for i, sh in enumerate(shapes)]
    gB = [np.random.RandomState(50 + i).randn(*sh).astype(np.float32)
          for i, sh in enumerate(shapes)]
    relay_port = free_port()
    leader = HostRelayLeader(relay_port, local_size=2)
    member = HostRelayMember(relay_port, rank=1)
    kv = make_kv(0)
    bL = GradientBucketer(kv, items, target_bytes=4096)
    bM = GradientBucketer(None, items, target_bytes=4096)
    before = wire_pushes()
    outs = {}

    def run(who, end, b, g):
        grads = [_a(x) for x in g]
        end.allreduce(b, grads, grads)
        outs[who] = [x.asnumpy() for x in grads]

    run_workers([lambda: run("L", leader, bL, gA),
                 lambda: run("M", member, bM, gB)])
    for i in range(len(shapes)):
        want = gA[i] + gB[i]
        assert outs["L"][i].tobytes() == want.tobytes()
        assert outs["M"][i].tobytes() == want.tobytes()
    assert wire_pushes() - before <= len(bL.plan) + 1
    leader.close()
    member.close()
    stop(srvs, [kv])


def test_relay_env_resolution(monkeypatch):
    hierarchy.reset()
    try:
        monkeypatch.setenv("MXNET_KV_HIERARCHY", "1")
        monkeypatch.setenv("MXNET_KV_LOCAL_SIZE", "2")
        monkeypatch.setenv("MXNET_KV_LOCAL_RANK", "0")
        monkeypatch.setenv("MXNET_KV_RELAY_PORT", str(free_port()))
        r = hierarchy.relay()
        assert r is not None and r.is_leader
        assert hierarchy.relay() is r
    finally:
        hierarchy.reset()
    monkeypatch.delenv("MXNET_KV_HIERARCHY")
    try:
        assert hierarchy.relay() is None
    finally:
        hierarchy.reset()


def test_relay_member_missing_port_raises(monkeypatch):
    hierarchy.reset()
    try:
        monkeypatch.setenv("MXNET_KV_HIERARCHY", "1")
        monkeypatch.setenv("MXNET_KV_LOCAL_SIZE", "2")
        monkeypatch.setenv("MXNET_KV_LOCAL_RANK", "1")
        monkeypatch.delenv("MXNET_KV_RELAY_PORT", raising=False)
        with pytest.raises(MXNetError, match="MXNET_KV_RELAY_PORT"):
            hierarchy.relay()
    finally:
        hierarchy.reset()


def test_trainer_rejects_update_on_kvstore_with_relay(monkeypatch):
    hierarchy.reset()
    try:
        monkeypatch.setenv("MXNET_KV_HIERARCHY", "1")
        monkeypatch.setenv("MXNET_KV_LOCAL_SIZE", "2")
        monkeypatch.setenv("MXNET_KV_LOCAL_RANK", "0")
        monkeypatch.setenv("MXNET_KV_RELAY_PORT", str(free_port()))
        net = gluon.nn.Dense(2, in_units=2)
        net.initialize(mx.init.Constant(0.5), ctx=mx.cpu())
        with pytest.raises(MXNetError, match="hierarchical host relay"):
            gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore="device",
                          update_on_kvstore=True)
    finally:
        hierarchy.reset()
