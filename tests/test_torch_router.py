"""The port's serving-fleet router against the JAX package's.

`_hash64` and the vnode ring's `_preference(model_id)` walk are exactly
the JAX router's for the same replica set (the same blake2s over the
same strings).  Then `tests/test_router.py`'s ten scenarios on the port:
health-driven ejection, probed re-admission, hedged retries, deadline
budgets, rolling deploys, over real in-process port `ServingRuntime`s
on the CPU serving a 5 -> 6 -> 3 MLP, and the one place the port departs
from the JAX router: a hedge's cancelled loser gives back its replica's
in-flight count (the JAX router leaks it, so a rolling deploy under
hedged load waits out drain_ms on every replica).
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from incubator_mxnet_tpu import router as jrouter

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import router as trouter
from incubator_mxnet_torch.deploy import export_serving, load_serving
from incubator_mxnet_torch.models import get_model
from incubator_mxnet_torch.serving import ServeConfig, ServingRuntime
from incubator_mxnet_torch.router import Replica, Router, RouterConfig

CAP = 4


def _make_artifact(tmp_path_factory, seed, name):
    mx.seed(seed)
    net = get_model("mlp", hidden=(6,), classes=3)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    x = np.random.RandomState(3).randn(CAP, 5).astype(np.float32)
    out = str(tmp_path_factory.mktemp("router") / name)
    export_serving(net, [x], out)
    return out


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return _make_artifact(tmp_path_factory, 3, "artifact_a")


@pytest.fixture(scope="module")
def artifact_b(tmp_path_factory):
    """Different weights — hedging tests tell the replicas apart by
    their OUTPUTS, the one thing a late loser could corrupt."""
    return _make_artifact(tmp_path_factory, 17, "artifact_b")


def _replica(artifact, **cfg):
    cfg.setdefault("concurrency", 1)
    rt = ServingRuntime(artifact, ServeConfig(**cfg), ctx=mx.cpu())
    port = rt.start(0)
    return rt, f"127.0.0.1:{port}"


def _router(addrs, **cfg):
    cfg.setdefault("replicas", ",".join(addrs))
    # tests drive health transitions explicitly via check_replica();
    # a long interval keeps the background loop out of the way when
    # the router is started, and routers used in-process (no start())
    # have no loop at all
    cfg.setdefault("health_interval_ms", 60000.0)
    cfg.setdefault("probe_interval_ms", 0.0)
    return Router(config=RouterConfig(**cfg))


def _rows(n, seed=0):
    return np.random.RandomState(seed).randn(n, 5).astype(np.float32)


def _body(x):
    return json.dumps({"inputs": [x.tolist()]}).encode()


def _ref(artifact, x):
    model = load_serving(artifact, ctx=mx.cpu())
    pad = np.zeros((CAP - x.shape[0], 5), np.float32)
    full = np.concatenate([x, pad]) if x.shape[0] < CAP else x
    return np.asarray(model(full)[0][:x.shape[0]])


def _outputs(body_bytes):
    return np.asarray(json.loads(body_bytes)["outputs"][0],
                      np.float32)


def _model_id_preferring(router, addr):
    """A model id whose consistent-hash walk puts `addr` first — how
    tests pin WHICH replica a request tries before any failover."""
    for i in range(512):
        mid = f"m{i}"
        if router._preference(mid)[0] == addr:
            return mid
    raise AssertionError(f"no model id prefers {addr}")


def _post(url, body, headers=None, timeout=30):
    req = urllib.request.Request(
        url, data=body, headers=headers or {}, method="POST")
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


# -- parity with the JAX router ------------------------------------------

@pytest.mark.parametrize("addrs,vnodes", [
    (["127.0.0.1:8081", "127.0.0.1:8082"], 64),
    (["10.0.0.1:9000", "10.0.0.2:9000", "10.0.0.3:9000"], 64),
    ([f"host{i}:80" for i in range(7)], 16),
    (["only:1"], 1),
])
def test_preference_walk_equals_the_jax_routers(addrs, vnodes):
    cfg = dict(replicas=",".join(addrs), vnodes=vnodes,
               health_interval_ms=60000.0, probe_interval_ms=0.0)
    ours = trouter.Router(config=trouter.RouterConfig(**cfg))
    theirs = jrouter.Router(config=jrouter.RouterConfig(**cfg))
    try:
        for mid in ["default", ""] + [f"m{i}" for i in range(200)] + \
                ["model/ünï", "x" * 300]:
            walk = ours._preference(mid)
            assert walk == theirs._preference(mid), mid
            assert sorted(walk) == sorted(addrs)
            assert trouter._hash64(mid) == jrouter._hash64(mid)
        for hdr in (None, "", "00000000deadbeef", "req-7", "zz" * 100):
            got, want = trouter._trace_of(hdr), jrouter._trace_of(hdr)
            if hdr:
                assert got == want
            else:
                assert len(got[1]) == len(want[1]) == 16
    finally:
        ours.close()
        theirs.close()


def test_router_config_fields_equal_the_jax_routers():
    assert trouter.RouterConfig._FIELDS == jrouter.RouterConfig._FIELDS
    assert (Replica.HEALTHY, Replica.EJECTED, Replica.DRAINING) == \
        (jrouter.Replica.HEALTHY, jrouter.Replica.EJECTED,
         jrouter.Replica.DRAINING)


def test_hedge_loser_gives_back_its_inflight_count(artifact, artifact_b):
    rt_slow, addr_slow = _replica(artifact_b, fault_plan="slow:*:700")
    rt_fast, addr_fast = _replica(artifact)
    router = _router([addr_slow, addr_fast], hedge_ms=50.0, retries=0)
    try:
        mid = _model_id_preferring(router, addr_slow)
        code, _, _ = router.route(_body(_rows(2, seed=8)), model_id=mid)
        assert code == 200
        assert router.replica(addr_slow).inflight == 0
        assert router.replica(addr_fast).inflight == 0
    finally:
        router.close()
        rt_slow.close()
        rt_fast.close()


# -- routing basics ------------------------------------------------------

def test_route_parity_and_affinity(artifact):
    rt_a, addr_a = _replica(artifact)
    rt_b, addr_b = _replica(artifact)
    router = _router([addr_a, addr_b])
    try:
        x = _rows(2, seed=1)
        code, body, headers = router.route(_body(x))
        assert code == 200
        np.testing.assert_array_equal(_outputs(body),
                                      _ref(artifact, x))
        assert "X-Trace-Id" in headers
        # consistent hashing: one model id always walks the ring the
        # same way
        assert router._preference("m1") == router._preference("m1")
        assert set(router._preference("m1")) == {addr_a, addr_b}
        # the statusz section a fleet scraper joins on
        st = router.statusz()
        assert {r["addr"] for r in st["replicas"]} == {addr_a, addr_b}
        assert st["healthy"] == 2
    finally:
        router.close()
        rt_a.close()
        rt_b.close()


def test_failover_on_connect_failure(artifact):
    rt_a, addr_a = _replica(artifact)
    rt_b, addr_b = _replica(artifact)
    router = _router([addr_a, addr_b], eject_failures=1)
    try:
        mid = _model_id_preferring(router, addr_a)
        rt_a.close()    # primary dies; its port now refuses connects
        x = _rows(3, seed=2)
        code, body, _ = router.route(_body(x), model_id=mid)
        assert code == 200
        np.testing.assert_array_equal(_outputs(body),
                                      _ref(artifact, x))
        # the connect failure both retried AND ejected (passive path)
        assert router.replica(addr_a).state == Replica.EJECTED
        assert router.replica(addr_a).reason == "unreachable"
    finally:
        router.close()
        rt_b.close()


# -- router × replica-breaker interplay ----------------------------------

def test_breaker_eject_before_retry_budget(artifact):
    """A replica that tripped its own breaker is ejected on the first
    503 it sheds: later requests must not spend attempts on it."""
    rt_a, addr_a = _replica(artifact, breaker_threshold=1,
                            breaker_cooldown_ms=60000.0,
                            fault_plan="fail:0")
    rt_b, addr_b = _replica(artifact)
    router = _router([addr_a, addr_b], retries=2)
    try:
        # trip A's breaker directly: its first (and only) model call
        # fails, threshold 1 opens the breaker
        code, _, _ = _post(f"http://{addr_a}/predict",
                           _body(_rows(1)))
        assert code == 500
        mid = _model_id_preferring(router, addr_a)
        x = _rows(2, seed=3)
        code, body, headers = router.route(_body(x), model_id=mid)
        assert code == 200
        np.testing.assert_array_equal(_outputs(body),
                                      _ref(artifact, x))
        # exactly A (shed breaker_open) then B — not A again
        assert headers["X-Router-Attempts"] == "2"
        rep_a = router.replica(addr_a)
        assert rep_a.state == Replica.EJECTED
        assert rep_a.reason == "breaker_open"
        # ejected means OUT: ten more requests on A's preferred id all
        # go straight to B, single attempt each
        for i in range(10):
            code, _, headers = router.route(_body(x), model_id=mid)
            assert code == 200
            assert headers["X-Router-Attempts"] == "1"
        assert rep_a.served == 0
    finally:
        router.close()
        rt_a.close()
        rt_b.close()


def test_half_open_probe_readmits(artifact):
    """Once the breaker cooldown elapses the replica reports
    half-open; the router's probe re-admits it and the next real
    request through it is the breaker's half-open probe — success
    closes the breaker and the replica is fully back."""
    rt_a, addr_a = _replica(artifact, breaker_threshold=1,
                            breaker_cooldown_ms=300.0,
                            fault_plan="fail:0")
    rt_b, addr_b = _replica(artifact)
    router = _router([addr_a, addr_b])
    try:
        code, _, _ = _post(f"http://{addr_a}/predict",
                           _body(_rows(1)))
        assert code == 500
        mid = _model_id_preferring(router, addr_a)
        code, _, _ = router.route(_body(_rows(2)), model_id=mid)
        assert code == 200
        rep_a = router.replica(addr_a)
        assert rep_a.state == Replica.EJECTED
        # inside the cooldown a probe must NOT re-admit
        router.check_replica(rep_a)
        assert rep_a.state == Replica.EJECTED
        # after the cooldown the breaker is half-open: probe re-admits
        time.sleep(0.35)
        router.check_replica(rep_a)
        assert rep_a.state == Replica.HEALTHY
        # the next request through A is its half-open probe; only
        # call 0 was poisoned, so it succeeds and closes the breaker
        x = _rows(2, seed=4)
        code, body, _ = router.route(_body(x), model_id=mid)
        assert code == 200
        np.testing.assert_array_equal(_outputs(body),
                                      _ref(artifact, x))
        assert rep_a.served == 1
        _, h = 0, json.loads(urllib.request.urlopen(
            f"http://{addr_a}/-/healthz", timeout=5).read())
        assert h["breaker"]["state"] == "closed"
    finally:
        router.close()
        rt_a.close()
        rt_b.close()


# -- hedging -------------------------------------------------------------

def test_hedge_cancels_loser(artifact, artifact_b):
    """The hedge's first answer wins and the loser's late answer never
    reaches the client: the slow primary serves DIFFERENT weights, so
    any leak of its late response would change the output bytes."""
    rt_slow, addr_slow = _replica(artifact_b,
                                  fault_plan="slow:*:700")
    rt_fast, addr_fast = _replica(artifact)
    router = _router([addr_slow, addr_fast], hedge_ms=50.0, retries=0)
    try:
        mid = _model_id_preferring(router, addr_slow)
        x = _rows(2, seed=5)
        t0 = time.monotonic()
        code, body, _ = router.route(_body(x), model_id=mid)
        elapsed = time.monotonic() - t0
        assert code == 200
        # the answer is the FAST replica's (artifact A weights), and
        # it arrived without waiting out the slow primary
        np.testing.assert_array_equal(_outputs(body),
                                      _ref(artifact, x))
        assert not np.array_equal(_outputs(body),
                                  _ref(artifact_b, x))
        assert elapsed < 0.65, f"waited for the loser: {elapsed:.3f}s"
        # the loser finishing later changes nothing client-visible
        time.sleep(0.8)
    finally:
        router.close()
        rt_slow.close()
        rt_fast.close()


# -- deadline budget -----------------------------------------------------

def test_deadline_exhausted_504_original_trace(artifact):
    """Every replica slow, deadline tiny: the router answers 504
    BEFORE any replica would, carrying the client's original trace
    id — retries never outlive X-Deadline-Ms."""
    rt_a, addr_a = _replica(artifact, fault_plan="slow:*:2000")
    rt_b, addr_b = _replica(artifact, fault_plan="slow:*:2000")
    router = _router([addr_a, addr_b], retries=2, hedge_ms=0)
    port = router.start(0)
    try:
        t0 = time.monotonic()
        code, body, headers = _post(
            f"http://127.0.0.1:{port}/predict", _body(_rows(1)),
            {"X-Deadline-Ms": "300",
             "X-Trace-Id": "feedface00112233"})
        elapsed = time.monotonic() - t0
        assert code == 504
        assert headers["X-Trace-Id"] == "feedface00112233"
        assert json.loads(body)["stage"] == "router"
        assert elapsed < 1.5, f"504 took {elapsed:.3f}s"
    finally:
        router.close()
        rt_a.close()
        rt_b.close()


# -- fleet admission -----------------------------------------------------

def test_no_replicas_sheds_503_with_retry_after(artifact):
    router = _router(["127.0.0.1:1"], eject_failures=1)
    try:
        rep = router.replica("127.0.0.1:1")
        router.check_replica(rep)
        assert rep.state == Replica.EJECTED
        code, body, headers = router.route(_body(_rows(1)))
        assert code == 503
        assert json.loads(body)["reason"] == "no_replicas"
        assert "Retry-After" in headers
    finally:
        router.close()


# -- rolling deploy ------------------------------------------------------

def test_rolling_deploy_and_rollback(artifact, artifact_b):
    rt_a, addr_a = _replica(artifact)
    rt_b, addr_b = _replica(artifact)
    router = _router([addr_a, addr_b])
    try:
        for rep in router.replicas():
            router.check_replica(rep)   # learn current artifacts
        x = _rows(2, seed=6)
        res = router.rolling_deploy(artifact_b)
        assert res["ok"], res
        assert [s["ok"] for s in res["steps"]] == [True, True]
        # both replicas answer with the NEW weights
        code, body, _ = router.route(_body(x))
        assert code == 200
        np.testing.assert_array_equal(_outputs(body),
                                      _ref(artifact_b, x))
        # a bad artifact aborts and rolls back: replicas still answer
        # with the (new) current weights afterwards
        res = router.rolling_deploy("/nonexistent/artifact")
        assert not res["ok"]
        assert res["rolled_back"] is not None
        code, body, _ = router.route(_body(x))
        assert code == 200
        np.testing.assert_array_equal(_outputs(body),
                                      _ref(artifact_b, x))
        assert router.statusz()["last_deploy"]["ok"] is False
    finally:
        router.close()
        rt_a.close()
        rt_b.close()


def test_deploy_never_drains_last_replica(artifact, artifact_b):
    rt_a, addr_a = _replica(artifact)
    router = _router([addr_a])
    try:
        router.check_replica(router.replica(addr_a))
        res = router.rolling_deploy(artifact_b)
        assert not res["ok"]
        assert "last admittable" in res["error"]
        # the lone replica was never taken out
        assert router.replica(addr_a).state == Replica.HEALTHY
    finally:
        router.close()
        rt_a.close()


# -- queue-signal (wedged replica) ejection ------------------------------

def test_saturated_replica_ejected_then_readmitted(artifact):
    """A wedged replica — still answering health checks while slow
    model calls back its queue up — is ejected off the queue debugz
    signal after N consecutive saturated polls, and re-admitted only
    once its queue has drained."""
    rt_a, addr_a = _replica(artifact, fault_plan="slow:0:1200",
                            queue_limit=1, concurrency=1)
    rt_b, addr_b = _replica(artifact)
    router = _router([addr_a, addr_b], eject_saturated_polls=2)
    try:
        rep_a = router.replica(addr_a)
        # wedge A: the micro-batcher pops up to batch-capacity (4)
        # requests into the one slow in-flight call, so send enough
        # that the queue of 1 fills behind it (the surplus is shed
        # 429 — _post tolerates that)
        wedgers = [threading.Thread(
            target=lambda: _post(f"http://{addr_a}/predict",
                                 _body(_rows(1)), timeout=30))
            for _ in range(6)]
        for t in wedgers:
            t.start()
        for _ in range(500):    # in-flight batch busy, queue full
            if rt_a.healthz()["queue"]["depth"] >= 1:
                break
            time.sleep(0.01)
        router.check_replica(rep_a)
        assert rep_a.state == Replica.HEALTHY   # one poll: not yet
        assert rep_a.sat_polls == 1
        router.check_replica(rep_a)
        assert rep_a.state == Replica.EJECTED
        assert rep_a.reason == "saturated"
        for t in wedgers:
            t.join(timeout=30)
        # queue drained (the slow plan only poisoned call 0): the
        # probe re-admits
        rep_a.last_probe = 0.0
        router.check_replica(rep_a)
        assert rep_a.state == Replica.HEALTHY
    finally:
        router.close()
        rt_a.close()
        rt_b.close()
