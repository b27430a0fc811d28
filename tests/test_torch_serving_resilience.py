"""The port's resilient serving runtime against the JAX package's.

Both packages serve the same 5 -> 6 -> 3 MLP (the JAX weights carried
into the port by `convert.params_from_jax`, capacity 4) on the CPU.
First `tests/test_serving.py`'s cases on the port (admission control,
deadlines, the circuit breaker, hot reload rollback, graceful drain,
micro-batching, trace ids, the access log, batch buckets); then both
runtimes side by side on one body sequence: the same status codes and
headers on the 200, 400, 429, 503, 504 and 409 paths, the same healthz
keys, the same serving metric families, the same access-log keys, and
outputs within rtol = atol = 1e-5 (float32 on both sides; XLA's and
torch's CPU matmuls sum in another order).  A `bert_tiny` classifier at
T = 16 (capacity 8, buckets 1, 2, 4) takes the attention path the same
way, within rtol = atol = 1e-4 (as `tests/test_torch_bert.py`: four
layers of float32 sums in another order).

Batch buckets on the CPU: torch's matmul takes another kernel for a
1-row batch than for a 4-row one (and bert_tiny's rows differ at every
batch size), so a bucketed row is not bit for bit the flat path's row
as it is in the JAX package.  The port is held bit for bit to a direct
call at the same pad target, and to the flat path within 1e-6 relative
of the largest output (measured: 1.9e-8 absolute on this MLP).
"""
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.deploy import export_serving as jexport_serving

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import telemetry
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.deploy import export_serving, load_serving
from incubator_mxnet_torch.models import get_model
from incubator_mxnet_torch.serving import (CircuitBreaker, ServeConfig,
                                           ServingRuntime)

CAP = 4     # artifact batch capacity
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_mlp(seed):
    mxj.seed(seed)
    np.random.seed(seed)
    net = mxj.gluon.nn.HybridSequential()
    net.add(mxj.gluon.nn.Dense(6, activation="relu"),
            mxj.gluon.nn.Dense(3))
    net.initialize(mxj.init.Xavier())
    net(mxj.nd.array(np.zeros((1, 5), np.float32)))
    return net


def _export_pair(tmp_path_factory, seed, name, cap=CAP, buckets=None):
    """(port artifact, JAX artifact) of the same weights."""
    jnet = _jax_mlp(seed)
    x = np.random.RandomState(3).randn(cap, 5).astype(np.float32)
    d = tmp_path_factory.mktemp("serving")
    jout = str(d / f"{name}_jax")
    jexport_serving(jnet, [mxj.nd.array(x)], jout, platforms=["cpu"],
                    batch_buckets=buckets)
    net = get_model("mlp", hidden=(6,), classes=3)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    params_from_jax(net, {k: v.data().asnumpy() for k, v in
                          jnet._collect_params_with_prefix().items()},
                    ctx=mx.cpu())
    out = str(d / name)
    export_serving(net, [x], out, batch_buckets=buckets)
    return out, jout


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _export_pair(tmp_path_factory, 3, "artifact")


@pytest.fixture(scope="module")
def artifact(pair):
    return pair[0]


def _runtime(artifact, **cfg):
    cfg.setdefault("concurrency", 1)
    rt = ServingRuntime(artifact, ServeConfig(**cfg), ctx=mx.cpu())
    port = rt.start(0)
    return rt, f"http://127.0.0.1:{port}"


def _jruntime(artifact, **cfg):
    cfg.setdefault("concurrency", 1)
    rt = jserving.ServingRuntime(artifact, jserving.ServeConfig(**cfg))
    port = rt.start(0)
    return rt, f"http://127.0.0.1:{port}"


def _post(base, body, headers=None, path="/predict", timeout=30):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {})
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(base, path, timeout=10):
    try:
        r = urllib.request.urlopen(base + path, timeout=timeout)
        return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _rows(n, seed=0):
    return np.random.RandomState(seed).randn(n, 5).astype(np.float32)


def _ref_outputs(artifact, x):
    """Direct load_serving outputs for rows x, batch-padded the same
    way the runtime pads."""
    model = load_serving(artifact, ctx=mx.cpu())
    pad = np.zeros((CAP - x.shape[0], 5), np.float32)
    full = np.concatenate([x, pad]) if x.shape[0] < CAP else x
    return [np.asarray(o[:x.shape[0]]) for o in model(full)]


# -- happy path + endpoints ---------------------------------------------

def test_predict_parity_and_endpoints(artifact):
    rt, base = _runtime(artifact)
    try:
        x = _rows(2, seed=1)
        code, body, _ = _post(base, {"inputs": [x.tolist()]})
        assert code == 200
        got = np.asarray(body["outputs"][0], np.float32)
        np.testing.assert_array_equal(got, _ref_outputs(artifact, x)[0])
        assert _get(base, "/-/readyz")[0] == 200
        code, raw = _get(base, "/-/healthz")
        health = json.loads(raw)
        assert code == 200 and health["status"] == "ok"
        assert health["breaker"]["state"] == "closed"
        assert health["model"]["batch_capacity"] == CAP
        code, raw = _get(base, "/metrics")
        assert code == 200
        assert b"serving_http_requests_total" in raw
        assert b"serving_queue_depth" in raw
        assert _get(base, "/nope")[0] == 404
    finally:
        rt.close()


def test_bad_inputs_are_400_not_breaker_food(artifact):
    rt, base = _runtime(artifact, breaker_threshold=1)
    try:
        assert _post(base, b"{not json")[0] == 400
        assert _post(base, {"nope": 1})[0] == 400
        assert _post(base, {"inputs": [[[1.0, 2.0]]]})[0] == 400
        assert _post(base, {"inputs": []})[0] == 400
        # ragged rows
        assert _post(base, {"inputs": [[[1, 2, 3, 4, 5], [1]]]})[0] == 400
        assert rt.breaker.state == "closed"     # validation != poison
        x = _rows(1)
        assert _post(base, {"inputs": [x.tolist()]})[0] == 200
    finally:
        rt.close()


# -- admission control ---------------------------------------------------

def test_queue_full_sheds_429_with_retry_after(artifact):
    rt, base = _runtime(artifact, queue_limit=2,
                        fault_plan="slow:*:400", deadline_ms=5000)
    try:
        x = _rows(CAP)      # full batches: no coalescing headroom
        results = []

        def fire():
            results.append(_post(base, {"inputs": [x.tolist()]}))

        threads = [threading.Thread(target=fire) for _ in range(6)]
        for t in threads:
            t.start()
            time.sleep(0.02)    # first wedges in-flight, rest pile up
        for t in threads:
            t.join(timeout=30)
        codes = sorted(c for c, _, _ in results)
        assert codes.count(429) >= 1, codes
        for code, body, headers in results:
            if code == 429:
                assert body["reason"] == "queue_full"
                assert int(headers["Retry-After"]) >= 1
        tele = telemetry.REGISTRY.value("serving_shed",
                                        reason="queue_full")
        assert tele and tele >= 1
    finally:
        rt.close()


# -- deadlines -----------------------------------------------------------

def test_inflight_deadline_504(artifact):
    rt, base = _runtime(artifact, fault_plan="slow:*:500")
    try:
        t0 = time.monotonic()
        code, body, _ = _post(base, {"inputs": [_rows(1).tolist()]},
                              headers={"X-Deadline-Ms": "100"})
        assert code == 504 and body["stage"] == "inflight"
        assert time.monotonic() - t0 < 0.45     # answered AT the
        #                                         deadline, not after the
        #                                         500ms call finished
    finally:
        rt.close()


def test_queued_deadline_504(artifact):
    rt, base = _runtime(artifact, fault_plan="slow:0:600",
                        queue_limit=8, deadline_ms=5000)
    try:
        x = _rows(CAP)
        slow = threading.Thread(target=_post, args=(
            base, {"inputs": [x.tolist()]}))
        slow.start()
        time.sleep(0.15)        # worker wedged in call 0
        code, body, _ = _post(base, {"inputs": [x.tolist()]},
                              headers={"X-Deadline-Ms": "100"})
        assert code == 504 and body["stage"] == "queued"
        slow.join(timeout=10)
    finally:
        rt.close()


def test_deadline_shorter_than_warmup(artifact):
    """A cold model (no startup warmup: the first call pays the kernel
    builds and allocator growth, emulated with slow:0) must still answer a
    tiny-deadline request with 504, then serve normally once warm."""
    rt = ServingRuntime(artifact,
                        ServeConfig(concurrency=1, fault_plan="slow:0:400"),
                        warm=False, ctx=mx.cpu())
    base = f"http://127.0.0.1:{rt.start(0)}"
    try:
        code, body, _ = _post(base, {"inputs": [_rows(1).tolist()]},
                              headers={"X-Deadline-Ms": "50"})
        assert code == 504
        code, _, _ = _post(base, {"inputs": [_rows(1).tolist()]})
        assert code == 200
    finally:
        rt.close()


# -- circuit breaker -----------------------------------------------------

def test_breaker_unit_state_machine():
    br = CircuitBreaker(threshold=2, cooldown_s=0.1)
    assert br.admit() == (True, 0.0, False)
    br.record_failure(RuntimeError("a"))
    assert br.state == "closed"
    br.record_failure(RuntimeError("b"))
    assert br.state == "open"
    ok, retry, _ = br.admit()
    assert not ok and 0 < retry <= 0.1
    time.sleep(0.12)
    ok, _, probe = br.admit()
    assert ok and probe                     # half-open: one probe
    assert br.admit()[0] is False           # second request while probing
    br.record_failure(RuntimeError("probe failed"))
    assert br.state == "open"               # re-opened, fresh cooldown
    time.sleep(0.12)
    ok, _, probe = br.admit()
    assert ok and probe
    br.record_success(probe=probe)
    assert br.state == "closed" and br.last_error is None


def test_breaker_half_open_only_probe_success_closes():
    """While the probe is out, a straggler success from a pre-trip call
    on another worker must not close the breaker — only the probe's
    outcome may."""
    br = CircuitBreaker(threshold=1, cooldown_s=0.05)
    br.record_failure(RuntimeError("poison"))
    time.sleep(0.07)
    ok, _, probe = br.admit()
    assert ok and probe                     # half-open, probe in flight
    br.record_success()                     # straggler, NOT the probe
    assert br.state == "half-open"
    br.record_success(probe=probe)          # the probe's verdict
    assert br.state == "closed"


def test_wedged_probe_lease_reclaimed_and_stale_token_ignored():
    """A probe whose forward pass never returns must not pin the
    breaker half-open forever: after a full cooldown the slot is
    reclaimed, and the stale probe's token no longer releases or
    closes anything."""
    br = CircuitBreaker(threshold=1, cooldown_s=0.05)
    br.record_failure(RuntimeError("poison"))
    time.sleep(0.07)
    ok, _, p1 = br.admit()
    assert ok and p1
    assert br.admit()[0] is False       # within the lease: no 2nd probe
    time.sleep(0.07)                    # lease (one cooldown) expires
    ok, _, p2 = br.admit()
    assert ok and p2 and p2 != p1       # slot reclaimed, fresh token
    br.release_probe(p1)                # stale release: must be a no-op
    assert br.admit()[0] is False       # p2 still holds the slot
    br.record_success(probe=p1)         # stale success: ignored
    assert br.state == "half-open"
    br.record_success(probe=p2)
    assert br.state == "closed"


def test_describe_reports_half_open_after_cooldown():
    """healthz must not show a stuck-'open' breaker on a server whose
    cooldown elapsed and will admit the next request as a probe."""
    br = CircuitBreaker(threshold=1, cooldown_s=0.05)
    br.record_failure(RuntimeError("x"))
    d = br.describe()
    assert d["state"] == "open" and d["retry_after_s"] > 0
    time.sleep(0.07)
    d = br.describe()
    assert d["state"] == "half-open" and "retry_after_s" not in d


def test_abandoned_queue_corpses_do_not_shed_fresh_requests(artifact):
    """Requests that 504'd while queued sit in the deque until a worker
    pops them; they must not count against the queue bound, or wedged
    workers + short-deadline retries would 429 every fresh request."""
    rt, base = _runtime(artifact, queue_limit=2, fault_plan="slow:*:500",
                        deadline_ms=8000)
    try:
        x = _rows(CAP)      # full batches: no coalescing
        blocker = threading.Thread(target=_post, args=(
            base, {"inputs": [x.tolist()]}))
        blocker.start()
        time.sleep(0.15)            # worker wedged in a slow call
        corpses = [threading.Thread(target=_post, args=(
            base, {"inputs": [x.tolist()]},
            {"X-Deadline-Ms": "100"})) for _ in range(2)]
        for t in corpses:
            t.start()
        for t in corpses:
            t.join(timeout=10)      # both 504 queued -> abandoned,
        #                             still occupying the full queue
        code, body, _ = _post(base, {"inputs": [x.tolist()]})
        assert code == 200, (code, body)    # culled, not 429
        blocker.join(timeout=10)
    finally:
        rt.close()


def test_breaker_open_ignores_straggler_success():
    """A success from a call that STARTED before the trip (e.g. a slow
    but healthy call on another worker) must not close an open breaker
    — only the half-open probe's outcome may."""
    br = CircuitBreaker(threshold=1, cooldown_s=10)
    br.record_failure(RuntimeError("poison"))
    assert br.state == "open"
    br.record_success()                 # straggler from pre-trip
    assert br.state == "open"
    assert br.admit()[0] is False       # cooldown still enforced


def test_breaker_trips_half_open_probe_paths(artifact):
    rt, base = _runtime(artifact, breaker_threshold=2,
                        breaker_cooldown_ms=250,
                        fault_plan="fail:0,fail:1,fail:2")
    try:
        x = {"inputs": [_rows(1).tolist()]}
        assert _post(base, x)[0] == 500         # call 0
        assert _post(base, x)[0] == 500         # call 1 -> trips
        code, body, headers = _post(base, x)
        assert code == 503 and body["reason"] == "breaker_open"
        assert int(headers["Retry-After"]) >= 1
        health = json.loads(_get(base, "/-/healthz")[1])
        assert health["breaker"]["state"] == "open"
        assert "injected model fault" in health["breaker"]["last_error"]
        time.sleep(0.3)
        assert _post(base, x)[0] == 500         # probe (call 2) fails
        health = json.loads(_get(base, "/-/healthz")[1])
        assert health["breaker"]["state"] == "open"     # re-opened
        time.sleep(0.3)
        assert _post(base, x)[0] == 200         # probe succeeds
        health = json.loads(_get(base, "/-/healthz")[1])
        assert health["breaker"]["state"] == "closed"
        trips = telemetry.REGISTRY.value("serving_breaker_trips")
        assert trips and trips >= 2
    finally:
        rt.close()


def test_batch_assembly_failure_releases_probe(artifact):
    """A half-open probe that dies in batch assembly (409 path) never
    reaches the model, so it must release the probe slot — otherwise
    the breaker wedges half-open and sheds 503 forever."""
    from incubator_mxnet_torch.serving import _Request
    rt, base = _runtime(artifact, breaker_threshold=1,
                        breaker_cooldown_ms=100, fault_plan="fail:0")
    try:
        assert _post(base, {"inputs": [_rows(1).tolist()]})[0] == 500
        assert rt.breaker.state == "open"
        time.sleep(0.15)
        ok, _, probe = rt.breaker.admit()
        assert ok and probe
        bad = _Request([_rows(CAP + 1)], CAP + 1,
                       time.monotonic() + 5, probe=probe)
        rt._run_batch([bad])        # rows > capacity -> 409, no model call
        assert bad.status == 409
        ok, _, probe = rt.breaker.admit()       # slot freed: can probe
        assert ok and probe
        rt.breaker.release_probe()
    finally:
        rt.close()


# -- hot reload ----------------------------------------------------------

def test_reload_rollback_keeps_old_model_bit_identical(artifact,
                                                       tmp_path):
    corrupt = str(tmp_path / "corrupt")
    shutil.copytree(artifact, corrupt)
    with open(os.path.join(corrupt, "params.npz"), "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))

    rt, base = _runtime(artifact)
    try:
        x = _rows(2, seed=9)
        before = _post(base, {"inputs": [x.tolist()]})[1]
        code, body, _ = _post(base, {"artifact_dir": corrupt},
                              path="/-/reload")
        assert code == 500 and not body["ok"]
        assert "params.npz" in body["error"]
        assert body["rolled_back_to"] == artifact
        health = json.loads(_get(base, "/-/healthz")[1])
        assert not health["last_reload"]["ok"]
        assert health["model"]["artifact_dir"] == artifact
        after = _post(base, {"inputs": [x.tolist()]})[1]
        assert before == after      # bit-identical through the rollback
        # a GOOD reload still swaps
        code, body, _ = _post(base, {}, path="/-/reload")
        assert code == 200 and body["ok"]
        assert telemetry.REGISTRY.value("serving_reloads",
                                        result="failed") >= 1
        assert telemetry.REGISTRY.value("serving_reloads",
                                        result="ok") >= 1
    finally:
        rt.close()


def test_reload_missing_artifact_rolls_back(artifact):
    rt, base = _runtime(artifact)
    try:
        code, body, _ = _post(base, {"artifact_dir": "/nonexistent/x"},
                              path="/-/reload")
        assert code == 500 and not body["ok"]
        # non-dict JSON bodies must 400, not crash the handler
        for bad in (b"[1]", b'"x"', b"123"):
            code, body, _ = _post(base, bad, path="/-/reload")
            assert code == 400, (bad, code, body)
        assert _post(base, {"inputs": [_rows(1).tolist()]})[0] == 200
    finally:
        rt.close()


# -- graceful drain ------------------------------------------------------

def test_drain_full_queue_queued_503_inflight_finish(artifact):
    rt, base = _runtime(artifact, queue_limit=8,
                        fault_plan="slow:0:500", deadline_ms=10000)
    try:
        x = _rows(CAP)      # full batches: queued ones can't coalesce
        results = {}

        def fire(name):
            results[name] = _post(base, {"inputs": [x.tolist()]})

        inflight = threading.Thread(target=fire, args=("inflight",))
        inflight.start()
        time.sleep(0.15)            # inside the slow call 0
        queued = [threading.Thread(target=fire, args=(f"q{i}",))
                  for i in range(3)]
        for t in queued:
            t.start()
        time.sleep(0.1)             # all three are parked in the queue
        rt.begin_drain()
        assert _get(base, "/-/readyz")[0] == 503
        health = json.loads(_get(base, "/-/healthz")[1])
        assert health["status"] == "draining"
        for t in queued + [inflight]:
            t.join(timeout=15)
        assert results["inflight"][0] == 200        # finished the work
        for i in range(3):
            code, body, _ = results[f"q{i}"]
            assert code == 503 and body["reason"] == "draining"
        assert rt.drain(5.0)                        # clean drain
        # post-drain submissions shed too
        assert _post(base, {"inputs": [x.tolist()]})[0] == 503
    finally:
        rt.close()


# -- micro-batching ------------------------------------------------------

def test_micro_batching_coalesces_and_splits_correctly(artifact):
    rt, base = _runtime(artifact, queue_limit=16,
                        fault_plan="slow:0:400", deadline_ms=10000)
    try:
        calls_before = telemetry.REGISTRY.value("serving_model_calls") or 0
        blocker = threading.Thread(target=_post, args=(
            base, {"inputs": [_rows(CAP).tolist()]}))
        blocker.start()
        time.sleep(0.15)            # worker wedged: next 3 pile up
        xs = [_rows(1, seed=20 + i) for i in range(3)]
        results = [None] * 3

        def fire(i):
            results[i] = _post(base, {"inputs": [xs[i].tolist()]})

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
            time.sleep(0.02)        # deterministic queue order
        for t in threads:
            t.join(timeout=15)
        blocker.join(timeout=15)
        # every request got ITS OWN rows back, batched or not
        for i in range(3):
            code, body, _ = results[i]
            assert code == 200
            got = np.asarray(body["outputs"][0], np.float32)
            np.testing.assert_array_equal(
                got, _ref_outputs(rt.artifact_dir, xs[i])[0])
        # 3 single-row requests rode at most 2 jitted calls (the
        # blocker's plus a coalesced one) — not one call each
        calls = telemetry.REGISTRY.value("serving_model_calls")
        assert calls - calls_before <= 3, calls - calls_before
    finally:
        rt.close()


def test_oversize_rows_rejected(artifact):
    rt, base = _runtime(artifact)
    try:
        code, body, _ = _post(
            base, {"inputs": [_rows(CAP + 1).tolist()]})
        assert code == 400 and "rows" in body["error"]
    finally:
        rt.close()


def test_nonfinite_deadline_header_rejected(artifact):
    """inf/nan deadlines would defeat every `now >= deadline` check —
    the one way to get a truly hung connection.  Must 400."""
    rt, base = _runtime(artifact)
    try:
        x = {"inputs": [_rows(1).tolist()]}
        for bad in ("nan", "inf", "-inf", "0", "-5", "bogus"):
            code, body, _ = _post(base, x,
                                  headers={"X-Deadline-Ms": bad})
            assert code == 400, (bad, code, body)
        assert _post(base, x, headers={"X-Deadline-Ms": "5000"})[0] == 200
    finally:
        rt.close()


def test_404_paths_do_not_mint_telemetry_labels(artifact):
    rt, base = _runtime(artifact)
    try:
        for i in range(5):
            assert _get(base, f"/scan-{i}")[0] == 404
        text = telemetry.prometheus_text()
        assert "scan-" not in text
        assert 'path="other"' in text
    finally:
        rt.close()


def test_reload_shrinks_capacity_queued_request_409_worker_survives(
        artifact, tmp_path_factory):
    """A request validated against the OLD slot that no longer fits the
    hot-reloaded one must answer 409 — and must not kill the worker."""
    small, _ = _export_pair(tmp_path_factory, 4, "small", cap=2)

    rt, base = _runtime(artifact, fault_plan="slow:0:500",
                        deadline_ms=10000, queue_limit=8)
    try:
        blocker = threading.Thread(target=_post, args=(
            base, {"inputs": [_rows(CAP).tolist()]}))
        blocker.start()
        time.sleep(0.15)        # worker wedged in call 0
        results = {}
        queued = threading.Thread(
            target=lambda: results.update(
                q=_post(base, {"inputs": [_rows(CAP).tolist()]})))
        queued.start()          # CAP=4 rows: valid now, not after swap
        time.sleep(0.1)
        code, body, _ = _post(base, {"artifact_dir": small},
                              path="/-/reload")
        assert code == 200 and body["ok"], body
        queued.join(timeout=15)
        blocker.join(timeout=15)
        code, body, _ = results["q"]
        assert code == 409 and "capacity" in body["error"], (code, body)
        # the worker survived: a request sized for the NEW slot serves
        code, _, _ = _post(base, {"inputs": [_rows(2).tolist()]})
        assert code == 200
    finally:
        rt.close()


# -- tracing: X-Trace-Id, access log, /-/debug/traces --------------------

def test_trace_id_assigned_and_echoed_on_200(artifact):
    rt, base = _runtime(artifact)
    try:
        code, _, headers = _post(base, {"inputs": [_rows(1).tolist()]})
        assert code == 200
        assert len(headers["X-Trace-Id"]) == 16     # assigned hex id
        code, _, headers = _post(base, {"inputs": [_rows(1).tolist()]},
                                 headers={"X-Trace-Id": "req-77-abc"})
        assert code == 200
        assert headers["X-Trace-Id"] == "req-77-abc"    # echoed verbatim
    finally:
        rt.close()


def test_trace_id_on_504_shed_path(artifact):
    """A deadline miss must still be correlatable: the 504 carries the
    client's trace id on both the queued and in-flight stages."""
    rt, base = _runtime(artifact, fault_plan="slow:*:500")
    try:
        code, body, headers = _post(base, {"inputs": [_rows(1).tolist()]},
                                    headers={"X-Deadline-Ms": "100",
                                             "X-Trace-Id": "deadbeef0504"})
        assert code == 504 and body["stage"] == "inflight"
        assert headers["X-Trace-Id"] == "deadbeef0504"
    finally:
        rt.close()


def test_trace_id_on_429_shed_path(artifact):
    """Queue-full sheds answer BEFORE parsing the body, but still mint
    (or echo) a trace id."""
    rt, base = _runtime(artifact, queue_limit=2, fault_plan="slow:*:400",
                        deadline_ms=5000)
    try:
        x = _rows(CAP)
        results = []

        def fire(i):
            results.append(_post(base, {"inputs": [x.tolist()]},
                                 headers={"X-Trace-Id": f"burst-{i}"}))

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
            time.sleep(0.02)
        for t in threads:
            t.join(timeout=30)
        shed = [(c, h) for c, _, h in results if c == 429]
        assert shed, [c for c, _, _ in results]
        for _, headers in shed:
            assert headers["X-Trace-Id"].startswith("burst-")
    finally:
        rt.close()


def test_access_log_jsonl_lines(artifact, tmp_path):
    """MXNET_SERVE_ACCESS_LOG: one JSONL line per answered request —
    trace id, status, queue-wait, exec time, batch rows, deadline
    left — for 200s and shed 504s alike."""
    log = str(tmp_path / "access.jsonl")
    rt, base = _runtime(artifact, access_log=log)
    try:
        code, _, _ = _post(base, {"inputs": [_rows(2).tolist()]},
                           headers={"X-Trace-Id": "okreq"})
        assert code == 200
        code, _, _ = _post(base, {"inputs": [_rows(1).tolist()]},
                           headers={"X-Deadline-Ms": "0.001",
                                    "X-Trace-Id": "lateeq"})
        assert code == 504
    finally:
        rt.close()
    with open(log) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert len(lines) == 2
    by_trace = {ln["trace_id"]: ln for ln in lines}
    ok = by_trace["okreq"]
    assert ok["status"] == 200
    assert ok["batch"] >= 2                     # coalesced rows
    assert ok["exec_ms"] > 0
    assert ok["queue_wait_ms"] >= 0
    late = by_trace["lateeq"]
    assert late["status"] == 504
    assert late["deadline_left_ms"] <= 0
    for ln in lines:
        assert set(("time", "path", "trace_id", "status",
                    "queue_wait_ms", "exec_ms", "batch",
                    "deadline_left_ms")) <= set(ln)


def test_debug_traces_endpoint(artifact):
    from incubator_mxnet_torch import tracing
    tracing.reset()
    tracing.set_enabled(True)
    rt, base = _runtime(artifact)
    try:
        code, _, _ = _post(base, {"inputs": [_rows(1).tolist()]},
                           headers={"X-Trace-Id": "0123456789abcdef"})
        assert code == 200
        code, raw = _get(base, "/-/debug/traces")
        assert code == 200
        doc = json.loads(raw)
        assert doc["tracing_enabled"] is True
        assert any(r["trace_id"] == "0123456789abcdef"
                   for r in doc["recent_requests"])
        tr = next(t for t in doc["traces"]
                  if t["trace_id"] == "0123456789abcdef")
        names = {s["name"] for s in tr["spans"]}
        assert {"serve.request", "serve.queue_wait",
                "serve.model_call"} <= names
        req = next(s for s in tr["spans"] if s["name"] == "serve.request")
        call = next(s for s in tr["spans"]
                    if s["name"] == "serve.model_call")
        assert call["parent_id"] == req["span_id"]
    finally:
        rt.close()
        tracing.set_enabled(False)
        tracing.reset()


# -- per-shape padding buckets -------------------------------------------

@pytest.fixture(scope="module")
def bucketed_artifact(tmp_path_factory):
    """Same weights as `artifact` (same seeds), plus batch buckets 1
    and 2 listed beside the capacity 4."""
    return _export_pair(tmp_path_factory, 3, "bucketed", buckets=[1, 2])[0]


def _pad(x, target):
    return np.concatenate([x, np.zeros((target - x.shape[0],) + x.shape[1:],
                                       x.dtype)]) if x.shape[0] < target \
        else x


def test_bucketed_parity(artifact, bucketed_artifact):
    """Mixed-size traffic through the bucketed artifact: every row is
    bit for bit a direct call at its pad target, and within 1e-6 of the
    largest output of the unbucketed runtime's row."""
    with open(os.path.join(bucketed_artifact, "meta.json")) as f:
        meta = json.load(f)
    assert meta["batch_buckets"] == [1, 2]
    with open(os.path.join(bucketed_artifact, "manifest.json")) as f:
        manifest = json.load(f)["files"]
    assert set(manifest) == {"meta.json", "params.npz"}   # no bucket files
    model = load_serving(bucketed_artifact, ctx=mx.cpu())
    assert sorted(model.buckets) == [1, 2]
    rt_flat, base_flat = _runtime(artifact, batch_buckets=0)
    rt_bkt, base_bkt = _runtime(bucketed_artifact)
    try:
        for n in range(1, CAP + 1):
            x = _rows(n, seed=40 + n)
            body = {"inputs": [x.tolist()]}
            code_f, out_f, _ = _post(base_flat, body)
            code_b, out_b, _ = _post(base_bkt, body)
            assert (code_f, code_b) == (200, 200)
            a = np.asarray(out_f["outputs"][0], np.float32)
            b = np.asarray(out_b["outputs"][0], np.float32)
            target = next((k for k in (1, 2) if k >= n), CAP)
            call = model.buckets.get(target, model)
            direct = call(_pad(x, target))[0][:n]
            assert b.tobytes() == direct.tobytes(), f"rows={n}"
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-6 * np.abs(a).max())
        code, raw = _get(base_bkt, "/-/healthz")
        assert json.loads(raw)["model"]["batch_buckets"] == [1, 2]
        pads = telemetry.REGISTRY.get("serving_batch_pad_rows")
        assert pads is not None and pads.count >= 2 * CAP
    finally:
        rt_flat.close()
        rt_bkt.close()


def test_buckets_disabled_by_config(bucketed_artifact):
    """MXNET_SERVE_BUCKETS=0 pads to capacity even when the artifact
    lists buckets: a 2-row request then runs the full-capacity call."""
    model = load_serving(bucketed_artifact, ctx=mx.cpu())
    rt_on, base_on = _runtime(bucketed_artifact)
    rt_off, base_off = _runtime(bucketed_artifact, batch_buckets=0)
    try:
        x = _rows(2, seed=50)
        body = {"inputs": [x.tolist()]}
        _, out_on, _ = _post(base_on, body)
        _, out_off, _ = _post(base_off, body)
        a = np.asarray(out_on["outputs"][0], np.float32)
        b = np.asarray(out_off["outputs"][0], np.float32)
        assert a.tobytes() == model.buckets[2](x)[0].tobytes()
        assert b.tobytes() == model(_pad(x, CAP))[0][:2].tobytes()
        assert rt_off.healthz()["model"]["batch_buckets"] == [1, 2]
    finally:
        rt_on.close()
        rt_off.close()


def test_export_rejects_buckets_without_a_batch_dim(tmp_path):
    net = get_model("mlp", hidden=(6,), classes=3)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    export_serving(net, [_rows(1)], str(tmp_path / "init"))
    with pytest.raises(mx.MXNetError, match="batch dimension"):
        export_serving(net, [np.zeros((5,), np.float32)],
                       str(tmp_path / "a"), batch_buckets=[1])
    out = export_serving(net, [_rows(CAP)], str(tmp_path / "b"),
                         batch_buckets=[0, 2, 2, CAP, CAP + 3])
    with open(os.path.join(out, "meta.json")) as f:
        assert json.load(f)["batch_buckets"] == [2]


# -- the port and the JAX runtime side by side ---------------------------

def _both(pair, **cfg):
    return _runtime(pair[0], **cfg), _jruntime(pair[1], **cfg)


def _families(base, prefix="serving_"):
    text = _get(base, "/metrics")[1].decode()
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ") and ln.split()[2].startswith(prefix)}


def _keys(d, skip=()):
    """The key tree of a JSON object, less `skip` (dotted paths)."""
    out = set()
    for k, v in d.items():
        if k in skip:
            continue
        out.add(k)
        if isinstance(v, dict):
            sub = tuple(s.split(".", 1)[1] for s in skip
                        if s.startswith(k + "."))
            out |= {f"{k}.{x}" for x in _keys(v, sub)}
    return out


# the port's healthz adds the model's device and model_calls
PORT_ONLY = ("model_calls", "model.device")


def test_side_by_side_200_400_503_504_paths(pair, tmp_path):
    cfg = dict(breaker_threshold=2, breaker_cooldown_ms=300.0,
               fault_plan="slow:1:600,fail:2,fail:3")
    (rt, base), (jrt, jbase) = _both(
        pair, access_log=str(tmp_path / "port.jsonl"), **cfg)
    jrt._cfg.access_log = str(tmp_path / "jax.jsonl")
    x = _rows(2, seed=61)
    steps = [
        ("ok", {"inputs": [x.tolist()]}, {"X-Trace-Id": "client-a"}),
        ("late", {"inputs": [x.tolist()]},
         {"X-Deadline-Ms": "150", "X-Trace-Id": "feed0504"}),
        ("json", b"{not json", {}),
        ("shape", {"inputs": [[[1.0, 2.0]]]}, {}),
        ("deadline", {"inputs": [x.tolist()]}, {"X-Deadline-Ms": "nan"}),
        ("poison", {"inputs": [x.tolist()]}, {}),
        ("poison", {"inputs": [x.tolist()]}, {}),
        ("open", {"inputs": [x.tolist()]}, {"X-Trace-Id": "shed-1"}),
    ]
    try:
        seen = {}
        for name, body, hdrs in steps:
            got = _post(base, body, hdrs)
            want = _post(jbase, body, hdrs)
            assert got[0] == want[0], (name, got, want)
            for h in ("Retry-After", "X-Trace-Id"):
                assert (h in got[2]) == (h in want[2]), (name, h)
            if "X-Trace-Id" in hdrs:
                assert got[2]["X-Trace-Id"] == want[2]["X-Trace-Id"] == \
                    hdrs["X-Trace-Id"]
            for k in ("reason", "stage"):
                assert got[1].get(k) == want[1].get(k), (name, k)
            seen[name] = got[0]
            if name == "late":
                time.sleep(0.6)         # the slow call finishes
        assert seen == {"ok": 200, "late": 504, "json": 400, "shape": 400,
                        "deadline": 400, "poison": 500, "open": 503}
        time.sleep(0.35)                # cooldown -> half-open probe
        got = _post(base, {"inputs": [x.tolist()]})
        want = _post(jbase, {"inputs": [x.tolist()]})
        assert got[0] == want[0] == 200
        np.testing.assert_allclose(np.asarray(got[1]["outputs"][0]),
                                   np.asarray(want[1]["outputs"][0]), **TOL)
        h, jh = rt.healthz(), jrt.healthz()
        assert _keys(h, PORT_ONLY) == _keys(jh)
        assert h["breaker"]["state"] == jh["breaker"]["state"] == "closed"
        fams = _families(base)
        assert fams == _families(jbase)
        assert {"serving_shed_total", "serving_breaker_trips_total",
                "serving_deadline_timeouts_total",
                "serving_batch_pad_rows"} <= fams
    finally:
        rt.close()
        jrt.close()
    logs = []
    for name in ("port", "jax"):
        with open(tmp_path / f"{name}.jsonl") as f:
            logs.append([json.loads(ln) for ln in f if ln.strip()])
    assert [ln["status"] for ln in logs[0]] == \
        [ln["status"] for ln in logs[1]]
    for a, b in zip(*logs):
        assert set(a) == set(b)
    client = {"client-a", "feed0504", "shed-1"}
    for log in logs:
        assert client <= {ln["trace_id"] for ln in log}


def test_side_by_side_429_path(pair):
    (rt, base), (jrt, jbase) = _both(pair, queue_limit=1,
                                     fault_plan="slow:*:400",
                                     deadline_ms=8000)
    try:
        for b in (base, jbase):
            results = []

            def fire(i, b=b, results=results):
                results.append(_post(b, {"inputs": [_rows(CAP).tolist()]},
                                     {"X-Trace-Id": f"burst-{i}"}))

            threads = [threading.Thread(target=fire, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
                time.sleep(0.02)
            for t in threads:
                t.join(timeout=30)
            codes = {c for c, _, _ in results}
            assert 429 in codes and codes <= {200, 429}, codes
            for code, body, headers in results:
                assert headers["X-Trace-Id"].startswith("burst-")
                if code == 429:
                    assert body["reason"] == "queue_full"
                    assert int(headers["Retry-After"]) >= 1
    finally:
        rt.close()
        jrt.close()


def test_side_by_side_409_after_reload(pair, tmp_path_factory):
    small = _export_pair(tmp_path_factory, 4, "small_both", cap=2)
    (rt, base), (jrt, jbase) = _both(pair, fault_plan="slow:0:500",
                                     deadline_ms=10000, queue_limit=8)
    try:
        codes = []
        for b, target in ((base, small[0]), (jbase, small[1])):
            results = {}
            blocker = threading.Thread(target=_post, args=(
                b, {"inputs": [_rows(CAP).tolist()]}))
            blocker.start()
            time.sleep(0.15)
            queued = threading.Thread(target=lambda b=b: results.update(
                q=_post(b, {"inputs": [_rows(CAP).tolist()]})))
            queued.start()
            time.sleep(0.1)
            code, body, _ = _post(b, {"artifact_dir": target},
                                  path="/-/reload")
            assert code == 200 and body["ok"], body
            queued.join(timeout=15)
            blocker.join(timeout=15)
            codes.append(results["q"][0])
            assert "capacity" in results["q"][1]["error"]
            codes.append(_post(b, {"inputs": [_rows(2).tolist()]})[0])
        assert codes == [409, 200, 409, 200]
    finally:
        rt.close()
        jrt.close()


# -- bert_tiny through both runtimes: the attention path ------------------

VOCAB, T, BERT_CAP = 200, 16, 8
BERT_TOL = dict(rtol=1e-4, atol=1e-4)


def _bert_rows(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n, T)).astype(np.int32),
            rng.randint(0, 2, (n, T)).astype(np.int32),
            rng.randint(0, T + 1, (n,)).astype(np.int32)]


@pytest.fixture(scope="module")
def bert_pair(tmp_path_factory):
    from incubator_mxnet_tpu.models.bert import (
        get_bert_model as jax_get_bert_model, BERTClassifier)
    mxj.random.seed(0)
    jnet = BERTClassifier(jax_get_bert_model(
        "bert_tiny", vocab_size=VOCAB, max_length=T, dropout=0.0),
        num_classes=2, dropout=0.0)
    jnet.initialize(mxj.init.Normal(0.02), ctx=mxj.cpu())
    ex = _bert_rows(BERT_CAP, 0)
    jnet(*[mxj.nd.array(a) for a in ex])
    d = tmp_path_factory.mktemp("bert")
    jout = jexport_serving(jnet, [mxj.nd.array(a) for a in ex],
                           str(d / "jax"), platforms=["cpu"],
                           batch_buckets=[1, 2, 4])
    net = get_model("bert_classifier", model_name="bert_tiny",
                    num_classes=2, dropout=0.0, vocab_size=VOCAB,
                    max_length=T)
    net.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    params_from_jax(net, {k: v.data().asnumpy() for k, v in
                          jnet._collect_params_with_prefix().items()},
                    ctx=mx.cpu())
    out = export_serving(net, ex, str(d / "port"), batch_buckets=[1, 2, 4])
    return out, jout


def test_bert_tiny_bucketed_serving_matches_the_jax_runtime(bert_pair):
    (rt, base), (jrt, jbase) = _both(bert_pair)
    rt_flat, base_flat = _runtime(bert_pair[0], batch_buckets=0)
    model = load_serving(bert_pair[0], ctx=mx.cpu())
    try:
        assert rt.healthz()["model"]["batch_buckets"] == [1, 2, 4]
        for n in (1, 2, 3, 5, 8):
            req = _bert_rows(n, 10 + n)
            body = {"inputs": [a.tolist() for a in req]}
            outs = []
            for b in (base, jbase, base_flat):
                code, payload, _ = _post(b, body)
                assert code == 200, payload
                outs.append(np.asarray(payload["outputs"][0], np.float32))
            got, want, flat = outs
            assert got.shape == (n, 2) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, **BERT_TOL)
            target = next(k for k in (1, 2, 4, BERT_CAP) if k >= n)
            call = model.buckets.get(target, model)
            direct = call(*[_pad(a, target) for a in req])[0][:n]
            assert got.tobytes() == direct.tobytes(), n
            np.testing.assert_allclose(got, flat, rtol=0,
                                       atol=1e-6 * np.abs(flat).max())
    finally:
        rt.close()
        jrt.close()
        rt_flat.close()
