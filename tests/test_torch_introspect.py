"""The port's introspection plane (incubator_mxnet_torch/introspect.py):
its debugz paths are the JAX package's less the six pages of planes the
port does not have, its statusz carries the JAX package's keys; then
`tests/test_introspect.py`'s cases on the port's module (debugz
endpoints, flight-recorder ring, postmortem capture on an exception and
on SIGTERM, the single-shot dump guard, serving's debug/traces parity
and its folded debugz pages), the serving ones on a port MLP on the
CPU."""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from incubator_mxnet_tpu import introspect as jins

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import telemetry
from incubator_mxnet_torch import introspect as ins
from incubator_mxnet_torch.models import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEFT_OUT = ("/-/goodputz", "/-/numericz", "/-/profilez", "/-/controllerz",
            "/-/tunerz", "/-/checkpointz")


@pytest.fixture(autouse=True)
def _clean_introspect():
    ins._reset_for_tests()
    yield
    ins._reset_for_tests()


def test_debugz_paths_are_the_jax_packages_less_six():
    assert set(LEFT_OUT) <= set(jins.DEBUGZ_PATHS)
    assert ins.DEBUGZ_PATHS == tuple(p for p in jins.DEBUGZ_PATHS
                                     if p not in LEFT_OUT)


def test_statusz_and_pages_carry_the_jax_packages_keys():
    want = set(jins.statusz()) - set(jins._statusz_providers)
    assert set(ins.statusz()) == want
    for page in ("stackz", "metricz", "flightz"):
        assert set(getattr(ins, page)()) == set(getattr(jins, page)())
    assert set(ins.process_identity()) == set(jins.process_identity())
    ev = ins.flight("reload", ok=True)
    assert set(ev) == set(jins.flight("reload", ok=True))


def _get(port, path, timeout=10):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, json.load(r)


# -- flight recorder ----------------------------------------------------

def test_flight_ring_bounds():
    ins.set_flight_capacity(8)
    try:
        for i in range(25):
            ins.flight("step", step=i, seconds=0.01)
        evs = ins.flight_events()
        assert len(evs) == 8                       # bounded
        assert [e["step"] for e in evs] == list(range(17, 25))
        seqs = [e["seq"] for e in evs]
        assert seqs == sorted(seqs)                # ordered
        assert all(e["kind"] == "step" and "unix_time" in e
                   for e in evs)
        assert ins.flight_events(limit=3) == evs[-3:]
    finally:
        ins.set_flight_capacity(512)


def test_flight_capacity_resize_keeps_newest():
    ins.set_flight_capacity(4)
    try:
        for i in range(10):
            ins.flight("x", i=i)
        ins.set_flight_capacity(2)
        assert [e["i"] for e in ins.flight_events()] == [8, 9]
    finally:
        ins.set_flight_capacity(512)


def test_step_bookkeeping():
    assert ins.current_step() is None
    ins.begin_step(0)
    assert ins.current_step() == 0     # what a postmortem would name
    ins.end_step(0, 0.5)
    ins.begin_step(1)
    ins.end_step(1, 0.25, compute_seconds=0.1)
    evs = [e for e in ins.flight_events() if e["kind"] == "step"]
    assert evs[-1]["step"] == 1 and evs[-1]["compute_seconds"] == 0.1
    assert "compute_seconds" not in evs[0]
    assert ins.current_step() == 1


# -- debugz endpoints ---------------------------------------------------

def test_debugz_endpoint_schemas():
    srv = ins.start_debugz(0, role="worker")
    try:
        ins.register_statusz("kvstore_server",
                             lambda: {"epoch": 3, "live": 2})
        ins.flight("reconnect", server=0)

        code, st = _get(srv.port, "/-/statusz")
        assert code == 200
        for key in ("role", "rank", "host", "pid", "uptime_seconds",
                    "start_unix_time", "build", "env", "argv",
                    "current_step", "telemetry_enabled",
                    "tracing_enabled"):
            assert key in st, key
        assert st["role"] == "worker"
        assert st["kvstore_server"] == {"epoch": 3, "live": 2}

        code, sz = _get(srv.port, "/-/stackz")
        assert code == 200 and sz["thread_count"] >= 2
        names = [t["name"] for t in sz["threads"]]
        assert "MainThread" in names and "mx-debugz-http" in names
        main = next(t for t in sz["threads"]
                    if t["name"] == "MainThread")
        assert main["stack"] and all(
            set(fr) >= {"file", "line", "function"}
            for fr in main["stack"])

        code, mz = _get(srv.port, "/-/metricz")
        assert code == 200 and mz["version"] == 1
        assert "metrics" in mz and mz["identity"]["role"] == "worker"

        code, tz = _get(srv.port, "/-/tracez")
        assert code == 200 and "traces" in tz

        code, fz = _get(srv.port, "/-/flightz")
        assert code == 200
        assert any(e["kind"] == "reconnect" for e in fz["events"])
        assert fz["capacity"] >= 16

        # prometheus text rides the same listener
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics",
                timeout=10) as r:
            assert r.status == 200
    finally:
        srv.close()


def test_debugz_404_and_index():
    srv = ins.start_debugz(0)
    try:
        code, idx = _get(srv.port, "/")
        assert code == 200 and "/-/statusz" in idx["endpoints"]
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/nope", timeout=10)
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        srv.close()


def test_statusz_provider_errors_are_captured():
    def boom():
        raise RuntimeError("provider broke")
    ins.register_statusz("broken", boom)
    st = ins.statusz()
    assert "RuntimeError" in st["broken"]["error"]


def test_ensure_debugz_no_port_is_inert(monkeypatch):
    monkeypatch.delenv("MXNET_DEBUGZ_PORT", raising=False)
    before = {t.ident for t in threading.enumerate()}
    assert ins.ensure_debugz() is None
    assert {t.ident for t in threading.enumerate()} == before


def test_ensure_debugz_from_env(monkeypatch):
    monkeypatch.setenv("MXNET_DEBUGZ_PORT", "0")
    srv = ins.ensure_debugz(role="worker")
    try:
        assert srv is not None and srv is ins.debugz_server()
        assert ins.ensure_debugz() is srv      # idempotent
        code, st = _get(srv.port, "/-/statusz")
        assert code == 200
    finally:
        srv.close()


def test_debugz_payload_dispatch():
    code, payload = ins.debugz_payload("/-/statusz")
    assert code == 200 and "role" in payload
    code, payload = ins.debugz_payload("/nope")
    assert code == 404 and payload is None


# -- single-shot dump guard --------------------------------------------

def test_single_shot_postmortem_guard(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_POSTMORTEM_DIR", str(tmp_path))
    ins.flight("step", step=4, seconds=0.1)
    path = ins.write_postmortem("explicit")
    assert path is not None and os.path.exists(path)
    # the guard is consumed: a second writer returns None and writes
    # no second file
    assert ins.write_postmortem("explicit") is None
    files = [f for f in os.listdir(tmp_path)
             if f.startswith("postmortem-")]
    assert len(files) == 1
    pm = json.load(open(path))
    assert pm["reason"] == "explicit"
    assert any(e["kind"] == "step" for e in pm["flight_events"])
    assert pm["threads"]


def test_single_shot_telemetry_and_trace_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_DUMP",
                       str(tmp_path / "telemetry.json"))
    monkeypatch.setenv("MXNET_TRACE_DIR", str(tmp_path / "traces"))
    assert ins.dump_telemetry_once() == str(tmp_path / "telemetry.json")
    assert ins.dump_telemetry_once() is None       # guard consumed
    p = ins.dump_traces_once()
    assert p is not None and os.path.exists(p)
    assert ins.dump_traces_once() is None


def test_telemetry_dump_carries_identity(tmp_path, monkeypatch):
    path = str(tmp_path / "t.json")
    telemetry.dump(path)
    doc = json.load(open(path))
    assert {"role", "rank", "host"} <= set(doc)


# -- postmortem on crash paths (real subprocesses) ---------------------

_CRASH_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
from incubator_mxnet_torch import introspect as ins
ins.install_postmortem(role="worker")
ins.begin_step(3)
ins.flight("step", step=2, seconds=0.1)
raise ValueError("boom from test")
"""

_SIGTERM_SCRIPT = """
import sys, time
sys.path.insert(0, {repo!r})
from incubator_mxnet_torch import introspect as ins
ins.install_postmortem(role="worker")
ins.begin_step(9)
print("READY", flush=True)
time.sleep(60)
"""


def _run_py(code, env, **kw):
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            **kw)


def _pm_env(tmp_path):
    env = dict(os.environ, MXNET_POSTMORTEM_DIR=str(tmp_path))
    env.pop("MXNET_DEBUGZ_PORT", None)
    return env


def _one_postmortem(tmp_path, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        files = [f for f in os.listdir(tmp_path)
                 if f.startswith("postmortem-")
                 and f.endswith(".json")]
        if files:
            assert len(files) == 1, files
            return json.load(open(os.path.join(tmp_path, files[0])))
        time.sleep(0.1)
    raise AssertionError("no postmortem written")


def test_postmortem_on_uncaught_exception(tmp_path):
    proc = _run_py(_CRASH_SCRIPT.format(repo=REPO),
                   _pm_env(tmp_path), stderr=subprocess.PIPE)
    _, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert b"boom from test" in err        # prior excepthook chained
    pm = _one_postmortem(tmp_path)
    assert pm["reason"] == "exception"
    assert pm["step"] == 3                 # the failing step
    assert pm["exception"]["type"] == "ValueError"
    assert "boom from test" in pm["exception"]["message"]
    assert any(e["kind"] == "step" for e in pm["flight_events"])
    assert pm["threads"] and pm["threads"][0]["stack"]
    assert pm["identity"]["role"] == "worker"


def test_postmortem_on_sigterm(tmp_path):
    proc = _run_py(_SIGTERM_SCRIPT.format(repo=REPO),
                   _pm_env(tmp_path), stdout=subprocess.PIPE,
                   text=True)
    assert proc.stdout.readline().strip() == "READY"
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=120)
    # default disposition re-raised: exit status says killed-by-TERM
    assert proc.returncode == -signal.SIGTERM
    pm = _one_postmortem(tmp_path)
    assert pm["reason"] == "signal:SIGTERM"
    assert pm["step"] == 9
    assert pm["exception"] is None
    assert pm["threads"]


def test_sigterm_crash_path_dumps_telemetry_and_traces(tmp_path):
    """The at-exit dump loss fix: SIGTERM (which skips atexit) must
    still produce the MXNET_TELEMETRY_DUMP / MXNET_TRACE_DIR files,
    via the postmortem hook's guarded dumps."""
    env = _pm_env(tmp_path)
    env["MXNET_TELEMETRY_DUMP"] = str(tmp_path / "telemetry.json")
    env["MXNET_TRACE_DIR"] = str(tmp_path / "traces")
    proc = _run_py(_SIGTERM_SCRIPT.format(repo=REPO), env,
                   stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().strip() == "READY"
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=120)
    assert os.path.exists(tmp_path / "telemetry.json")
    assert os.path.isdir(tmp_path / "traces")


# -- serving parity through the shared handler --------------------------

CAP = 4


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    from incubator_mxnet_torch.deploy import export_serving
    mx.seed(5)
    net = get_model("mlp", hidden=(6,), classes=3)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    x = np.random.RandomState(5).randn(CAP, 5).astype(np.float32)
    out = str(tmp_path_factory.mktemp("introspect") / "artifact")
    export_serving(net, [x], out)
    return out


def test_serving_debug_traces_parity(artifact):
    """`/-/debug/traces` and `/-/tracez` answer through ONE shared
    handler on a serving process, and the debugz plane (statusz with
    the serving section, stackz, flightz) is folded into the serving
    listener itself."""
    from incubator_mxnet_torch.serving import ServeConfig, ServingRuntime
    rt = ServingRuntime(artifact, ServeConfig(concurrency=1), ctx=mx.cpu())
    port = rt.start(0)
    try:
        # a request so recent_requests is non-trivial
        data = json.dumps(
            {"inputs": [np.zeros((1, 5), np.float32).tolist()]}
        ).encode()
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=data),
            timeout=30).read()

        code, legacy = _get(port, "/-/debug/traces")
        assert code == 200
        code, tracez = _get(port, "/-/tracez")
        assert code == 200
        # identical payload modulo capture instant: same keys, same
        # request summaries
        assert set(legacy) == set(tracez)
        assert legacy["recent_requests"] == tracez["recent_requests"]
        assert len(legacy["recent_requests"]) == 1
        assert legacy["recent_requests"][0]["status"] == 200

        code, st = _get(port, "/-/statusz")
        assert code == 200 and "serving" in st
        assert st["serving"]["queue"]["depth"] == 0
        code, sz = _get(port, "/-/stackz")
        names = [t["name"] for t in sz["threads"]]
        assert any(n.startswith("mx-serve-worker") for n in names)
        code, fz = _get(port, "/-/flightz")
        assert code == 200
    finally:
        rt.close()
    # close() unhooks the providers
    assert ins._tracez_provider is None
    assert "serving" not in ins._statusz_providers


def test_serving_public_bind_gates_debugz_fold(artifact, monkeypatch):
    """A non-loopback serving bind must NOT expose statusz/stackz
    (env vars, argv, thread stacks) to predict clients unless
    MXNET_DEBUGZ_EXPOSE opts in; /-/debug/traces keeps its
    pre-existing public behavior."""
    monkeypatch.delenv("MXNET_DEBUGZ_EXPOSE", raising=False)
    from incubator_mxnet_torch.serving import ServeConfig, ServingRuntime
    rt = ServingRuntime(artifact, ServeConfig(concurrency=1), ctx=mx.cpu())
    port = rt.start(0, addr="0.0.0.0")
    try:
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/-/statusz", timeout=10)
            assert False, "expected 404 on public bind"
        except urllib.error.HTTPError as e:
            assert e.code == 404
        code, _ = _get(port, "/-/debug/traces")
        assert code == 200      # legacy endpoint keeps its behavior
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/-/tracez", timeout=10)
            assert False, "tracez is part of the gated debugz plane"
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        rt.close()


def test_serving_flight_events_breaker_and_reload(artifact):
    from incubator_mxnet_torch.serving import ServeConfig, ServingRuntime
    rt = ServingRuntime(artifact, ServeConfig(
        concurrency=1, breaker_threshold=1, fault_plan="fail:*"),
        ctx=mx.cpu())
    port = rt.start(0)
    try:
        data = json.dumps(
            {"inputs": [np.zeros((1, 5), np.float32).tolist()]}
        ).encode()
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=data),
                timeout=30).read()
        except urllib.error.HTTPError:
            pass
        kinds = [e["kind"] for e in ins.flight_events()]
        assert "breaker_trip" in kinds
        rt.reload(artifact)     # the fault plan skips warm-up calls
        kinds = [e["kind"] for e in ins.flight_events()]
        assert "reload" in kinds
        rt.begin_drain()
        kinds = [e["kind"] for e in ins.flight_events()]
        assert "drain_begin" in kinds
    finally:
        rt.close()
