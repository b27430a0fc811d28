"""The port's process entry points on the CPU: `python -m
incubator_mxnet_torch.serving ART --ctx cpu` under SIGHUP (hot reload)
and a mid-flight SIGTERM (the in-flight request answers 200, the process
exits 0), `POST /-/quitquitquit`, the default device raising without
CUDA, `python -m incubator_mxnet_torch.router` over a replica, and the
serving chaos tool's happy path.  Each process imports torch, so each
start costs a few seconds; the artifact is a seeded 6 -> 8 -> 3 MLP.
"""
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
import torch

from incubator_mxnet_torch.serving import _ctx_arg
from incubator_mxnet_torch.tools import serve_chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return serve_chaos.build_mlp_artifact(
        str(tmp_path_factory.mktemp("proc") / "a"), seed=7)


def _body(artifact, rows=2, seed=11):
    return {"inputs": serve_chaos.request_inputs(artifact, rows, seed)}


def _post(base, path, body, timeout=30):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _healthz(base):
    with urllib.request.urlopen(base + "/-/healthz", timeout=10) as r:
        return json.loads(r.read())


def test_ctx_argument():
    assert str(_ctx_arg("cpu")) == "cpu(0)"
    assert str(_ctx_arg("gpu")) == "gpu(0)"
    assert str(_ctx_arg("gpu(1)")) == "gpu(1)"
    assert str(_ctx_arg("cuda:2")) == "gpu(2)"
    with pytest.raises(ValueError):
        _ctx_arg("tpu")


def test_sighup_reloads_and_sigterm_drains_in_flight(artifact):
    a = artifact
    srv = serve_chaos.serving(a, "cpu", {
        "MXNET_SERVE_FAULT_PLAN": "slow:2:700",
        "MXNET_SERVE_CONCURRENCY": "1", "MXNET_SERVE_DRAIN_MS": "15000"})
    try:
        body = _body(a)
        code, before = _post(srv.base, "/predict", body)        # call 0
        assert code == 200
        assert _healthz(srv.base)["model"]["device"] == "cpu"
        srv.proc.send_signal(signal.SIGHUP)     # reloads the same artifact
        for _ in range(200):
            last = _healthz(srv.base)["last_reload"]
            if last:
                break
            time.sleep(0.05)
        assert last["ok"] and last["artifact_dir"] == a
        code, after = _post(srv.base, "/predict", body)         # call 1
        assert code == 200 and after == before
        inflight = {}
        t = threading.Thread(target=lambda: inflight.update(
            r=_post(srv.base, "/predict", body)))               # call 2
        t.start()
        time.sleep(0.3)                 # inside the slow call
        srv.proc.send_signal(signal.SIGTERM)
        t.join(timeout=30)
        assert srv.proc.wait(timeout=30) == 0
        assert inflight["r"] == (200, before)
    finally:
        srv.kill()


def test_quitquitquit_exits_like_sigterm(artifact):
    srv = serve_chaos.serving(artifact, "cpu")
    try:
        code, body = _post(srv.base, "/-/quitquitquit", {})
        assert code == 200 and body == {"draining": True, "exiting": True}
        assert srv.proc.wait(timeout=30) == 0
    finally:
        srv.kill()


def test_default_ctx_raises_without_cuda(artifact):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    r = subprocess.run(
        [sys.executable, "-m", "incubator_mxnet_torch.serving",
         artifact, "--port", "0"], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr


def test_router_process_routes_and_drains(artifact):
    a = artifact
    srv = serve_chaos.serving(a, "cpu")
    router = None
    try:
        router = serve_chaos.Server(
            ["--replicas", srv.addr], module="incubator_mxnet_torch.router",
            what="router")
        body = _body(a, rows=3, seed=5)
        code, routed = _post(router.base, "/predict", body)
        direct = _post(srv.base, "/predict", body)
        assert code == 200 and (code, routed) == direct
        code, reps = _post(router.base, "/-/replicas", {})
        assert code == 200
        assert [x["addr"] for x in reps["replicas"]] == [srv.addr]
        rc, _ = router.sigterm_and_wait(timeout=30)
        assert rc == 0
    finally:
        if router is not None:
            router.kill()
        srv.kill()


def test_serve_chaos_smoke(artifact):
    r = subprocess.run(
        [sys.executable, "-m", "incubator_mxnet_torch.tools.serve_chaos",
         "--ctx", "cpu", "--smoke", "--artifact", artifact],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SERVE-SMOKE OK" in r.stdout
    assert json.loads(r.stdout.strip().splitlines()[-1]) == \
        {"serve_chaos": {}}
    np.testing.assert_equal(r.stdout.count(" OK"), 4)
