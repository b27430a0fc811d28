#!/usr/bin/env python
"""Serving chaos gate: the port's `tools/serve_chaos.py` (``--smoke`` is
its happy-path half).

Drives a REAL ``python -m incubator_mxnet_torch.serving`` process
through the full fault menu and fails unless every fault is shed with a
proper status code (429/503/504 — never a hung connection or a crash)
and every post-fault 200 is **bitwise identical** to a fault-free
baseline run at the same pad target:

* a slow model call under a short client deadline → 504, fast;
* poison inputs (``MXNET_SERVE_FAULT_PLAN`` ``fail:N`` — failures that
  pass validation) → 500s that trip the circuit breaker → fast 503 +
  ``Retry-After`` while open → half-open probe → closed again;
* malformed JSON and wrong-shape inputs → 400, breaker untouched;
* a burst beyond queue+concurrency while the worker is wedged → ≥1
  429 with ``Retry-After``;
* a hot reload pointed at a CORRUPT artifact → rolled back, old model
  keeps serving bit-identically; a good reload to a second artifact
  (other weights) → swapped, answering as that artifact did in the
  baseline run;
* mid-flight SIGTERM → the in-flight request finishes 200 (bitwise
  identical), later requests are shed, the process exits 0 within the
  drain deadline.

Also asserts via /metrics that the faults actually fired (shed/trip/
timeout/reload-failure counters non-zero), and that the debugz pages
(statusz, tracez, flightz, stackz) answer 200 on the serving port.  A
500 that the fault plan did not inject fails the gate.

    python -m incubator_mxnet_torch.tools.serve_chaos [--ctx cpu|gpu]
        [--artifact DIR --artifact-b DIR] [--smoke]

Without ``--artifact`` it exports two seeded 6 -> 8 -> 3 MLPs
(capacity 4).  The last line of its output is one JSON object of the
readings (reload seconds, breaker-open 503 latency, drain seconds).
"""
from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

ROWS = 2            # rows per happy request


def free_port():
    """A free port below the kernel's ephemeral range: a server killed
    and restarted on its port (the fleet gate's) must not find it taken
    as the local port of a client connection in between, which a port
    the kernel handed out by binding port 0 can be."""
    lo = 32768
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    rng = random.Random()
    for _ in range(1000):
        port = rng.randrange(max(1024, lo // 2), lo)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port below {lo}")


def build_mlp_artifact(out_dir, seed=7):
    """A seeded 6 -> 8 -> 3 MLP exported at capacity 4 (on the CPU: an
    artifact holds no device)."""
    import numpy as np
    sys.path.insert(0, REPO)
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import deploy
    from incubator_mxnet_torch.models import get_model

    mx.seed(seed)
    net = get_model("mlp", hidden=(8,), classes=3)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    x = np.random.RandomState(seed).randn(4, 6).astype(np.float32)
    deploy.export_serving(net, [x], out_dir)
    return out_dir


def request_inputs(artifact, rows, seed):
    """Seeded inputs of `rows` rows for the artifact's signature: BERT's
    token ids, token types and valid lengths for a BERT classifier,
    standard normal values for float inputs otherwise."""
    import numpy as np
    with open(os.path.join(artifact, "meta.json")) as f:
        meta = json.load(f)
    rng = np.random.RandomState(seed)
    specs = meta["inputs"]
    if meta["model"]["name"] == "bert_classifier":
        kw = meta["model"]["kwargs"]
        t = specs[0]["shape"][1]
        valid = rng.randint(1, t + 1, (rows,))
        return [rng.randint(0, kw.get("vocab_size", 30522),
                            (rows, t)).tolist(),
                rng.randint(0, 2, (rows, t)).tolist(), valid.tolist()]
    out = []
    for s in specs:
        shape = (rows,) + tuple(s["shape"][1:])
        if s["dtype"].startswith(("float", "bfloat")):
            out.append(rng.randn(*shape).astype(np.float32).tolist())
        else:
            out.append(np.zeros(shape, np.int32).tolist())
    return out


class Server:
    """A process of the port (the server, or `module`) on a free port,
    ``--port`` appended to `args`, polled until `ready_path` answers one
    of `ready_codes`."""

    def __init__(self, args, env_extra=None, port=None,
                 module="incubator_mxnet_torch.serving",
                 ready_path="/-/readyz", ready_codes=(200,), what="server",
                 ready_timeout=300):
        self.port = port or free_port()
        self.what = what
        env = dict(os.environ, PYTHONPATH=REPO, MXNET_TELEMETRY="1",
                   **(env_extra or {}))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args, "--port", str(self.port)],
            env=env, cwd=REPO)
        self.base = f"http://127.0.0.1:{self.port}"
        deadline = time.monotonic() + ready_timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"{what} died at startup "
                                   f"(rc={self.proc.returncode})")
            try:
                code, _, _ = self.request("GET", ready_path, timeout=2)
                if code in ready_codes:
                    return
            except OSError:
                pass
            time.sleep(0.2)
        self.proc.kill()
        raise RuntimeError(f"{what} never became ready")

    @property
    def addr(self):
        return f"127.0.0.1:{self.port}"

    def request(self, method, path, body=None, headers=None, timeout=15):
        """One HTTP call; returns (status, raw body, headers)."""
        req = urllib.request.Request(self.base + path, data=body,
                                     method=method, headers=headers or {})
        try:
            r = urllib.request.urlopen(req, timeout=timeout)
            return r.status, r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, e.read(), dict(e.headers)

    def get(self, path, timeout=15):
        return self.request("GET", path, timeout=timeout)

    def post(self, path, body, headers=None, timeout=60):
        """POST `body` (JSON-encoded unless bytes); returns (status,
        decoded JSON, headers, seconds)."""
        t0 = time.monotonic()
        code, raw, hdr = self.request(
            "POST", path, body if isinstance(body, bytes)
            else json.dumps(body).encode(),
            {"Content-Type": "application/json", **(headers or {})},
            timeout)
        return code, json.loads(raw), hdr, time.monotonic() - t0

    def sigterm_and_wait(self, timeout=60):
        """SIGTERM; returns (exit code, seconds until the process was
        gone)."""
        t0 = time.monotonic()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise RuntimeError(f"{self.what} hung past the drain deadline")
        return rc, time.monotonic() - t0

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def serving(artifact, ctx, env_extra=None, port=None, what="server"):
    """``python -m incubator_mxnet_torch.serving artifact --ctx ctx``."""
    return Server([artifact, "--ctx", ctx], env_extra, port, what=what)


def check(cond, msg, tag="serve-chaos"):
    """Print `msg` OK, or print it as a failure and exit 1."""
    if not cond:
        print(f"{tag} FAIL: {msg}", flush=True)
        sys.exit(1)
    print(f"{tag}: {msg} OK", flush=True)


def corrupt_copy(artifact):
    """A copy of `artifact` with one byte of params.npz flipped."""
    bad = os.path.join(tempfile.mkdtemp(prefix="serve-bad-"), "art")
    shutil.copytree(artifact, bad)
    with open(os.path.join(bad, "params.npz"), "r+b") as f:
        f.seek(64)
        b = f.read(1)
        f.seek(64)
        f.write(bytes([b[0] ^ 0xFF]))
    return bad


def smoke(artifact, ctx):
    """Start, one happy request, a clean drain."""
    srv = serving(artifact, ctx)
    try:
        code, body, _, _ = srv.post(
            "/predict", {"inputs": request_inputs(artifact, ROWS, 11)})
        check(code == 200 and len(body["outputs"][0]) == ROWS,
               f"happy-path predict ({code})")
        code, raw, _ = srv.get("/-/healthz")
        check(code == 200 and json.loads(raw)["status"] == "ok",
               "healthz reports ok")
        rc, _ = srv.sigterm_and_wait()
        check(rc == 0, f"SIGTERM drained clean, exit {rc}")
    finally:
        srv.kill()
    return {}


def chaos(artifact, artifact_b, ctx):
    happy = {"inputs": request_inputs(artifact, ROWS, 11)}
    readings = {}

    # ---- fault-free baseline, both artifacts --------------------------
    srv = serving(artifact, ctx)
    try:
        code, baseline, _, _ = srv.post("/predict", happy)
        check(code == 200, "baseline predict")
        code, body, _, _ = srv.post("/-/reload",
                                    {"artifact_dir": artifact_b})
        check(code == 200 and body["ok"], "baseline reload to artifact B")
        code, baseline_b, _, _ = srv.post("/predict", happy)
        check(code == 200 and baseline_b != baseline,
               "artifact B answers with other outputs")
        rc, _ = srv.sigterm_and_wait()
        check(rc == 0, f"baseline drain exit {rc}")
    finally:
        srv.kill()

    # ---- run 1: faults -------------------------------------------------
    # data-path model calls, in order: 0 happy, 1 slow (deadline), 2-4
    # poison (trips breaker at 3), 5 half-open probe, 6 post-rollback
    # happy, 7 post-reload happy, 8+ flood (call 8 wedges the worker so
    # the burst must shed)
    corrupt = corrupt_copy(artifact)
    srv = serving(artifact, ctx, {
        "MXNET_SERVE_FAULT_PLAN": "slow:1:600,fail:2,fail:3,fail:4,"
                                  "slow:8:600",
        "MXNET_SERVE_CONCURRENCY": "1",
        "MXNET_SERVE_QUEUE": "2",
        "MXNET_SERVE_BREAKER_THRESHOLD": "3",
        "MXNET_SERVE_BREAKER_COOLDOWN_MS": "500",
    })
    try:
        code, body, _, _ = srv.post("/predict", happy)
        check(code == 200 and body == baseline,
               "pre-fault response bitwise-identical")

        code, body, _, dt = srv.post("/predict", happy,
                                     headers={"X-Deadline-Ms": "150"})
        check(code == 504 and dt < 5.0,
               f"slow call under 150ms deadline -> 504 in {dt:.2f}s")

        for i in range(3):
            code, body, _, _ = srv.post("/predict", happy)
            check(code == 500 and "injected model fault" in body["error"],
                   f"poison input {i} -> injected 500")

        code, body, hdr, dt = srv.post("/predict", happy)
        readings["breaker_503_ms"] = dt * 1e3
        check(code == 503 and body.get("reason") == "breaker_open"
               and "Retry-After" in hdr and dt < 0.3,
               f"breaker open -> fast 503 + Retry-After ({dt:.3f}s)")

        time.sleep(0.6)     # cooldown -> half-open
        code, body, _, _ = srv.post("/predict", happy)
        check(code == 200 and body == baseline,
               "half-open probe succeeds, bitwise-identical")
        code, raw, _ = srv.get("/-/healthz")
        check(json.loads(raw)["breaker"]["state"] == "closed",
               "breaker closed again")

        code, body, _, _ = srv.post("/predict", b"{not json",
                                    timeout=15)
        check(code == 400, "malformed JSON -> 400")
        code, body, _, _ = srv.post(
            "/predict", {"inputs": [[[1.0, 2.0]]]})
        check(code == 400, "wrong-shape input -> 400")
        code, raw, _ = srv.get("/-/healthz")
        breaker = json.loads(raw)["breaker"]
        check(breaker["state"] == "closed"
               and breaker["consecutive_failures"] == 0,
               "400s left the breaker untouched")

        code, body, _, _ = srv.post("/-/reload",
                                    {"artifact_dir": corrupt})
        check(code == 500 and not body["ok"]
               and "params.npz" in body["error"],
               "corrupt reload rejected naming params.npz")
        code, raw, _ = srv.get("/-/healthz")
        health = json.loads(raw)
        check(health["last_reload"] and not health["last_reload"]["ok"]
               and health["model"]["artifact_dir"] == artifact,
               "healthz shows the rolled-back reload")
        code, body, _, _ = srv.post("/predict", happy)
        check(code == 200 and body == baseline,
               "post-rollback response bitwise-identical")

        code, body, _, _ = srv.post("/-/reload",
                                    {"artifact_dir": artifact_b})
        check(code == 200 and body["ok"], "good reload to B swaps")
        readings["reload_seconds"] = body["seconds"]
        code, body, _, _ = srv.post("/predict", happy)
        check(code == 200 and body == baseline_b,
               "post-reload response is artifact B's, bitwise")

        # call 8 wedges the worker 600ms; burst past queue+worker
        results = []

        def fire():
            code, _, hdr, _ = srv.post("/predict", happy, timeout=30)
            results.append((code, "Retry-After" in hdr))

        threads = [threading.Thread(target=fire) for _ in range(8)]
        for t in threads:
            t.start()
            time.sleep(0.02)    # first lands in-flight, rest pile up
        for t in threads:
            t.join(timeout=60)
        codes = sorted({c for c, _ in results})
        check(not any(t.is_alive() for t in threads),
               "burst: every connection answered (no hangs)")
        check(any(c == 429 and ra for c, ra in results),
               f"burst sheds with 429 + Retry-After (saw {codes})")
        check(set(codes) <= {200, 429, 503, 504},
               f"burst codes bounded (saw {codes})")

        code, metrics, _ = srv.get("/metrics")
        text = metrics.decode()

        def metric_sum(name):
            return sum(float(ln.rpartition(" ")[2])
                       for ln in text.splitlines()
                       if ln.startswith(name) and not ln.startswith("#"))

        shed = metric_sum("serving_shed_total")
        trips = metric_sum("serving_breaker_trips_total")
        tmo = metric_sum("serving_deadline_timeouts_total")
        bad_reload = metric_sum('serving_reloads_total{result="failed"}')
        check(shed >= 1 and trips >= 1 and tmo >= 1 and bad_reload >= 1,
               f"faults actually fired (shed={shed:.0f}, trips="
               f"{trips:.0f}, timeouts={tmo:.0f}, "
               f"failed_reloads={bad_reload:.0f})")
        for page in ("/-/statusz", "/-/tracez", "/-/flightz", "/-/stackz"):
            code, raw, _ = srv.get(page)
            check(code == 200 and isinstance(json.loads(raw), dict),
                   f"{page} answers 200 on the serving port")

        code, body, _, _ = srv.post("/predict", happy)
        check(code == 200 and body == baseline_b,
               "post-chaos response bitwise-identical")
        rc, _ = srv.sigterm_and_wait()
        check(rc == 0, f"chaos server drained clean, exit {rc}")
    finally:
        srv.kill()
        shutil.rmtree(os.path.dirname(corrupt), ignore_errors=True)

    # ---- run 2: mid-flight SIGTERM ------------------------------------
    srv = serving(artifact, ctx, {"MXNET_SERVE_FAULT_PLAN": "slow:*:700",
                                 "MXNET_SERVE_CONCURRENCY": "1",
                                 "MXNET_SERVE_DRAIN_MS": "15000"})
    try:
        inflight = {}

        def fire_inflight():
            inflight["resp"] = srv.post("/predict", happy, timeout=30)

        t = threading.Thread(target=fire_inflight)
        t.start()
        time.sleep(0.25)        # request is inside the slow model call
        t_term = time.monotonic()
        srv.proc.send_signal(signal.SIGTERM)
        time.sleep(0.05)
        late = []
        try:
            late.append(srv.post("/predict", happy, timeout=10)[0])
        except OSError:
            late.append("refused")      # listener already gone: also fine
        t.join(timeout=60)
        code, body, _, _ = inflight["resp"]
        check(code == 200 and body == baseline,
               "in-flight request finished 200 bitwise-identical "
               "through SIGTERM")
        check(late[0] in (503, "refused"),
               f"post-SIGTERM request shed ({late[0]})")
        rc = srv.proc.wait(timeout=30)
        readings["drain_seconds"] = time.monotonic() - t_term
        check(rc == 0 and readings["drain_seconds"] < 15.0,
               f"mid-flight SIGTERM drained clean, exit {rc} in "
               f"{readings['drain_seconds']:.3f}s")
    finally:
        srv.kill()
    return readings


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m incubator_mxnet_torch.tools.serve_chaos")
    ap.add_argument("--ctx", default="gpu(0)",
                    help="the servers' --ctx (default gpu(0))")
    ap.add_argument("--artifact", help="artifact A (default: a seeded MLP)")
    ap.add_argument("--artifact-b", help="artifact B, other weights, the "
                    "same signature (default: the MLP at another seed)")
    ap.add_argument("--smoke", action="store_true",
                    help="only the happy path and a clean drain")
    args = ap.parse_args(argv)
    tmp = None
    artifact, artifact_b = args.artifact, args.artifact_b
    if artifact is None:
        tmp = tempfile.mkdtemp(prefix="serve-chaos-")
        artifact = build_mlp_artifact(os.path.join(tmp, "a"), seed=7)
        artifact_b = build_mlp_artifact(os.path.join(tmp, "b"), seed=8)
    elif artifact_b is None and not args.smoke:
        ap.error("--artifact needs --artifact-b")
    print(f"serve-chaos: artifact at {artifact} on {args.ctx}", flush=True)
    try:
        if args.smoke:
            readings = smoke(artifact, args.ctx)
            print("SERVE-SMOKE OK", flush=True)
        else:
            readings = chaos(artifact, artifact_b, args.ctx)
            print("SERVE-CHAOS OK: slow/poison/breaker/flood/corrupt-"
                  "reload/good-reload/mid-flight-SIGTERM all shed or "
                  "recovered, responses bitwise-identical to fault-free",
                  flush=True)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"serve_chaos": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
