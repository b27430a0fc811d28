#!/usr/bin/env python
"""Fleet chaos gate: the port's `tools/fleet_chaos_smoke.py`, without its
fleetz join.

Runs a REAL router (``python -m incubator_mxnet_torch.router``) over
three REAL serving replicas, keeps a client load loop running the
whole time, and drives the fleet through the fault menu:

* **SIGKILL one replica** — the router must eject it off consecutive
  connect failures and route around it; restarting the process on the
  same port must get it probed back into rotation;
* **wedge one replica** — restart it with a finite
  ``MXNET_SERVE_FAULT_PLAN`` slow-poison (the process keeps answering
  health checks while its queue backs up) — the router must eject it
  on the queue signal (reason ``saturated``) and re-admit it once the
  poison plan is exhausted and the queue has drained;
* **rolling deploy mid-load** — ``POST /-/deploy`` swaps every
  replica to a re-export of the same model, one at a time, while the
  client loop keeps running.

The gate fails unless every client response is 200, or a 429/503 shed
carrying ``Retry-After`` (never a 5xx crash, a hung connection or a
504); every 200 is bitwise-identical to the fault-free baseline for the
same payload (the replicas serve without batch buckets, so every batch
pads to the capacity, and the deploy ships identical weights); and the
router's ``/-/readyz`` never reports the fleet unready.  It also checks
via /metrics that the faults fired (ejections for both reasons,
re-admissions, a completed deploy).

    python -m incubator_mxnet_torch.tools.fleet_chaos [--ctx cpu|gpu]
        [--artifact DIR --artifact-b DIR]

`--artifact-b` must hold the same weights as `--artifact` (a second
export of the same block).  Without them it exports a seeded MLP twice.
The last line of its output is one JSON object of the readings (the
router's requests/s, p50 and p99 latency, the deploy's seconds).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import sys
import tempfile
import threading
import time

from .serve_chaos import (Server, build_mlp_artifact, check,
                          request_inputs, serving)

ROWS = 2            # rows per client request
N_PAYLOADS = 6      # distinct payload/model-id pairs in the load mix
JSON = {"Content-Type": "application/json"}


def _replica(artifact, ctx, port=None, env_extra=None, name="replica"):
    return serving(artifact, ctx,
                   {"MXNET_SERVE_BUCKETS": "0", **(env_extra or {})},
                   port, what=name)


def _router(replica_addrs):
    return Server(["--replicas", ",".join(replica_addrs)],
                  {"MXNET_ROUTER_HEALTH_MS": "100",
                   "MXNET_ROUTER_PROBE_MS": "150",
                   "MXNET_ROUTER_EJECT_FAILURES": "2",
                   "MXNET_ROUTER_EJECT_SATURATED_POLLS": "2",
                   "MXNET_ROUTER_CONNECT_TIMEOUT_MS": "1000"},
                  module="incubator_mxnet_torch.router",
                  ready_path="/-/healthz", ready_codes=(200, 503),
                  what="router")


def _check(cond, msg):
    check(cond, msg, "fleet-chaos")


def _replica_row(router, addr):
    code, raw, _ = router.get("/-/statusz", timeout=5)
    if code != 200:
        return None
    rt = (json.loads(raw) or {}).get("router") or {}
    for rep in rt.get("replicas") or ():
        if rep.get("addr") == addr:
            return rep
    return None


def _wait_state(router, addr, want_state, timeout=60.0, want_reason=None):
    deadline = time.monotonic() + timeout
    row = None
    while time.monotonic() < deadline:
        row = _replica_row(router, addr)
        if row and row.get("state") == want_state and \
                (want_reason is None or row.get("reason") == want_reason):
            return row
        time.sleep(0.1)
    raise AssertionError(
        f"replica {addr} never reached {want_state}"
        f"{f'/{want_reason}' if want_reason else ''} (last: {row})")


def _metric_sum(text, name, **labels):
    total = 0.0
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        rest = line[len(name):]
        if rest[:1] not in ("{", " "):
            continue
        if any(f'{k}="{v}"' not in rest for k, v in labels.items()):
            continue
        try:
            total += float(line.rsplit(None, 1)[1])
        except ValueError:
            pass
    return total


def _quantile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


def run(art_a, art_b, ctx):
    payloads = {f"m{i}": json.dumps(
        {"inputs": request_inputs(art_a, ROWS, 100 + i)}).encode()
        for i in range(N_PAYLOADS)}

    # the three replicas start together: each is a process that imports
    # torch and loads the model before it answers
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        starts = [pool.submit(_replica, art_a, ctx, name=f"replica-{i}")
                  for i in range(3)]
    failed = [f.exception() for f in starts if f.exception() is not None]
    replicas = [f.result() for f in starts if f.exception() is None]
    if failed:
        for r in replicas:
            r.kill()
        raise failed[0]
    router = _router([r.addr for r in replicas])

    results = []        # (phase, model_id, status, body, headers, secs,
    #                        seconds into the run when sent)
    downtime = []       # router readyz observations != 200
    stop = threading.Event()
    phase = ["baseline"]
    readings = {}
    t_run = time.monotonic()

    def enter(name):
        phase[0] = name
        print(f"fleet-chaos: {name} phase from "
              f"{time.monotonic() - t_run:.2f} s", flush=True)

    try:
        # ---- fault-free baseline per payload --------------------------
        reference = {}
        for mid, body in payloads.items():
            code, out, _ = router.request(
                "POST", "/predict", body,
                {**JSON, "X-Model-Id": mid, "X-Deadline-Ms": "15000"},
                timeout=60)
            _check(code == 200, f"baseline 200 for {mid} (got {code})")
            reference[mid] = out
        _check(len(set(reference.values())) > 1,
               "baseline payloads produce distinct outputs")

        # ---- sustained load + zero-downtime monitor -------------------
        def load_loop():
            mids = list(payloads)
            i = 0
            while not stop.is_set():
                mid = mids[i % len(mids)]
                i += 1
                t0 = time.monotonic()
                try:
                    code, out, hdr = router.request(
                        "POST", "/predict", payloads[mid],
                        {**JSON, "X-Model-Id": mid,
                         "X-Deadline-Ms": "15000"}, timeout=60)
                except OSError as e:
                    code, out, hdr = -1, str(e).encode(), {}
                results.append((phase[0], mid, code, out, hdr,
                                time.monotonic() - t0, t0 - t_run))

        def readyz_loop():
            while not stop.is_set():
                try:
                    code, _, _ = router.get("/-/readyz", timeout=5)
                except OSError:
                    code = -1
                if code != 200:
                    downtime.append((phase[0], code))
                time.sleep(0.1)

        threads = [threading.Thread(target=load_loop) for _ in range(2)]
        threads.append(threading.Thread(target=readyz_loop))
        t_load = time.monotonic()
        for t in threads:
            t.start()
        time.sleep(1.0)

        # ---- fault 1: SIGKILL a replica -------------------------------
        enter("sigkill")
        victim = replicas[1]
        victim.kill()
        print(f"fleet-chaos: killed replica gone at "
              f"{time.monotonic() - t_run:.2f} s", flush=True)
        row = _wait_state(router, victim.addr, "ejected", timeout=30)
        _check(row["reason"] in ("unreachable", "breaker_open"),
               f"killed replica ejected ({row['reason']})")
        replicas[1] = _replica(art_a, ctx, port=victim.port,
                               name="replica-1-reborn")
        _wait_state(router, victim.addr, "healthy", timeout=60)
        _check(True, "restarted replica probed back into rotation")
        time.sleep(0.5)

        # ---- fault 2: wedged replica (slow-poison, finite) ------------
        enter("wedge")
        wedged = replicas[2]
        wedged.sigterm_and_wait()
        plan = ",".join(f"slow:{i}:600" for i in range(6))
        replicas[2] = _replica(
            art_a, ctx, port=wedged.port,
            env_extra={"MXNET_SERVE_FAULT_PLAN": plan,
                       "MXNET_SERVE_CONCURRENCY": "1",
                       "MXNET_SERVE_QUEUE": "1"},
            name="replica-2-wedged")
        _wait_state(router, wedged.addr, "healthy", timeout=60)
        # saturate it: the slow in-flight batch backs its queue of 1 up
        # while /-/healthz keeps answering — the queue signal, not a
        # connect failure, must take it out
        burst = [threading.Thread(target=lambda: replicas[2].request(
            "POST", "/predict", payloads["m0"], JSON, timeout=30))
            for _ in range(6)]
        for t in burst:
            t.start()
        _wait_state(router, wedged.addr, "ejected", timeout=30,
                    want_reason="saturated")
        _check(True, "wedged replica ejected on the queue signal")
        for t in burst:
            t.join(timeout=30)
        # burn whatever poison is left so the probe finds it healthy
        for _ in range(8):
            code, _, _ = replicas[2].request("POST", "/predict",
                                             payloads["m0"], JSON,
                                             timeout=30)
            if code != 200:
                time.sleep(0.2)
        _wait_state(router, wedged.addr, "healthy", timeout=60)
        _check(True, "wedged replica re-admitted once drained")
        time.sleep(0.5)

        # ---- rolling deploy mid-load ----------------------------------
        enter("deploy")
        t0 = time.monotonic()
        code, raw, _ = router.request(
            "POST", "/-/deploy",
            json.dumps({"artifact_dir": art_b}).encode(), JSON, timeout=300)
        readings["deploy_seconds"] = time.monotonic() - t0
        dep = json.loads(raw)
        _check(code == 200 and dep.get("ok"),
               f"rolling deploy succeeded ({len(dep.get('steps') or ())}"
               f" steps in {readings['deploy_seconds']:.2f}s)")
        for r in replicas:
            row = _replica_row(router, r.addr)
            _check(row is not None and row.get("artifact") == art_b,
                   f"replica {r.addr} serving the new artifact")
        time.sleep(1.0)

        # ---- drain the load and judge ---------------------------------
        enter("done")
        stop.set()
        for t in threads:
            t.join(timeout=120)
        load_s = time.monotonic() - t_load

        _check(not downtime, "router readyz stayed 200 for the whole "
               f"run ({len(downtime)} violations)")

        oks = sheds = 0
        seen_phases = set()
        lat = []
        for ph, mid, code, out, hdr, secs, sent in results:
            if code == 200:
                oks += 1
                lat.append(secs)
                seen_phases.add(ph)
                if out != reference[mid]:
                    _check(False, f"[{ph}] 200 for {mid} NOT "
                           "bitwise-identical to the baseline")
            elif code in (429, 503):
                sheds += 1
                if "Retry-After" not in hdr:
                    _check(False,
                           f"[{ph}] {code} shed without Retry-After")
            else:
                # whether the fleet stalled or this request alone did
                inside = [r[5] for r in results if r[6] > sent
                          and r[6] + r[5] < sent + secs]
                _check(False, f"[{ph}] non-shed failure: {code} "
                       f"{out[:200]!r} (sent at {sent:.2f} s, answered "
                       f"after {secs:.2f} s; {len(inside)} requests sent "
                       f"and answered meanwhile, the slowest in "
                       f"{max(inside, default=0.0):.2f} s)")
        _check(True, "every response was a 200 or a shed with "
               "Retry-After, every 200 bitwise-identical")
        _check(oks >= 50, f"sustained load got {oks} 200s "
               f"({sheds} sheds, {len(results)} total)")
        for ph in ("sigkill", "wedge", "deploy"):
            _check(ph in seen_phases, f"load kept succeeding during "
                   f"the {ph} phase")
        readings.update({
            "load_seconds": load_s, "requests": len(results),
            "ok": oks, "shed": sheds,
            "requests_per_s": len(results) / load_s,
            "p50_ms": _quantile(lat, 0.5) * 1e3,
            "p99_ms": _quantile(lat, 0.99) * 1e3})

        # ---- the faults actually fired --------------------------------
        code, raw, _ = router.get("/metrics", timeout=5)
        text = raw.decode()
        _check(_metric_sum(text, "router_ejections_total",
                           reason="unreachable") >= 1 or
               _metric_sum(text, "router_ejections_total",
                           reason="breaker_open") >= 1,
               "ejection metric fired for the killed replica")
        _check(_metric_sum(text, "router_ejections_total",
                           reason="saturated") >= 1,
               "ejection metric fired for the wedged replica")
        _check(_metric_sum(text, "router_readmissions_total") >= 2,
               "re-admission metric fired")
        _check(_metric_sum(text, "router_deploys_total", result="ok") >= 1,
               "deploy metric fired")
        return readings
    finally:
        stop.set()
        for p in [router] + replicas:
            p.kill()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m incubator_mxnet_torch.tools.fleet_chaos")
    ap.add_argument("--ctx", default="gpu(0)",
                    help="the replicas' --ctx (default gpu(0))")
    ap.add_argument("--artifact", help="artifact A (default: a seeded MLP)")
    ap.add_argument("--artifact-b", help="a second export of the same "
                    "weights, the rolling deploy's target")
    args = ap.parse_args(argv)
    tmp = None
    art_a, art_b = args.artifact, args.artifact_b
    if art_a is None:
        tmp = tempfile.mkdtemp(prefix="fleet-art-")
        art_a = build_mlp_artifact(os.path.join(tmp, "a"), seed=7)
        art_b = build_mlp_artifact(os.path.join(tmp, "b"), seed=7)
    elif art_b is None:
        ap.error("--artifact needs --artifact-b")
    try:
        readings = run(art_a, art_b, args.ctx)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    print("FLEET-CHAOS OK", flush=True)
    print(json.dumps({"fleet_chaos": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
