"""Diagnose a machine and a running process for a bug report
(counterpart of the JAX package's `tools/diagnose.py`, MXNet's
`tools/diagnose.py`): platform, Python, packages, the card, the
`MXNET_*` environment, a compute check on the CPU and the card, the
telemetry registry, and the runtime planes — tracing, device profiling
(`profiling`), training health (`/-/numericz`), serving, debugz and
postmortems, the compile cache and the tuner.  The multi-GPU sections
of the JAX tool (kvstore overlap, ZeRO placement, mesh) and the
remediation controller come with their slices.

Usage: python -m incubator_mxnet_torch.tools.diagnose
"""
from __future__ import annotations

import os
import platform
import time


def _section(title):
    print(f"----------{title}----------")


def check_platform():
    _section("Platform Info")
    print("Platform     :", platform.platform())
    print("system       :", platform.system())
    print("node         :", platform.node())
    print("release      :", platform.release())
    print("version      :", platform.version())
    print("machine      :", platform.machine())


def check_python():
    _section("Python Info")
    print("Version      :", platform.python_version())
    print("Compiler     :", platform.python_compiler())
    print("Build        :", platform.python_build())


def check_packages():
    _section("Package Info")
    for mod in ("numpy", "torch", "triton"):
        try:
            m = __import__(mod)
            print(f"{mod:<13}: {getattr(m, '__version__', '?')}")
        except ImportError:
            print(f"{mod:<13}: not installed")
    import torch
    print(f"{'cuda (torch)':<13}: {torch.version.cuda}")
    from incubator_mxnet_torch import runtime
    feats = runtime.Features()
    print("features     :", " ".join(
        ("+" if f.enabled else "-") + n for n, f in sorted(feats.items())))


def check_devices():
    _section("Device Info")
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device (the port's entry points need ctx=cpu())")
        return
    for i in range(torch.cuda.device_count()):
        cap = "%d.%d" % torch.cuda.get_device_capability(i)
        free, total = torch.cuda.mem_get_info(i)
        print(f"  cuda:{i}: {torch.cuda.get_device_name(i)} (sm_{cap}) "
              f"{free / 2**30:.1f} of {total / 2**30:.1f} GiB free")
    try:
        import subprocess
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
        print("nvidia-smi   :", out or "(no output)")
    except (OSError, subprocess.SubprocessError) as e:
        print(f"nvidia-smi   : unavailable ({e})")


def check_env():
    _section("Environment")
    for k, v in sorted(os.environ.items()):
        if k.startswith(("MXNET_", "DMLC_", "CUDA_", "TORCH_", "OMP_")):
            print(f"{k}={v}")


def check_compute():
    _section("Compute Check")
    import numpy as np
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import nd
    for ctx_name, ctx in (("cpu", mx.cpu()),
                          ("gpu", mx.gpu(0) if mx.context.num_gpus()
                           else None)):
        if ctx is None:
            print(f"{ctx_name:<5}: no device")
            continue
        t0 = time.time()
        a = nd.array(np.ones((512, 512), np.float32), ctx=ctx)
        b = nd.dot(a, a)
        val = float(b.asnumpy()[0, 0])
        ok = "OK" if val == 512.0 else f"BAD ({val})"
        print(f"{ctx_name:<5}: 512x512 matmul {ok} "
              f"({(time.time() - t0) * 1e3:.1f} ms incl. dispatch)")


def check_telemetry():
    """Registry snapshot — runtime state (engine pending/executed,
    io/kvstore counters) for bug reports, not just environment."""
    _section("Telemetry")
    try:
        from incubator_mxnet_torch import telemetry
    except Exception as e:      # noqa: BLE001 — diagnose must keep going
        print("telemetry unavailable:", e)
        return
    try:
        # instantiate the host engine so its gauges report live state
        from incubator_mxnet_torch.engine import Engine
        Engine.get()
    except Exception:           # noqa: BLE001 — no compiler to build it
        pass
    snap = telemetry.snapshot()
    printed = 0
    for name, fam in sorted(snap.items()):
        for v in fam["values"]:
            labels = ",".join(f"{k}={val}" for k, val in
                              sorted(v["labels"].items()))
            lbl = f"{{{labels}}}" if labels else ""
            if fam["type"] == "histogram":
                if not v["count"]:
                    continue
                print(f"{name}{lbl}: count={v['count']} "
                      f"sum={v['sum']:.6g}s")
            else:
                print(f"{name}{lbl}: {v['value']:.6g}")
            printed += 1
    if not printed:
        print("(registry empty — no instrumented code ran)")


def check_tracing():
    """Tracing state for bug reports: the env flags in effect, the
    ``MXNET_TRACE_DIR`` contents, and a summary of the newest dumped
    timeline (span count, step count, slowest span)."""
    _section("Tracing")
    for flag in ("MXNET_TRACE", "MXNET_TRACE_SAMPLE", "MXNET_TRACE_DIR",
                 "MXNET_TRACE_BUFFER", "MXNET_TRACE_LABEL"):
        print(f"{flag:<20}: {os.environ.get(flag, '(unset)')}")
    d = os.environ.get("MXNET_TRACE_DIR")
    if not d:
        print("(set MXNET_TRACE=1 and MXNET_TRACE_DIR to dump "
              "Perfetto timelines at exit — docs/tracing.md)")
        return
    try:
        files = sorted(
            (f for f in os.listdir(d) if f.endswith(".json")),
            key=lambda f: os.path.getmtime(os.path.join(d, f)))
    except OSError as e:
        print(f"trace dir      : unreadable ({e})")
        return
    print(f"trace dir      : {len(files)} dump(s)")
    if not files:
        return
    newest = os.path.join(d, files[-1])
    try:
        import json
        with open(newest) as f:
            doc = json.load(f)
        evs = [e for e in doc.get("traceEvents", ())
               if e.get("ph") == "X"]
        steps = [e for e in evs if e.get("name") == "step"]
        print(f"newest dump    : {files[-1]} ({len(evs)} spans, "
              f"{len(steps)} steps)")
        if evs:
            slow = max(evs, key=lambda e: e.get("dur", 0))
            print(f"slowest span   : {slow['name']} "
                  f"({slow.get('dur', 0) / 1e3:.3f} ms)")
    except Exception as e:      # noqa: BLE001 — diagnose must keep going
        print(f"newest dump    : unparseable ({e})")


def check_profiling():
    """Device-profiling state (docs/observability.md "Device
    profiling"): capture capability, the window flags in effect, a
    live process's ``/-/profilez`` status (``MXNET_DEBUGZ_URL``), and
    the newest ``profile_report-*.json`` in ``MXNET_PROFILE_DIR`` —
    with its measured-vs-analytic disagreement flags, the first thing
    to check before trusting the ledger's analytic numbers."""
    _section("Profiling")
    import json
    for flag in ("MXNET_PROFILE_STEPS", "MXNET_PROFILE_DIR"):
        print(f"{flag:<20}: {os.environ.get(flag, '(unset)')}")
    try:
        from incubator_mxnet_torch import profiling
        sup = profiling.capture_supported()
    except Exception as e:      # noqa: BLE001 — diagnose must keep going
        print(f"capture        : unavailable ({e})")
        return
    print(f"capture        : {'available' if sup else 'UNSUPPORTED'} "
          f"(torch.profiler trace, CUDA activity with a card)")
    url = os.environ.get("MXNET_DEBUGZ_URL")
    if url:
        import urllib.request
        try:
            with urllib.request.urlopen(
                    url.rstrip("/") + "/-/profilez", timeout=5) as r:
                pz = json.load(r)
            print(f"live profilez  : supported={pz.get('supported')} "
                  f"armed={bool(pz.get('armed'))} "
                  f"captures={pz.get('capture_seq')} "
                  f"steps_seen={pz.get('steps_seen')}")
        except Exception as e:  # noqa: BLE001 — diagnose must keep going
            print(f"live profilez  : unreachable ({e})")
    d = os.environ.get("MXNET_PROFILE_DIR")
    if not d:
        print("(set MXNET_PROFILE_DIR + MXNET_PROFILE_STEPS=k:n — or "
              "hit a live /-/profilez?steps=N — to capture a device "
              "timeline)")
        return
    try:
        files = sorted(
            (f for f in os.listdir(d)
             if f.startswith("profile_report-") and f.endswith(".json")),
            key=lambda f: os.path.getmtime(os.path.join(d, f)))
    except OSError as e:
        print(f"profile dir    : unreadable ({e})")
        return
    print(f"profile dir    : {len(files)} report(s)")
    if not files:
        return
    try:
        with open(os.path.join(d, files[-1])) as f:
            rep = json.load(f)
        win = rep.get("window") or {}
        dev = rep.get("device") or {}
        print(f"newest report  : {files[-1]} ({win.get('steps')} "
              f"steps, {dev.get('event_count')} device events, "
              f"anchor skew {win.get('anchor_skew_ms')} ms)")
        top = (rep.get("top_ops") or [{}])[0]
        if top.get("name"):
            print(f"top op         : {top['name'][:60]} "
                  f"({top.get('pct')}% [{top.get('class')}])")
        dis = rep.get("disagreements") or []
        if dis:
            print(f"DISAGREEMENTS  : {', '.join(dis)} — measured "
                  f"device truth contradicts the analytic accounting "
                  f"(see report cross_checks)")
        else:
            print(f"cross-checks   : "
                  f"{len(rep.get('cross_checks') or [])} ran, all "
                  f"within tolerance")
    except Exception as e:      # noqa: BLE001 — diagnose must keep going
        print(f"newest report  : unparseable ({e})")


def check_health():
    """Training-health state (docs/observability.md "Numerics & model
    health"): the MXNET_HEALTH flags in effect, and — when
    ``MXNET_DEBUGZ_URL`` points at a live process — its ``/-/numericz``
    ledger: last grad/weight norms, last anomaly, and the last
    divergence-audit verdict."""
    _section("Training health")
    import json
    for flag in ("MXNET_HEALTH", "MXNET_HEALTH_AUTOCAPTURE",
                 "MXNET_HEALTH_AUDIT_STEPS", "MXNET_HEALTH_BAND",
                 "MXNET_HEALTH_FAULT_PLAN"):
        print(f"{flag:<26}: {os.environ.get(flag, '(unset)')}")
    url = os.environ.get("MXNET_DEBUGZ_URL")
    if not url:
        print("(set MXNET_HEALTH=1 for in-step numerics + divergence "
              "audits, and MXNET_DEBUGZ_URL to probe a live "
              "/-/numericz)")
        return
    import urllib.request
    try:
        with urllib.request.urlopen(url.rstrip("/") + "/-/numericz",
                                    timeout=5) as r:
            nz = json.load(r)
    except Exception as e:      # noqa: BLE001 — diagnose must keep going
        print(f"live numericz : unreachable ({e})")
        return
    print(f"live numericz : enabled={nz.get('enabled')} "
          f"autocapture={nz.get('autocapture')} "
          f"audit_steps={nz.get('audit_steps')}")
    for tr in nz.get("trainers") or ():
        last = tr.get("last") or {}
        print(f"  {tr.get('label')} (rank {tr.get('rank')}): "
              f"step={last.get('step')} "
              f"grad_norm={last.get('grad_norm')} "
              f"weight_norm={last.get('weight_norm')} "
              f"nonfinite={last.get('nonfinite')} "
              f"anomalies={tr.get('anomalies')}")
        la = tr.get("last_anomaly")
        if la:
            cap = la.get("profile_report")
            print(f"    last anomaly: {la.get('anomaly')} at step "
                  f"{la.get('step')}"
                  + (f" (capture: {cap})" if cap else ""))
        audit = tr.get("last_audit")
        if audit:
            verdict = "ok" if audit.get("ok") else (
                f"DIVERGED — {audit.get('diverged')}")
            print(f"    last audit : step {audit.get('step')} "
                  f"scope={audit.get('scope')} {verdict}")


def check_serving():
    """Serving health for bug reports: artifact integrity against its
    manifest (``MXNET_SERVE_ARTIFACT``), and a live runtime's breaker /
    queue / last-reload state via its ``/-/healthz`` endpoint
    (``MXNET_SERVE_URL``, e.g. ``http://127.0.0.1:8080``)."""
    _section("Serving")
    artifact = os.environ.get("MXNET_SERVE_ARTIFACT")
    if artifact:
        try:
            from incubator_mxnet_torch.deploy import validate_artifact
            manifest = validate_artifact(artifact)
            n = len(manifest["files"]) if manifest else 0
            detail = (f"{n} files checksum-verified" if manifest
                      else "no manifest.json (pre-manifest export)")
            print(f"artifact     : OK ({detail})")
        except Exception as e:      # noqa: BLE001 — diagnose must keep going
            print(f"artifact     : BAD — {e}")
    url = os.environ.get("MXNET_SERVE_URL")
    if url:
        import json
        import urllib.request
        try:
            with urllib.request.urlopen(url.rstrip("/") + "/-/healthz",
                                        timeout=5) as r:
                h = json.load(r)
            print(f"status       : {h['status']}")
            b = h["breaker"]
            print(f"breaker      : {b['state']} "
                  f"(consecutive_failures={b['consecutive_failures']}/"
                  f"{b['threshold']})")
            q = h["queue"]
            print(f"queue        : {q['depth']}/{q['limit']} queued, "
                  f"{h['inflight_calls']} in-flight")
            w = h["workers"]
            print(f"workers      : {w['live']} live "
                  f"({w['stuck']} stuck, target {w['target']})")
            lr = h.get("last_reload")
            if lr is None:
                print("last reload  : (none this process)")
            elif lr["ok"]:
                print(f"last reload  : OK -> {lr['artifact_dir']} "
                      f"({lr['seconds']:.2f}s)")
            else:
                print(f"last reload  : ROLLED BACK — {lr['error']}")
        except Exception as e:      # noqa: BLE001 — diagnose must keep going
            print(f"healthz      : unreachable ({e})")
    if not artifact and not url:
        print("(set MXNET_SERVE_ARTIFACT and/or MXNET_SERVE_URL to "
              "check an artifact / live server)")


def check_debugz():
    """Debugz / postmortem state for bug reports: probe a live
    process's introspection endpoints (``MXNET_DEBUGZ_URL``, e.g.
    ``http://127.0.0.1:7071``) and summarize the newest postmortem in
    ``MXNET_POSTMORTEM_DIR`` (docs/observability.md)."""
    _section("Debugz / Postmortem")
    import json
    url = os.environ.get("MXNET_DEBUGZ_URL")
    if url:
        import urllib.request
        base = url.rstrip("/")
        try:
            with urllib.request.urlopen(base + "/-/statusz",
                                        timeout=5) as r:
                st = json.load(r)
            print(f"statusz      : {st.get('role')}:r{st.get('rank')}"
                  f"@{st.get('host')} pid={st.get('pid')} "
                  f"up {st.get('uptime_seconds', 0):.0f}s "
                  f"step={st.get('current_step')}")
            srv = st.get("kvstore_server")
            if isinstance(srv, dict):
                print(f"kv server    : epoch={srv.get('epoch')} "
                      f"live={srv.get('live')} keys={srv.get('keys')}")
            tr = st.get("trainer")
            if isinstance(tr, dict):
                m = tr.get("membership") or {}
                print(f"trainer      : steps={tr.get('steps')} "
                      f"epoch={m.get('epoch')} live={m.get('live')}")
        except Exception as e:  # noqa: BLE001 — diagnose must keep going
            print(f"statusz      : unreachable ({e})")
        try:
            with urllib.request.urlopen(base + "/-/stackz",
                                        timeout=5) as r:
                sz = json.load(r)
            names = sorted(t["name"] for t in sz.get("threads", ()))
            print(f"stackz       : {sz.get('thread_count')} threads "
                  f"({', '.join(names[:6])}"
                  f"{', ...' if len(names) > 6 else ''})")
        except Exception as e:  # noqa: BLE001 — diagnose must keep going
            print(f"stackz       : unreachable ({e})")
    d = os.environ.get("MXNET_POSTMORTEM_DIR")
    if d:
        try:
            files = sorted(
                (f for f in os.listdir(d)
                 if f.startswith("postmortem-") and f.endswith(".json")),
                key=lambda f: os.path.getmtime(os.path.join(d, f)))
        except OSError as e:
            files = None
            print(f"postmortems  : unreadable ({e})")
        if files is not None and not files:
            print("postmortems  : none (no crash recorded)")
        elif files:
            newest = os.path.join(d, files[-1])
            try:
                with open(newest) as f:
                    pm = json.load(f)
                exc = pm.get("exception") or {}
                print(f"postmortems  : {len(files)} file(s); newest "
                      f"{files[-1]}")
                print(f"  reason     : {pm.get('reason')} "
                      f"at step {pm.get('step')}")
                if exc:
                    print(f"  exception  : {exc.get('type')}: "
                          f"{exc.get('message')}")
                print(f"  evidence   : "
                      f"{len(pm.get('flight_events', []))} flight "
                      f"events, {len(pm.get('threads', []))} thread "
                      f"stacks, {len(pm.get('traces', []))} traces")
            except Exception as e:  # noqa: BLE001 — keep going
                print(f"postmortems  : newest unparseable ({e})")
    if not url and not d:
        print("(set MXNET_DEBUGZ_URL to probe a live process and/or "
              "MXNET_POSTMORTEM_DIR to summarize crash evidence — "
              "docs/observability.md)")


def check_cache_tuner():
    """Persistent compile cache + auto-tuner state (docs/perf.md §7):
    the cache directory's entry count/bytes against its LRU cap, this
    process's hit/miss counters, and the tuned.json artifact the
    process would consume — the first stop for "cache hit rate is 0 —
    why?" and "which winner is this fleet actually running?"."""
    _section("Compile cache / Tuner")
    for flag in ("MXNET_COMPILE_CACHE_DIR", "MXNET_COMPILE_CACHE_MAX_MB",
                 "MXNET_TUNED_CONFIG"):
        print(f"{flag:<28}: {os.environ.get(flag, '(unset)')}")
    try:
        from incubator_mxnet_torch import compile_cache, tuner
    except Exception as e:      # noqa: BLE001 — diagnose must keep going
        print(f"import failed : {e}")
        return
    s = compile_cache.stats()
    if not s["enabled"]:
        print("cache        : OFF (set MXNET_COMPILE_CACHE_DIR to let a "
              "later export reuse compiled AOTInductor packages)")
    else:
        print(f"cache        : {s['entries']} entries, {s['bytes']} "
              f"bytes (cap {s['max_mb']} MB) in {s['dir']}")
        print(f"this process : hits={s['hits']} misses={s['misses']} "
              f"puts={s['puts']} evictions={s['evictions']} "
              f"compile_seconds={s['compile_seconds']}")
        bt = compile_cache.backend_token()
        print(f"key backend  : torch={bt['torch']} cuda={bt['cuda']} "
              f"{bt['device_kind']} sm={bt['capability']} (a mismatch "
              "on ANY component is a different key — the usual "
              "zero-hit-rate cause)")
    doc = tuner.load_tuned()
    if doc is None:
        print("tuned.json   : none loaded (run the tuner, then point "
              "MXNET_TUNED_CONFIG at its winner artifact)")
    else:
        print(f"tuned.json   : winner={doc.get('winner')} "
              f"score={doc.get('score')} trials={doc.get('trials')}")


def main():
    check_platform()
    check_python()
    check_packages()
    check_devices()
    check_env()
    check_compute()
    check_telemetry()
    check_tracing()
    check_profiling()
    check_health()
    check_serving()
    check_debugz()
    check_cache_tuner()


if __name__ == "__main__":
    main()
