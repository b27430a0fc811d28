#!/usr/bin/env python
"""Fleet health aggregator (counterpart of the JAX package's
`tools/fleetz.py`): scrape every debugz endpoint, join the processes,
derive health signals.

The port serves the planes' pages `goodputz`, `numericz`, `profilez`
and `tunerz`.  What the JAX tool reads from the distributed parameter
server — `controllerz`, `checkpointz`, the servers' statusz and wire
counters, the membership and ownership epochs — comes with that
server, and so does the controller's one-shot decision mode.

Every process — `gluon.Trainer` and `ParallelTrainer` workers, serving
replicas, routers — exposes a debugz endpoint (``MXNET_DEBUGZ_PORT``;
the serving front end serves the same paths on its own port).  This
tool scrapes ``/-/statusz``, ``/-/metricz``, ``/-/flightz`` and
``/-/tracez`` from each, joins them by identity (role/rank/host/pid)
and trace identity (shared trace ids across process dumps), and
derives:

* **Stragglers** — per-worker step-time EWMA over the flight
  recorder's step events, compared against the fleet median.  The
  signal is each step's COMPUTE seconds (time between steps, which
  excludes exchange wait): in a sync fleet the *fast* workers show the
  long step() walls because they wait for the straggler inside the
  exchange, so wall-step-time would flag exactly the wrong process.
  Chronic stragglers feed the ROADMAP item 4 backup-step work.
* **Step-time regression** — a worker whose recent steps are
  significantly slower than its own earlier steps (input pipeline
  degradation, thermal throttle, noisy neighbor).
* **Serving saturation** — queue depth near the limit, non-closed
  breaker, stuck workers, shed counters; plus a fleet-level rollup
  (every replica saturated = the condition under which the router
  sheds 429 up front).
* **Router join** — a router process's statusz registry (per-replica
  state/reason/inflight) lands in ``report["routers"]``, joining the
  router's view of the fleet with each replica's own serving row;
  an ejected replica is a finding.
* **Fleet goodput** — from each worker's ``/-/goodputz`` ledger
  window (docs/observability.md "Goodput ledger"): fleet goodput is
  sum(useful compute seconds) / sum(wall seconds) across workers,
  each worker is attributed its DOMINANT loss bucket (input_stall /
  wire_exposed / straggler_wait / ...), and workers rank by their
  loss share — "the fleet is at 61% goodput and worker 3 loses 30%
  to input stall" is one scrape.

Usage::

    python -m incubator_mxnet_torch.tools.fleetz --endpoints \
        127.0.0.1:7071,127.0.0.1:7072
    python -m incubator_mxnet_torch.tools.fleetz host:port --json
    ... --strict     # exit 1 on any finding
    ... --capture --capture-steps 4 \
        --out fleet_profile.json            # fleet device capture

``--capture`` (docs/observability.md "Device profiling") arms
SIMULTANEOUS ``/-/profilez?steps=N`` windows on every endpoint, waits
for each process's capture to finish, then merges the per-process
host+device timelines into ONE fleet Perfetto file — pids remapped per
process, spans still joined by the shared trace ids in ``args`` — and
summarizes each process's report (device events, anchor skew,
cross-check disagreements).

The derivation functions (`detect_stragglers`, `detect_regression`,
`derive_health`, `merge_fleet_traces`) are pure over scraped/synthetic
snapshots, so tests and other tools can reuse them without a live
fleet.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import urllib.request

DEFAULT_BAND = 0.3          # relative step-time excess flagging a straggler
MIN_STEPS = 3               # ignore workers with fewer step samples


# ---------------------------------------------------------------------
# scraping
# ---------------------------------------------------------------------

def _get_json(url, timeout):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def scrape(endpoint, timeout=5.0):
    """One process's debugz snapshot: ``{"endpoint", "statusz",
    "metricz", "flightz", "tracez"}`` (or ``{"endpoint", "error"}``
    when unreachable — a dead process is itself a finding)."""
    base = endpoint if "://" in endpoint else f"http://{endpoint}"
    base = base.rstrip("/")
    snap = {"endpoint": endpoint}
    try:
        snap["statusz"] = _get_json(base + "/-/statusz", timeout)
    except Exception as e:      # noqa: BLE001 — reported, not raised
        snap["error"] = f"{type(e).__name__}: {e}"
        return snap
    for name in ("metricz", "flightz", "tracez", "goodputz",
                 "numericz", "tunerz"):
        try:
            snap[name] = _get_json(f"{base}/-/{name}", timeout)
        except Exception as e:  # noqa: BLE001 — partial snapshot is fine
            snap[name] = {"error": f"{type(e).__name__}: {e}"}
    return snap


def gather(endpoints, timeout=5.0):
    return [scrape(ep, timeout=timeout) for ep in endpoints]


# ---------------------------------------------------------------------
# snapshot accessors (tolerant of partial/synthetic payloads)
# ---------------------------------------------------------------------

def metric_value(metricz, name, **labels):
    """Sum of a counter/gauge's children matching the label SUBSET
    (histograms: observation count), or None when absent."""
    fam = ((metricz or {}).get("metrics") or {}).get(name)
    if not fam:
        return None
    total, hit = 0.0, False
    for v in fam.get("values", ()):
        vl = v.get("labels") or {}
        if any(str(vl.get(k)) != str(val) for k, val in labels.items()):
            continue
        hit = True
        total += v["count"] if fam.get("type") == "histogram" \
            else v.get("value", 0.0)
    return total if hit else None


def step_times(flightz):
    """Per-step seconds from a flightz payload, preferring the
    compute-phase seconds (straggler attribution — see module doc).
    Compute and wall samples are never mixed into one series: when any
    event carries ``compute_seconds`` only those are used (the first
    step of a run has no previous-step anchor, and its wall time in a
    sync fleet includes waiting on peers — seeding the EWMA with it
    would mis-attribute).  Events from different trainers (a
    multi-trainer process labels them) are never merged either — the
    DOMINANT series (most events: the training loop, not an eval
    trainer) is the one graded, instead of an EWMA over a bimodal
    interleave."""
    by_trainer = {}
    for ev in (flightz or {}).get("events", ()):
        if ev.get("kind") == "step":
            by_trainer.setdefault(ev.get("trainer"), []).append(ev)
    if not by_trainer:
        return []
    events = max(by_trainer.values(), key=len)
    compute = [float(ev["compute_seconds"]) for ev in events
               if ev.get("compute_seconds") is not None]
    if compute:
        return compute
    return [float(ev["seconds"]) for ev in events
            if ev.get("seconds") is not None]


def _identity(snap):
    st = snap.get("statusz") or {}
    return {"endpoint": snap.get("endpoint"),
            "role": st.get("role", "?"),
            "rank": st.get("rank"),
            "host": st.get("host", "?"),
            "pid": st.get("pid"),
            "uptime_seconds": st.get("uptime_seconds")}


def _goodput_window(snap):
    """The DOMINANT trainer's ledger window from a goodputz payload
    (most total steps — the training loop, not an eval trainer), or
    None."""
    gz = snap.get("goodputz") or {}
    trainers = [t for t in (gz.get("trainers") or ())
                if isinstance(t, dict) and t.get("window")]
    if not trainers:
        return None
    top = max(trainers, key=lambda t: t.get("steps", 0))
    return top.get("window")


def _trace_ids(snap):
    tz = snap.get("tracez") or {}
    ids = set()
    for t in tz.get("traces", ()) or ():
        tid = t.get("trace_id")
        if tid:
            ids.add(tid)
    return ids


# ---------------------------------------------------------------------
# derivation (pure — tests feed synthetic inputs)
# ---------------------------------------------------------------------

def _ewma(values, alpha=0.3):
    e = float(values[0])
    for v in values[1:]:
        e += alpha * (float(v) - e)
    return e


def detect_stragglers(per_worker, band=DEFAULT_BAND,
                      min_steps=MIN_STEPS):
    """Workers whose step-time EWMA exceeds the fleet median by more
    than `band` (relative).  `per_worker`: {key: [seconds, ...]}.
    Needs >= 2 workers with >= `min_steps` samples each — a fleet of
    one has no peer to straggle behind."""
    ewmas = {k: _ewma(v) for k, v in per_worker.items()
             if len(v) >= min_steps}
    if len(ewmas) < 2:
        return []
    med = statistics.median(ewmas.values())
    if med <= 0:
        return []
    return sorted(k for k, e in ewmas.items()
                  if e > (1.0 + band) * med)


def goodput_rollup(per_worker):
    """Fleet goodput from per-worker ledger windows.

    `per_worker`: ``{key: {"wall_seconds", "buckets": {bucket: secs},
    ...}}`` (a `goodput.StepLedger.summary()["window"]` per worker —
    scraped from ``/-/goodputz`` or synthetic).  Returns None when no
    worker has traced wall, else::

        {"fleet_goodput_fraction",      # sum useful / sum wall
         "wall_seconds", "buckets",     # fleet-summed
         "workers": [{"process", "goodput_fraction",
                      "loss_fraction", "dominant_loss_bucket",
                      "dominant_loss_fraction"}, ...]}   # ranked by
                                                         # loss_fraction
    """
    rows = []
    fleet_wall = 0.0
    fleet_buckets = {}
    for key, win in sorted(per_worker.items()):
        win = win or {}
        buckets = win.get("buckets") or {}
        wall = win.get("traced_wall_seconds")
        if wall is None:
            wall = win.get("wall_seconds")
        try:
            wall = float(wall)
        except (TypeError, ValueError):
            continue
        if wall <= 0 or not buckets:
            continue
        fleet_wall += wall
        for b, s in buckets.items():
            fleet_buckets[b] = fleet_buckets.get(b, 0.0) + float(s)
        compute = float(buckets.get("compute", 0.0))
        loss = {b: float(s) for b, s in buckets.items()
                if b != "compute" and float(s) > 0.0}
        dom = max(loss, key=loss.get) if loss else None
        rows.append({
            "process": key,
            "wall_seconds": round(wall, 6),
            "steps": win.get("steps"),
            "goodput_fraction": round(compute / wall, 4),
            "loss_fraction": round(1.0 - compute / wall, 4),
            "dominant_loss_bucket": dom,
            "dominant_loss_fraction": (round(loss[dom] / wall, 4)
                                       if dom else None),
            "buckets": {b: round(float(s), 6)
                        for b, s in sorted(buckets.items())},
        })
    if fleet_wall <= 0:
        return None
    rows.sort(key=lambda r: -r["loss_fraction"])
    return {
        "fleet_goodput_fraction": round(
            fleet_buckets.get("compute", 0.0) / fleet_wall, 4),
        "wall_seconds": round(fleet_wall, 6),
        "buckets": {b: round(s, 6)
                    for b, s in sorted(fleet_buckets.items())},
        "workers": rows,
    }


def detect_regression(times, band=DEFAULT_BAND, min_steps=6):
    """True when the recent half of a worker's own step times is
    slower than its earlier half by more than `band` (relative) — a
    within-worker slowdown rather than a cross-worker imbalance."""
    if len(times) < min_steps:
        return False
    half = len(times) // 2
    early = statistics.median(times[:half])
    late = statistics.median(times[half:])
    return early > 0 and late > (1.0 + band) * early


def derive_health(snapshots, band=DEFAULT_BAND, min_steps=MIN_STEPS):
    """The fleet report, from scraped (or synthetic) snapshots."""
    processes, unreachable = [], []
    worker_steps = {}
    goodput_windows = {}
    numerics = []
    serving = []
    routers = []
    trace_sets = {}

    for snap in snapshots:
        ident = _identity(snap)
        if "error" in snap:
            unreachable.append({**ident, "error": snap["error"]})
            continue
        row = dict(ident)
        # pid-suffixed so co-hosted replicas sharing a default rank
        # (two serving processes on one box) never collide in the join
        key = (f"{ident['role']}:r{ident['rank']}@{ident['host']}"
               f"#{ident['pid']}")
        tids = _trace_ids(snap)
        if tids:
            trace_sets[key] = tids
        mz = snap.get("metricz")

        if ident["role"] == "worker" or \
                (snap.get("statusz") or {}).get("trainer"):
            times = step_times(snap.get("flightz"))
            row["steps"] = len(times)
            if times:
                row["step_time_ewma"] = round(_ewma(times), 6)
                worker_steps[key] = times
            win = _goodput_window(snap)
            if win:
                goodput_windows[key] = win
            # numerics & model health (MXNET_HEALTH=1, served at
            # /-/numericz): anomalies (NaN grads, loss spikes) and
            # failed divergence audits are per-worker findings — a
            # diverged audit NAMES the bad participant
            nz = snap.get("numericz")
            for tr in ((nz or {}).get("trainers") or ()):
                if not isinstance(tr, dict):
                    continue
                an = tr.get("anomalies") or 0
                la = tr.get("last_anomaly") or {}
                audit = tr.get("last_audit") or {}
                if an:
                    numerics.append(
                        {"process": key, "trainer": tr.get("label"),
                         "kind": "anomalies", "count": an,
                         "last": la.get("anomaly"),
                         "step": la.get("step")})
                if audit and audit.get("ok") is False:
                    numerics.append(
                        {"process": key, "trainer": tr.get("label"),
                         "kind": "audit_diverged",
                         "scope": audit.get("scope"),
                         "step": audit.get("step"),
                         "diverged": audit.get("diverged")})

        sv = (snap.get("statusz") or {}).get("serving")
        if isinstance(sv, dict) and "queue" in sv:
            q = sv.get("queue") or {}
            brk = (sv.get("breaker") or {}).get("state")
            stuck = (sv.get("workers") or {}).get("stuck", 0)
            shed = metric_value(mz, "serving_shed") or 0
            depth, limit = q.get("depth", 0), max(1, q.get("limit", 1))
            findings = []
            if depth >= 0.8 * limit:
                findings.append(f"queue {depth}/{limit}")
            if brk and brk != "closed":
                findings.append(f"breaker {brk}")
            if stuck:
                findings.append(f"{stuck} stuck workers")
            if shed:
                findings.append(f"{int(shed)} shed")
            serving.append({"process": key, "status": sv.get("status"),
                            "queue_depth": depth, "queue_limit": limit,
                            "breaker": brk, "stuck": stuck,
                            "shed": shed, "saturated": bool(findings),
                            "findings": findings})

        # the serving-fleet router's registry: its per-replica states
        # join here with the replicas' own serving rows (same report,
        # two views of one fleet — docs/deploy.md "Serving fleet")
        rt = (snap.get("statusz") or {}).get("router")
        if isinstance(rt, dict) and "replicas" in rt:
            reps = [{"addr": r.get("addr"), "state": r.get("state"),
                     "reason": r.get("reason"),
                     "breaker": r.get("breaker"),
                     "inflight": r.get("inflight"),
                     "queue_depth": r.get("queue_depth"),
                     "queue_limit": r.get("queue_limit")}
                    for r in rt.get("replicas") or ()]
            routers.append({
                "process": key,
                "healthy_replicas": rt.get("healthy"),
                "replicas": reps,
                "requests": rt.get("requests"),
                "p95_ms": rt.get("p95_ms"),
                "draining": rt.get("draining"),
                "last_deploy_ok": (rt.get("last_deploy")
                                   or {}).get("ok"),
            })
            row["router"] = {"healthy": rt.get("healthy"),
                             "replicas": len(reps)}
        processes.append(row)

    stragglers = detect_stragglers(worker_steps, band=band,
                                   min_steps=min_steps)
    regressions = sorted(k for k, v in worker_steps.items()
                         if detect_regression(v, band=band))

    shared = set.intersection(*trace_sets.values()) \
        if len(trace_sets) >= 2 else set()

    # fleet-level serving saturation: the router sheds 429 up front
    # when EVERY replica saturates; this rollup is the same condition
    # derived observer-side
    serving_fleet = None
    if serving:
        sat = sum(1 for s in serving if s["saturated"])
        serving_fleet = {"replicas": len(serving), "saturated": sat,
                         "all_saturated": sat == len(serving)}
    ejected_replicas = [r for rt in routers
                        for r in rt["replicas"]
                        if r.get("state") == "ejected"]

    return {
        "generated_unix_time": time.time(),
        "processes": processes,
        "unreachable": unreachable,
        "trace_join": {"processes_with_traces": len(trace_sets),
                       "shared_trace_ids": len(shared)},
        "goodput": goodput_rollup(goodput_windows),
        "stragglers": stragglers,
        "step_time_regressions": regressions,
        "numerics": numerics,
        "serving": serving,
        "serving_fleet": serving_fleet,
        "routers": routers,
        "healthy": not (stragglers or regressions or numerics
                        or unreachable
                        or any(s["saturated"] for s in serving)
                        or ejected_replicas),
    }


# ---------------------------------------------------------------------
# fleet device capture (--capture)
# ---------------------------------------------------------------------

def merge_fleet_traces(docs, labels):
    """Merge per-process merged-timeline dicts into ONE fleet Chrome
    trace (pure — tests feed synthetic docs).  Every process's pids
    are remapped into a disjoint range (two hosts can share an OS
    pid), its process_name metadata is prefixed with the endpoint
    label, and span ``args`` (trace ids) pass through untouched — the
    cross-process join key Perfetto readers group on."""
    events = []
    trace_sets = []
    for idx, (doc, label) in enumerate(zip(docs, labels)):
        pid_map = {}
        tids = set()
        for ev in doc.get("traceEvents", ()):
            ev = dict(ev)
            orig = ev.get("pid", 0)
            new = pid_map.get(orig)
            if new is None:
                new = pid_map[orig] = idx * 100 + len(pid_map) + 1
            ev["pid"] = new
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                nm = (ev.get("args") or {}).get("name", "")
                ev["args"] = {"name": f"{label} {nm}".strip()}
            tid = (ev.get("args") or {}).get("trace_id")
            if tid:
                tids.add(tid)
            events.append(ev)
        trace_sets.append(tids)
    shared = set.intersection(*trace_sets) if len(trace_sets) >= 2 \
        and all(trace_sets) else set()
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"processes": list(labels),
                          "shared_trace_ids": len(shared)}}


def capture_fleet(endpoints, steps=4, timeout=120.0, poll=0.5,
                  http_timeout=10.0):
    """Trigger simultaneous capture windows across the fleet and merge
    the results.  Returns ``(merged_doc_or_None, rows)`` where each
    row summarizes one endpoint (or carries its error).

    Windows are armed with BOTH a step count and a deadline
    (``?steps=N&duration_ms=M``, whichever closes first): a fleet
    spans process classes, and a steps-only window on a process that
    never steps — a serving replica, a router — would wedge
    the whole capture until the timeout.  With the deadline, workers
    close after `steps` boundaries and stepless processes close at
    the deadline with whatever device work their window saw."""
    import threading

    bases = [(ep if "://" in ep else f"http://{ep}").rstrip("/")
             for ep in endpoints]
    rows = [{"endpoint": ep} for ep in endpoints]
    # the window's deadline leaves the poll loop room to see the
    # close + fetch the trace before `timeout` expires
    duration_ms = max(1000, int(timeout * 0.5 * 1000))
    # arming starts the trace ON the endpoint's HTTP thread, and a
    # process's FIRST start_trace pays the profiler backend's cold
    # init (measured 10-15s; worse when a whole fleet cold-inits
    # concurrently) — the arm request gets its own headroom
    arm_timeout = max(http_timeout, 90.0)

    def _arm(i):
        try:
            st = _get_json(f"{bases[i]}/-/profilez", http_timeout)
            rows[i]["seq0"] = st.get("capture_seq", 0)
            if not st.get("supported", True):
                rows[i]["error"] = "capture unsupported on this build"
                return
            armed = _get_json(
                f"{bases[i]}/-/profilez?steps={int(steps)}"
                f"&duration_ms={duration_ms}",
                arm_timeout)
            if armed.get("error"):
                rows[i]["error"] = armed["error"]
        except Exception as e:  # noqa: BLE001 — reported, not raised
            rows[i]["error"] = f"{type(e).__name__}: {e}"

    # arm from one thread per endpoint so the windows open together —
    # a serial arm loop would skew the fleet's windows by the HTTP
    # round-trips
    threads = [threading.Thread(target=_arm, args=(i,))
               for i in range(len(bases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    deadline = time.monotonic() + timeout
    docs, labels = [], []
    for i, base in enumerate(bases):
        if rows[i].get("error"):
            continue
        done = False
        last_err = None
        while time.monotonic() < deadline:
            try:
                st = _get_json(f"{base}/-/profilez", http_timeout)
            except Exception as e:  # noqa: BLE001 — transient: a poll
                # can block behind the endpoint's cold profiler init
                # or its post-processing; keep polling to the deadline
                last_err = f"{type(e).__name__}: {e}"
                time.sleep(poll)
                continue
            if st.get("capture_seq", 0) > rows[i]["seq0"] \
                    and not st.get("armed") and not st.get("active"):
                rep = st.get("last_report") or {}
                rows[i]["report"] = {
                    "steps": (rep.get("window") or {}).get("steps"),
                    "device_events":
                        (rep.get("device") or {}).get("event_count"),
                    "anchor_skew_ms":
                        (rep.get("window") or {}).get("anchor_skew_ms"),
                    "disagreements": rep.get("disagreements"),
                }
                done = True
                break
            time.sleep(poll)
        if not done:
            rows[i].setdefault(
                "error", f"capture did not finish within {timeout}s"
                + (f" (last poll error: {last_err})" if last_err
                   else ""))
            continue
        try:
            doc = _get_json(f"{base}/-/profilez?view=trace",
                            http_timeout)
        except Exception as e:  # noqa: BLE001
            rows[i]["error"] = f"{type(e).__name__}: {e}"
            continue
        if "traceEvents" not in doc:
            rows[i]["error"] = f"no merged trace: {doc.get('error')}"
            continue
        docs.append(doc)
        labels.append(endpoints[i])
    merged = merge_fleet_traces(docs, labels) if docs else None
    return merged, rows


# ---------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------

def render_text(report):
    lines = ["fleetz: "
             + ("HEALTHY" if report["healthy"] else "FINDINGS")]
    lines.append(f"  processes ({len(report['processes'])} up, "
                 f"{len(report['unreachable'])} unreachable):")
    for p in report["processes"]:
        extra = ""
        if "step_time_ewma" in p:
            extra = (f" steps={p.get('steps')} "
                     f"ewma={p['step_time_ewma'] * 1e3:.1f}ms")
        lines.append(f"    {p['role']}:r{p['rank']}@{p['host']} "
                     f"pid={p['pid']}{extra}")
    for u in report["unreachable"]:
        lines.append(f"    UNREACHABLE {u['endpoint']}: {u['error']}")
    tj = report["trace_join"]
    if tj["processes_with_traces"] >= 2:
        lines.append(f"  trace join: {tj['shared_trace_ids']} trace "
                     f"ids shared across "
                     f"{tj['processes_with_traces']} processes")
    gp = report.get("goodput")
    if gp:
        lines.append(f"  goodput: fleet "
                     f"{gp['fleet_goodput_fraction'] * 100:.1f}%")
        for w in gp["workers"]:
            dom = (f", {w['dominant_loss_fraction'] * 100:.1f}% to "
                   f"{w['dominant_loss_bucket']}"
                   if w["dominant_loss_bucket"] else "")
            lines.append(f"    {w['process']}: "
                         f"{w['goodput_fraction'] * 100:.1f}%{dom}")
    lines.append("  stragglers: "
                 + (", ".join(report["stragglers"]) or "none"))
    if report["step_time_regressions"]:
        lines.append("  step-time regressions: "
                     + ", ".join(report["step_time_regressions"]))
    for n in report.get("numerics") or ():
        if n["kind"] == "audit_diverged":
            lines.append(
                f"  numerics: {n['process']} AUDIT DIVERGED "
                f"(scope={n.get('scope')}, step={n.get('step')}, "
                f"diverged={n.get('diverged')})")
        else:
            lines.append(
                f"  numerics: {n['process']} {n['count']} "
                f"anomalies (last: {n.get('last')} at step "
                f"{n.get('step')})")
    for s in report["serving"]:
        state = "SATURATED: " + "; ".join(s["findings"]) \
            if s["saturated"] else "ok"
        lines.append(f"  serving {s['process']}: {state}")
    sf = report.get("serving_fleet")
    if sf and sf["saturated"]:
        lines.append(
            f"  serving fleet: {sf['saturated']}/{sf['replicas']} "
            f"replicas saturated"
            + (" — FLEET SATURATED (router sheds 429)"
               if sf["all_saturated"] else ""))
    for rt in report.get("routers") or ():
        reps = rt["replicas"]
        states = ", ".join(
            r["addr"] + "=" + r["state"]
            + (f"({r['reason']})" if r.get("reason") else "")
            for r in reps)
        lines.append(
            f"  router {rt['process']}: "
            f"{rt.get('healthy_replicas')}/{len(reps)} replicas "
            f"healthy [{states}] requests={rt.get('requests')}"
            + (f" p95={rt['p95_ms']:.1f}ms"
               if rt.get("p95_ms") is not None else ""))
        if rt.get("last_deploy_ok") is False:
            lines.append("    last rolling deploy FAILED "
                         "(rolled back)")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("endpoints", nargs="*",
                    help="debugz endpoints (host:port or URL)")
    ap.add_argument("--endpoints", dest="endpoint_list", default="",
                    help="comma-separated endpoint list")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw report JSON")
    ap.add_argument("--band", type=float, default=DEFAULT_BAND,
                    help="relative step-time band for straggler/"
                         "regression flags (default 0.3)")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when the fleet is not healthy")
    ap.add_argument("--capture", action="store_true",
                    help="trigger simultaneous /-/profilez capture "
                         "windows on every endpoint and merge the "
                         "host+device timelines into one fleet "
                         "Perfetto file")
    ap.add_argument("--capture-steps", type=int, default=4,
                    help="steps per capture window (default 4)")
    ap.add_argument("--capture-timeout", type=float, default=120.0,
                    help="seconds to wait for the fleet's captures")
    ap.add_argument("--out", default="fleet_profile.json",
                    help="merged fleet trace output path (--capture)")
    args = ap.parse_args(argv)
    endpoints = list(args.endpoints)
    endpoints += [e.strip() for e in args.endpoint_list.split(",")
                  if e.strip()]
    if not endpoints:
        ap.error("no endpoints given")
    if args.capture:
        merged, rows = capture_fleet(endpoints,
                                     steps=args.capture_steps,
                                     timeout=args.capture_timeout)
        for row in rows:
            if "error" in row:
                print(f"  {row['endpoint']}: ERROR {row['error']}")
            else:
                r = row.get("report") or {}
                print(f"  {row['endpoint']}: {r.get('device_events')} "
                      f"device events over {r.get('steps')} steps, "
                      f"anchor skew {r.get('anchor_skew_ms')} ms, "
                      f"disagreements {r.get('disagreements') or []}")
        if merged is None:
            print("fleetz: capture FAILED on every endpoint")
            return 2
        with open(args.out, "w") as f:
            json.dump(merged, f)
        print(f"fleetz: merged {len(merged['otherData']['processes'])} "
              f"process timeline(s) -> {args.out} "
              f"({merged['otherData']['shared_trace_ids']} shared "
              f"trace ids)")
        return 1 if any("error" in r for r in rows) else 0
    report = derive_health(gather(endpoints, timeout=args.timeout),
                           band=args.band)
    print(json.dumps(report, indent=2, default=str) if args.json
          else render_text(report))
    if args.strict and not report["healthy"]:
        return 1
    if len(report["unreachable"]) == len(endpoints):
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
