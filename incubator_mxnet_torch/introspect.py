"""Fleet introspection plane: per-process debugz server, crash flight
recorder, and postmortem capture (counterpart of
`incubator_mxnet_tpu/introspect.py`, the parts a server needs).

`telemetry.py` records what happened in aggregate; `tracing.py`
records when.  This module answers "what is this process doing *right
now*" (live HTTP endpoints on every process) and "what was it doing
*when it died*" (an automatic postmortem JSON).

Three pieces:

* **Debugz server** — a tiny threaded HTTP endpoint
  (``MXNET_DEBUGZ_PORT``; SO_REUSEADDR, the `telemetry.MetricsServer`
  plumbing) embeddable in any process:

  - ``/-/statusz`` — role, rank, host, uptime, build/config snapshot,
    the ``MXNET_*``/``DMLC_*`` env overrides in effect, plus any
    sections registered by subsystems (`serving` its healthz summary,
    `router` its replica table).
  - ``/-/stackz`` — every thread's current stack via
    ``sys._current_frames`` (serving worker threads are name-tagged,
    so a wedged thread is identifiable at a glance).
  - ``/-/tracez`` — recent traces (`tracing.recent_traces`), or the
    process's richer registered provider (serving registers
    `debug_traces`, so ``/-/tracez`` and the legacy
    ``/-/debug/traces`` answer identically there).
  - ``/-/metricz`` — the telemetry JSON snapshot.
  - ``/-/flightz`` — the flight recorder ring (below).
  - ``/metrics`` — Prometheus text (so one listener serves scrapers
    and humans).

  - ``/-/goodputz``, ``/-/numericz``, ``/-/profilez`` and
    ``/-/tunerz`` — the runtime planes' pages (`goodput`, `health`,
    `profiling`, `tuner` with the compile cache); ``/-/profilez``
    reads its query string (``?steps=N`` arms a capture window,
    ``?view=trace`` returns the last merged timeline).

  With ``MXNET_DEBUGZ_PORT`` unset, :func:`ensure_debugz` is a no-op:
  zero extra threads, zero sockets.  The JAX package's two further
  pages, controllerz and checkpointz, read planes that come with the
  distributed parameter server, so `DEBUGZ_PATHS` is its tuple less
  those two.

* **Flight recorder** — a bounded in-memory ring
  (``MXNET_FLIGHT_EVENTS`` entries) of recent structured events: step
  boundaries, breaker trips, reloads, drains, router ejections.  Cheap
  enough to stay always-on (a dict build + deque append), it is the
  "what led up to this" record every postmortem starts from.

* **Postmortem capture** — :func:`install_postmortem` hooks
  ``sys.excepthook``, ``faulthandler``, and SIGTERM/SIGABRT; on a
  crash it writes one JSON file into ``MXNET_POSTMORTEM_DIR``
  (atomic rename): the last-N flight events, the telemetry snapshot,
  recent trace spans, every thread's stack, the exception, and the
  in-flight step index.  The ``MXNET_TELEMETRY_DUMP`` /
  ``MXNET_TRACE_DIR`` at-exit dumps are routed through the same
  single-shot guard, so a SIGTERM mid-step does not lose them and a
  clean exit never double-dumps.
"""
from __future__ import annotations

import collections
import faulthandler
import itertools
import json
import logging
import os
import signal
import socket as _socket
import sys
import threading
import time
import traceback

from .base import get_env
from . import telemetry as _telemetry
from . import tracing as _tracing

__all__ = [
    "flight", "flight_events", "set_flight_capacity",
    "begin_step", "end_step", "current_step",
    "process_identity", "set_role",
    "statusz", "stackz", "metricz", "tracez", "flightz", "goodputz",
    "numericz", "profilez", "tunerz",
    "debugz_payload", "register_statusz", "unregister_statusz",
    "set_tracez_provider",
    "DebugzServer", "start_debugz", "ensure_debugz", "debugz_server",
    "install_postmortem", "maybe_install_postmortem",
    "write_postmortem", "postmortem_dir",
    "dump_telemetry_once", "dump_traces_once",
]

_START_MONO = time.monotonic()
_START_WALL = time.time()

# -- process identity ---------------------------------------------------

_role_override = None


def set_role(role):
    """Pin this process's role label (worker/server/serving/...) —
    wins over the DMLC_ROLE env default."""
    global _role_override
    if role:
        _role_override = str(role)


def process_identity():
    """Who this process is, for joining multi-process streams:
    role (DMLC_ROLE / :func:`set_role`), rank, host, pid."""
    role = _role_override or get_env(
        "MXNET_DEBUGZ_ROLE", get_env("DMLC_ROLE", "process"))
    try:
        rank = int(get_env(
            "DMLC_WORKER_RANK", get_env("DMLC_RANK", "0")) or 0)
    except ValueError:
        rank = 0
    return {"role": role, "rank": rank,
            "host": _socket.gethostname(), "pid": os.getpid()}


# -- flight recorder ----------------------------------------------------

_flight_lock = threading.Lock()
_flight = collections.deque(
    maxlen=max(16, get_env("MXNET_FLIGHT_EVENTS", 512, int)))
_flight_seq = itertools.count(1)


def set_flight_capacity(n):
    """Resize the ring (tests / embedders); keeps the newest events."""
    global _flight
    n = max(1, int(n))
    with _flight_lock:
        _flight = collections.deque(_flight, maxlen=n)


def flight(kind, **fields):
    """Record one structured flight event into the bounded ring.

    Always on: the ring is what a postmortem or a fleetz scrape reads
    back to answer "what led up to this".  Keep call sites coarse
    (step boundaries, membership folds, reconnects, breaker trips —
    not per-key wire ops)."""
    ev = dict(fields)
    ev["seq"] = next(_flight_seq)
    ev["kind"] = str(kind)
    ev["unix_time"] = time.time()
    with _flight_lock:
        _flight.append(ev)
    return ev


def flight_events(limit=None):
    """Snapshot of the ring, oldest first (optionally the newest
    `limit` entries)."""
    with _flight_lock:
        evs = list(_flight)
    if limit is not None and limit >= 0:
        evs = evs[-limit:]
    return evs


# -- step bookkeeping (gluon.Trainer / parallel.Trainer) ---------------

_cur = {"step": None, "trainer": None}


def begin_step(step, trainer=None):
    """Mark a train step as in flight — what a postmortem names as
    the failing step (with the owning trainer's label in a
    multi-trainer process).  The compute-phase gap (time since the
    caller's previous step ended) is measured by the caller per
    trainer instance: a process running two trainers must not
    attribute one trainer's phase to the other."""
    _cur["step"] = step
    _cur["trainer"] = trainer


def end_step(step, seconds, compute_seconds=None, trainer=None,
             overlap_wire_seconds=None, ledger=None):
    """Record the step-boundary flight event.  `compute_seconds` is
    the caller-measured gap since ITS previous step ended — the
    worker's compute phase (forward/backward/data), which excludes
    time spent waiting inside the gradient exchange and is therefore
    the straggler-attribution signal (in a sync fleet the *fast*
    workers have the long step() walls, because they wait for the
    straggler inside the exchange).  Under MXNET_KV_OVERLAP part of
    the exchange runs INSIDE that gap (streamed pushes fire during
    backward): the caller subtracts its metered in-backward wire wall
    before passing `compute_seconds` and reports the subtracted share
    as `overlap_wire_seconds`, so the EWMA stays a pure compute
    signal and the overlap itself remains visible in the event.
    `trainer` labels the event so a multi-trainer process (GAN G/D)
    emits distinguishable series — fleetz keys its EWMA on the
    dominant per-trainer series instead of a merged bimodal one.
    `ledger` (a `goodput.StepLedger.on_step` record) folds the step's
    wall-clock breakdown / goodput / MFU / HBM peak into the event,
    so postmortems and fleetz carry the last N step breakdowns."""
    ev = {"step": int(step), "seconds": round(float(seconds), 6)}
    if compute_seconds is not None:
        ev["compute_seconds"] = round(float(compute_seconds), 6)
    if overlap_wire_seconds:
        ev["overlap_wire_seconds"] = round(
            float(overlap_wire_seconds), 6)
    if trainer is not None:
        ev["trainer"] = trainer
    if ledger:
        if ledger.get("buckets") and not ledger.get("untraced"):
            ev["breakdown"] = {b: round(s, 6) for b, s in
                               ledger["buckets"].items() if s > 0.0}
        for field in ("goodput", "mfu"):
            if ledger.get(field) is not None:
                ev[field] = round(ledger[field], 4)
        if ledger.get("hbm_peak_bytes"):
            ev["hbm_peak_bytes"] = int(ledger["hbm_peak_bytes"])
    flight("step", **ev)


def current_step():
    """The in-flight (or last) step index, or None before any step —
    what a postmortem names as the failing step."""
    return _cur["step"]


def current_step_trainer():
    """Label of the trainer that owns :func:`current_step`, or None
    (single-trainer processes and non-trainer callers)."""
    return _cur["trainer"]


# -- endpoint payloads --------------------------------------------------

_providers_lock = threading.Lock()
_statusz_providers = {}         # name -> fn() -> dict
_tracez_provider = None         # fn() -> dict (serving: debug_traces)


def register_statusz(name, fn):
    """Contribute a named section to ``/-/statusz`` (`fn()` -> dict;
    exceptions are captured into the payload, never raised)."""
    with _providers_lock:
        _statusz_providers[str(name)] = fn


def unregister_statusz(name):
    with _providers_lock:
        _statusz_providers.pop(str(name), None)


def set_tracez_provider(fn):
    """Replace the default ``/-/tracez`` payload (pass None to
    restore).  `serving.ServingRuntime` registers its `debug_traces`
    here, so ``/-/tracez`` and the legacy ``/-/debug/traces`` answer
    with the SAME payload on a serving process."""
    global _tracez_provider
    _tracez_provider = fn


def _env_overrides():
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(("MXNET_", "DMLC_", "CUDA_", "TORCH_"))}


def statusz():
    """``/-/statusz``: identity, uptime, build/config snapshot, env
    overrides, and every registered subsystem section."""
    from . import __version__
    payload = dict(process_identity())
    payload.update({
        "uptime_seconds": round(time.monotonic() - _START_MONO, 3),
        "start_unix_time": _START_WALL,
        "unix_time": time.time(),
        "argv": list(sys.argv),
        "build": {"version": __version__,
                  "python": sys.version.split()[0]},
        "env": _env_overrides(),
        "current_step": current_step(),
        "flight_event_count": len(_flight),
        "telemetry_enabled": _telemetry.enabled(),
        "tracing_enabled": _tracing.enabled(),
    })
    with _providers_lock:
        providers = dict(_statusz_providers)
    for name, fn in providers.items():
        try:
            payload[name] = fn()
        except Exception as e:      # noqa: BLE001 — introspection only
            payload[name] = {"error": f"{type(e).__name__}: {e}"}
    return payload


def stackz():
    """``/-/stackz``: every thread's current stack, name-tagged."""
    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    threads = []
    for tid, frame in frames.items():
        t = by_id.get(tid)
        stack = [{"file": fs.filename, "line": fs.lineno,
                  "function": fs.name, "code": fs.line or ""}
                 for fs in traceback.extract_stack(frame)]
        threads.append({
            "thread_id": tid,
            "name": t.name if t is not None else f"unknown-{tid}",
            "daemon": bool(t.daemon) if t is not None else None,
            "stack": stack,
        })
    threads.sort(key=lambda d: d["name"])
    return {"thread_count": len(threads), "threads": threads}


def metricz():
    """``/-/metricz``: the telemetry JSON snapshot, identity-stamped."""
    return {"version": 1, "identity": process_identity(),
            "unix_time": time.time(),
            "metrics": _telemetry.snapshot()}


def tracez():
    """``/-/tracez``: the registered provider's payload (serving), or
    the plain recent-traces view."""
    fn = _tracez_provider
    if fn is not None:
        try:
            return fn()
        except Exception as e:      # noqa: BLE001 — introspection only
            return {"error": f"{type(e).__name__}: {e}"}
    return {"tracing_enabled": _tracing.enabled(),
            "recent_requests": [],
            "traces": _tracing.recent_traces()}


def flightz():
    """``/-/flightz``: the flight-recorder ring."""
    return {"identity": process_identity(),
            "capacity": _flight.maxlen,
            "events": flight_events()}


def goodputz():
    """``/-/goodputz``: the per-trainer goodput ledger windows
    (`goodput.goodputz`; imported lazily — goodput imports this
    module at its own import)."""
    from . import goodput as _goodput
    return _goodput.goodputz()


def numericz():
    """``/-/numericz``: the per-trainer numerics & model-health
    ledgers — rolling stats, last anomaly, last audit verdict
    (`health.numericz`; imported lazily)."""
    from . import health as _health
    return _health.numericz()


def profilez(query=""):
    """``/-/profilez``: the device-profiling plane — status / last
    report with no query, ``?steps=N`` / ``?duration_ms=M`` arms a
    capture window, ``?view=trace`` returns the last merged host+device
    timeline (`profiling.profilez`; imported lazily)."""
    from . import profiling as _profiling
    return _profiling.profilez(query)


def tunerz():
    """``/-/tunerz``: the auto-tuner + persistent compile cache — the
    consumed ``tuned.json``, the last in-process tune, trial counters,
    cache hit/miss/bytes (`tuner.tunerz`; imported lazily)."""
    from . import tuner as _tuner
    return _tuner.tunerz()


_PATHS = {
    "/-/statusz": statusz,
    "/-/stackz": stackz,
    "/-/tracez": tracez,
    "/-/metricz": metricz,
    "/-/flightz": flightz,
    "/-/goodputz": goodputz,
    "/-/numericz": numericz,
    "/-/profilez": profilez,
    "/-/tunerz": tunerz,
}

# endpoints whose handler takes the request's query string (the
# capture-arming endpoint); every other payload is query-free
_QUERY_PATHS = frozenset(("/-/profilez",))

DEBUGZ_PATHS = tuple(sorted(_PATHS))


def debugz_payload(path, query=None):
    """Shared handler dispatch: ``(status_code, payload_dict)`` for a
    debugz path, or ``(404, None)``.  The standalone debugz server AND
    the serving front end both answer through this, so every process
    class exposes identical payloads.  `path` may carry its raw query
    string (``/-/profilez?steps=4``) — or pass it via `query`."""
    path, _, inline_q = path.partition("?")
    fn = _PATHS.get(path)
    if fn is None:
        return 404, None
    if path in _QUERY_PATHS:
        return 200, fn(query if query is not None else inline_q)
    return 200, fn()


# -- the debugz HTTP server --------------------------------------------

class DebugzServer(_telemetry.MetricsServer):
    """Handle for a running debugz endpoint (close() releases the
    port; all the `MetricsServer` int/str coercions apply)."""

    def __repr__(self):
        state = "closed" if self._srv is None else "open"
        return f"<DebugzServer port={self.port} {state}>"


_debugz = None
_debugz_lock = threading.Lock()


def debugz_server():
    """The process's running `DebugzServer`, or None."""
    return _debugz


def start_debugz(port, addr="127.0.0.1", role=None):
    """Bind the debugz endpoint on `addr:port` (0 picks a free port)
    and serve from one daemon thread.  Replacing a running server
    closes the old one first.  Returns a `DebugzServer`."""
    global _debugz
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if role:
        set_role(role)

    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"

        def log_message(self, *args):
            pass

        def _send(self, code, body, ctype="application/json"):
            try:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass

        def do_GET(self):
            path = self.path.split("?")[0]
            if path in ("/", "/-/debugz"):
                self._send(200, (json.dumps(
                    {"endpoints": list(DEBUGZ_PATHS) + ["/metrics"],
                     "identity": process_identity()}) + "\n").encode())
                return
            if path == "/metrics":
                self._send(200, _telemetry.prometheus_text().encode(),
                           ctype="text/plain; version=0.0.4; "
                                 "charset=utf-8")
                return
            code, payload = debugz_payload(self.path)
            if payload is None:
                self._send(404, (json.dumps(
                    {"error": f"no such path {path!r}",
                     "endpoints": list(DEBUGZ_PATHS)}) + "\n").encode())
                return
            self._send(code, (json.dumps(payload, default=str)
                              + "\n").encode())

    class _Server(ThreadingHTTPServer):
        allow_reuse_address = 1
        daemon_threads = True

    with _debugz_lock:
        if _debugz is not None:
            _debugz.close()
            _debugz = None
        srv = _Server((addr, int(port)), _Handler)
        thread = threading.Thread(target=srv.serve_forever, daemon=True,
                                  name="mx-debugz-http")
        thread.start()
        _debugz = DebugzServer(srv, thread)
    return _debugz


def ensure_debugz(role=None):
    """Start the debugz endpoint iff ``MXNET_DEBUGZ_PORT`` is set and
    none is running yet.  Never raises and — with the env unset —
    creates NO thread or socket; a bind failure (port collision on a
    shared host) logs a warning and returns None so training/serving
    proceeds undebugged rather than crashing."""
    if role:
        set_role(role)
    if _debugz is not None and _debugz._srv is not None:
        return _debugz      # already running (a closed handle is not)
    port = get_env("MXNET_DEBUGZ_PORT")
    if not port:
        return None
    addr = get_env("MXNET_DEBUGZ_ADDR", "127.0.0.1")
    try:
        return start_debugz(int(port), addr=addr)
    except Exception as e:          # noqa: BLE001 — introspection only
        logging.warning("debugz: cannot bind %s:%s (%s) — continuing "
                        "without the endpoint", addr, port, e)
        return None


# -- single-shot at-exit / crash dumps ----------------------------------

_once_lock = threading.Lock()
_once_done = set()


def _once(tag):
    with _once_lock:
        if tag in _once_done:
            return False
        _once_done.add(tag)
        return True


def dump_telemetry_once():
    """`telemetry.dump()` guarded to fire at most once per process —
    shared between the crash path (postmortem/SIGTERM, which runs
    first) and the clean-exit atexit hook, so a crash dump is never
    lost and a clean exit never double-writes."""
    if not _once("telemetry-dump"):
        return None
    try:
        return _telemetry.dump()
    except Exception:               # noqa: BLE001 — last-gasp path
        return None


def dump_traces_once():
    """`tracing.dump()` under the same single-shot guard."""
    if not _once("trace-dump"):
        return None
    try:
        return _tracing.dump()
    except Exception:               # noqa: BLE001 — last-gasp path
        return None


# -- postmortem capture -------------------------------------------------

def postmortem_dir():
    return get_env("MXNET_POSTMORTEM_DIR") or None


def _exc_payload(etype, evalue, tb):
    return {
        "type": getattr(etype, "__name__", str(etype)),
        "message": str(evalue),
        "traceback": traceback.format_exception(etype, evalue, tb),
    }


def write_postmortem(reason, exc_info=None):
    """Write the postmortem JSON (atomic rename) into
    ``MXNET_POSTMORTEM_DIR``; single-shot — the first writer (signal
    handler, excepthook, or an explicit call) wins and later calls
    return None.  Returns the path written, or None (guard consumed /
    no dir configured)."""
    if not _once("postmortem"):
        return None
    d = postmortem_dir()
    if not d:
        return None
    ident = process_identity()
    payload = {
        "version": 1,
        "reason": str(reason),
        "identity": ident,
        "unix_time": time.time(),
        "uptime_seconds": round(time.monotonic() - _START_MONO, 3),
        "step": current_step(),
        "step_trainer": current_step_trainer(),
        "exception": _exc_payload(*exc_info) if exc_info else None,
        "flight_events": flight_events(),
        "threads": stackz()["threads"],
        "metrics": _telemetry.snapshot(),
        "traces": _tracing.recent_traces(limit=8),
    }
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"postmortem-{ident['role']}-r{ident['rank']}-"
               f"{ident['pid']}.json")
        tmp = f"{path}.tmp.{ident['pid']}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        os.replace(tmp, path)
        return path
    except Exception:               # noqa: BLE001 — last-gasp path
        return None


def _crash_dump(reason, exc_info=None, timeout=None):
    """The full crash sequence: postmortem JSON first (it embeds the
    telemetry/trace state anyway), then the guarded telemetry/trace
    file dumps that a hard exit would otherwise lose.

    With `timeout` set (the SIGNAL-HANDLER path), the whole sequence
    runs on a helper thread bounded by a join timeout: a signal lands
    between bytecodes on the MAIN thread, so if that thread was
    interrupted while holding one of the locks the dump needs
    (`_flight_lock`, a telemetry child lock, ...) taking it from the
    handler itself would self-deadlock — the lock's owner cannot run
    until the handler returns.  The helper thread blocks instead, the
    join times out, and the process exits without the dump (a
    nanoseconds-wide window) rather than hanging on SIGTERM forever."""
    def _run():
        write_postmortem(reason, exc_info)
        dump_telemetry_once()
        dump_traces_once()
    if timeout is None:
        _run()
        return
    t = threading.Thread(target=_run, daemon=True,
                         name="mx-crash-dump")
    t.start()
    t.join(timeout)


_installed = False
_prev_excepthook = None


def install_postmortem(role=None, signals=("SIGTERM", "SIGABRT")):
    """Install the crash hooks: ``sys.excepthook`` (uncaught exception
    -> postmortem then the previous hook), ``faulthandler`` (native
    crashes dump thread stacks into ``MXNET_POSTMORTEM_DIR``), and
    handlers for `signals` that write the postmortem before chaining
    to the prior handler (or re-raising the default, preserving the
    killed-by-signal exit status).  Idempotent; safe off the main
    thread (signal hooks are skipped there)."""
    global _installed, _prev_excepthook
    if role:
        set_role(role)
    if _installed:
        return
    _installed = True

    _prev_excepthook = sys.excepthook

    def _hook(etype, evalue, tb):
        if not issubclass(etype, (KeyboardInterrupt, SystemExit)):
            try:
                _crash_dump("exception", (etype, evalue, tb))
            except Exception:       # noqa: BLE001 — last-gasp path
                pass
        (_prev_excepthook or sys.__excepthook__)(etype, evalue, tb)

    sys.excepthook = _hook

    d = postmortem_dir()
    try:
        if d:
            os.makedirs(d, exist_ok=True)
            ident = process_identity()
            fh = open(os.path.join(
                d, f"faulthandler-{ident['role']}-{ident['pid']}.log"),
                "w")
            faulthandler.enable(file=fh)
        elif not faulthandler.is_enabled():
            faulthandler.enable()
    except (OSError, ValueError):
        pass

    for name in signals:
        signum = getattr(signal, name, None)
        if signum is None:
            continue
        try:
            prev = signal.getsignal(signum)

            def _on_signal(num, frame, _prev=prev, _name=name):
                try:
                    _crash_dump(f"signal:{_name}", timeout=10.0)
                except Exception:   # noqa: BLE001 — last-gasp path
                    pass
                if callable(_prev):
                    _prev(num, frame)
                elif _prev == signal.SIG_IGN:
                    pass
                else:
                    # default disposition: restore and re-raise so the
                    # exit status still says "killed by signal"
                    signal.signal(num, signal.SIG_DFL)
                    os.kill(os.getpid(), num)

            signal.signal(signum, _on_signal)
        except (ValueError, OSError):
            pass        # not the main thread / unsupported signal


def maybe_install_postmortem(role=None):
    """Install the crash hooks iff ``MXNET_POSTMORTEM_DIR`` is set —
    the library-code entry point (Trainer, kvstore server, serving
    call this; explicit embedders call :func:`install_postmortem`)."""
    if postmortem_dir():
        install_postmortem(role=role)
    elif role:
        set_role(role)


# -- test hooks ---------------------------------------------------------

def _reset_for_tests():
    """Clear flight ring, step bookkeeping, once-guards, and
    providers.  Installed signal/excepthook hooks stay (they are
    process-global); the guards resetting re-arms the dumps."""
    global _tracez_provider
    with _flight_lock:
        _flight.clear()
    _cur["step"] = None
    _cur["trainer"] = None
    with _once_lock:
        _once_done.clear()
    with _providers_lock:
        _statusz_providers.clear()
    _tracez_provider = None
