"""Fault-tolerant serving front tier: a router over N serving replicas
(counterpart of `incubator_mxnet_tpu/router.py`).

`serving.py` makes ONE serving process resilient — admission control,
deadlines, a circuit breaker, atomic hot reload, graceful drain.  This
is the layer above it: an HTTP front end that keeps serving correct
answers while the replicas behind it crash, wedge, restart, and
redeploy.  It runs no model and touches no device.

* **Replica registry + consistent hashing** — replicas register by
  address; requests hash on their model id (``X-Model-Id``, default
  ``default``) onto a vnode ring, so one model's traffic lands on a
  stable primary (executable/cache affinity) with a deterministic
  fallback order when it is out.
* **Health-driven ejection / probed re-admission** — two signal paths
  feed one per-replica state machine (healthy → ejected → probing →
  healthy).  *Active*: a poll loop reads each replica's own
  ``/-/healthz``/``/-/readyz`` — a tripped breaker, a draining
  replica, or an unreachable one is ejected without burning a single
  client request on it.  *Passive*: every proxied request scores its
  replica — a 503 whose reason is ``breaker_open`` ejects immediately,
  ``MXNET_ROUTER_EJECT_FAILURES`` consecutive transport failures eject
  as unreachable.  Ejected replicas are probed on a cadence and
  re-admitted the moment ``/-/readyz`` is back and the breaker is no
  longer open (the breaker's half-open probe is then the next real
  request — a success closes it, a failure re-ejects).
* **Bounded, deadline-budgeted retries** — ``/predict`` is pure
  (idempotent), so a connect failure or a 503 shed retries against a
  *different* replica, up to ``MXNET_ROUTER_RETRIES`` times, never
  past the client's ``X-Deadline-Ms``: the budget travels with the
  request (each hop sees only the remaining milliseconds) and an
  exhausted budget answers 504 carrying the ORIGINAL trace id.
* **Latency hedging** — when the primary attempt is slower than the
  rolling p95 (EMA over recent request latencies, or a fixed
  ``MXNET_ROUTER_HEDGE_MS``), one hedge attempt fires at a different
  replica; the first answer wins and the loser is cancelled (its
  socket closed, its late answer discarded — it can never reach the
  client).
* **Fleet admission control** — when every admittable replica reports
  a full queue the router sheds ``429`` + ``Retry-After`` up front;
  when NO replica is admittable it sheds ``503`` + ``Retry-After``
  instead of queueing unboundedly.
* **Zero-downtime rolling deploys** — ``POST /-/deploy`` walks the
  fleet one replica at a time: stop routing to it, wait out its
  in-flight work, ``POST /-/reload`` (the replica's atomic reload: validate +
  load + warm off the request path, swap only on success), wait for
  ``/-/readyz``, re-admit, next.  The first failure aborts the deploy
  and rolls every already-upgraded replica back to its previous
  artifact.  A replica is only ever drained while its peers are
  admittable, so fleet readiness never goes false.
* **Trace propagation** — the client's ``X-Trace-Id`` (or a minted
  one) crosses the hop on every attempt and returns on EVERY response
  (sheds and 504s included), so the traces and statusz pages join the
  router's and the replica's views of one request.

Telemetry: ``router_requests``/``router_request_seconds``,
``router_attempts{replica,outcome}``, ``router_retries``,
``router_hedges{outcome}``, ``router_ejections{reason}``/
``router_readmissions``, ``router_shed{reason}``,
``router_replicas_healthy``, ``router_deploys{result}``.  The debugz
plane folds into the router port on loopback binds; the ``router``
statusz section lists the replica table.

Chaos gate: ``python -m incubator_mxnet_torch.tools.fleet_chaos``
SIGKILLs a replica, wedges one with a slow-poison fault plan, and
rolls a deploy through mid-load; it fails on any non-shed error, any
fleet-wide readiness gap, or any post-fault response that is not
bitwise-identical to a fault-free run.

Run standalone::

    python -m incubator_mxnet_torch.router \
        --replicas 127.0.0.1:8081,127.0.0.1:8082 --port 8080
"""
from __future__ import annotations

import bisect
import collections
import hashlib
import http.client
import json
import math
import queue as _queue
import signal
import threading
import time
import urllib.request

from .base import MXNetError, get_env
from . import telemetry
from . import tracing
from . import introspect

__all__ = ["RouterConfig", "Replica", "Router", "main"]


# -- telemetry ----------------------------------------------------------

_tm_requests = telemetry.counter(
    "router_requests", "Routed requests by final status", ("code",))
_tm_request_secs = telemetry.histogram(
    "router_request_seconds", "End-to-end routed request latency")
_tm_attempts = telemetry.counter(
    "router_attempts", "Per-replica proxy attempts",
    ("replica", "outcome"))
_tm_retries = telemetry.counter(
    "router_retries", "Attempts re-issued to a different replica "
    "after a connect failure or 503")
_tm_hedges = telemetry.counter(
    "router_hedges", "Latency hedge attempts", ("outcome",))
_tm_ejections = telemetry.counter(
    "router_ejections", "Replica ejections", ("reason",))
_tm_readmissions = telemetry.counter(
    "router_readmissions", "Replicas re-admitted after a probe")
_tm_shed = telemetry.counter(
    "router_shed", "Requests shed at the router", ("reason",))
_tm_healthy = telemetry.gauge(
    "router_replicas_healthy", "Replicas currently in rotation")
_tm_deploys = telemetry.counter(
    "router_deploys", "Rolling deploys", ("result",))


def _trace_of(hdr):
    """(trace id, header string) — serving.py's contract: a client
    token is kept verbatim (hex maps to the id, anything else hashes
    to a stable one); no header mints a fresh id."""
    if hdr:
        hdr = str(hdr)[:128]
        tid = tracing.parse_id(hdr)
        if not tid:
            tid = int.from_bytes(
                hashlib.blake2s(hdr.encode(), digest_size=8).digest(),
                "little") or 1
        return tid, hdr
    tid = tracing.new_id()
    return tid, tracing.format_id(tid)


def _hash64(s):
    return int.from_bytes(
        hashlib.blake2s(s.encode(), digest_size=8).digest(), "big")


# -- configuration ------------------------------------------------------

class RouterConfig:
    """Router knobs, each an ``MXNET_ROUTER_*`` env var overridable by
    keyword (tests)."""

    _FIELDS = (
        ("port", "MXNET_ROUTER_PORT", 8080, int),
        ("replicas", "MXNET_ROUTER_REPLICAS", "", str),
        ("retries", "MXNET_ROUTER_RETRIES", 2, int),
        # hedge trigger: <0 = auto (rolling p95 EMA), 0 = hedging off,
        # >0 = fixed milliseconds
        ("hedge_ms", "MXNET_ROUTER_HEDGE_MS", -1.0, float),
        ("deadline_ms", "MXNET_ROUTER_DEADLINE_MS", 30000.0, float),
        ("health_interval_ms", "MXNET_ROUTER_HEALTH_MS", 500.0, float),
        ("eject_failures", "MXNET_ROUTER_EJECT_FAILURES", 3, int),
        ("probe_interval_ms", "MXNET_ROUTER_PROBE_MS", 1000.0, float),
        ("connect_timeout_ms", "MXNET_ROUTER_CONNECT_TIMEOUT_MS",
         1000.0, float),
        # consecutive health polls showing a full queue or stuck
        # workers before a WEDGED (still-responding) replica is
        # ejected; 0 disables queue-signal ejection
        ("eject_saturated_polls", "MXNET_ROUTER_EJECT_SATURATED_POLLS",
         4, int),
        ("vnodes", "MXNET_ROUTER_VNODES", 64, int),
        ("drain_ms", "MXNET_ROUTER_DRAIN_MS", 10000.0, float),
        # ceiling for one replica's reload during a rolling deploy
        # (artifact load + warm-up; a cold start builds the kernels)
        ("reload_timeout_ms", "MXNET_ROUTER_RELOAD_TIMEOUT_MS",
         120000.0, float),
    )

    def __init__(self, **overrides):
        for attr, env, default, typ in self._FIELDS:
            if attr in overrides:
                setattr(self, attr, typ(overrides.pop(attr)))
            else:
                setattr(self, attr, get_env(env, default, typ))
        if overrides:
            raise MXNetError(
                f"unknown RouterConfig fields {sorted(overrides)}")
        self.retries = max(0, self.retries)
        self.eject_failures = max(1, self.eject_failures)
        self.vnodes = max(1, self.vnodes)

    def replica_list(self):
        return [a.strip() for a in self.replicas.split(",") if a.strip()]


# -- per-replica state machine ------------------------------------------

class Replica:
    """One backend's registry row.  State transitions happen under the
    router's lock; the request path only reads."""

    HEALTHY, EJECTED, DRAINING = "healthy", "ejected", "draining"

    __slots__ = ("addr", "host", "port", "state", "reason", "fails",
                 "inflight", "ejected_at", "last_probe", "last_health",
                 "artifact", "served", "deploying", "state_since",
                 "sat_polls")

    def __init__(self, addr):
        self.addr = addr
        host, _, port = addr.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.state = self.HEALTHY
        self.reason = ""
        self.fails = 0              # consecutive transport failures
        self.inflight = 0           # router-side attempts outstanding
        self.ejected_at = 0.0
        self.last_probe = 0.0
        self.last_health = None     # latest /-/healthz payload
        self.artifact = None        # from last_health (deploy rollback)
        self.served = 0             # 200s answered through this row
        self.sat_polls = 0          # consecutive saturated health polls
        self.deploying = False      # rolling deploy owns the state
        self.state_since = time.monotonic()

    def describe(self):
        h = self.last_health or {}
        q = h.get("queue") or {}
        return {"addr": self.addr, "state": self.state,
                "reason": self.reason or None, "fails": self.fails,
                "inflight": self.inflight, "served": self.served,
                "artifact": self.artifact,
                "breaker": (h.get("breaker") or {}).get("state"),
                "queue_depth": q.get("depth"),
                "queue_limit": q.get("limit"),
                "state_age_seconds": round(
                    time.monotonic() - self.state_since, 3)}


# -- one proxy attempt --------------------------------------------------

_RETRYABLE_EXC = (ConnectionError, OSError, http.client.HTTPException)


class _Attempt(threading.Thread):
    """One replica hop.  Runs on its own thread so the orchestrator
    can hedge and cancel; the result is pushed to the orchestrator's
    queue — a cancelled attempt's late answer lands in a queue nobody
    reads from anymore, never on the client's socket."""

    def __init__(self, replica, payload, headers, timeout_s, resultq,
                 hedge=False):
        super().__init__(daemon=True, name=f"mx-router-{replica.addr}")
        self.replica = replica
        self.payload = payload
        self.headers = headers
        self.timeout_s = max(0.001, timeout_s)
        self.resultq = resultq
        self.hedge = hedge
        self.cancelled = False
        self.outcome = None         # "ok" | "error"
        self.status = None
        self.body = b""
        self.resp_headers = {}
        self.error = None
        self.t0 = self.t1 = 0.0
        self.released = False       # the router's in-flight count
        self._conn = None
        self._lock = threading.Lock()

    def run(self):
        self.t0 = time.monotonic()
        r = self.replica
        try:
            conn = http.client.HTTPConnection(
                r.host, r.port, timeout=self.timeout_s)
            with self._lock:
                if self.cancelled:
                    return
                self._conn = conn
            conn.request("POST", "/predict", body=self.payload,
                         headers=self.headers)
            resp = conn.getresponse()
            self.body = resp.read()
            self.resp_headers = {k: v for k, v in resp.getheaders()}
            self.status = resp.status
            self.outcome = "ok"
        except Exception as e:  # noqa: BLE001 — classified by caller
            self.outcome = "error"
            self.error = e
        finally:
            self.t1 = time.monotonic()
            with self._lock:
                conn, self._conn = self._conn, None
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
            self.resultq.put(self)

    def cancel(self):
        """First answer won: close the loser's socket so its replica
        sees the disconnect instead of serving a response nobody will
        read."""
        with self._lock:
            self.cancelled = True
            conn = self._conn
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass


# -- the router ---------------------------------------------------------

class Router:
    """Owns the registry, the ring, the health loop, and the HTTP
    front end.  Library-embeddable (tests drive it in-process);
    `main()` adds signal handlers around it."""

    def __init__(self, replicas=None, config=None):
        self._cfg = config or RouterConfig()
        self._lock = threading.Lock()
        self._replicas = {}
        self._ring = []             # sorted (hash, addr)
        self._draining = False
        self._stopping = threading.Event()
        self._http = None
        self._health_thread = None
        self._deploy_lock = threading.Lock()
        self._last_deploy = None
        self._requests = 0
        # rolling p95: ring of recent 200-latencies + EMA smoothing
        self._lat = collections.deque(maxlen=64)
        self._p95_ms = None
        self._hedges_won = 0
        for addr in (replicas if replicas is not None
                     else self._cfg.replica_list()):
            self.add_replica(addr)
        introspect.register_statusz("router", self.statusz)

    # -- registry / ring ------------------------------------------------

    def add_replica(self, addr):
        with self._lock:
            if addr in self._replicas:
                return self._replicas[addr]
            rep = Replica(addr)
            self._replicas[addr] = rep
            self._rebuild_ring_locked()
        self._note_healthy()
        return rep

    def remove_replica(self, addr):
        with self._lock:
            rep = self._replicas.pop(addr, None)
            if rep is not None:
                self._rebuild_ring_locked()
        self._note_healthy()
        return rep is not None

    def _rebuild_ring_locked(self):
        self._ring = sorted(
            (_hash64(f"{addr}#{v}"), addr)
            for addr in self._replicas
            for v in range(self._cfg.vnodes))

    def _preference(self, key):
        """Every replica address, ordered by the consistent-hash walk
        from `key`'s ring position — the stable primary first, then
        deterministic fallbacks."""
        with self._lock:
            ring = self._ring
            n = len(self._replicas)
        if not ring:
            return []
        i = bisect.bisect(ring, (_hash64(key), ""))
        seen, order = set(), []
        for j in range(len(ring)):
            addr = ring[(i + j) % len(ring)][1]
            if addr not in seen:
                seen.add(addr)
                order.append(addr)
                if len(order) == n:
                    break
        return order

    def replica(self, addr):
        with self._lock:
            return self._replicas.get(addr)

    def replicas(self):
        with self._lock:
            return list(self._replicas.values())

    # -- state transitions ----------------------------------------------

    def _note_healthy(self):
        _tm_healthy.set(sum(1 for r in self.replicas()
                            if r.state == Replica.HEALTHY))

    def _eject(self, rep, reason):
        with self._lock:
            if rep.state == Replica.EJECTED:
                return
            rep.state = Replica.EJECTED
            rep.reason = reason
            rep.ejected_at = time.monotonic()
            rep.state_since = rep.ejected_at
        _tm_ejections.labels(reason).inc()
        introspect.flight("router_eject", replica=rep.addr,
                          reason=reason)
        self._note_healthy()

    def _mark_draining(self, rep, reason="draining", deploying=False):
        with self._lock:
            if rep.state == Replica.DRAINING:
                rep.deploying = rep.deploying or deploying
                return
            rep.state = Replica.DRAINING
            rep.reason = reason
            rep.deploying = deploying
            rep.state_since = time.monotonic()
        introspect.flight("router_replica_draining", replica=rep.addr,
                          reason=reason)
        self._note_healthy()

    def _readmit(self, rep, probe=True):
        with self._lock:
            was = rep.state
            rep.state = Replica.HEALTHY
            rep.reason = ""
            rep.fails = 0
            rep.sat_polls = 0
            rep.deploying = False
            rep.state_since = time.monotonic()
        if probe and was != Replica.HEALTHY:
            _tm_readmissions.inc()
            introspect.flight("router_readmit", replica=rep.addr,
                             was=was)
        self._note_healthy()

    # -- health: active poll + probed re-admission ----------------------

    def _fetch_json(self, rep, path, timeout=None):
        timeout = timeout if timeout is not None \
            else self._cfg.connect_timeout_ms / 1000.0
        with urllib.request.urlopen(
                f"http://{rep.addr}{path}", timeout=timeout) as r:
            return r.status, json.load(r)

    def check_replica(self, rep):
        """One active health pass over one replica — shared by the
        poll loop and tests (call it directly to skip the cadence)."""
        if rep.state == Replica.HEALTHY:
            try:
                _, h = self._fetch_json(rep, "/-/healthz")
            except Exception:   # noqa: BLE001 — unreachable is a signal
                rep.fails += 1
                if rep.fails >= self._cfg.eject_failures:
                    self._eject(rep, "unreachable")
                return
            rep.last_health = h
            rep.artifact = (h.get("model") or {}).get("artifact_dir")
            brk = (h.get("breaker") or {}).get("state")
            if brk == "open":
                self._eject(rep, "breaker_open")
                return
            if h.get("status") == "draining":
                self._mark_draining(rep)
                return
            # queue-signal ejection: a WEDGED replica keeps answering
            # health checks while its slow model calls back the queue
            # up — a full queue or stuck workers for N consecutive
            # polls takes it out of rotation (it re-admits through the
            # probe path once drained)
            q = h.get("queue") or {}
            stuck = (h.get("workers") or {}).get("stuck", 0)
            depth, limit = q.get("depth"), q.get("limit")
            if stuck or (depth is not None and limit
                         and depth >= limit):
                rep.sat_polls += 1
                if self._cfg.eject_saturated_polls and rep.sat_polls \
                        >= self._cfg.eject_saturated_polls:
                    self._eject(rep, "saturated")
            else:
                rep.sat_polls = 0
            return
        # ejected / draining: probe for re-admission (a deploy-owned
        # drain is the deploy routine's to resolve, not the prober's)
        if rep.deploying:
            return
        now = time.monotonic()
        if now - rep.last_probe < self._cfg.probe_interval_ms / 1000.0:
            return
        rep.last_probe = now
        try:
            code, _ = self._fetch_json(rep, "/-/readyz")
            _, h = self._fetch_json(rep, "/-/healthz")
        except Exception:   # noqa: BLE001 — still down
            return
        rep.last_health = h
        rep.artifact = (h.get("model") or {}).get("artifact_dir")
        brk = (h.get("breaker") or {}).get("state")
        # "open" still inside its cooldown stays out; once the cooldown
        # elapses the replica reports half-open and is re-admitted —
        # the next real request is its single half-open probe.  A
        # saturation-ejected replica must also have DRAINED its queue
        # before coming back, or it would flap straight out again.
        q = h.get("queue") or {}
        drained = not q.get("limit") \
            or q.get("depth", 0) < q["limit"]
        if code == 200 and h.get("status") == "ok" \
                and brk != "open" and drained:
            self._readmit(rep)

    def _health_loop(self):
        interval = self._cfg.health_interval_ms / 1000.0
        while not self._stopping.wait(interval):
            for rep in self.replicas():
                try:
                    self.check_replica(rep)
                except Exception:   # noqa: BLE001 — the loop outlives
                    pass            # any one bad poll

    # -- admission -------------------------------------------------------

    def _admittable(self):
        return [r for r in self.replicas()
                if r.state == Replica.HEALTHY]

    def _fleet_shed(self):
        """Fleet-level admission: ``(status, payload, headers)`` when
        the whole fleet must shed, else None."""
        admittable = self._admittable()
        if self._draining:
            return self._shed("draining", 503, 1.0)
        if not admittable:
            retry = self._cfg.probe_interval_ms / 1000.0
            return self._shed("no_replicas", 503, retry)
        saturated = []
        for r in admittable:
            q = (r.last_health or {}).get("queue") or {}
            depth, limit = q.get("depth"), q.get("limit")
            if depth is None or not limit:
                return None     # unknown load: let the replica decide
            if depth < limit:
                return None
            saturated.append(limit)
        # every admittable replica reports a full queue: shed here
        # instead of burning a hop to be shed there
        return self._shed("fleet_saturated", 429, 1.0)

    def _shed(self, reason, code, retry_after_s):
        _tm_shed.labels(reason).inc()
        return code, {"error": f"request shed: {reason}",
                      "reason": reason}, \
            {"Retry-After": str(max(1, int(retry_after_s + 0.999)))}

    # -- the data path ---------------------------------------------------

    def _hedge_delay_s(self, deadline):
        cfg = self._cfg
        if cfg.hedge_ms == 0:
            return None
        if cfg.hedge_ms > 0:
            delay = cfg.hedge_ms / 1000.0
        else:
            with self._lock:
                p95 = self._p95_ms
            if p95 is None:
                return None     # no latency history yet
            delay = p95 / 1000.0
        remaining = deadline - time.monotonic()
        # a hedge that cannot possibly finish is pure load: require
        # head-room of one more delay after it fires
        if remaining < 2.0 * delay:
            return None
        return delay

    def _note_latency(self, seconds):
        ms = seconds * 1000.0
        with self._lock:
            self._lat.append(ms)
            if len(self._lat) >= 8:
                srt = sorted(self._lat)
                p = srt[int(0.95 * (len(srt) - 1))]
                self._p95_ms = p if self._p95_ms is None \
                    else 0.8 * self._p95_ms + 0.2 * p

    def _classify(self, att):
        """Outcome label + retryability for one finished attempt, with
        the passive health side effects (scoring, immediate ejection)."""
        rep = att.replica
        if att.outcome != "ok":
            rep.fails += 1
            if rep.fails >= self._cfg.eject_failures:
                self._eject(rep, "unreachable")
            return "connect_error", True
        rep.fails = 0
        if att.status == 503:
            reason = ""
            try:
                reason = json.loads(att.body or b"{}").get("reason", "")
            except ValueError:
                pass
            if reason == "breaker_open":
                # the replica tripped its own breaker: eject NOW —
                # the retry budget is for the fleet, not for feeding
                # a breaker that already said no
                self._eject(rep, "breaker_open")
            elif reason == "draining" or \
                    att.resp_headers.get("X-Replica-Status") == \
                    "draining":
                self._mark_draining(rep)
            return "shed_503", True
        if att.status == 200:
            rep.served += 1
            self._note_latency(att.t1 - att.t0)
        return f"http_{att.status}", False

    def route(self, body_bytes, deadline_ms=None, trace=None,
              model_id="default"):
        """Route one ``/predict`` body.  Returns ``(status, body_bytes,
        headers)`` — always bounded by the deadline, never hangs, and
        the headers always carry the request's ``X-Trace-Id``."""
        t_enter = time.monotonic()
        tid, hdr = trace if trace is not None else _trace_of(None)
        deadline = t_enter + (deadline_ms if deadline_ms is not None
                              else self._cfg.deadline_ms) / 1000.0
        status, body, headers, detail = self._route_impl(
            body_bytes, deadline, tid, hdr, model_id)
        headers = dict(headers or {})
        headers["X-Trace-Id"] = hdr
        self._requests += 1
        _tm_requests.labels(str(status)).inc()
        _tm_request_secs.observe(time.monotonic() - t_enter)
        if tracing.enabled():
            root = tracing.new_id()
            now = time.monotonic()
            for a in detail.get("attempts", ()):
                tracing.record_span(
                    "router.attempt", a["t0"], a["t1"], tid, root,
                    {"replica": a["replica"], "outcome": a["outcome"],
                     "hedge": a["hedge"]})
            tracing.record_span(
                "router.request", t_enter, now, tid, 0,
                {"status": status, "model_id": model_id,
                 "attempts": len(detail.get("attempts", ())),
                 "client_trace_id": hdr}, span_id=root)
        return status, body, headers

    def _route_impl(self, body_bytes, deadline, tid, hdr, model_id):
        detail = {"attempts": []}
        shed = self._fleet_shed()
        if shed is not None:
            code, payload, headers = shed
            return code, (json.dumps(payload) + "\n").encode(), \
                headers, detail

        prefs = self._preference(model_id)
        resultq = _queue.Queue()
        outstanding = []
        tried = set()
        retries_used = 0
        hedged = False
        last_shed = None

        def _headers(now):
            return {"Content-Type": "application/json",
                    "X-Trace-Id": hdr,
                    "X-Deadline-Ms": str(max(
                        1, int((deadline - now) * 1000.0)))}

        def _launch(hedge=False):
            now = time.monotonic()
            addr = next((a for a in prefs if a not in tried
                         and self._is_admittable(a)), None)
            if addr is None or now >= deadline:
                return False
            tried.add(addr)
            rep = self.replica(addr)
            if rep is None:
                return False
            with self._lock:
                rep.inflight += 1
            att = _Attempt(rep, body_bytes, _headers(now),
                           deadline - now, resultq, hedge=hedge)
            outstanding.append(att)
            att.start()
            return True

        def _finish(att):
            # once per attempt: a loser cancelled below is released
            # when the request returns, or the replica's in-flight
            # count leaks and a rolling deploy waits out drain_ms on it
            with self._lock:
                if not att.released:
                    att.released = True
                    att.replica.inflight -= 1

        def _cancel_rest(winner):
            for att in outstanding:
                if att is not winner and att.is_alive():
                    att.cancel()
                    if att.hedge != winner.hedge:
                        _tm_hedges.labels(
                            "won" if winner.hedge else "lost").inc()

        try:
            if not _launch():
                code, payload, headers = self._shed(
                    "no_replicas", 503,
                    self._cfg.probe_interval_ms / 1000.0)
                return code, (json.dumps(payload) + "\n").encode(), \
                    headers, detail

            while True:
                now = time.monotonic()
                if now >= deadline:
                    break
                live = [a for a in outstanding if a.outcome is None]
                wait = deadline - now
                hedge_delay = None
                if not hedged and live:
                    hd = self._hedge_delay_s(deadline)
                    if hd is not None:
                        started = min(a.t0 or now for a in live)
                        hedge_at = started + hd
                        if hedge_at <= now:
                            hedged = True
                            if _launch(hedge=True):
                                _tm_hedges.labels("fired").inc()
                            continue
                        hedge_delay = hedge_at - now
                if hedge_delay is not None:
                    wait = min(wait, hedge_delay)
                try:
                    att = resultq.get(timeout=max(0.001, wait))
                except _queue.Empty:
                    continue
                _finish(att)
                outcome, retryable = self._classify(att)
                detail["attempts"].append(
                    {"replica": att.replica.addr, "outcome": outcome,
                     "hedge": att.hedge, "t0": att.t0, "t1": att.t1})
                _tm_attempts.labels(att.replica.addr, outcome).inc()
                if att.outcome == "ok" and not retryable:
                    _cancel_rest(att)
                    headers = {"Content-Type": att.resp_headers.get(
                        "Content-Type", "application/json")}
                    for k in ("Retry-After", "X-Served-By",
                              "X-Replica-Status"):
                        if k in att.resp_headers:
                            headers[k] = att.resp_headers[k]
                    headers["X-Router-Attempts"] = str(
                        len(detail["attempts"]))
                    return att.status, att.body, headers, detail
                if outcome == "shed_503":
                    last_shed = att
                # retryable: another replica, if budget and retries allow
                if retries_used < self._cfg.retries and \
                        time.monotonic() < deadline:
                    if _launch():
                        retries_used += 1
                        _tm_retries.inc()
                        continue
                if not any(a.outcome is None for a in outstanding):
                    break       # nothing in flight, nothing left to try

            for att in outstanding:
                if att.is_alive():
                    att.cancel()
            if time.monotonic() >= deadline:
                payload = {"error": "deadline exceeded while routing",
                           "stage": "router",
                           "attempts": len(detail["attempts"])}
                _tm_shed.labels("deadline").inc()
                return 504, (json.dumps(payload) + "\n").encode(), {}, \
                    detail
            if last_shed is not None:
                # every hop shed: relay the last replica's shed verbatim
                # (it carries the most honest Retry-After)
                headers = {"Content-Type": "application/json"}
                if "Retry-After" in last_shed.resp_headers:
                    headers["Retry-After"] = \
                        last_shed.resp_headers["Retry-After"]
                else:
                    headers["Retry-After"] = "1"
                _tm_shed.labels("all_replicas_shed").inc()
                return 503, last_shed.body, headers, detail
            code, payload, headers = self._shed(
                "no_replicas", 503, self._cfg.probe_interval_ms / 1000.0)
            return code, (json.dumps(payload) + "\n").encode(), headers, \
                detail
        finally:
            for att in outstanding:
                _finish(att)

    def _is_admittable(self, addr):
        rep = self.replica(addr)
        return rep is not None and rep.state == Replica.HEALTHY

    # -- rolling deploy --------------------------------------------------

    def rolling_deploy(self, artifact_dir):
        """Drain → reload → warm → readmit, one replica at a time;
        abort and roll back already-upgraded replicas on the first
        failure.  Returns the result dict also shown by statusz."""
        if not self._deploy_lock.acquire(blocking=False):
            return {"ok": False, "error": "deploy already in progress",
                    "in_progress": True}
        try:
            t0 = time.time()
            introspect.flight("router_deploy_begin",
                              artifact=artifact_dir)
            upgraded = []       # (replica, previous_artifact)
            steps = []
            for rep in sorted(self.replicas(), key=lambda r: r.addr):
                ok, note, prev = self._deploy_one(rep, artifact_dir)
                steps.append({"replica": rep.addr, "ok": ok,
                              "note": note})
                if not ok:
                    rolled = self._rollback(upgraded)
                    result = {"ok": False, "artifact_dir": artifact_dir,
                              "failed_replica": rep.addr, "error": note,
                              "steps": steps, "rolled_back": rolled,
                              "seconds": time.time() - t0,
                              "unix_time": t0}
                    _tm_deploys.labels("rolled_back").inc()
                    introspect.flight("router_deploy_abort",
                                      artifact=artifact_dir,
                                      failed=rep.addr, error=note)
                    self._last_deploy = result
                    return result
                upgraded.append((rep, prev))
            result = {"ok": True, "artifact_dir": artifact_dir,
                      "steps": steps, "seconds": time.time() - t0,
                      "unix_time": t0}
            _tm_deploys.labels("ok").inc()
            introspect.flight("router_deploy_done",
                              artifact=artifact_dir,
                              replicas=len(steps))
            self._last_deploy = result
            return result
        finally:
            self._deploy_lock.release()

    def _deploy_one(self, rep, artifact_dir):
        """One replica through drain → reload → ready → readmit.
        Returns ``(ok, note, previous_artifact)``."""
        cfg = self._cfg
        prev = rep.artifact
        if prev is None:
            try:
                _, h = self._fetch_json(rep, "/-/healthz", timeout=5.0)
                prev = (h.get("model") or {}).get("artifact_dir")
            except Exception:   # noqa: BLE001
                pass
        # zero-downtime invariant: never take the last admittable
        # replica out of rotation
        others = [r for r in self._admittable() if r is not rep]
        if rep.state == Replica.HEALTHY and not others:
            return False, "refusing to drain the last admittable " \
                          "replica", prev
        was_ejected = rep.state == Replica.EJECTED
        self._mark_draining(rep, reason="deploy", deploying=True)
        # wait out the router's own in-flight attempts to it
        t_end = time.monotonic() + cfg.drain_ms / 1000.0
        while time.monotonic() < t_end:
            with self._lock:
                if rep.inflight == 0:
                    break
            time.sleep(0.01)
        try:
            req = urllib.request.Request(
                f"http://{rep.addr}/-/reload",
                data=json.dumps(
                    {"artifact_dir": artifact_dir}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(
                    req, timeout=cfg.reload_timeout_ms / 1000.0) as r:
                res = json.load(r)
        except Exception as e:  # noqa: BLE001 — a dead replica fails
            # its own deploy step; the abort path handles it
            if was_ejected:
                self._eject(rep, "deploy_failed")
            else:
                self._readmit(rep, probe=False)
            return False, f"reload failed: {type(e).__name__}: {e}", \
                prev
        if not res.get("ok"):
            # the replica rolled itself back (its reload semantics) —
            # it still serves the OLD artifact; readmit and abort
            self._readmit(rep, probe=False)
            return False, f"reload rejected: {res.get('error')}", prev
        # reload warmed the new slot already; confirm readiness
        t_end = time.monotonic() + cfg.reload_timeout_ms / 1000.0
        while time.monotonic() < t_end:
            try:
                code, _ = self._fetch_json(rep, "/-/readyz",
                                           timeout=2.0)
                _, h = self._fetch_json(rep, "/-/healthz",
                                        timeout=2.0)
            except Exception:   # noqa: BLE001 — not back yet
                time.sleep(0.05)
                continue
            if code == 200 and (h.get("model") or {}).get(
                    "artifact_dir") == artifact_dir:
                rep.last_health = h
                rep.artifact = artifact_dir
                self._readmit(rep, probe=False)
                return True, "reloaded", prev
            time.sleep(0.05)
        self._readmit(rep, probe=False)
        return False, "replica did not become ready on the new " \
                      "artifact in time", prev

    def _rollback(self, upgraded):
        """Best-effort reload of already-upgraded replicas back to
        their pre-deploy artifacts (reverse order)."""
        rolled = []
        for rep, prev in reversed(upgraded):
            if not prev:
                rolled.append({"replica": rep.addr, "ok": False,
                               "note": "previous artifact unknown"})
                continue
            try:
                req = urllib.request.Request(
                    f"http://{rep.addr}/-/reload",
                    data=json.dumps({"artifact_dir": prev}).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(
                        req,
                        timeout=self._cfg.reload_timeout_ms
                        / 1000.0) as r:
                    res = json.load(r)
                ok = bool(res.get("ok"))
                rep.artifact = prev if ok else rep.artifact
                rolled.append({"replica": rep.addr, "ok": ok})
            except Exception as e:  # noqa: BLE001 — best-effort
                rolled.append({"replica": rep.addr, "ok": False,
                               "note": f"{type(e).__name__}: {e}"})
        introspect.flight("router_rollback", replicas=len(rolled))
        return rolled

    # -- introspection ---------------------------------------------------

    def statusz(self):
        reps = [r.describe() for r in
                sorted(self.replicas(), key=lambda r: r.addr)]
        healthy = sum(1 for r in reps if r["state"] == Replica.HEALTHY)
        with self._lock:
            p95 = self._p95_ms
        return {"replicas": reps,
                "healthy": healthy,
                "draining": self._draining,
                "requests": self._requests,
                "p95_ms": round(p95, 3) if p95 is not None else None,
                "retries": self._cfg.retries,
                "hedge_ms": self._cfg.hedge_ms,
                "last_deploy": self._last_deploy}

    def healthz(self):
        return {"status": "draining" if self._draining else "ok",
                "router": self.statusz()}

    def ready(self):
        return not self._draining and bool(self._admittable())

    # -- lifecycle -------------------------------------------------------

    def begin_drain(self):
        self._draining = True
        introspect.flight("router_drain_begin")

    def close(self):
        self.begin_drain()
        self._stopping.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
            self._health_thread = None
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        introspect.unregister_statusz("router")

    # -- HTTP front end --------------------------------------------------

    def start(self, port=None, addr="127.0.0.1"):
        """Bind the front end + start the health loop; returns the
        bound port."""
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer

        router = self
        debugz_folded = addr in ("127.0.0.1", "localhost", "::1") \
            or get_env("MXNET_DEBUGZ_EXPOSE", False, bool)

        _KNOWN_PATHS = frozenset(
            ("/predict", "/-/healthz", "/-/readyz", "/metrics",
             "/-/deploy", "/-/replicas", "/-/quitquitquit")
            + introspect.DEBUGZ_PATHS)

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *args):
                pass

            def _reply(self, code, payload, headers=None, raw=None,
                       ctype="application/json", t0=None):
                body = raw if raw is not None else (
                    json.dumps(payload) + "\n").encode()
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    for k, v in (headers or {}).items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _read_body(self):
                try:
                    n = int(self.headers.get("Content-Length", "0")
                            or 0)
                except ValueError:
                    n = 0
                return self.rfile.read(n) if n > 0 else b""

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/-/healthz":
                    self._reply(200, router.healthz())
                elif path == "/-/readyz":
                    if router.ready():
                        self._reply(200, {"ready": True})
                    else:
                        self._reply(503, {
                            "ready": False,
                            "healthy_replicas": len(
                                router._admittable())})
                elif path == "/metrics":
                    self._reply(
                        200, None,
                        raw=telemetry.prometheus_text().encode(),
                        ctype="text/plain; version=0.0.4; "
                              "charset=utf-8")
                else:
                    payload = None
                    if debugz_folded:
                        code, payload = introspect.debugz_payload(
                            self.path)
                    if payload is not None:
                        self._reply(code, payload)
                    else:
                        self._reply(404, {"error":
                                          f"no such path {path!r}"})

            def do_POST(self):
                path = self.path.split("?")[0]
                if path == "/predict":
                    trace = _trace_of(self.headers.get("X-Trace-Id"))
                    deadline_ms = None
                    hdr = self.headers.get("X-Deadline-Ms")
                    if hdr is not None:
                        try:
                            deadline_ms = float(hdr)
                            if not math.isfinite(deadline_ms) or \
                                    deadline_ms <= 0:
                                raise ValueError
                        except ValueError:
                            self._reply(400, {
                                "error": f"bad X-Deadline-Ms {hdr!r}"},
                                {"X-Trace-Id": trace[1]})
                            return
                    body = self._read_body()
                    code, out, headers = router.route(
                        body, deadline_ms, trace=trace,
                        model_id=self.headers.get("X-Model-Id",
                                                  "default"))
                    self._reply(code, None, headers, raw=out)
                elif path == "/-/deploy" and debugz_folded:
                    try:
                        body = json.loads(self._read_body() or b"{}")
                        target = body["artifact_dir"]
                    except (ValueError, KeyError):
                        self._reply(400, {
                            "error": "deploy body must be "
                                     '{"artifact_dir": ...}'})
                        return
                    result = router.rolling_deploy(target)
                    self._reply(
                        200 if result["ok"] else
                        (409 if result.get("in_progress") else 500),
                        result)
                elif path == "/-/replicas" and debugz_folded:
                    try:
                        body = json.loads(self._read_body() or b"{}")
                    except ValueError:
                        self._reply(400, {"error": "bad JSON body"})
                        return
                    for addr in body.get("add") or ():
                        router.add_replica(str(addr))
                    for addr in body.get("remove") or ():
                        router.remove_replica(str(addr))
                    self._reply(200, router.statusz())
                elif path == "/-/quitquitquit" and debugz_folded:
                    router.begin_drain()
                    cb = getattr(router, "on_quit", None)
                    self._reply(200, {"draining": True,
                                      "exiting": cb is not None})
                    if cb is not None:
                        cb()
                else:
                    self._reply(404,
                                {"error": f"no such path {path!r}"})

        class _Server(ThreadingHTTPServer):
            allow_reuse_address = 1
            daemon_threads = True

        self._http = _Server(
            (addr, port if port is not None else self._cfg.port),
            _Handler)
        threading.Thread(target=self._http.serve_forever, daemon=True,
                         name="mx-router-http").start()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name="mx-router-health")
        self._health_thread.start()
        return self._http.server_address[1]


# -- process entry point ------------------------------------------------

def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m incubator_mxnet_torch.router",
        description="Route /predict over N serving replicas with "
                    "health-driven ejection, hedged retries, and "
                    "zero-downtime rolling deploys (POST /-/deploy).")
    ap.add_argument("--port", type=int,
                    default=get_env("MXNET_ROUTER_PORT", 8080, int))
    ap.add_argument("--addr", default="127.0.0.1")
    ap.add_argument("--replicas", default=None,
                    help="comma-separated replica host:port list "
                         "(default: MXNET_ROUTER_REPLICAS)")
    args = ap.parse_args(argv)

    introspect.set_role("router")
    introspect.maybe_install_postmortem(role="router")
    introspect.ensure_debugz(role="router")
    cfg = RouterConfig(**({"replicas": args.replicas}
                          if args.replicas is not None else {}))
    router = Router(config=cfg)
    port = router.start(args.port, args.addr)
    stop = threading.Event()

    def _on_term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    router.on_quit = stop.set

    print(f"router: {len(router.replicas())} replica(s) on "
          f"http://{args.addr}:{port} (SIGTERM drains)", flush=True)
    while not stop.is_set():
        stop.wait(0.5)
    router.close()
    print("router: drained, bye", flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
