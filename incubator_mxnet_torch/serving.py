"""Resilient serving runtime: an HTTP front end over `deploy.load_serving`
with admission control, per-request deadlines, a circuit breaker, atomic
hot model reload, batch buckets and graceful drain (counterpart of
`incubator_mxnet_tpu/serving.py`).

* **Admission control** — a bounded request queue
  (``MXNET_SERVE_QUEUE``) with load shedding: a full queue answers
  ``429`` + ``Retry-After`` instead of building unbounded latency, and
  ``MXNET_SERVE_CONCURRENCY`` model workers bound the in-flight work.
* **Deadlines** — every request carries one
  (``MXNET_SERVE_DEADLINE_MS``, client-overridable via the
  ``X-Deadline-Ms`` header), enforced both while queued and in flight:
  the client gets ``504`` the moment the deadline passes even if a
  forward pass is stuck on the device.  A worker wedged past its
  request's deadline is counted (``serving_workers_stuck``) and a
  bounded replacement worker is spawned so capacity doesn't silently
  collapse.
* **Circuit breaker** — ``MXNET_SERVE_BREAKER_THRESHOLD`` consecutive
  model failures trip it; while open every request is shed with a fast
  ``503`` + ``Retry-After``; after ``MXNET_SERVE_BREAKER_COOLDOWN_MS``
  it half-opens and admits exactly one probe — success closes it,
  failure re-opens it.
* **Hot reload** — ``POST /-/reload`` (or ``SIGHUP``) loads the new
  artifact in the background (manifest-validated, then warmed with the
  last recorded good inputs so kernel builds and allocator growth
  happen off the request path), atomically swaps on success, and rolls
  back — old model keeps serving, bit-identical — on any failure.
* **Graceful drain** — ``SIGTERM`` flips ``/-/readyz`` to 503, sheds
  everything still queued with ``503``, finishes in-flight requests
  under ``MXNET_SERVE_DRAIN_MS``, joins the workers, then the process
  exits 0.
* **Micro-batching** — compatible queued requests coalesce into one
  forward up to the artifact's batch capacity, but never by waiting
  past the point where any member's deadline could be missed.  The
  batch is padded with zero rows (their valid_length is 0: the
  attention kernels give them the mean of v over the keys they visit,
  never NaN) to the smallest batch bucket of the artifact that fits
  (``MXNET_SERVE_BUCKETS=1``, the default), else to the capacity, and
  each request gets its own rows back.
* **Tracing** — every request gets (or keeps) an ``X-Trace-Id``,
  returned on EVERY response (429/503/504 included); with
  ``MXNET_TRACE=1`` the queue-wait → batch-coalesce → model-call →
  reply pipeline is recorded as spans in that trace, recent traces are
  served at ``/-/debug/traces``, and ``MXNET_SERVE_ACCESS_LOG=path``
  appends one JSONL line per request (trace id, status, queue-wait/exec
  ms, batch rows, deadline left).

Endpoints: ``POST /predict`` (JSON ``{"inputs": [...]}``),
``GET /-/healthz`` (always-200 state dump), ``GET /-/readyz``,
``GET /metrics`` (telemetry exposition — no second listener needed),
``GET /-/debug/traces``, ``POST /-/reload``, and on a loopback bind the
debugz pages (``/-/statusz``, ``/-/stackz``, ``/-/tracez``,
``/-/metricz``, ``/-/flightz``) and ``POST /-/quitquitquit``.

Everything emits through `incubator_mxnet_torch.telemetry`:
``serving_queue_depth``, ``serving_shed_total``,
``serving_deadline_timeouts_total``, ``serving_breaker_state``/
``_trips``, ``serving_reloads_total``, ``serving_model_calls_total``,
``serving_batch_rows``, ``serving_batch_pad_rows``,
``serving_http_request_seconds``.

The device is explicit: `ServingRuntime(..., ctx=None)` and ``--ctx``
serve on gpu(0) unless the CPU is asked for, and raise without CUDA.
The JAX package reads `batch_window_ms` from the tuner's winner file
when its env var is unset; the port has no tuner, so it takes the
default.

Chaos gate: ``python -m incubator_mxnet_torch.tools.serve_chaos``.

Run standalone::

    python -m incubator_mxnet_torch.serving /path/to/artifact --port 8080 \
        [--ctx cpu]
"""
from __future__ import annotations

import collections
import itertools
import json
import math
import signal
import threading
import time

import numpy as np

from .base import MXNetError, get_env
from . import deploy
from . import telemetry
from . import tracing
from . import introspect

__all__ = ["ServeConfig", "CircuitBreaker", "ServingRuntime", "main"]


# -- telemetry ----------------------------------------------------------

_tm_http = telemetry.counter(
    "serving_http_requests", "HTTP requests by path and status",
    ("path", "code"))
_tm_http_secs = telemetry.histogram(
    "serving_http_request_seconds", "HTTP request latency", ("path",))
_tm_shed = telemetry.counter(
    "serving_shed", "Requests shed at admission", ("reason",))
_tm_timeouts = telemetry.counter(
    "serving_deadline_timeouts", "Requests past deadline", ("stage",))
_tm_queue_depth = telemetry.gauge(
    "serving_queue_depth", "Requests waiting for a model worker")
_tm_inflight = telemetry.gauge(
    "serving_inflight_requests", "Requests inside a model call")
_tm_breaker_state = telemetry.gauge(
    "serving_breaker_state", "0 closed, 1 open, 2 half-open")
_tm_breaker_trips = telemetry.counter(
    "serving_breaker_trips", "Circuit breaker close->open transitions")
_tm_reloads = telemetry.counter(
    "serving_reloads", "Hot reload attempts", ("result",))
_tm_model_calls = telemetry.counter(
    "serving_model_calls", "Model invocations (batches)")
_tm_model_failures = telemetry.counter(
    "serving_model_failures", "Model invocations that raised")
_tm_batch_rows = telemetry.histogram(
    "serving_batch_rows", "Rows coalesced per model call",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
_tm_pad_rows = telemetry.histogram(
    "serving_batch_pad_rows", "Zero rows padded onto a model call "
    "(per-shape buckets shrink this)",
    buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128))
_tm_stuck = telemetry.gauge(
    "serving_workers_stuck", "Workers wedged past their request deadline")


def _np_dtype(name):
    """Host-side dtype of an input spec; numpy has no bfloat16, so such
    inputs are parsed as float32 and cast on the device."""
    return np.dtype("float32" if name == "bfloat16" else name)


def _jsonable(arr):
    return np.asarray(arr).tolist()


def _trace_of(hdr):
    """(int trace id, header string) for a request.  A client-sent
    ``X-Trace-Id`` is kept verbatim as the header string (it is THEIR
    correlation key); hex up to 16 chars maps to the id directly, any
    other token hashes to a stable id.  No header: mint a fresh id."""
    if hdr:
        hdr = str(hdr)[:128]
        tid = tracing.parse_id(hdr)
        if not tid:
            import hashlib
            tid = int.from_bytes(
                hashlib.blake2s(hdr.encode(), digest_size=8).digest(),
                "little") or 1
        return tid, hdr
    tid = tracing.new_id()
    return tid, tracing.format_id(tid)


import weakref as _weakref

_live_runtimes = _weakref.WeakSet()


def _over_live_runtimes(accessor):
    """One introspection payload over every live runtime:
    single-runtime processes keep the flat per-runtime shape (what a
    fleet scraper reads); multi-runtime embedders report the list.  Shared
    by the statusz and tracez providers so the two contracts cannot
    diverge — and closing the newest runtime degrades nothing for a
    survivor."""
    rts = sorted(_live_runtimes, key=id)
    if not rts:
        return {"gone": True}
    if len(rts) == 1:
        return accessor(rts[0])
    return {"count": len(rts), "replicas": [accessor(r) for r in rts]}


def _runtimes_statusz():
    return _over_live_runtimes(lambda r: r.healthz())


def _runtimes_tracez():
    return _over_live_runtimes(lambda r: r.debug_traces())


# -- configuration ------------------------------------------------------

class ServeConfig:
    """Runtime knobs, each an ``MXNET_SERVE_*`` env var overridable by
    keyword (tests)."""

    _FIELDS = (
        ("concurrency", "MXNET_SERVE_CONCURRENCY", 2, int),
        ("queue_limit", "MXNET_SERVE_QUEUE", 64, int),
        ("deadline_ms", "MXNET_SERVE_DEADLINE_MS", 30000.0, float),
        ("batch_window_ms", "MXNET_SERVE_BATCH_WINDOW_MS", 2.0, float),
        ("breaker_threshold", "MXNET_SERVE_BREAKER_THRESHOLD", 5, int),
        ("breaker_cooldown_ms", "MXNET_SERVE_BREAKER_COOLDOWN_MS",
         1000.0, float),
        ("drain_ms", "MXNET_SERVE_DRAIN_MS", 10000.0, float),
        ("fault_plan", "MXNET_SERVE_FAULT_PLAN", "", str),
        ("access_log", "MXNET_SERVE_ACCESS_LOG", "", str),
        # 1 = pad each coalesced batch to the smallest artifact bucket
        # that fits (when the artifact lists batch_buckets); 0 = always
        # pad to full capacity
        ("batch_buckets", "MXNET_SERVE_BUCKETS", 1, int),
    )

    def __init__(self, **overrides):
        for attr, env, default, typ in self._FIELDS:
            if attr in overrides:
                setattr(self, attr, typ(overrides.pop(attr)))
            else:
                setattr(self, attr, get_env(env, default, typ))
        if overrides:
            raise MXNetError(
                f"unknown ServeConfig fields {sorted(overrides)}")
        self.concurrency = max(1, self.concurrency)
        self.queue_limit = max(1, self.queue_limit)


def _parse_fault_plan(spec):
    """``MXNET_SERVE_FAULT_PLAN`` — deterministic test-only fault hooks
    on the model-call path, the serving analogue of
    ``MXNET_KV_FAULT_PLAN``: comma-separated ``fail:N`` (the Nth model
    call raises — a poison input that passed validation) and
    ``slow:N:MS`` (the Nth call stalls MS first — a stuck forward
    pass).  ``N`` may be ``*`` for every call.  0-indexed over data-path
    calls only (warmup and reload-warm calls don't count)."""
    plan = {"fail": set(), "slow": {}}
    for tok in filter(None, (t.strip() for t in spec.split(","))):
        try:
            parts = tok.split(":")
            kind, idx = parts[0], parts[1]
            key = "*" if idx == "*" else int(idx)
            if kind == "fail":
                plan["fail"].add(key)
            elif kind == "slow":
                plan["slow"][key] = float(parts[2])
            else:
                raise ValueError(kind)
        except (IndexError, ValueError):
            raise MXNetError(
                f"bad MXNET_SERVE_FAULT_PLAN entry {tok!r}") from None
    return plan


# -- circuit breaker ----------------------------------------------------

class CircuitBreaker:
    """Consecutive-failure breaker: closed → (threshold consecutive
    model failures) → open — every request sheds with a fast 503 +
    Retry-After until the cooldown elapses — → half-open: exactly one
    probe request is admitted; success closes, failure re-opens."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, threshold, cooldown_s):
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown_s)
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_out = False
        self._probe_at = 0.0
        self._probe_token = 0   # admit() hands it out; release/success
        #                         must present it — stale probes can't
        #                         clobber a newer one's slot
        self.last_error = None
        _tm_breaker_state.set(0)

    @property
    def state(self):
        with self._lock:
            if self._state == self.OPEN and \
                    time.monotonic() >= self._opened_at + self.cooldown:
                return self.HALF_OPEN   # next admit() will transition
            return self._state

    def admit(self):
        """Called per request before queueing.  Returns
        ``(admitted, retry_after_s, probe_token)`` — probe_token is 0
        for ordinary requests, a positive token when this request is
        the half-open probe (hand it back to `release_probe` /
        `record_success`)."""
        with self._lock:
            if self._state == self.CLOSED:
                return True, 0.0, 0
            if self._state == self.OPEN:
                rem = self._opened_at + self.cooldown - time.monotonic()
                if rem > 0:
                    return False, rem, 0
                self._state = self.HALF_OPEN
                self._probe_out = False
                _tm_breaker_state.set(2)
            if self._probe_out and \
                    time.monotonic() - self._probe_at <= self.cooldown:
                return False, self.cooldown, 0
            # no probe out — or the outstanding one has been gone a
            # full cooldown (its forward pass wedged; its 504 released
            # the client but record_* will never fire): reclaim the
            # slot, else a single hung probe pins the breaker half-open
            # and the server sheds 503 forever
            self._probe_out = True
            self._probe_at = time.monotonic()
            self._probe_token += 1
            return True, 0.0, self._probe_token

    def release_probe(self, token=None):
        """The probe never reached the model (expired/drained): let the
        next request probe instead of wedging half-open forever.  With
        a token, only the CURRENT probe is released — a stale 504'd
        probe racing a fresh one is a no-op instead of opening a second
        concurrent probe slot."""
        with self._lock:
            if token is None or token == self._probe_token:
                self._probe_out = False

    def record_success(self, probe=0):
        with self._lock:
            if self._state == self.OPEN or \
                    (self._state == self.HALF_OPEN
                     and probe != self._probe_token):
                # a straggler call that started BEFORE the trip (or a
                # stale superseded probe): its success says nothing
                # about recovery — only the CURRENT probe's outcome may
                # close the breaker, else the cooldown/single-probe
                # discipline is defeated
                return
            self._failures = 0
            self._probe_out = False
            if self._state != self.CLOSED:
                self._state = self.CLOSED
                self.last_error = None
            _tm_breaker_state.set(0)

    def record_failure(self, err):
        with self._lock:
            self.last_error = f"{type(err).__name__}: {err}"
            self._failures += 1
            if self._state == self.HALF_OPEN or \
                    self._failures >= self.threshold:
                if self._state != self.OPEN:
                    _tm_breaker_trips.inc()
                    introspect.flight("breaker_trip",
                                      error=self.last_error,
                                      failures=self._failures)
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                self._probe_out = False
                self._failures = 0
                _tm_breaker_state.set(1)

    def describe(self):
        with self._lock:
            state = self._state
            d = {"consecutive_failures": self._failures,
                 "threshold": self.threshold,
                 "cooldown_ms": self.cooldown * 1000.0}
            if state == self.OPEN:
                rem = self._opened_at + self.cooldown - time.monotonic()
                if rem > 0:
                    d["retry_after_s"] = rem
                else:
                    # mirror the `state` property: the cooldown has
                    # elapsed, the next request WILL be admitted as a
                    # probe — healthz must not show a stuck-"open"
                    # breaker on a server that is accepting traffic
                    state = self.HALF_OPEN
            d["state"] = state
            if self.last_error:
                d["last_error"] = self.last_error
            return d


# -- requests and model slots ------------------------------------------

class _Request:
    __slots__ = ("arrays", "rows", "deadline", "enqueued_at", "probe",
                 "started", "abandoned", "status", "payload", "_event",
                 "trace_id", "trace_hdr", "popped_at", "call_t0",
                 "call_t1", "batch_rows")

    def __init__(self, arrays, rows, deadline, probe=False):
        self.arrays = arrays
        self.rows = rows
        self.deadline = deadline      # absolute time.monotonic()
        self.enqueued_at = time.monotonic()
        self.probe = probe
        self.started = False          # picked up by a worker
        self.abandoned = False        # handler already answered (504)
        self.status = None
        self.payload = None
        self._event = threading.Event()
        # tracing / access-log bookkeeping
        self.trace_id = 0
        self.trace_hdr = ""
        self.popped_at = 0.0          # left the queue (queue-wait end)
        self.call_t0 = 0.0            # model call start / end — set by
        self.call_t1 = 0.0            #   the worker, read at reply time
        self.batch_rows = 0           # rows of the coalesced batch

    def finish(self, status, payload):
        self.status = status
        self.payload = payload
        self._event.set()

    def wait(self, timeout):
        return self._event.wait(timeout)


class _ModelSlot:
    """One loaded artifact: the model plus everything the batcher needs.
    Slots are immutable — hot reload builds a new one and swaps the
    reference, so workers always see a consistent (model, signature)
    pair."""

    __slots__ = ("model", "artifact_dir", "meta", "capacity", "batchable",
                 "loaded_at", "buckets")

    def __init__(self, model, artifact_dir):
        self.model = model
        self.artifact_dir = artifact_dir
        self.meta = model.meta
        self.loaded_at = time.time()
        ins, outs = self.meta["inputs"], self.meta["outputs"]
        cap = ins[0]["shape"][0] if ins and ins[0]["shape"] else 0
        # batchable: every input AND output leads with the same batch
        # dim, so rows from several requests concat along axis 0 and the
        # outputs slice back apart
        self.batchable = (
            cap >= 1
            and all(s["shape"][:1] == [cap] for s in ins)
            and all(o["shape"][:1] == [cap] for o in outs))
        self.capacity = cap if self.batchable else 1
        # per-shape padding buckets: the sub-capacity batch sizes the
        # artifact lists (deploy.load_serving attaches .buckets)
        sub = getattr(model, "buckets", None) or {}
        self.buckets = sorted(b for b in sub
                              if 1 <= b < self.capacity) \
            if self.batchable else []

    def bucket_for(self, rows):
        """``(pad_target, callable)`` — the smallest bucket that fits
        `rows`, else the full-capacity model."""
        for b in self.buckets:
            if b >= rows:
                return b, self.model.buckets[b]
        return self.capacity, self.model

    def zero_inputs(self):
        return [np.zeros(s["shape"], _np_dtype(s["dtype"]))
                for s in self.meta["inputs"]]

    def parse_inputs(self, body):
        """Validate a request body against this slot's signature;
        returns ``(arrays, rows)`` or raises ValueError (→ 400)."""
        if not isinstance(body, dict) or "inputs" not in body:
            raise ValueError('body must be {"inputs": [...]}')
        raw = body["inputs"]
        specs = self.meta["inputs"]
        if not isinstance(raw, list) or len(raw) != len(specs):
            raise ValueError(
                f"expected {len(specs)} input arrays, got "
                f"{len(raw) if isinstance(raw, list) else type(raw).__name__}")
        arrays, rows = [], None
        for i, (x, spec) in enumerate(zip(raw, specs)):
            try:
                arr = np.asarray(x, dtype=_np_dtype(spec["dtype"]))
            except (TypeError, ValueError) as e:
                raise ValueError(f"input[{i}]: not a dense "
                                 f"{spec['dtype']} array ({e})") from None
            full = tuple(spec["shape"])
            if self.batchable:
                if arr.ndim != len(full) or arr.shape[1:] != full[1:]:
                    raise ValueError(
                        f"input[{i}]: expected shape (rows<="
                        f"{self.capacity},)+{full[1:]}, got {arr.shape}")
                if not 1 <= arr.shape[0] <= self.capacity:
                    raise ValueError(
                        f"input[{i}]: rows must be in [1, "
                        f"{self.capacity}], got {arr.shape[0]}")
                if rows is None:
                    rows = arr.shape[0]
                elif rows != arr.shape[0]:
                    raise ValueError("inputs disagree on row count")
            else:
                if arr.shape != full:
                    raise ValueError(
                        f"input[{i}]: expected shape {full}, "
                        f"got {arr.shape}")
                rows = 1
            arrays.append(arr)
        return arrays, rows


# -- the runtime --------------------------------------------------------

class ServingRuntime:
    """Owns the model slot, the admission queue, the worker pool, the
    breaker, and the HTTP front end.  Library-embeddable (tests drive
    it in-process); `main()` adds signal handlers around it.  `ctx` is
    the device to serve on (default gpu(0)); every slot, reloads
    included, loads there."""

    def __init__(self, artifact_dir, config=None, warm=True, ctx=None):
        self._cfg = config or ServeConfig()
        self._ctx = ctx
        self._fault_plan = (_parse_fault_plan(self._cfg.fault_plan)
                            if self._cfg.fault_plan else None)
        self._breaker = CircuitBreaker(
            self._cfg.breaker_threshold,
            self._cfg.breaker_cooldown_ms / 1000.0)
        self._qcond = threading.Condition()
        self._queue = collections.deque()
        self._active_batches = 0    # popped from queue, not yet answered
        self._draining = False
        self._stopping = False
        self._slot_lock = threading.Lock()
        self._warm_inputs = None        # last known-good padded inputs
        self._exec_ema = 0.05           # seconds per model call
        self._call_ids = itertools.count()
        self._inflight_calls = {}       # worker ident -> (t0, deadline)
        self._call_lock = threading.Lock()
        self.model_calls = 0            # forwards run on behalf of requests
        self._reload_lock = threading.Lock()
        self._last_reload = None
        self._http = None
        self._recent = collections.deque(maxlen=64)   # /-/debug/traces
        self._log_lock = threading.Lock()
        self._log_f = None              # MXNET_SERVE_ACCESS_LOG handle
        # replica identity on every response (router passive health:
        # X-Served-By joins router attempts to replica views without
        # body parsing)
        ident = introspect.process_identity()
        self._served_by = f"{ident['host']}#{ident['pid']}"
        self._slot = self._load_slot(artifact_dir, warm=warm)
        self._workers = []
        self._live_workers = 0
        for _ in range(self._cfg.concurrency):
            self._spawn_worker()
        # fleet introspection: the serving
        # front end serves the debugz paths itself (no second
        # listener), with /-/tracez answering EXACTLY like the legacy
        # /-/debug/traces.  Live runtimes share one weak statusz
        # registry, so a closed/dropped runtime never masks a live
        # one's section.
        _live_runtimes.add(self)
        introspect.set_tracez_provider(_runtimes_tracez)
        introspect.register_statusz("serving", _runtimes_statusz)

    # -- model loading / hot reload ------------------------------------

    def _load_slot(self, artifact_dir, warm=True):
        # load_serving manifest-validates first (one checksum pass —
        # params.npz can be huge)
        slot = _ModelSlot(deploy.load_serving(artifact_dir, ctx=self._ctx),
                          artifact_dir)
        if warm:
            inputs = self._warm_inputs
            if inputs is None or not self._compatible_warm(slot, inputs):
                inputs = slot.zero_inputs()
            # kernel builds and allocator growth off the request path;
            # raises on a poisoned artifact or a kernel that does not
            # build or launch, so no server starts on one
            slot.model(*inputs)
            if self._cfg.batch_buckets:
                # each bucket is its own batch shape: warm them too, or
                # the first sub-capacity batch grows the allocator
                # in-flight
                for b in slot.buckets:
                    slot.model.buckets[b](*[
                        np.zeros((b,) + tuple(s["shape"][1:]),
                                 _np_dtype(s["dtype"]))
                        for s in slot.meta["inputs"]])
        return slot

    @staticmethod
    def _compatible_warm(slot, inputs):
        specs = slot.meta["inputs"]
        return (len(inputs) == len(specs)
                and all(list(a.shape) == s["shape"]
                        and str(a.dtype) == str(_np_dtype(s["dtype"]))
                        for a, s in zip(inputs, specs)))

    def reload(self, artifact_dir=None):
        """Atomic hot reload: validate + load + warm the new artifact in
        the background while the old model keeps serving, swap only on
        success.  Returns the result dict also shown by /-/healthz."""
        if not self._reload_lock.acquire(blocking=False):
            return {"ok": False, "error": "reload already in progress",
                    "in_progress": True}
        try:
            target = artifact_dir or self._slot.artifact_dir
            t0 = time.time()
            try:
                slot = self._load_slot(target, warm=True)
            except Exception as e:   # noqa: BLE001 — rollback, not crash
                result = {"ok": False, "artifact_dir": target,
                          "error": f"{type(e).__name__}: {e}",
                          "rolled_back_to": self._slot.artifact_dir,
                          "unix_time": t0}
                _tm_reloads.labels("failed").inc()
                introspect.flight("reload", ok=False, artifact=target,
                                  error=result["error"])
                self._last_reload = result
                return result
            with self._slot_lock:
                self._slot = slot
            result = {"ok": True, "artifact_dir": target,
                      "seconds": time.time() - t0, "unix_time": t0}
            _tm_reloads.labels("ok").inc()
            introspect.flight("reload", ok=True, artifact=target)
            self._last_reload = result
            return result
        finally:
            self._reload_lock.release()

    # -- admission ------------------------------------------------------

    def _cull_abandoned_locked(self):
        """Caller holds _qcond.  Requests whose handler already answered
        504 (``abandoned``) still sit in the queue until a worker pops
        them; with wedged workers those corpses would eat the bounded
        queue and shed fresh requests spuriously — drop them before
        judging fullness."""
        if len(self._queue) >= self._cfg.queue_limit:
            live = [r for r in self._queue if not r.abandoned]
            if len(live) != len(self._queue):
                self._queue.clear()
                self._queue.extend(live)
                _tm_queue_depth.set(len(self._queue))

    def _queue_retry_after(self):
        # caller holds _qcond.  The backlog drains roughly one model
        # call per worker per _exec_ema seconds; tell the client when a
        # queue slot should plausibly free up.
        waves = (len(self._queue) + 1) / max(1, self._cfg.concurrency)
        return self._exec_ema * max(1.0, waves)

    def _shed(self, reason, code, retry_after=None):
        _tm_shed.labels(reason).inc()
        headers = {}
        if retry_after is not None:
            headers["Retry-After"] = str(max(1, int(retry_after + 0.999)))
        return code, {"error": f"request shed: {reason}",
                      "reason": reason}, headers

    def preadmit(self):
        """Cheap, non-mutating overload check the HTTP layer runs
        BEFORE even json-decoding the body: overload is exactly when
        the fast 429/503 must not cost a full parse of a large body.
        Returns a shed ``(status, payload, headers)`` or None to
        proceed (the real admission re-checks inside `predict`)."""
        with self._qcond:
            if self._draining or self._stopping:
                return self._shed("draining", 503)
            self._cull_abandoned_locked()
            if len(self._queue) >= self._cfg.queue_limit:
                return self._shed("queue_full", 429,
                                  self._queue_retry_after())
        b = self._breaker.describe()
        if b["state"] == CircuitBreaker.OPEN and \
                b.get("retry_after_s", 0) > 0:
            return self._shed("breaker_open", 503, b["retry_after_s"])
        return None

    def predict(self, body, deadline_ms=None, trace=None):
        """Full data path for one request body (already JSON-decoded).
        Returns ``(status, payload, headers)`` — always, bounded by the
        request deadline; never hangs.  `trace` is the ``(trace id,
        header string)`` pair from :func:`_trace_of`; the returned
        headers ALWAYS carry ``X-Trace-Id`` — 429/503/504 included —
        so a shed or timed-out request is still correlatable."""
        t_enter = time.monotonic()
        tid, hdr = trace if trace is not None else _trace_of(None)
        deadline = t_enter + (deadline_ms if deadline_ms is not None
                              else self._cfg.deadline_ms) / 1000.0
        status, payload, headers, req = self._predict_impl(
            body, deadline, tid, hdr)
        headers = dict(headers or {})
        headers["X-Trace-Id"] = hdr
        self._note_request(tid, hdr, status, t_enter, deadline, req,
                           payload)
        return status, payload, headers

    def _predict_impl(self, body, deadline, tid, hdr):
        shed = self.preadmit()
        if shed is not None:
            return shed + (None,)

        with self._slot_lock:
            slot = self._slot
        try:
            arrays, rows = slot.parse_inputs(body)
        except ValueError as e:
            return 400, {"error": str(e)}, {}, None

        with self._qcond:
            if self._draining or self._stopping:
                return self._shed("draining", 503) + (None,)
            admitted, retry_after, probe = self._breaker.admit()
            if not admitted:
                return self._shed("breaker_open", 503,
                                  retry_after) + (None,)
            self._cull_abandoned_locked()
            if len(self._queue) >= self._cfg.queue_limit:
                if probe:
                    self._breaker.release_probe(probe)
                return self._shed("queue_full", 429,
                                  self._queue_retry_after()) + (None,)
            req = _Request(arrays, rows, deadline, probe=probe)
            req.trace_id, req.trace_hdr = tid, hdr
            self._queue.append(req)
            _tm_queue_depth.set(len(self._queue))
            self._qcond.notify()

        if req.wait(max(0.0, deadline - time.monotonic())):
            return req.status, req.payload, {}, req
        # deadline passed first: answer 504 now, whatever the worker is
        # doing — a stuck forward pass must not wedge the client too
        with self._qcond:
            req.abandoned = True
            stage = "inflight" if req.started else "queued"
        _tm_timeouts.labels(stage).inc()
        if stage == "inflight":
            self._maybe_add_worker()
        elif req.probe:
            self._breaker.release_probe(req.probe)
        return 504, {"error": f"deadline exceeded while {stage}",
                     "stage": stage}, {}, req

    # -- per-request observability --------------------------------------

    def _note_request(self, tid, hdr, status, t_enter, deadline=None,
                      req=None, payload=None, path="/predict"):
        """One exit point for every answered request: records the
        serve.request → queue_wait → batch_coalesce → model_call span
        pipeline into the request's trace, appends the
        ``/-/debug/traces`` summary, and writes the access-log line."""
        now = time.monotonic()
        qwait = exec_s = coalesce = 0.0
        batch = 0
        if req is not None:
            popped = req.popped_at or now
            qwait = max(0.0, popped - req.enqueued_at)
            if req.call_t0:
                exec_s = max(0.0, (req.call_t1 or now) - req.call_t0)
                coalesce = max(0.0, req.call_t0 - popped)
            batch = req.batch_rows
        deadline_left_ms = None if deadline is None else \
            round((deadline - now) * 1000.0, 3)
        if tracing.enabled():
            root = tracing.new_id()
            if req is not None:
                tracing.record_span(
                    "serve.queue_wait", req.enqueued_at,
                    req.enqueued_at + qwait, tid, root)
                if req.call_t0:
                    tracing.record_span(
                        "serve.batch_coalesce", req.popped_at,
                        req.call_t0, tid, root)
                    tracing.record_span(
                        "serve.model_call", req.call_t0,
                        req.call_t1 or now, tid, root,
                        {"batch_rows": batch})
            attrs = {"status": status, "path": path}
            if hdr != tracing.format_id(tid):
                # non-hex client token: it hashed to the internal id,
                # so surface the original on the span or the client
                # could never find their trace in /-/debug/traces
                attrs["client_trace_id"] = hdr
            tracing.record_span(
                "serve.request", t_enter, now, tid, 0, attrs,
                span_id=root)
        entry = {"time": time.time(), "path": path,
                 "trace_id": hdr, "status": int(status),
                 "queue_wait_ms": round(qwait * 1e3, 3),
                 "exec_ms": round(exec_s * 1e3, 3),
                 "coalesce_ms": round(coalesce * 1e3, 3),
                 "batch": int(batch),
                 "deadline_left_ms": deadline_left_ms}
        reason = (payload or {}).get("reason") if isinstance(
            payload, dict) else None
        if reason:
            entry["reason"] = reason
        self._recent.appendleft(entry)
        self._access_log_write(entry)

    def _access_log_write(self, entry):
        """One JSONL line per request (``MXNET_SERVE_ACCESS_LOG``).
        Best-effort: an unwritable log disables itself rather than
        failing requests."""
        path = self._cfg.access_log
        if not path:
            return
        line = json.dumps(entry, sort_keys=True)
        with self._log_lock:
            try:
                if self._log_f is None:
                    self._log_f = open(path, "a")
                self._log_f.write(line + "\n")
                self._log_f.flush()
            except OSError:
                self._cfg.access_log = ""

    def debug_traces(self, limit=20):
        """Payload of ``GET /-/debug/traces``: recent request summaries
        (always) plus full span timelines when tracing is on."""
        return {"tracing_enabled": tracing.enabled(),
                "recent_requests": list(self._recent),
                "traces": tracing.recent_traces(limit)
                if tracing.enabled() else []}

    # -- worker pool ----------------------------------------------------

    def _spawn_worker(self):
        self._live_workers += 1
        t = threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"mx-serve-worker-{self._live_workers}")
        # retired replacements stay dead Thread objects forever — prune
        # them here or a long-lived server leaks one per wedge incident
        self._workers = [w for w in self._workers if w.is_alive()]
        self._workers.append(t)
        t.start()

    def _maybe_add_worker(self):
        """A worker is wedged past a deadline: restore capacity with a
        bounded replacement (cap: 2x concurrency).  The surplus retires
        as wedged calls eventually return."""
        with self._qcond:
            stuck = self._stuck_count()
            if stuck and self._live_workers < 2 * self._cfg.concurrency \
                    and self._live_workers - stuck < self._cfg.concurrency:
                self._spawn_worker()

    def _stuck_count(self):
        now = time.monotonic()
        with self._call_lock:
            n = sum(1 for t0, dl in self._inflight_calls.values()
                    if now > dl)
        _tm_stuck.set(n)
        return n

    def _worker_loop(self):
        retired = False
        try:
            while True:
                batch = self._next_batch()
                if batch is None:
                    return
                try:
                    self._run_batch(batch)
                except Exception as e:  # noqa: BLE001 — backstop: a bug
                    # on the batch path must answer the batch and keep
                    # the worker alive, never silently shrink the pool
                    for r in batch:
                        if r.probe:
                            # the probe never reached the model: free
                            # the half-open slot or the breaker wedges
                            self._breaker.release_probe(r.probe)
                        if not r.abandoned:
                            r.finish(500, {"error": f"internal error: "
                                           f"{type(e).__name__}: {e}"})
                finally:
                    with self._qcond:
                        self._active_batches -= 1
                with self._qcond:
                    if self._live_workers - self._stuck_count() > \
                            self._cfg.concurrency:
                        # surplus replacement: retire.  Decrement HERE,
                        # inside the same critical section as the check
                        # — two workers deciding in separate sections
                        # could both retire and empty the pool.
                        self._live_workers -= 1
                        retired = True
                        return
        finally:
            if not retired:
                with self._qcond:
                    self._live_workers -= 1

    def _pop_expired_or_dead(self, req):
        """Handle a request that must not run; True if it was culled."""
        if req.abandoned:
            if req.probe:
                # a probe 504'd in the pop→model gap never reaches
                # record_*: free its slot here (token-gated, so this
                # is a no-op if a newer probe already took over)
                self._breaker.release_probe(req.probe)
            return True
        if time.monotonic() >= req.deadline:
            _tm_timeouts.labels("queued").inc()
            if req.probe:
                self._breaker.release_probe(req.probe)
            req.finish(504, {"error": "deadline exceeded while queued",
                             "stage": "queued"})
            return True
        return False

    def _next_batch(self):
        """Deadline-aware coalescing pop.  Blocks until work or stop.
        FIFO: the head request anchors the batch; more queued requests
        join while they fit the capacity, and we only *wait* for more
        if the batching window AND every member's deadline allow it."""
        with self._qcond:
            while True:
                while not self._queue and not self._stopping:
                    self._qcond.wait(0.05)
                if self._stopping and not self._queue:
                    return None
                head = self._queue.popleft()
                _tm_queue_depth.set(len(self._queue))
                if self._pop_expired_or_dead(head):
                    continue
                # started flips under _qcond AT the pop: predict's 504
                # path reads it under the same lock, so a probe is
                # either still queued (predict releases it) or owned by
                # this worker (record_*/409 paths resolve it) — never
                # both, which would run two probes concurrently
                head.started = True
                head.popped_at = time.monotonic()   # queue-wait ends
                batch, rows = [head], head.rows
                with self._slot_lock:
                    capacity = self._slot.capacity
                start_by = head.deadline - self._exec_ema
                window_end = (time.monotonic()
                              + self._cfg.batch_window_ms / 1000.0)
                end = min(start_by, window_end)
                while rows < capacity:
                    while self._queue and rows < capacity:
                        cand = self._queue[0]
                        if cand.rows + rows > capacity:
                            break
                        self._queue.popleft()
                        _tm_queue_depth.set(len(self._queue))
                        if self._pop_expired_or_dead(cand):
                            continue
                        cand.started = True
                        cand.popped_at = time.monotonic()
                        batch.append(cand)
                        rows += cand.rows
                        start_by = min(start_by,
                                       cand.deadline - self._exec_ema)
                        end = min(start_by, window_end)
                    remaining = end - time.monotonic()
                    if rows >= capacity or remaining <= 0 or \
                            self._stopping:
                        break
                    self._qcond.wait(min(remaining, 0.005))
                # counted while still under _qcond: drain() must see
                # this batch as busy the instant it leaves the queue,
                # or SIGTERM in the pop→model-call gap reports a clean
                # drain with a request still on its way into the model
                self._active_batches += 1
                return batch

    def _run_batch(self, batch):
        with self._slot_lock:
            slot = self._slot
        batch = [r for r in batch if not self._pop_expired_or_dead(r)]
        if not batch:
            return
        rows = sum(r.rows for r in batch)
        model = slot.model
        pad_target = slot.capacity
        try:
            if slot.batchable:
                if rows > slot.capacity:
                    raise ValueError(
                        f"{rows} rows exceed batch capacity "
                        f"{slot.capacity}")
                if self._cfg.batch_buckets and slot.buckets:
                    # per-shape buckets: pad to the smallest listed
                    # bucket that fits instead of the worst case
                    pad_target, model = slot.bucket_for(rows)
                inputs = []
                for i, spec in enumerate(slot.meta["inputs"]):
                    parts = [r.arrays[i] for r in batch]
                    pad = pad_target - rows
                    if pad > 0:
                        parts.append(
                            np.zeros((pad,) + tuple(spec["shape"][1:]),
                                     _np_dtype(spec["dtype"])))
                    inputs.append(np.concatenate(parts, axis=0)
                                  if len(parts) > 1 else parts[0])
            else:
                # requests were validated (and maybe coalesced) against
                # the slot _next_batch saw; a reload may have swapped in
                # a non-batchable one since.  Silently feeding only
                # batch[0] would hand its outputs to every member —
                # re-check here so the mismatch lands on the 409 path
                if len(batch) > 1:
                    raise ValueError(
                        "coalesced batch incompatible with non-batchable"
                        " reloaded model")
                inputs = batch[0].arrays
                for a, spec in zip(inputs, slot.meta["inputs"]):
                    if list(a.shape) != spec["shape"]:
                        raise ValueError(
                            f"request shape {a.shape} incompatible with "
                            f"reloaded model {tuple(spec['shape'])}")
        except Exception as e:  # noqa: BLE001 — requests validated against
            # an OLD slot can be incompatible with a hot-reloaded one;
            # that is the request's problem, not the model's (no breaker
            # food) and must never kill the worker
            for r in batch:
                if r.probe:     # never reached the model: free the slot
                    self._breaker.release_probe(r.probe)
                if not r.abandoned:
                    r.finish(409, {"error": "request incompatible with "
                                            f"reloaded model: "
                                            f"{type(e).__name__}: {e}"})
            return

        ident = threading.get_ident()
        min_deadline = min(r.deadline for r in batch)
        with self._call_lock:
            self._inflight_calls[ident] = (time.monotonic(), min_deadline)
            self.model_calls += 1
        _tm_inflight.inc(len(batch))
        _tm_batch_rows.observe(rows)
        if slot.batchable:
            _tm_pad_rows.observe(pad_target - rows)
        call_idx = next(self._call_ids)
        call_t0 = time.monotonic()
        for r in batch:
            r.call_t0 = call_t0
            r.batch_rows = rows
        t0 = time.perf_counter()
        try:
            _tm_model_calls.inc()
            self._inject_faults(call_idx)
            outs = model(*inputs)
        except Exception as e:      # noqa: BLE001 — breaker absorbs it
            _tm_model_failures.inc()
            self._breaker.record_failure(e)
            for r in batch:
                if not r.abandoned:
                    r.finish(500, {"error": f"model failure: "
                                            f"{type(e).__name__}: {e}"})
            return
        finally:
            _tm_inflight.dec(len(batch))
            call_t1 = time.monotonic()
            for r in batch:
                r.call_t1 = call_t1
            with self._call_lock:
                self._inflight_calls.pop(ident, None)
            self._stuck_count()
        dt = time.perf_counter() - t0
        self._exec_ema = 0.8 * self._exec_ema + 0.2 * dt
        self._breaker.record_success(
            probe=next((r.probe for r in batch if r.probe), 0))
        if pad_target == slot.capacity:
            # known-good full-capacity inputs: reload warms with them.
            # A bucket-shaped call must not poison this — reload's
            # _compatible_warm checks against the meta capacity.
            self._warm_inputs = inputs
        off = 0
        for r in batch:
            if slot.batchable:
                payload = {"outputs": [_jsonable(o[off:off + r.rows])
                                       for o in outs]}
            else:
                payload = {"outputs": [_jsonable(o) for o in outs]}
            off += r.rows
            if not r.abandoned:
                r.finish(200, payload)

    def _inject_faults(self, call_idx):
        plan = self._fault_plan
        if not plan:
            return
        ms = plan["slow"].get(call_idx, plan["slow"].get("*"))
        if ms:
            time.sleep(ms / 1000.0)
        if call_idx in plan["fail"] or "*" in plan["fail"]:
            raise MXNetError(f"injected model fault (call {call_idx})")

    # -- drain / shutdown ----------------------------------------------

    def begin_drain(self):
        """Flip readiness and shed the whole queue with 503; in-flight
        requests keep running (SIGTERM semantics)."""
        with self._qcond:
            if self._draining:
                return
            self._draining = True
            introspect.flight("drain_begin",
                              queued=len(self._queue),
                              inflight=self._active_batches)
            while self._queue:
                req = self._queue.popleft()
                if req.probe:
                    self._breaker.release_probe(req.probe)
                if not req.abandoned:
                    _tm_shed.labels("draining").inc()
                    req.finish(503, {"error": "request shed: draining",
                                     "reason": "draining"})
            _tm_queue_depth.set(0)
            self._qcond.notify_all()

    def drain(self, timeout=None):
        """`begin_drain` + wait (bounded by ``MXNET_SERVE_DRAIN_MS``)
        for in-flight requests to finish and workers to park.  Returns
        True on a clean drain, False if the deadline forced it."""
        self.begin_drain()
        deadline = time.monotonic() + (
            timeout if timeout is not None else self._cfg.drain_ms / 1000.0)
        while time.monotonic() < deadline:
            with self._call_lock:
                busy = len(self._inflight_calls)
            with self._qcond:
                # _active_batches covers the pop→model-call window the
                # _inflight_calls registration hasn't reached yet
                queued = len(self._queue) + self._active_batches
            if not busy and not queued:
                return True
            time.sleep(0.01)
        return False

    def close(self, drain_timeout=0.0):
        """Stop everything (tests / embedders).  `drain(drain_timeout)`
        first if you want in-flight requests to finish."""
        self.begin_drain()
        if drain_timeout:
            self.drain(drain_timeout)
        with self._qcond:
            self._stopping = True
            self._qcond.notify_all()
        for t in self._workers:
            t.join(timeout=5)
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        with self._log_lock:
            if self._log_f is not None:
                try:
                    self._log_f.close()
                except OSError:
                    pass
                self._log_f = None
        # the providers are shared over the live-runtime registry:
        # closing one runtime degrades nothing for a survivor, and the
        # LAST close unhooks them (guarded — another subsystem may
        # have replaced the tracez provider meanwhile)
        _live_runtimes.discard(self)
        if not _live_runtimes:
            if introspect._tracez_provider is _runtimes_tracez:
                introspect.set_tracez_provider(None)
            introspect.unregister_statusz("serving")

    # -- introspection --------------------------------------------------

    @property
    def draining(self):
        return self._draining

    @property
    def breaker(self):
        return self._breaker

    @property
    def artifact_dir(self):
        return self._slot.artifact_dir

    def healthz(self):
        with self._slot_lock:
            slot = self._slot
        with self._qcond:
            queued = len(self._queue)
            live = self._live_workers
        with self._call_lock:
            inflight = len(self._inflight_calls)
            calls = self.model_calls
        # the port adds model_calls and the model's device to the JAX
        # package's keys: the device is explicit here
        return {
            "status": "draining" if self._draining else "ok",
            "breaker": self._breaker.describe(),
            "queue": {"depth": queued, "limit": self._cfg.queue_limit},
            "inflight_calls": inflight,
            "model_calls": calls,
            "workers": {"live": live, "stuck": self._stuck_count(),
                        "target": self._cfg.concurrency},
            "model": {"artifact_dir": slot.artifact_dir,
                      "loaded_unix_time": slot.loaded_at,
                      "batch_capacity": slot.capacity,
                      "batchable": slot.batchable,
                      "batch_buckets": list(slot.buckets),
                      "device": str(slot.model.device)},
            "last_reload": self._last_reload,
            "exec_ema_seconds": self._exec_ema,
        }

    def ready(self):
        return not self._draining and not self._stopping

    # -- HTTP front end -------------------------------------------------

    def start(self, port=0, addr="127.0.0.1"):
        """Bind the HTTP front end; returns the bound port."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        runtime = self

        # the debugz fold (statusz env vars + argv, all-thread stacks)
        # is operator-facing, not client-facing: it rides a loopback
        # bind freely, but a replica bound publicly (behind a load
        # balancer) must opt in (MXNET_DEBUGZ_EXPOSE=1) — or use the
        # loopback MXNET_DEBUGZ_PORT listener instead
        debugz_folded = addr in ("127.0.0.1", "localhost", "::1") \
            or get_env("MXNET_DEBUGZ_EXPOSE", False, bool)

        _KNOWN_PATHS = frozenset(
            ("/predict", "/-/healthz", "/-/readyz", "/metrics",
             "/-/reload", "/-/debug/traces", "/-/quitquitquit")
            + introspect.DEBUGZ_PATHS)

        class _Handler(BaseHTTPRequestHandler):
            # HTTP/1.0: one request per connection — a draining server
            # must never strand a keep-alive peer
            protocol_version = "HTTP/1.0"

            def log_message(self, *args):
                pass

            def _reply(self, code, payload, headers=None, t0=None,
                       raw=None, ctype="application/json"):
                body = raw if raw is not None else (
                    json.dumps(payload) + "\n").encode()
                try:
                    # status line and headers hit the socket too — an
                    # early-disconnecting client (curl ^C while queued)
                    # must not traceback-spam stderr via handle_error
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    # replica identity + drain state on EVERY response:
                    # the router's passive health scoring reads these
                    # headers instead of parsing bodies
                    self.send_header("X-Served-By", runtime._served_by)
                    self.send_header("X-Replica-Status",
                                     "draining" if runtime._draining
                                     else "ok")
                    for k, v in (headers or {}).items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass            # client gone: its problem, not ours
                # arbitrary 404 paths must not mint unbounded labels
                path = self.path.split("?")[0]
                if path not in _KNOWN_PATHS:
                    path = "other"
                _tm_http.labels(path, code).inc()
                if t0 is not None:
                    _tm_http_secs.labels(path).observe(
                        time.perf_counter() - t0)

            def _read_json(self):
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    return json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, OSError) as e:
                    raise ValueError(f"bad JSON body: {e}") from None

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/-/healthz":
                    self._reply(200, runtime.healthz())
                elif path == "/-/readyz":
                    if runtime.ready():
                        self._reply(200, {"ready": True})
                    else:
                        self._reply(503, {"ready": False,
                                          "status": "draining"})
                elif path == "/metrics":
                    self._reply(200, None,
                                raw=telemetry.prometheus_text().encode(),
                                ctype="text/plain; version=0.0.4; "
                                      "charset=utf-8")
                elif path == "/-/debug/traces" or (
                        path == "/-/tracez" and debugz_folded):
                    # one payload, two spellings — THIS runtime's
                    # debug_traces (not the module-global tracez
                    # provider: with two runtimes in one process, A's
                    # listener must not serve B's traces).  The legacy
                    # /-/debug/traces keeps its pre-fold public
                    # behavior; the /-/tracez spelling is part of the
                    # debugz plane and obeys its loopback gate.
                    self._reply(200, runtime.debug_traces())
                else:
                    # the debugz plane (statusz/stackz/metricz/
                    # flightz) is folded into this front end — no
                    # second listener needed on a serving replica
                    # (loopback binds only, unless opted in above)
                    payload = None
                    if debugz_folded:
                        # raw path: profilez reads ?steps=N/?view=trace
                        # from the query string
                        code, payload = introspect.debugz_payload(
                            self.path)
                    if payload is not None:
                        self._reply(code, payload)
                    else:
                        self._reply(404,
                                    {"error": f"no such path {path!r}"})

            def do_POST(self):
                t0 = time.perf_counter()
                path = self.path.split("?")[0]
                if path == "/predict":
                    # X-Trace-Id: accepted from the client (their
                    # correlation key) or assigned here; echoed on
                    # EVERY response — 429/503/504 sheds included
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
                            # inf/nan would break every deadline
                            # comparison -> the one way to get a truly
                            # hung connection
                            runtime._note_request(
                                trace[0], trace[1], 400,
                                time.monotonic())
                            self._reply(400, {"error":
                                              f"bad X-Deadline-Ms {hdr!r}"},
                                        {"X-Trace-Id": trace[1]},
                                        t0=t0)
                            return
                    shed = runtime.preadmit()
                    if shed is not None:
                        # overloaded: answer before paying json.loads
                        # of a possibly-huge body.  Still drain the
                        # wire (cheap reads, no parse) so the client
                        # can finish sending and read the reply.
                        try:
                            n = int(self.headers.get("Content-Length",
                                                     "0") or 0)
                        except ValueError:
                            n = 0
                        while n > 0:
                            chunk = self.rfile.read(min(n, 1 << 20))
                            if not chunk:
                                break
                            n -= len(chunk)
                        code, payload, headers = shed
                        headers = dict(headers or {})
                        headers["X-Trace-Id"] = trace[1]
                        runtime._note_request(
                            trace[0], trace[1], code,
                            time.monotonic(), payload=payload)
                        self._reply(code, payload, headers, t0=t0)
                        return
                    try:
                        body = self._read_json()
                    except ValueError as e:
                        runtime._note_request(
                            trace[0], trace[1], 400, time.monotonic())
                        self._reply(400, {"error": str(e)},
                                    {"X-Trace-Id": trace[1]}, t0=t0)
                        return
                    code, payload, headers = runtime.predict(
                        body, deadline_ms, trace=trace)
                    self._reply(code, payload, headers, t0=t0)
                elif path == "/-/reload":
                    try:
                        body = self._read_json()
                        if not isinstance(body, dict):
                            raise ValueError(
                                "reload body must be a JSON object")
                    except ValueError as e:
                        self._reply(400, {"error": str(e)})
                        return
                    result = runtime.reload(body.get("artifact_dir"))
                    self._reply(200 if result["ok"] else
                                (409 if result.get("in_progress") else 500),
                                result)
                elif path == "/-/quitquitquit" and debugz_folded:
                    # operator/controller drain actuation with SIGTERM
                    # semantics: shed the queue, and when the process
                    # entry point registered its stop event (on_quit),
                    # drain + exit exactly like a SIGTERM.  Gated like
                    # the debugz fold: loopback (or MXNET_DEBUGZ_EXPOSE
                    # =1) only — a public bind must not expose remote
                    # shutdown.
                    runtime.begin_drain()
                    cb = getattr(runtime, "on_quit", None)
                    self._reply(200, {"draining": True,
                                      "exiting": cb is not None})
                    if cb is not None:
                        cb()
                else:
                    self._reply(404, {"error": f"no such path {path!r}"})

        class _Server(ThreadingHTTPServer):
            allow_reuse_address = 1
            daemon_threads = True

        self._http = _Server((addr, port), _Handler)
        threading.Thread(target=self._http.serve_forever, daemon=True,
                         name="mx-serve-http").start()
        return self._http.server_address[1]


# -- process entry point ------------------------------------------------

def _ctx_arg(text):
    """``--ctx``: ``cpu``, ``gpu``, ``gpu(1)`` or ``gpu:1`` (``cuda``
    spells ``gpu`` too) as a Context."""
    import re
    from .context import Context
    m = re.fullmatch(r"\s*(cpu|gpu|cuda)\s*(?:[(:]\s*(\d+)\s*\)?)?\s*",
                     str(text))
    if m is None:
        raise ValueError(f"bad --ctx {text!r}: want cpu, gpu or gpu(N)")
    kind = "cpu" if m.group(1) == "cpu" else "gpu"
    return Context(kind, int(m.group(2) or 0))


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m incubator_mxnet_torch.serving",
        description="Serve an export_serving artifact over HTTP with "
                    "admission control, deadlines, a circuit breaker, "
                    "hot reload (SIGHUP / POST /-/reload), and graceful "
                    "drain (SIGTERM).")
    ap.add_argument("artifact_dir")
    ap.add_argument("--port", type=int,
                    default=get_env("MXNET_SERVE_PORT", 8080, int))
    ap.add_argument("--addr", default="127.0.0.1")
    ap.add_argument("--ctx", type=_ctx_arg, default="gpu(0)",
                    help="device to serve on: gpu(N) (the default; raises "
                         "without CUDA) or cpu")
    ap.add_argument("--no-warm", action="store_true",
                    help="skip the startup warmup call (first request "
                         "pays the kernel builds)")
    args = ap.parse_args(argv)

    # crash hooks BEFORE the signal handlers below: SIGTERM must keep
    # its graceful-drain semantics (the handler installed next wins the
    # signal), while an uncaught exception / SIGABRT still leaves a
    # postmortem (MXNET_POSTMORTEM_DIR)
    introspect.maybe_install_postmortem(role="serving")
    # optional loopback debugz listener (MXNET_DEBUGZ_PORT) alongside
    # the front end — the way to introspect a publicly-bound replica
    # without exposing stacks/env on the serving port
    introspect.ensure_debugz(role="serving")
    runtime = ServingRuntime(args.artifact_dir, warm=not args.no_warm,
                             ctx=args.ctx)
    port = runtime.start(args.port, args.addr)
    stop = threading.Event()

    def _on_term(signum, frame):
        # Event.set only — begin_drain takes the (non-reentrant) queue
        # lock, and a second SIGTERM landing while the main thread
        # holds it inside drain()/close() would self-deadlock
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    # POST /-/quitquitquit (remediation-controller drain actuation)
    # exits through the same stop event as a SIGTERM
    runtime.on_quit = stop.set
    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, lambda s, f: threading.Thread(
            target=runtime.reload, daemon=True).start())

    print(f"serving: {args.artifact_dir} on http://{args.addr}:{port} "
          f"({args.ctx}; SIGTERM drains, SIGHUP reloads)", flush=True)
    while not stop.is_set():
        stop.wait(0.5)
    t0 = time.monotonic()
    clean = runtime.drain()
    # close() joins the workers: none may still be inside a device call
    # when the interpreter tears down
    runtime.close()
    print(f"serving: drained {'clean' if clean else 'FORCED'} in "
          f"{time.monotonic() - t0:.3f} s, bye", flush=True)
    return 0 if clean else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
