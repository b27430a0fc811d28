"""Serving runtime: an HTTP front end over `deploy.load_serving`
(counterpart of `incubator_mxnet_tpu/serving.py`).

* **Admission control** — a bounded request queue (``MXNET_SERVE_QUEUE``)
  with load shedding: a full queue answers ``429`` + ``Retry-After``, and
  ``MXNET_SERVE_CONCURRENCY`` model workers bound the in-flight work.
* **Deadlines** — every request carries one (``MXNET_SERVE_DEADLINE_MS``,
  client-overridable with the ``X-Deadline-Ms`` header), enforced while
  queued and in flight: the client gets ``504`` once it passes even if a
  forward pass is stuck, and a bounded replacement worker restores the
  pool's capacity.
* **Micro-batching** — queued requests coalesce into one forward up to the
  artifact's batch capacity, never by waiting past the point where a
  member's deadline could be missed.  The batch is padded with zero rows
  to the capacity (their valid_length is 0: the attention kernels give
  them the mean of v over the keys they visit, never NaN) and each
  request gets its own rows back.
* **Graceful drain** — `drain()` flips ``/-/readyz`` to 503, sheds the
  queue with ``503`` and lets in-flight requests finish.

Endpoints: ``POST /predict`` (JSON ``{"inputs": [...]}``),
``GET /-/healthz``, ``GET /-/readyz``.

Not ported yet (ROADMAP.md): the circuit breaker, hot reload, the fault
plan, batch buckets, telemetry, tracing and introspection hooks, and the
access log.
"""
from __future__ import annotations

import collections
import json
import math
import threading
import time

import numpy as np

from .base import MXNetError, get_env
from . import deploy

__all__ = ["ServeConfig", "ServingRuntime"]


def _np_dtype(name):
    """Host-side dtype of an input spec; numpy has no bfloat16, so such
    inputs are parsed as float32 and cast on the device."""
    return np.dtype("float32" if name == "bfloat16" else name)


def _jsonable(arr):
    return np.asarray(arr).tolist()


class ServeConfig:
    """Runtime knobs, each an ``MXNET_SERVE_*`` env var overridable by
    keyword."""

    _FIELDS = (
        ("concurrency", "MXNET_SERVE_CONCURRENCY", 2, int),
        ("queue_limit", "MXNET_SERVE_QUEUE", 64, int),
        ("deadline_ms", "MXNET_SERVE_DEADLINE_MS", 30000.0, float),
        ("batch_window_ms", "MXNET_SERVE_BATCH_WINDOW_MS", 2.0, float),
        ("drain_ms", "MXNET_SERVE_DRAIN_MS", 10000.0, float),
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


class _Request:
    __slots__ = ("arrays", "rows", "deadline", "enqueued_at", "started",
                 "abandoned", "status", "payload", "_event")

    def __init__(self, arrays, rows, deadline):
        self.arrays = arrays
        self.rows = rows
        self.deadline = deadline      # absolute time.monotonic()
        self.enqueued_at = time.monotonic()
        self.started = False          # picked up by a worker
        self.abandoned = False        # handler already answered (504)
        self.status = None
        self.payload = None
        self._event = threading.Event()

    def finish(self, status, payload):
        self.status = status
        self.payload = payload
        self._event.set()

    def wait(self, timeout):
        return self._event.wait(timeout)


class _ModelSlot:
    """One loaded artifact plus what the batcher needs to know of it."""

    __slots__ = ("model", "artifact_dir", "meta", "capacity", "batchable",
                 "loaded_at")

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


class ServingRuntime:
    """Owns the model slot, the admission queue, the worker pool and the
    HTTP front end.  `ctx` is the device to serve on (default gpu(0))."""

    def __init__(self, artifact_dir, config=None, warm=True, ctx=None):
        self._cfg = config or ServeConfig()
        self._qcond = threading.Condition()
        self._queue = collections.deque()
        self._active_batches = 0    # popped from queue, not yet answered
        self._draining = False
        self._stopping = False
        self._exec_ema = 0.05           # seconds per model call
        self._inflight_calls = {}       # worker ident -> (t0, deadline)
        self._call_lock = threading.Lock()
        self.model_calls = 0            # forwards run on behalf of requests
        self._http = None
        self._slot = _ModelSlot(deploy.load_serving(artifact_dir, ctx=ctx),
                                artifact_dir)
        if warm:
            # first forward (kernel build, allocator growth) off the
            # request path; raises on a poisoned artifact
            self._slot.model(*self._slot.zero_inputs())
        self._workers = []
        self._live_workers = 0
        for _ in range(self._cfg.concurrency):
            self._spawn_worker()

    # -- admission ------------------------------------------------------

    def _cull_abandoned_locked(self):
        """Caller holds _qcond.  Drop requests already answered 504 before
        judging fullness, so they cannot shed fresh ones."""
        if len(self._queue) >= self._cfg.queue_limit:
            live = [r for r in self._queue if not r.abandoned]
            if len(live) != len(self._queue):
                self._queue.clear()
                self._queue.extend(live)

    def _queue_retry_after(self):
        # caller holds _qcond: about one model call per worker per
        # _exec_ema seconds drains the backlog
        waves = (len(self._queue) + 1) / max(1, self._cfg.concurrency)
        return self._exec_ema * max(1.0, waves)

    @staticmethod
    def _shed(reason, code, retry_after=None):
        headers = {}
        if retry_after is not None:
            headers["Retry-After"] = str(max(1, int(retry_after + 0.999)))
        return code, {"error": f"request shed: {reason}",
                      "reason": reason}, headers

    def preadmit(self):
        """Cheap overload check before the body is decoded.  Returns a
        shed ``(status, payload, headers)`` or None to proceed."""
        with self._qcond:
            if self._draining or self._stopping:
                return self._shed("draining", 503)
            self._cull_abandoned_locked()
            if len(self._queue) >= self._cfg.queue_limit:
                return self._shed("queue_full", 429,
                                  self._queue_retry_after())
        return None

    def predict(self, body, deadline_ms=None):
        """Full data path for one decoded request body.  Returns
        ``(status, payload, headers)``, always within the deadline."""
        deadline = time.monotonic() + (
            deadline_ms if deadline_ms is not None
            else self._cfg.deadline_ms) / 1000.0
        shed = self.preadmit()
        if shed is not None:
            return shed
        try:
            arrays, rows = self._slot.parse_inputs(body)
        except ValueError as e:
            return 400, {"error": str(e)}, {}
        with self._qcond:
            if self._draining or self._stopping:
                return self._shed("draining", 503)
            self._cull_abandoned_locked()
            if len(self._queue) >= self._cfg.queue_limit:
                return self._shed("queue_full", 429,
                                  self._queue_retry_after())
            req = _Request(arrays, rows, deadline)
            self._queue.append(req)
            self._qcond.notify()

        if req.wait(max(0.0, deadline - time.monotonic())):
            return req.status, req.payload, {}
        # deadline passed first: answer 504 now, whatever the worker is
        # doing — a stuck forward pass must not wedge the client too
        with self._qcond:
            req.abandoned = True
            stage = "inflight" if req.started else "queued"
        if stage == "inflight":
            self._maybe_add_worker()
        return 504, {"error": f"deadline exceeded while {stage}",
                     "stage": stage}, {}

    # -- worker pool ----------------------------------------------------

    def _spawn_worker(self):
        self._live_workers += 1
        t = threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"mx-serve-worker-{self._live_workers}")
        self._workers = [w for w in self._workers if w.is_alive()]
        self._workers.append(t)
        t.start()

    def _maybe_add_worker(self):
        """A worker is wedged past a deadline: restore capacity with a
        bounded replacement (cap: 2x concurrency)."""
        with self._qcond:
            stuck = self._stuck_count()
            if stuck and self._live_workers < 2 * self._cfg.concurrency \
                    and self._live_workers - stuck < self._cfg.concurrency:
                self._spawn_worker()

    def _stuck_count(self):
        now = time.monotonic()
        with self._call_lock:
            return sum(1 for _t0, dl in self._inflight_calls.values()
                       if now > dl)

    def _worker_loop(self):
        retired = False
        try:
            while True:
                batch = self._next_batch()
                if batch is None:
                    return
                try:
                    self._run_batch(batch)
                except Exception as e:  # noqa: BLE001 — a fault on the
                    # batch path answers the batch and keeps the worker
                    for r in batch:
                        if not r.abandoned:
                            r.finish(500, {"error": f"model failure: "
                                           f"{type(e).__name__}: {e}"})
                finally:
                    with self._qcond:
                        self._active_batches -= 1
                with self._qcond:
                    if self._live_workers - self._stuck_count() > \
                            self._cfg.concurrency:
                        # surplus replacement: retire, deciding and
                        # decrementing in one critical section
                        self._live_workers -= 1
                        retired = True
                        return
        finally:
            if not retired:
                with self._qcond:
                    self._live_workers -= 1

    def _expired_or_dead(self, req):
        """True (and the request answered) if it must not run."""
        if req.abandoned:
            return True
        if time.monotonic() >= req.deadline:
            req.finish(504, {"error": "deadline exceeded while queued",
                             "stage": "queued"})
            return True
        return False

    def _next_batch(self):
        """Deadline-aware coalescing pop; blocks until work or stop.  The
        head request anchors the batch; more queued requests join while
        they fit the capacity, and the worker waits for more only while
        the batching window AND every member's deadline allow it."""
        with self._qcond:
            while True:
                while not self._queue and not self._stopping:
                    self._qcond.wait(0.05)
                if self._stopping and not self._queue:
                    return None
                head = self._queue.popleft()
                if self._expired_or_dead(head):
                    continue
                head.started = True
                batch, rows = [head], head.rows
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
                        if self._expired_or_dead(cand):
                            continue
                        cand.started = True
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
                # counted under _qcond: drain() must see this batch as
                # busy the instant it leaves the queue
                self._active_batches += 1
                return batch

    def _run_batch(self, batch):
        slot = self._slot
        batch = [r for r in batch if not self._expired_or_dead(r)]
        if not batch:
            return
        rows = sum(r.rows for r in batch)
        if slot.batchable:
            inputs = []
            for i, spec in enumerate(slot.meta["inputs"]):
                parts = [r.arrays[i] for r in batch]
                pad = slot.capacity - rows
                if pad > 0:
                    parts.append(np.zeros((pad,) + tuple(spec["shape"][1:]),
                                          _np_dtype(spec["dtype"])))
                inputs.append(np.concatenate(parts, axis=0)
                              if len(parts) > 1 else parts[0])
        else:
            inputs = batch[0].arrays

        ident = threading.get_ident()
        with self._call_lock:
            self._inflight_calls[ident] = (
                time.monotonic(), min(r.deadline for r in batch))
            self.model_calls += 1
        t0 = time.perf_counter()
        try:
            outs = slot.model(*inputs)
        finally:
            with self._call_lock:
                self._inflight_calls.pop(ident, None)
        self._exec_ema = 0.8 * self._exec_ema + \
            0.2 * (time.perf_counter() - t0)
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

    # -- drain / shutdown ----------------------------------------------

    def begin_drain(self):
        """Flip readiness and shed the whole queue with 503; in-flight
        requests keep running."""
        with self._qcond:
            if self._draining:
                return
            self._draining = True
            while self._queue:
                req = self._queue.popleft()
                if not req.abandoned:
                    req.finish(503, {"error": "request shed: draining",
                                     "reason": "draining"})
            self._qcond.notify_all()

    def drain(self, timeout=None):
        """`begin_drain` + wait (bounded by ``MXNET_SERVE_DRAIN_MS``) for
        in-flight requests to finish.  True on a clean drain."""
        self.begin_drain()
        deadline = time.monotonic() + (
            timeout if timeout is not None else self._cfg.drain_ms / 1000.0)
        while time.monotonic() < deadline:
            with self._call_lock:
                busy = len(self._inflight_calls)
            with self._qcond:
                queued = len(self._queue) + self._active_batches
            if not busy and not queued:
                return True
            time.sleep(0.01)
        return False

    def close(self, drain_timeout=0.0):
        """Stop the workers and the HTTP front end."""
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

    # -- introspection --------------------------------------------------

    @property
    def draining(self):
        return self._draining

    def healthz(self):
        slot = self._slot
        with self._qcond:
            queued = len(self._queue)
            live = self._live_workers
        with self._call_lock:
            inflight = len(self._inflight_calls)
            calls = self.model_calls
        return {
            "status": "draining" if self._draining else "ok",
            "queue": {"depth": queued, "limit": self._cfg.queue_limit},
            "inflight_calls": inflight,
            "model_calls": calls,
            "workers": {"live": live, "stuck": self._stuck_count(),
                        "target": self._cfg.concurrency},
            "model": {"artifact_dir": slot.artifact_dir,
                      "loaded_unix_time": slot.loaded_at,
                      "batch_capacity": slot.capacity,
                      "batchable": slot.batchable,
                      "device": str(slot.model.device)},
            "exec_ema_seconds": self._exec_ema,
        }

    def ready(self):
        return not self._draining and not self._stopping

    # -- HTTP front end -------------------------------------------------

    def start(self, port=0, addr="127.0.0.1"):
        """Bind the HTTP front end; returns the bound port."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        runtime = self

        class _Handler(BaseHTTPRequestHandler):
            # HTTP/1.0: one request per connection — a draining server
            # must never strand a keep-alive peer
            protocol_version = "HTTP/1.0"

            def log_message(self, *args):
                pass

            def _reply(self, code, payload, headers=None):
                body = (json.dumps(payload) + "\n").encode()
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    for k, v in (headers or {}).items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass            # client gone: its problem, not ours

            def _drain_body(self):
                try:
                    n = int(self.headers.get("Content-Length", "0") or 0)
                except ValueError:
                    n = 0
                while n > 0:
                    chunk = self.rfile.read(min(n, 1 << 20))
                    if not chunk:
                        break
                    n -= len(chunk)

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
                else:
                    self._reply(404, {"error": f"no such path {path!r}"})

            def do_POST(self):
                path = self.path.split("?")[0]
                if path != "/predict":
                    self._reply(404, {"error": f"no such path {path!r}"})
                    return
                deadline_ms = None
                hdr = self.headers.get("X-Deadline-Ms")
                if hdr is not None:
                    try:
                        deadline_ms = float(hdr)
                        if not math.isfinite(deadline_ms) or deadline_ms <= 0:
                            raise ValueError
                    except ValueError:
                        self._reply(400, {"error":
                                          f"bad X-Deadline-Ms {hdr!r}"})
                        return
                shed = runtime.preadmit()
                if shed is not None:
                    # overloaded: answer before paying to decode the body,
                    # but read it off the wire so the client can finish
                    self._drain_body()
                    self._reply(*shed)
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, OSError) as e:
                    self._reply(400, {"error": f"bad JSON body: {e}"})
                    return
                self._reply(*runtime.predict(body, deadline_ms))

        class _Server(ThreadingHTTPServer):
            allow_reuse_address = 1
            daemon_threads = True

        self._http = _Server((addr, port), _Handler)
        threading.Thread(target=self._http.serve_forever, daemon=True,
                         name="mx-serve-http").start()
        return self._http.server_address[1]
