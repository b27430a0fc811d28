"""Numerics and model-health plane (counterpart of
`incubator_mxnet_tpu/health.py`), gated by ``MXNET_HEALTH`` (one flag
check per entry point when off).

* **In-step numerics stats** -- global gradient L2 norm, nonfinite
  (NaN/Inf) gradient-element counts, weight norm and the update/weight
  ratio ``||dw|| / ||w||``.  Nonfinite elements are masked out of the
  sums and counted apart, so one NaN cannot poison the norms that
  would localize it.  The reductions are torch ops on the tensors'
  own device, all launched before one host sync.  `ParallelTrainer`
  takes them inside its step (`traced_step_stats`); the imperative
  `gluon.Trainer` reduces its parameters' gradients and weights after
  the update (`tensor_stats`).

* **Anomaly detector** -- EWMA bands over loss and grad-norm (the one
  `EwmaBand` of `tools/parse_log.py`), plus hard triggers on any
  nonfinite count and on a nonfinite loss.  Each anomaly emits a
  ``numerics_anomaly`` flight event, rate-limited per kind by
  ``MXNET_HEALTH_COOLDOWN`` steps.  With ``MXNET_HEALTH_AUTOCAPTURE=1``
  the first anomaly also arms a device profiling window at the next
  step boundary (:func:`profiling.arm`), whose report path is attached
  to the same flight record.

* **Divergence audit** -- every ``MXNET_HEALTH_AUDIT_STEPS`` steps a
  weight checksum (an xxhash-style position-dependent fold of each
  array's float32 bit pattern, 32-bit wraparound arithmetic, combined
  to 64 bits on the host) can be compared across replicas.  The fold
  gives the JAX package's digest bit for bit; torch has no uint32
  arithmetic, so it runs in int64 with every product split into two
  that stay below 2^63.  One card holds one replica, so
  `replica_digests` finds nothing to compare until the multi-GPU
  slice; the digest itself holds a card's weights against a host copy.

Exports: telemetry (``health_grad_norm``, ``health_nonfinite_total``,
...), the ``/-/numericz`` debugz page, and `Speedometer`'s JSONL fields
through :func:`last_record`.

Deterministic fault injection: ``MXNET_HEALTH_FAULT_PLAN`` takes
comma-separated ``kind:step[@rank]`` directives --

* ``nan_grad:STEP[@RANK]`` -- poison one gradient element with NaN at
  that step, so the NaN flows through the real stats;
* ``bitflip_weight:STEP[@RANK]`` -- flip the lowest mantissa bit of
  one weight at the end of that step.
"""
from __future__ import annotations

import collections
import math
import threading
import weakref

import torch

from .base import get_env
from . import telemetry as _telemetry
from . import introspect as _introspect

__all__ = ["enabled", "set_enabled", "audit_interval", "EwmaBand",
           "tensor_stats", "update_sumsq", "checksum",
           "combine_digest",
           "note_bucket", "drain_bucket_stats", "traced_step_stats",
           "STEP_STAT_KEYS", "replica_digests", "monitor_stats",
           "fault_actions", "HealthLedger", "ledger", "ledgers", "snapshot",
           "last_record", "numericz"]

_enabled = get_env("MXNET_HEALTH", False, bool)
_WINDOW = max(8, get_env("MXNET_HEALTH_WINDOW", 64, int))


def enabled():
    return _enabled


def set_enabled(on):
    """Flip the health plane globally (tests / embedders)."""
    global _enabled
    _enabled = bool(on)


def audit_interval():
    """Steps between divergence audits (``MXNET_HEALTH_AUDIT_STEPS``,
    default 64; 0 disables).  Read per call so tests/smokes can flip
    the env between trainers."""
    try:
        return max(0, get_env("MXNET_HEALTH_AUDIT_STEPS", 64, int))
    except (TypeError, ValueError):
        return 64


from .tools.parse_log import EwmaBand     # noqa: E402 — the one band


def _band_params():
    return {"alpha": get_env("MXNET_HEALTH_ALPHA", 0.3, float),
            "band": get_env("MXNET_HEALTH_BAND", 4.0, float),
            "rel_floor": get_env("MXNET_HEALTH_REL_FLOOR", 0.5,
                                 float)}


# ---------------------------------------------------------------------
# reductions: torch ops on the tensors' own device; callers launch all
# of them before one host sync
# ---------------------------------------------------------------------

def _raw(a):
    """The tensor behind an NDArray (or the tensor itself)."""
    return getattr(a, "_data", a)


def _stats_parts(x):
    """(masked sum of squares f32, nonfinite element count f32), 0-d
    tensors on x's device."""
    xf = _raw(x).detach().to(torch.float32)
    finite = torch.isfinite(xf)
    sumsq = torch.where(finite, xf, torch.zeros((), device=xf.device)) \
        .square().sum(dtype=torch.float32)
    return sumsq, (~finite).sum(dtype=torch.float32)


# xxhash-style avalanche constants; the index xor makes the fold
# POSITION-DEPENDENT (a swapped pair of elements changes the digest,
# a plain sum would not)
_GOLDEN = 0x9E3779B1
_MIX = 0x85EBCA6B
_SEED = 0x811C9DC5
_M32 = 0xFFFFFFFF


def _mul32(a, c):
    """(a * c) mod 2^32 for int64 tensors a in [0, 2^32) and a constant
    c < 2^32, with no product reaching 2^63: c is split in 16-bit
    halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _checksum_word(x):
    """The uint32 position-dependent fold of one array's float32 bit
    pattern (the JAX `_checksum_kernel`), as a 0-d int64 tensor."""
    flat = _raw(x).detach().to(torch.float32).reshape(-1).contiguous()
    bits = flat.view(torch.int32).to(torch.int64) & _M32
    idx = torch.arange(flat.numel(), dtype=torch.int64, device=flat.device)
    # n < 2^31 words of < 2^32 each: the int64 sum cannot overflow
    return _mul32(bits ^ _mul32(idx, _GOLDEN), _MIX).sum() & _M32


def _host(parts):
    """One device-to-host copy of a list of 0-d tensors (one sync)."""
    if not parts:
        return []
    devs = {p.device for p in parts}
    if len(devs) > 1:
        parts = [p.cpu() for p in parts]
    dtype = torch.int64 if parts[0].dtype == torch.int64 else torch.float64
    return torch.stack([p.to(dtype) for p in parts]).cpu().tolist()


# elements one concatenated pass holds: a model's hundreds of tensors
# reduce in a few launches (a reduction a tensor would cost a Python
# dispatch each), with the float32 temporaries bounded
_CHUNK = 1 << 26


class Snapshot(list):
    """Copies of arrays as the flat chunks `_chunks` makes of them."""


def _chunks(arrays, copy=False):
    """The arrays flattened and concatenated, in order, into 1-D tensors
    of at most `_CHUNK` elements each (a larger array stands alone).
    With `copy` every chunk is a copy, never a view of an array."""
    group, n = [], 0

    def flush():
        if len(group) > 1 or copy:
            return torch.cat(group) if len(group) > 1 else group[0].clone()
        return group[0]
    for a in arrays:
        t = _raw(a).detach().reshape(-1)
        if group and n + t.numel() > _CHUNK:
            yield flush()
            group, n = [], 0
        group.append(t)
        n += t.numel()
    if group:
        yield flush()


def snapshot(arrays):
    """A copy of `arrays` to diff a later state against (the update
    ratio's old weights), in a few copy launches."""
    return Snapshot(_chunks(arrays, copy=True))


def _sumsq(chunks):
    """Sum of squares over chunks in float32, a 0-d tensor."""
    total = None
    for c in chunks:
        s = c.to(torch.float32).square().sum(dtype=torch.float32)
        total = s if total is None else total + s
    return total if total is not None else torch.zeros((), dtype=torch.float32)


def _diff_sumsq(new, old):
    """sum((new - old)^2) in float32 over paired chunks."""
    old = old if isinstance(old, Snapshot) else list(_chunks(old))
    return _sumsq(a.to(torch.float32) - b.to(torch.float32)
                  for a, b in zip(_chunks(new), old))


def _masked_stats(arrays):
    """(masked sum of squares, nonfinite count) over the arrays' chunks,
    float32 0-d tensors."""
    gsq = nf = None
    for c in _chunks(arrays):
        s, n = _stats_parts(c)
        gsq, nf = (s, n) if gsq is None else (gsq + s, nf + n)
    if gsq is None:
        gsq = nf = torch.zeros((), dtype=torch.float32)
    return gsq, nf


def update_sumsq(new_arrays, old_arrays):
    """``sum(||new - old||^2)`` over paired arrays (or a `snapshot` of the
    old ones), one host sync."""
    return float(_host([_diff_sumsq(new_arrays, old_arrays)])[0])


def tensor_stats(arrays):
    """``{"sumsq", "nonfinite"}`` over a sequence of tensors/NDArrays —
    the reductions over their concatenated chunks, all launched before
    one host sync."""
    vals = _host(list(_masked_stats(arrays)))
    return {"sumsq": float(vals[0]), "nonfinite": int(vals[1])}


def combine_digest(digest, part):
    """Order-sensitive 64-bit fold of one 32/64-bit part (FNV-style)."""
    return ((int(digest) * 1000003) ^ int(part)) & 0xFFFFFFFFFFFFFFFF


def checksum(arrays):
    """64-bit order-sensitive digest over a sequence of tensors/NDArrays
    (the per-participant audit digest), one host sync."""
    d = _SEED
    for w in _host([_checksum_word(a) for a in arrays]):
        d = combine_digest(d, w)
    return d


# ---------------------------------------------------------------------
# pack-time bucket stats: a gradient bucketer (the multi-GPU slice's)
# calls note_bucket with the already-flat bucket payload; only device
# scalars are stored (no host sync on the pack path) and the owning
# trainer drains them at the step boundary.
# ---------------------------------------------------------------------

_bucket_lock = threading.Lock()
_pending_buckets = []       # [(wire_key, sumsq_dev, nonfinite_dev)]


def note_bucket(key, flat):
    """Record one packed gradient bucket's stats (the payload is
    already flat on its device; no host sync here)."""
    if not _enabled:
        return
    s, n = _stats_parts(flat)
    with _bucket_lock:
        _pending_buckets.append((str(key), s, n))


def drain_bucket_stats():
    """Fold the pack-time notes accumulated since the last drain into
    ``{"sumsq", "nonfinite", "bucket_norms"}``, or None when no bucket
    packed (the per-parameter exchange path)."""
    global _pending_buckets
    with _bucket_lock:
        pend, _pending_buckets = _pending_buckets, []
    if not pend:
        return None
    sumsq, nonfinite, norms = 0.0, 0, {}
    vals = _host([x for _, s, n in pend for x in (s, n)])
    for (key, _, _), s, n in zip(pend, vals[0::2], vals[1::2]):
        sumsq += s
        nonfinite += int(n)
        # a re-packed key (grad accumulation) keeps its LAST norm
        norms[key] = round(s ** 0.5, 6)
    return {"sumsq": sumsq, "nonfinite": nonfinite,
            "bucket_norms": norms}


# ---------------------------------------------------------------------
# in-step stats for ParallelTrainer's step
# ---------------------------------------------------------------------

# key order of the step stats dict
STEP_STAT_KEYS = ("loss", "grad_sumsq", "nonfinite", "weight_sumsq",
                  "update_sumsq")


def traced_step_stats(loss, grads, new_params, old_params):
    """Numerics stats as a dict of float32 0-d tensors on the step's
    device, taken inside `ParallelTrainer`'s step: no host sync here,
    the trainer reads all five at once.  Nonfinite gradient elements
    are masked out of the sums and counted (a float32 count, exact to
    2^24).  `old_params` is a list of arrays or their `snapshot`; each
    statistic is a few reductions over concatenated chunks."""
    gsq, nf = _masked_stats(grads)
    wsq = _sumsq(_chunks(new_params))
    usq = _diff_sumsq(new_params, old_params)
    lval = loss.detach().to(torch.float32).reshape(()) \
        if isinstance(loss, torch.Tensor) \
        else torch.tensor(float(loss), dtype=torch.float32)
    return {"loss": lval, "grad_sumsq": gsq, "nonfinite": nf,
            "weight_sumsq": wsq, "update_sumsq": usq}


def host_step_stats(stats):
    """The five step stats as Python floats, one host sync."""
    vals = _host([stats[k] for k in STEP_STAT_KEYS])
    return dict(zip(STEP_STAT_KEYS, vals))


def replica_digests(arrays, mesh, axis):
    """Per-replica weight digests ``{replica_index: digest}`` along the
    mesh axis `axis`, or None when the mesh has no such axis or one
    replica.  Each rank folds its blocks of `arrays` into one digest;
    the digests are all-gathered over the mesh (a collective: every rank
    calls this at the same point), and each replica's are combined in
    mesh-grid order, so equal replicas give equal digests whatever the
    tp/pp cut within them."""
    import numpy as np
    names = list(getattr(mesh, "axis_names", ()))
    if axis not in names or mesh.shape[axis] < 2 or \
            getattr(mesh, "transport", None) is None:
        return None
    from .parallel import collectives as C
    d = checksum(arrays)
    signed = d - (1 << 64) if d >= (1 << 63) else d
    mine = torch.tensor([signed], dtype=torch.int64, device=mesh.device)
    every = C._all_gather(mesh, mesh.axis_names, mine, 0).cpu().tolist()
    every = [x & 0xFFFFFFFFFFFFFFFF for x in every]
    pos = np.arange(mesh.size).reshape(np.asarray(mesh.devices).shape)
    grid = np.moveaxis(pos, names.index(axis), 0).reshape(
        mesh.shape[axis], -1)
    out = {}
    for i, row in enumerate(grid):
        dg = _SEED
        for p in row:
            dg = combine_digest(dg, every[int(p)])
        out[i] = dg
    return out


# ---------------------------------------------------------------------
# legacy Monitor support: per-tensor abs-mean over a tensor list, one
# host sync
# ---------------------------------------------------------------------

def monitor_stats(arrays):
    """Per-tensor ``mean(|x|)`` (the legacy `Monitor` default stat)
    over a list of tensors/NDArrays."""
    if not arrays:
        return []
    return [float(v) for v in _host(
        [_raw(a).detach().to(torch.float32).abs().mean() for a in arrays])]


# ---------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------

def _parse_fault_plan():
    out = []
    for item in (get_env("MXNET_HEALTH_FAULT_PLAN", "", str)
                 or "").split(","):
        item = item.strip()
        if not item:
            continue
        kind, _, rest = item.partition(":")
        step_s, _, rank_s = rest.partition("@")
        try:
            out.append((kind.strip(), int(step_s),
                        int(rank_s) if rank_s else None))
        except ValueError:
            continue
    return out


_fault_plan = _parse_fault_plan()


def fault_actions(step, rank=None):
    """Fault kinds this (step, rank) must inject, from
    ``MXNET_HEALTH_FAULT_PLAN`` (``kind:step[@rank],...``).  A
    directive without ``@rank`` fires on every rank."""
    if not _fault_plan:
        return []
    return [k for k, s, r in _fault_plan
            if s == int(step)
            and (r is None or rank is None or r == int(rank))]


# ---------------------------------------------------------------------
# telemetry instruments
# ---------------------------------------------------------------------

_tm_grad_norm = _telemetry.gauge(
    "health_grad_norm",
    "Global gradient L2 norm at the last step", ("trainer",))
_tm_weight_norm = _telemetry.gauge(
    "health_weight_norm",
    "Global weight L2 norm at the last step", ("trainer",))
_tm_update_ratio = _telemetry.gauge(
    "health_update_ratio",
    "||delta w|| / ||w|| of the last optimizer step", ("trainer",))
_tm_nonfinite = _telemetry.counter(
    "health_nonfinite_total",
    "NaN/Inf gradient elements observed", ("trainer",))
_tm_anomalies = _telemetry.counter(
    "health_anomalies_total",
    "Numerics anomalies fired, by kind", ("trainer", "kind"))
_tm_audits = _telemetry.counter(
    "health_divergence_audits_total",
    "Cross-replica divergence audits judged, by result",
    ("trainer", "result"))


# ---------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------

_reg_lock = threading.Lock()
_ledgers = weakref.WeakValueDictionary()    # label -> HealthLedger
_last = None                                # newest on_step record


class HealthLedger:
    """Per-trainer numerics ledger.  The owning trainer feeds
    :meth:`on_step` the step's scalar stats (already reduced — on
    device or drained from pack-time notes); detection, flight
    events, telemetry, autocapture arming and audit verdicts happen
    here.  With ``MXNET_HEALTH=0`` every call is one flag check."""

    def __init__(self, label, rank=None):
        self.label = str(label)
        self.rank = rank
        self.steps = 0
        self.anomalies = 0
        self.last_anomaly = None    # retained flight dict (mutable —
        #                             autocapture attaches the report)
        self.last_audit = None
        self._records = collections.deque(maxlen=_WINDOW)
        bp = _band_params()
        self._bands = {"loss": EwmaBand(**bp),
                       "grad_norm": EwmaBand(**bp)}
        self._cooldown_until = {}   # anomaly kind -> step
        self._judged_through = -1   # newest audit id already judged
        with _reg_lock:
            _ledgers[self.label] = self

    # -- the step boundary ---------------------------------------------
    def on_step(self, step=None, loss=None, grad_sumsq=None,
                nonfinite=None, weight_sumsq=None, update_sumsq=None,
                bucket_norms=None):
        """Account one completed step's numerics.  Any stat may be
        None (paths that cannot produce it).  Returns the record, or
        None when disabled."""
        if not _enabled:
            return None
        global _last
        self.steps += 1
        step = self.steps - 1 if step is None else int(step)
        rec = {"trainer": self.label, "step": step}
        if self.rank is not None:
            rec["rank"] = self.rank
        gnorm = wnorm = None
        if grad_sumsq is not None:
            gnorm = max(0.0, float(grad_sumsq)) ** 0.5
            rec["grad_norm"] = round(gnorm, 6)
        if nonfinite is not None:
            nonfinite = int(nonfinite)
            rec["nonfinite"] = nonfinite
        if weight_sumsq is not None:
            wnorm = max(0.0, float(weight_sumsq)) ** 0.5
            rec["weight_norm"] = round(wnorm, 6)
        if update_sumsq is not None and wnorm:
            ratio = max(0.0, float(update_sumsq)) ** 0.5 / wnorm
            rec["update_ratio"] = round(ratio, 9)
        if loss is not None:
            loss = float(loss)
            rec["loss"] = loss
        if bucket_norms:
            rec["bucket_norms"] = dict(bucket_norms)
        if self.last_audit is not None:
            rec["audit_ok"] = self.last_audit.get("ok")
        self._records.append(rec)
        _last = rec
        if _telemetry.enabled():
            if gnorm is not None:
                _tm_grad_norm.labels(self.label).set(gnorm)
            if wnorm is not None:
                _tm_weight_norm.labels(self.label).set(wnorm)
            if rec.get("update_ratio") is not None:
                _tm_update_ratio.labels(self.label).set(
                    rec["update_ratio"])
            if nonfinite:
                _tm_nonfinite.labels(self.label).inc(nonfinite)
        self._detect(step, loss, gnorm, nonfinite)
        return rec

    # -- anomaly detection ---------------------------------------------
    def _detect(self, step, loss, gnorm, nonfinite):
        if nonfinite:
            self._anomaly("nonfinite", step, count=nonfinite)
        if loss is not None:
            if not math.isfinite(loss):
                # hard trigger; a nonfinite value must NOT fold into
                # the band (NaN comparisons poison the EWMA silently)
                self._anomaly("loss_nonfinite", step, value=loss
                              if math.isfinite(loss) else repr(loss))
            elif self._bands["loss"].update(loss):
                self._anomaly("loss_spike", step, value=round(loss, 6),
                              ewma=round(self._bands["loss"].ewma, 6))
        if gnorm is not None and math.isfinite(gnorm):
            if self._bands["grad_norm"].update(gnorm):
                self._anomaly("grad_norm_spike", step,
                              value=round(gnorm, 6),
                              ewma=round(
                                  self._bands["grad_norm"].ewma, 6))
        elif gnorm is not None:
            self._anomaly("grad_norm_nonfinite", step,
                          value=repr(gnorm))

    def _anomaly(self, kind, step, **fields):
        until = self._cooldown_until.get(kind)
        if until is not None and step < until:
            return None
        cooldown = max(0, get_env("MXNET_HEALTH_COOLDOWN", 16, int))
        self._cooldown_until[kind] = step + cooldown
        self.anomalies += 1
        ev = _introspect.flight(
            "numerics_anomaly", trainer=self.label, anomaly=kind,
            step=step, rank=self.rank, **fields)
        self.last_anomaly = ev
        if _telemetry.enabled():
            _tm_anomalies.labels(self.label, kind).inc()
        self._maybe_autocapture(ev, kind)
        return ev

    def _maybe_autocapture(self, ev, kind):
        if not get_env("MXNET_HEALTH_AUTOCAPTURE", False, bool):
            return
        from . import profiling as _profiling   # lazy: heavy import

        def _attach(report):
            # the flight dict lives in the ring — mutating it attaches
            # the capture to the ORIGINAL anomaly record
            report = report or {}
            ev["profile_report"] = (report.get("paths")
                                    or {}).get("report")
            if report.get("error"):
                ev["profile_capture_error"] = report["error"]

        steps = max(1, get_env("MXNET_HEALTH_CAPTURE_STEPS", 2, int))
        armed = _profiling.arm(steps=steps, duration_ms=60000,
                               label=f"health-{kind}",
                               on_finish=_attach)
        if isinstance(armed, dict) and armed.get("error"):
            # a window is already armed/active (an earlier anomaly's,
            # or an operator's) — note it, don't fight over the slot
            ev["autocapture_error"] = armed["error"]
        else:
            ev["autocapture"] = "armed"

    # -- divergence audit ----------------------------------------------
    def audit_due(self, step):
        """True when `step` closes an audit period."""
        n = audit_interval()
        return bool(_enabled and n > 0 and step > 0
                    and int(step) % n == 0)

    def note_audit(self, step, scope, digests, expected=None):
        """Judge one audit round's digest map ``{participant:
        digest}`` (dp replica index or worker rank).  Judged once per
        audit id, and only when the map is complete (`expected`
        participants — an exchange reply can be partial while peers
        are still posting; the NEXT exchange completes it, keeping
        the verdict within one audit period).  Majority vote names
        the diverged participants; a 2-way split is an ``ambiguous``
        pair verdict.  Returns the verdict, or None when not (yet)
        judged."""
        if not _enabled or not digests:
            return None
        aid = int(step)
        if aid <= self._judged_through:
            return None
        if expected is not None and len(digests) < int(expected):
            return None
        self._judged_through = aid
        counts = collections.Counter(digests.values())
        top, top_n = counts.most_common(1)[0]
        if len(counts) == 1:
            diverged, ambiguous = [], False
        elif top_n > len(digests) / 2.0:
            diverged = sorted(k for k, v in digests.items()
                              if v != top)
            ambiguous = False
        else:
            # no strict majority (a 2-way split): every participant
            # is a suspect — name the whole disagreement
            diverged = sorted(digests)
            ambiguous = True
        ok = not diverged
        verdict = {"step": aid, "scope": scope, "ok": ok,
                   "participants": sorted(digests),
                   "digests": {str(k): f"{v:016x}"
                               for k, v in sorted(digests.items())},
                   "diverged": diverged}
        if ambiguous:
            verdict["ambiguous"] = True
        self.last_audit = verdict
        if _telemetry.enabled():
            _tm_audits.labels(self.label,
                              "ok" if ok else "diverged").inc()
        if not ok:
            _introspect.flight(
                "divergence_audit", trainer=self.label, scope=scope,
                step=aid, rank=self.rank, diverged=diverged,
                ambiguous=ambiguous, digests=verdict["digests"])
        return verdict

    # -- rolling summary (numericz / fleetz / diagnose) ----------------
    def summary(self):
        recs = list(self._records)
        out = {"label": self.label, "rank": self.rank,
               "steps": self.steps, "anomalies": self.anomalies,
               "last": recs[-1] if recs else None,
               "last_anomaly": self.last_anomaly,
               "last_audit": self.last_audit,
               "ewma": {k: (round(b.ewma, 6)
                            if b.ewma is not None else None)
                        for k, b in sorted(self._bands.items())}}
        return out


def ledger(label, rank=None):
    """Get-or-create the ledger for `label` (the owner must hold the
    returned reference — the registry is weak)."""
    with _reg_lock:
        led = _ledgers.get(str(label))
    if led is None:
        led = HealthLedger(label, rank=rank)
    elif rank is not None:
        led.rank = rank
    return led


def ledgers():
    """Live ledgers, label-sorted (a GC'd trainer's ledger drops
    out)."""
    with _reg_lock:
        items = sorted(_ledgers.items())
    return [led for _, led in items]


def last_record():
    """The newest :meth:`HealthLedger.on_step` record in this process
    — what `Speedometer` stamps into its JSONL lines."""
    return _last


def numericz():
    """The ``/-/numericz`` debugz payload."""
    return {"identity": _introspect.process_identity(),
            "enabled": _enabled,
            "autocapture": get_env("MXNET_HEALTH_AUTOCAPTURE", False,
                                   bool),
            "audit_steps": audit_interval(),
            "window_size": _WINDOW,
            "trainers": [led.summary() for led in ledgers()]}


def _reset_for_tests():
    global _last, _pending_buckets, _fault_plan
    _last = None
    with _bucket_lock:
        _pending_buckets = []
    _fault_plan = _parse_fault_plan()
    with _reg_lock:
        _ledgers.clear()
