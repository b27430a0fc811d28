"""Profile-guided auto-tuner (counterpart of
`incubator_mxnet_tpu/tuner.py`): the measurements choose the knobs.

* **Pure search core** -- :func:`propose` is successive halving over a
  declared knob space: every grid configuration gets a short
  measurement window (``base_steps``), the top ``1/eta`` survive to a
  window ``eta`` times longer, until one remains.  It owns no clock:
  a pure function of ``(space, history)``.  A window the measurement
  layer discarded (a profiling cross-check disagreement) is retried up
  to ``retries`` times, then the configuration leaves the rung.

* **Measurement harness** -- :func:`tune` drives a caller-supplied
  ``runner(config, steps)`` through the schedule; :func:`measure_window`
  is the standard runner body: run ``steps`` steps, score steps (or
  items) per second of wall, optionally inside a `profiling` capture
  window whose cross-check disagreements discard the window.

* **Winner artifact** -- ``tune(..., out=path)`` writes ``tuned.json``
  (atomic rename), and ``MXNET_TUNED_CONFIG=path`` makes consumers read
  the winner at start-up: serving's ``serve_batch_window_ms`` and
  `DevicePrefetcher`'s ``staging_depth``.  The order everywhere is
  explicit argument > environment variable > tuned.json > built-in
  default (:func:`env_or_tuned`).

Telemetry: ``tuner_trials_total``, ``tuner_best_goodput``; the
``/-/tunerz`` debugz page carries the loaded artifact, the last
in-process tune and the compile cache's state.
"""

import itertools
import json
import math
import os
import time

from . import compile_cache as _compile_cache
from . import telemetry as _telemetry
from .base import MXNetError, get_env

__all__ = ["grid", "propose", "tune", "measure_window", "write_tuned",
           "load_tuned", "tuned_value", "env_or_tuned", "tunerz"]

_tm_trials = _telemetry.counter(
    "tuner_trials_total", "Auto-tuner measurement windows run")
_tm_best = _telemetry.gauge(
    "tuner_best_goodput", "Best measured goodput across tuner trials")

_last_result = None         # most recent in-process tune() outcome
_tuned_cache = {}           # path -> parsed tuned.json (or None)


# -- pure search core ---------------------------------------------------

def grid(space):
    """Deterministic enumeration of a knob space: ``{knob: [values]}``
    → list of config dicts (knobs iterated in sorted-name order,
    values in declared order)."""
    if not space:
        return []
    names = sorted(space)
    for n in names:
        if not isinstance(space[n], (list, tuple)) or not space[n]:
            raise MXNetError(f"tuner space knob {n!r} needs a non-empty "
                             "list of candidate values")
    return [dict(zip(names, combo))
            for combo in itertools.product(*(space[n] for n in names))]


def _ckey(config):
    return json.dumps(config, sort_keys=True, default=str)


def _rung_steps(rung, base_steps, eta, max_steps):
    s = base_steps * (eta ** rung)
    return min(s, max_steps) if max_steps else s


def propose(space, history, eta=3, base_steps=8, max_steps=None,
            max_trials=None, retries=1):
    """Next action for a successive-halving run — a pure function.

    `history` is the list of completed trial records, each
    ``{"config", "rung", "steps", "score", "discarded"}`` (``score``
    None + ``discarded`` True = the measurement window was flagged and
    must not be ranked).  Returns either::

        {"kind": "trial", "config": {...}, "rung": r, "steps": s}

    — run this window next — or ``{"kind": "done", "winner": {...},
    "score": best, "reason": ...}`` (winner None if nothing ever
    measured cleanly).  Rung ``r`` windows are ``base_steps * eta**r``
    steps (capped at `max_steps`); survivors into rung ``r+1`` are the
    top ``ceil(n/eta)`` of rung ``r`` by score.  A config flagged more
    than `retries` times within one rung is dropped from it."""
    if eta < 2:
        raise MXNetError("tuner eta must be >= 2")
    configs = grid(space)
    if not configs:
        return {"kind": "done", "winner": None, "score": None,
                "reason": "empty space"}
    order = {_ckey(c): i for i, c in enumerate(configs)}

    def best_overall():
        best = None
        for rec in history:
            s = rec.get("score")
            if s is None or rec.get("discarded"):
                continue
            if best is None or s > best["score"] or \
                    (s == best["score"]
                     and order.get(_ckey(rec["config"]), 0)
                     < order.get(_ckey(best["config"]), 0)):
                best = {"config": rec["config"], "score": s,
                        "rung": rec["rung"]}
        return best

    if max_trials is not None and len(history) >= max_trials:
        best = best_overall()
        return {"kind": "done",
                "winner": best["config"] if best else None,
                "score": best["score"] if best else None,
                "reason": "trial budget exhausted"}

    survivors = configs
    rung = 0
    while True:
        steps = _rung_steps(rung, base_steps, eta, max_steps)
        # rung bookkeeping: per-config best valid score + attempt count
        scores, attempts = {}, {}
        for rec in history:
            if rec.get("rung") != rung:
                continue
            k = _ckey(rec["config"])
            attempts[k] = attempts.get(k, 0) + 1
            s = rec.get("score")
            if s is not None and not rec.get("discarded"):
                if k not in scores or s > scores[k]:
                    scores[k] = s
        measured, dropped = [], []
        for c in survivors:
            k = _ckey(c)
            if k in scores:
                measured.append(c)
            elif attempts.get(k, 0) > retries:
                dropped.append(c)     # flagged past the retry budget
            else:
                return {"kind": "trial", "config": c, "rung": rung,
                        "steps": steps}
        # every survivor is measured or dropped — close the rung
        ranked = sorted(measured,
                        key=lambda c: (-scores[_ckey(c)],
                                       order[_ckey(c)]))
        if not ranked:
            return {"kind": "done", "winner": None, "score": None,
                    "reason": f"every rung-{rung} window discarded"}
        at_cap = max_steps is not None and steps >= max_steps
        if len(ranked) == 1 or at_cap:
            win = ranked[0]
            return {"kind": "done", "winner": win,
                    "score": scores[_ckey(win)],
                    "reason": "budget cap" if at_cap and len(ranked) > 1
                    else "single survivor"}
        survivors = ranked[:max(1, math.ceil(len(ranked) / eta))]
        rung += 1


# -- measurement harness ------------------------------------------------

def measure_window(run_step, steps, items_per_step=None, label="tuner",
                   warmup=1, capture=False):
    """Run one measurement window and score it.

    `run_step(i)` executes one training/serving step and blocks until
    the device work is done (return values are ignored).  `warmup`
    uncounted steps absorb compilation; the window proper is timed
    wall-to-wall and scored as steps/s (or items/s with
    `items_per_step`).  With ``capture=True`` the window rides the
    device capture plane (`profiling`): armed for exactly `steps` step
    boundaries, and if the report's measured-vs-analytic cross-checks
    disagree the window comes back ``flagged`` — the search layer
    discards it.  Returns ``{"goodput", "wall", "steps", "flagged",
    "disagreements"}``."""
    from . import profiling as _profiling
    for i in range(warmup):
        run_step(i)
    armed = False
    if capture:
        try:
            if _profiling.capture_supported() and not _profiling.armed():
                _profiling.arm(steps=steps, label=label)
                armed = True
        except Exception:   # noqa: BLE001 — capture is advisory
            armed = False
    t0 = time.perf_counter()
    for i in range(steps):
        run_step(i)
    wall = max(time.perf_counter() - t0, 1e-9)
    disagreements = []
    if armed:
        try:
            if _profiling.armed():      # steps never hit a boundary
                _profiling.disarm()     # (caller-managed stepping)
            rep = _profiling.last_report()
            if rep:
                disagreements = list(rep.get("disagreements") or [])
        except Exception:   # noqa: BLE001
            disagreements = []
    per_step = items_per_step if items_per_step else 1.0
    return {"goodput": per_step * steps / wall, "wall": wall,
            "steps": steps, "flagged": bool(disagreements),
            "disagreements": disagreements}


def tune(runner, space, eta=None, base_steps=None, max_steps=None,
         max_trials=None, retries=1, out=None):
    """Drive `runner(config, steps)` through the halving schedule.

    The runner returns a measurement dict — ``{"goodput": float}``
    plus optional ``"flagged"`` (True = discard this window) and any
    extra fields to keep in the history (``measure_window`` produces
    exactly this shape).  Defaults come from ``MXNET_TUNER_*`` env
    vars.  Returns the result doc (winner, score, full history) and
    writes it to `out` (``tuned.json``) when given."""
    global _last_result
    eta = eta if eta is not None else get_env("MXNET_TUNER_ETA", 3, int)
    base_steps = base_steps if base_steps is not None \
        else get_env("MXNET_TUNER_BASE_STEPS", 8, int)
    if max_steps is None:
        max_steps = get_env("MXNET_TUNER_MAX_STEPS", 64, int) or None
    if max_trials is None:
        max_trials = get_env("MXNET_TUNER_MAX_TRIALS", 0, int) or None
    history = []
    while True:
        action = propose(space, history, eta=eta, base_steps=base_steps,
                         max_steps=max_steps, max_trials=max_trials,
                         retries=retries)
        if action["kind"] == "done":
            break
        m = runner(action["config"], action["steps"]) or {}
        flagged = bool(m.get("flagged"))
        score = None if flagged else m.get("goodput")
        rec = {"config": action["config"], "rung": action["rung"],
               "steps": action["steps"], "score": score,
               "discarded": flagged}
        for k in ("mfu", "wall", "disagreements"):
            if k in m:
                rec[k] = m[k]
        history.append(rec)
        _tm_trials.inc()
        if score is not None and score > (_tm_best.value or 0.0):
            _tm_best.set(score)
    result = {"version": 1, "metric": "goodput", "space": space,
              "winner": action.get("winner"),
              "score": action.get("score"),
              "reason": action.get("reason"),
              "trials": len(history), "history": history,
              "backend": _compile_cache.backend_token(),
              "created": time.time()}
    _last_result = result
    if out:
        write_tuned(out, result)
    return result


# -- winner artifact ----------------------------------------------------

def write_tuned(path, result):
    """Atomic-rename write of ``tuned.json``."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".tuned-{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(result, f, indent=2, default=str)
    os.replace(tmp, os.path.abspath(path))
    _tuned_cache.pop(os.path.abspath(path), None)
    return path


def load_tuned(path=None):
    """Parse the ``tuned.json`` at `path` (default:
    ``MXNET_TUNED_CONFIG``).  Cached per path; a missing, corrupt, or
    winner-less artifact is None — consumers fall through to their
    built-in defaults, never fail."""
    path = path or get_env("MXNET_TUNED_CONFIG", "")
    if not path:
        return None
    path = os.path.abspath(path)
    if path in _tuned_cache:
        return _tuned_cache[path]
    doc = None
    try:
        with open(path) as f:
            parsed = json.load(f)
        if isinstance(parsed, dict) and \
                isinstance(parsed.get("winner"), dict):
            doc = parsed
    except Exception:   # noqa: BLE001 — a bad artifact is no artifact
        doc = None
    _tuned_cache[path] = doc
    return doc


def tuned_value(knob, default=None):
    """The winner's value for `knob`, or `default`."""
    doc = load_tuned()
    if doc is None:
        return default
    v = doc["winner"].get(knob, default)
    return default if v is None else v


def env_or_tuned(env_name, knob, default, type=str):
    """The repo-wide knob precedence: env var > tuned.json > default.
    (Explicit constructor arguments beat all three at the call
    sites.)"""
    raw = get_env(env_name, None)
    if raw not in (None, ""):
        return get_env(env_name, default, type)
    v = tuned_value(knob)
    if v is None:
        return default
    try:
        return type(v)
    except (TypeError, ValueError):
        return default


# -- debugz -------------------------------------------------------------

def tunerz():
    """``/-/tunerz`` payload: the consumed artifact, the last
    in-process tune, live counters, and the compile-cache state."""
    path = get_env("MXNET_TUNED_CONFIG", "")
    doc = load_tuned()
    last = None
    if _last_result:
        last = {k: _last_result.get(k)
                for k in ("winner", "score", "reason", "trials",
                          "created")}
    return {
        "tuned_config": path or None,
        "loaded": ({"winner": doc["winner"], "score": doc.get("score"),
                    "trials": doc.get("trials"),
                    "created": doc.get("created")} if doc else None),
        "last_tune": last,
        "trials_total": int(_tm_trials.value),
        "best_goodput": _tm_best.value,
        "compile_cache": _compile_cache.cachez(),
    }


def _reset_for_tests():
    global _last_result
    _last_result = None
    _tuned_cache.clear()
