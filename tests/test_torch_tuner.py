"""The auto-tuner of the port (`incubator_mxnet_torch/tuner.py`) against
the JAX package's (`incubator_mxnet_tpu/tuner.py`), and the two knobs
the port reads through it.

- `grid` and `propose` (pure successive halving): the same action for
  the same space and history, exactly, over whole runs driven by
  deterministic scores (discarded windows, retries, budget caps and
  trial limits among them);
- `tune` with the same runner: the same winner, history and score;
- the winner file: `write_tuned`/`load_tuned`/`tuned_value` and the
  precedence env > tuned.json > default of `env_or_tuned`, as the JAX
  package's;
- serving's ``batch_window_ms`` and `DevicePrefetcher`'s depth read from
  a ``tuned.json`` (and the env still winning), as the JAX package's
  `ServeConfig` does;
- `tunerz` with the JAX page's keys.
"""
import json

import numpy as np
import pytest

import incubator_mxnet_tpu as mxj  # noqa: F401 — package init
from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu import tuner as jtuner

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import io, tuner
from incubator_mxnet_torch.serving import ServeConfig


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("MXNET_TUNED_CONFIG", "MXNET_SERVE_BATCH_WINDOW_MS",
              "MXNET_IO_STAGING_DEPTH"):
        monkeypatch.delenv(k, raising=False)
    for t in (tuner, jtuner):
        t._reset_for_tests()
    yield
    for t in (tuner, jtuner):
        t._reset_for_tests()


SPACES = {
    "one_knob": {"batch_window_ms": [0.5, 1.0, 2.0, 4.0]},
    "two_knobs": {"staging_depth": [1, 2, 4], "serve_batch_window_ms":
                  [1.0, 2.0, 5.0]},
    "three_knobs": {"a": [1, 2], "b": ["x", "y", "z"], "c": [0.1, 0.2]},
    "single": {"a": [7]},
}


def _score(config, steps, seed):
    """A deterministic score: a hash of the configuration, nudged by
    the window length; some windows are flagged."""
    h = sum(ord(ch) for ch in json.dumps(config, sort_keys=True))
    score = ((h * 2654435761 + seed) % 1000) / 10.0 + steps * 0.001
    flagged = (h + steps + seed) % 7 == 0
    return score, flagged


def _drive(mod, space, seed, **kw):
    history, actions = [], []
    while True:
        a = mod.propose(space, history, **kw)
        actions.append(a)
        if a["kind"] == "done" or len(actions) > 500:
            return actions
        score, flagged = _score(a["config"], a["steps"], seed)
        history.append({"config": a["config"], "rung": a["rung"],
                        "steps": a["steps"],
                        "score": None if flagged else score,
                        "discarded": flagged})


@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("kw", [
    {}, {"eta": 2, "base_steps": 4}, {"max_steps": 16},
    {"max_trials": 5}, {"retries": 0}, {"eta": 4, "retries": 2}],
    ids=["default", "eta2", "cap16", "trials5", "no_retry", "eta4"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_propose_matches_jax_over_whole_runs(space, kw, seed):
    got = _drive(tuner, SPACES[space], seed, **kw)
    ref = _drive(jtuner, SPACES[space], seed, **kw)
    assert got == ref
    assert got[-1]["kind"] == "done"


def test_grid_and_errors_match_jax():
    for space in SPACES.values():
        assert tuner.grid(space) == jtuner.grid(space)
    assert tuner.grid({}) == jtuner.grid({}) == []
    for mod in (tuner, jtuner):
        with pytest.raises(Exception):
            mod.grid({"a": []})
        with pytest.raises(Exception):
            mod.propose({"a": [1]}, [], eta=1)


def test_tune_matches_jax(tmp_path):
    space = SPACES["two_knobs"]

    def runner(config, steps):
        score, flagged = _score(config, steps, 3)
        # the first rung's windows may be flagged; later ones are clean
        return {"goodput": score, "flagged": flagged and steps == 2,
                "wall": 1.0}
    got = tuner.tune(runner, space, eta=3, base_steps=2, max_steps=18,
                     out=str(tmp_path / "tuned.json"))
    ref = jtuner.tune(runner, space, eta=3, base_steps=2, max_steps=18)
    for k in ("winner", "score", "reason", "trials", "history", "space",
              "metric", "version"):
        assert got[k] == ref[k], k
    assert got["winner"] is not None
    assert any(h["discarded"] for h in got["history"])
    doc = tuner.load_tuned(str(tmp_path / "tuned.json"))
    assert doc["winner"] == got["winner"]
    assert set(doc["backend"]) == {"format", "torch", "cuda",
                                   "device_kind", "capability"}


def _tuned(tmp_path, winner):
    path = tmp_path / "tuned.json"
    tuner.write_tuned(str(path), {"winner": winner, "score": 1.0,
                                  "trials": 3})
    return str(path)


def test_env_or_tuned_precedence_matches_jax(tmp_path, monkeypatch):
    path = _tuned(tmp_path, {"staging_depth": 5,
                             "serve_batch_window_ms": 0.75})
    monkeypatch.setenv("MXNET_TUNED_CONFIG", path)
    for mod in (tuner, jtuner):
        mod._reset_for_tests()
        assert mod.tuned_value("staging_depth") == 5
        assert mod.env_or_tuned("MXNET_IO_STAGING_DEPTH", "staging_depth",
                                2, int) == 5
        assert mod.env_or_tuned("MXNET_X", "missing", 9, int) == 9
    monkeypatch.setenv("MXNET_IO_STAGING_DEPTH", "3")
    assert tuner.env_or_tuned("MXNET_IO_STAGING_DEPTH", "staging_depth",
                              2, int) == 3 == jtuner.env_or_tuned(
        "MXNET_IO_STAGING_DEPTH", "staging_depth", 2, int)
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert tuner.load_tuned(str(bad)) is None is jtuner.load_tuned(str(bad))


@pytest.mark.parametrize("env", [None, "3.5"])
def test_serving_batch_window_from_tuned_json(tmp_path, monkeypatch, env):
    path = _tuned(tmp_path, {"serve_batch_window_ms": 0.75})
    monkeypatch.setenv("MXNET_TUNED_CONFIG", path)
    if env is not None:
        monkeypatch.setenv("MXNET_SERVE_BATCH_WINDOW_MS", env)
    for mod in (tuner, jtuner):
        mod._reset_for_tests()
    got = ServeConfig().batch_window_ms
    assert got == jserving.ServeConfig().batch_window_ms
    assert got == (0.75 if env is None else 3.5)
    assert ServeConfig(batch_window_ms=9.0).batch_window_ms == 9.0
    monkeypatch.delenv("MXNET_TUNED_CONFIG")
    monkeypatch.delenv("MXNET_SERVE_BATCH_WINDOW_MS", raising=False)
    assert ServeConfig().batch_window_ms == 2.0


def test_prefetcher_depth_from_tuned_json(tmp_path, monkeypatch):
    path = _tuned(tmp_path, {"staging_depth": 3})
    monkeypatch.setenv("MXNET_TUNED_CONFIG", path)
    tuner._reset_for_tests()
    src = [np.full((2, 2), i, np.float32) for i in range(5)]
    pf = io.DevicePrefetcher(iter(src), ctx=mx.cpu())
    try:
        assert pf._depth == 3
        got = [b[0].asnumpy()[0, 0] for b in pf]
        assert got == [0.0, 1.0, 2.0, 3.0, 4.0]
    finally:
        pf.close()
    monkeypatch.setenv("MXNET_IO_STAGING_DEPTH", "1")
    pf = io.DevicePrefetcher(iter(src), ctx=mx.cpu())
    pf.close()
    assert pf._depth == 1


def test_tunerz_keys_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TUNED_CONFIG",
                       _tuned(tmp_path, {"staging_depth": 2}))
    for mod in (tuner, jtuner):
        mod._reset_for_tests()
    got, ref = tuner.tunerz(), jtuner.tunerz()
    assert set(got) == set(ref)
    assert got["loaded"]["winner"] == {"staging_depth": 2}
    assert set(got["loaded"]) == set(ref["loaded"])


def test_measure_window_scores_and_captures():
    calls = []
    out = tuner.measure_window(lambda i: calls.append(i), 4,
                               items_per_step=10, warmup=2, capture=True)
    assert len(calls) == 6 and out["steps"] == 4
    assert out["goodput"] > 0 and not out["flagged"]
    from incubator_mxnet_torch import profiling
    assert profiling.armed() is None
