"""Serving artifacts: `export_serving`, `validate_artifact`,
`load_serving` (counterpart of `incubator_mxnet_tpu/deploy.py`).

The JAX package's artifact carries a `jax.export` graph.  The port's
carries what rebuilds the model instead:

    meta.json      the registered constructor (`models.get_model` name and
                   kwargs), the dtype, the input/output specs and the
                   parameter specs in the JAX package's meta schema
    params.npz     weights by structural name (`ndarray.save` format)
    manifest.json  size and sha256 of each file, written last by atomic
                   rename

`load_serving` checks every file against the manifest before reading
any of them, rebuilds the block on the device, loads the weights and
returns a callable of numpy arrays.

Batch buckets: `export_serving(..., batch_buckets=[1, 2, ...])` records
the sorted sizes below the capacity in meta.json under
``"batch_buckets"``, and the loaded model's ``buckets`` maps each size b
to a callable that runs the same rebuilt block at batch b.  The JAX
format carries one ``model_b{n}.jaxexp`` file per bucket; the port's
artifact rebuilds the block, so a bucket needs no file of its own (an
artifact of the port is not one of the JAX package's either way).

Every call of a loaded model counts ``serving_requests`` and observes
``serving_request_seconds``, labelled with the artifact directory's
name (``name#b{n}`` for a bucket).  The JAX package's compile-cache
path has no counterpart: nothing is compiled.
"""
from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as _np
import torch

from .base import MXNetError, dtype_name, torch_dtype
from .context import as_device
from . import ndarray as nd
from . import telemetry as _telemetry

__all__ = ["export_serving", "load_serving", "validate_artifact"]

_REQUIRED_SERVING_FILES = ("meta.json", "params.npz")


def _spec(t):
    return {"shape": list(t.shape), "dtype": dtype_name(t.dtype)}


def _as_tensor(x, device):
    if isinstance(x, nd.NDArray):
        x = x.data
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(_np.ascontiguousarray(x))
    return x.to(device)


def export_serving(block, example_inputs, out_dir, batch_buckets=None):
    """Write a serving artifact for `block` (built with
    `models.get_model`) to `out_dir`.  `example_inputs` (tensors,
    NDArrays or numpy arrays) fix the input shapes and dtypes; their
    leading dimension is the batch capacity the server pads to.
    `batch_buckets`: extra batch sizes below the capacity that the
    server may pad a small batch to instead; they require every input
    and output to lead with the batch dimension.  Returns out_dir."""
    spec = getattr(block, "_model_spec", None)
    if spec is None:
        raise MXNetError("export_serving: build the block with "
                         "models.get_model(...) so the artifact can "
                         "rebuild it")
    params = block._collect_params_with_prefix()
    if not params:
        raise MXNetError("export_serving: the block has no parameters")
    first = next((p for p in params.values() if p._data is not None), None)
    if first is None:
        raise MXNetError("export_serving: parameters are uninitialized — "
                         "call initialize() (or load weights) first")
    device = first._data.device
    inputs = [_as_tensor(x, device) for x in example_inputs]
    with torch.inference_mode():
        # also finishes deferred initialization
        outs = block(*inputs)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    for name, p in params.items():
        if p._data is None:
            raise MXNetError(f"export_serving: parameter {name} is "
                             "uninitialized")
    buckets = []
    if batch_buckets:
        cap = int(inputs[0].shape[0]) if inputs and inputs[0].dim() else 0
        rowwise = (cap >= 1
                   and all(t.dim() and t.shape[0] == cap for t in inputs)
                   and all(t.dim() and t.shape[0] == cap for t in outs))
        if not rowwise:
            raise MXNetError(
                "export_serving: batch_buckets requires every input "
                "and output to lead with the same batch dimension")
        buckets = sorted({int(b) for b in batch_buckets
                          if 1 <= int(b) < cap})
    dtypes = {p.dtype for p in params.values()}
    os.makedirs(out_dir, exist_ok=True)
    nd.save(os.path.join(out_dir, "params.npz"),
            {k: p._data for k, p in params.items()})
    meta = {
        "model": spec,
        "dtype": dtypes.pop() if len(dtypes) == 1 else None,
        "param_keys": list(params),
        "params": {k: _spec(p._data) for k, p in params.items()},
        "inputs": [_spec(t) for t in inputs],
        "outputs": [_spec(t) for t in outs],
        "platforms": ["cuda"],
    }
    if buckets:
        meta["batch_buckets"] = buckets
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    _write_manifest(out_dir, ["meta.json", "params.npz"])
    return out_dir


def _sha256_file(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _write_manifest(out_dir, fnames):
    """Size and sha256 of the files this export wrote, written last by
    atomic rename: a torn or tampered artifact fails at load naming the
    bad file."""
    files = {}
    for fname in sorted(fnames):
        path = os.path.join(out_dir, fname)
        files[fname] = {"bytes": os.path.getsize(path),
                        "sha256": _sha256_file(path)}
    tmp = os.path.join(out_dir, f".manifest.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump({"format": 1, "files": files}, f, indent=2, sort_keys=True)
    os.replace(tmp, os.path.join(out_dir, "manifest.json"))


def validate_artifact(artifact_dir, required=_REQUIRED_SERVING_FILES):
    """Check a serving artifact against its `manifest.json`: every listed
    file must exist with the recorded size and sha256.  Raises one
    `MXNetError` naming the first bad file; returns the manifest."""
    if not os.path.isdir(artifact_dir):
        raise MXNetError(
            f"serving artifact {artifact_dir!r} is not a directory")
    for fname in required + ("manifest.json",):
        if not os.path.exists(os.path.join(artifact_dir, fname)):
            raise MXNetError(
                f"serving artifact {artifact_dir!r} is missing {fname}")
    try:
        with open(os.path.join(artifact_dir, "manifest.json")) as f:
            manifest = json.load(f)
        files = manifest["files"]
        if not isinstance(files, dict):
            raise TypeError("'files' is not an object")
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise MXNetError(
            f"serving artifact {artifact_dir!r}: manifest.json is "
            f"unreadable ({type(e).__name__}: {e})") from None
    for fname in required:
        if fname not in files:
            raise MXNetError(f"serving artifact {artifact_dir!r}: "
                             f"manifest.json does not list {fname}")
    for fname, info in sorted(files.items()):
        if not isinstance(info, dict) or \
                not {"bytes", "sha256"} <= info.keys():
            raise MXNetError(
                f"serving artifact {artifact_dir!r}: manifest.json "
                f"entry for {fname} is malformed (need 'bytes' and 'sha256')")
        path = os.path.join(artifact_dir, fname)
        if not os.path.exists(path):
            raise MXNetError(
                f"serving artifact {artifact_dir!r} is missing {fname} "
                f"(listed in manifest.json)")
        size = os.path.getsize(path)
        if size != info["bytes"]:
            raise MXNetError(
                f"serving artifact {artifact_dir!r}: {fname} is truncated "
                f"({size} bytes, manifest says {info['bytes']})")
        if _sha256_file(path) != info["sha256"]:
            raise MXNetError(
                f"serving artifact {artifact_dir!r}: {fname} is corrupt "
                f"(sha256 mismatch vs manifest.json)")
    return manifest


_tm_requests = _telemetry.counter(
    "serving_requests", "Inference requests served", ("model",))
_tm_request_secs = _telemetry.histogram(
    "serving_request_seconds", "Inference request latency", ("model",))


class ServedModel:
    """A loaded artifact: `model(*numpy_inputs)` returns a list of numpy
    outputs (bfloat16 outputs come back as float32).  `block`, `device`,
    `meta`, `label` and `buckets` (batch size -> a `ServedModel` of the
    same block at that batch) are public."""

    def __init__(self, block, device, meta, label="model"):
        self.block = block
        self.device = device
        self.meta = meta
        self.label = label
        self.buckets = {}
        self._in_dtypes = [torch_dtype(s["dtype"]) for s in meta["inputs"]]
        self._requests = _tm_requests.labels(label)
        self._latency = _tm_request_secs.labels(label)

    def __call__(self, *inputs):
        if len(inputs) != len(self._in_dtypes):
            raise MXNetError(f"expected {len(self._in_dtypes)} inputs, got "
                             f"{len(inputs)}")
        t0 = time.perf_counter()
        try:
            ts = [torch.as_tensor(_np.asarray(x)).to(self.device, dt)
                  for x, dt in zip(inputs, self._in_dtypes)]
            with torch.inference_mode():
                out = self.block(*ts)
            out = list(out) if isinstance(out, (tuple, list)) else [out]
            return [nd.to_numpy(o) for o in out]
        finally:
            self._requests.inc()
            self._latency.observe(time.perf_counter() - t0)


def _at_batch(specs, b):
    return [dict(s, shape=[b] + list(s["shape"][1:])) for s in specs]


def load_serving(artifact_dir, ctx=None):
    """Validate, rebuild and load an artifact on `ctx` (default gpu(0));
    returns a `ServedModel`, with one more per batch bucket the artifact
    lists (`model.buckets`), all sharing the one block."""
    validate_artifact(artifact_dir)
    device = as_device(ctx)
    with open(os.path.join(artifact_dir, "meta.json")) as f:
        meta = json.load(f)
    from .models import get_model
    block = get_model(meta["model"]["name"], **meta["model"]["kwargs"])
    if meta.get("dtype"):
        block.cast(meta["dtype"])
    block.load_dict(nd.load_tensors(os.path.join(artifact_dir,
                                                "params.npz")),
                    ctx=device, source=artifact_dir)
    block.eval()
    label = os.path.basename(os.path.normpath(artifact_dir)) or "model"
    model = ServedModel(block, device, meta, label)
    for b in meta.get("batch_buckets", ()):
        b = int(b)
        model.buckets[b] = ServedModel(
            block, device, dict(meta, inputs=_at_batch(meta["inputs"], b),
                                outputs=_at_batch(meta["outputs"], b)),
            f"{label}#b{b}")
    return model
