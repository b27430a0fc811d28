"""Serving artifacts: `export_serving`, `validate_artifact`,
`load_serving` (counterpart of `incubator_mxnet_tpu/deploy.py`).

The JAX package's artifact carries a `jax.export` graph.  The port's
carries what rebuilds the model instead:

    meta.json      the registered constructor (`models.get_model` name and
                   kwargs), the dtype, the input/output specs and the
                   parameter specs in the JAX package's meta schema
    params.npz     weights by structural name (`ndarray.save` format)
    int8.npz       for a net after `contrib.quantization.quantize_net`:
                   each fused int8 layer's int8 weight, scales and float32
                   bias by layer path (meta.json's "int8" lists the paths
                   and the calibrated activation thresholds); the loader
                   rebuilds the float net and swaps those layers back in
    manifest.json  size and sha256 of each file, written last by atomic
                   rename

`load_serving` checks every file against the manifest before reading
any of them, rebuilds the block on the device, loads the weights and
returns a callable of numpy arrays.

Framework-free artifacts (the JAX package's StableHLO modules and C
ABI): `export_serving(..., platforms=("cuda", "cpu"))` also writes, for
each platform named,

    model_native_<p>.pt2   `torch.export` of (params..., inputs...) ->
                           outputs at the capacity batch, the weights
                           inputs and not constants, compiled by
                           AOTInductor (`aoti_compile_and_package`)
    native_meta.txt        the JAX sidecar's line format: `format 1`,
                           `platform <p> <file>`, then `param <name>
                           <dtype> <rank> <dims>`, `input ...`, `output
                           ...` lines in the calling order
    serve.py               `deploy_serve.py`: `Model(dir)(x)` with only
                           torch and numpy (also `deploy.Model`)

and `export_training` writes the whole dense training step the same
way (`train_native_<p>.pt2`, `native_train_meta.txt`).  `params.npz`
holds `arr_<i>` in the sidecar's param order.  The C library
`csrc/mxtorch_infer.cc` (`_native.py` builds it) runs both artifacts
with no Python in the process.  A "cuda" export needs the card; the
package calls rows 1 and 1b as the custom ops `mxnet_torch::*`, which
a process without the framework registers from `libmxtorch_ops.so`.
No platform is written unless named: an AOTInductor compile takes tens
of seconds (the JAX package lowers for cpu and tpu by default).

Batch buckets: `export_serving(..., batch_buckets=[1, 2, ...])` records
the sorted sizes below the capacity in meta.json under
``"batch_buckets"``, and the loaded model's ``buckets`` maps each size b
to a callable that runs the same rebuilt block at batch b.  The JAX
format carries one ``model_b{n}.jaxexp`` file per bucket; the port's
artifact rebuilds the block, so a bucket needs no file of its own (an
artifact of the port is not one of the JAX package's either way).

Every call of a loaded model counts ``serving_requests`` and observes
``serving_request_seconds``, labelled with the artifact directory's
name (``name#b{n}`` for a bucket).  Loading compiles nothing; the
framework-free packages that `platforms=` and `export_training` write
are compiled once and go through the persistent compile cache
(`compile_cache`, ``MXNET_COMPILE_CACHE_DIR``), as the JAX package's
`export_*` do.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as _np
import torch

from .base import MXNetError, dtype_name, torch_dtype
from .context import as_device
from . import ndarray as nd
from . import telemetry as _telemetry
from .deploy_serve import Model
from .gluon.parameter import bound_data

__all__ = ["export_serving", "load_serving", "validate_artifact",
           "export_training", "Model"]

_REQUIRED_SERVING_FILES = ("meta.json", "params.npz")


def _spec(t):
    return {"shape": list(t.shape), "dtype": dtype_name(t.dtype)}


def _as_tensor(x, device):
    if isinstance(x, nd.NDArray):
        x = x.data
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(_np.ascontiguousarray(x))
    return x.to(device)


def export_serving(block, example_inputs, out_dir, batch_buckets=None,
                   platforms=None):
    """Write a serving artifact for `block` (built with
    `models.get_model`) to `out_dir`.  `example_inputs` (tensors,
    NDArrays or numpy arrays) fix the input shapes and dtypes; their
    leading dimension is the batch capacity the server pads to.
    `batch_buckets`: extra batch sizes below the capacity that the
    server may pad a small batch to instead; they require every input
    and output to lead with the batch dimension.  `platforms`
    ("cuda", "cpu"): also write the framework-free files for each (the
    module docstring).  Returns out_dir."""
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
    from .contrib.quantization import int8_state
    int8_arrays, int8_layers = int8_state(block)
    if int8_layers and platforms:
        raise MXNetError("export_serving: a quantized net has no "
                         "framework-free form (its int8 kernels are not "
                         "registered custom ops)")
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
    files = ["meta.json", "params.npz"]
    if int8_layers:
        meta["int8"] = int8_layers
        nd.save(os.path.join(out_dir, "int8.npz"),
                {k: v._data for k, v in int8_arrays.items()})
        files.append("int8.npz")
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    if platforms:
        plist = list(params.values())

        def fn(*flat):
            with bound_data(plist, flat[:len(plist)]), torch.no_grad():
                out = block(*flat[len(plist):])
            return tuple(out) if isinstance(out, (tuple, list)) else (out,)
        packages = {}
        for plat in platforms:
            dev = _platform_device(plat)
            flat = [p._data.detach().to(dev) for p in plist] + \
                [t.to(dev) for t in inputs]
            packages[plat] = _package(
                torch.export.export(_Traced(fn), tuple(flat)),
                out_dir, f"model_native_{plat}.pt2")
        lines = [f"param {k} {_dims(p._data)}" for k, p in params.items()]
        lines += [f"input {_dims(t)}" for t in inputs]
        lines += [f"output {_dims(t)}" for t in outs]
        _write_sidecar(out_dir, "native_meta.txt", packages, lines)
        shutil.copyfile(os.path.join(os.path.dirname(__file__),
                                     "deploy_serve.py"),
                        os.path.join(out_dir, "serve.py"))
        files += ["native_meta.txt", "serve.py", *packages.values()]
    _write_manifest(out_dir, files)
    return out_dir


# ---------------------------------------------------------------------
# framework-free artifacts
# ---------------------------------------------------------------------

class _Traced(torch.nn.Module):
    """A function of flat tensors as the module `torch.export` takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *flat):
        return self.fn(*flat)


def _platform_device(platform):
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError("export for platform cuda needs a CUDA device")
        return torch.device("cuda", 0)
    if platform == "cpu":
        return torch.device("cpu")
    raise MXNetError(f"unknown platform {platform!r}: 'cuda' or 'cpu'")


def _package(program, out_dir, fname, deterministic=False, **options):
    """AOTInductor-compile an exported program into out_dir/fname, with
    a C++ compiler that links OpenMP (`_native.openmp_compiler`) and
    Inductor's `options`.  The wrapper's one large function, which only
    enqueues the kernels, is compiled at -O0: at -O1 it took 82 of the
    116 s of BERT-base's serving export on the card's host.  With
    `deterministic`, Inductor lowers every accumulating scatter (an
    embedding's gradient) to ATen's sorted one instead of atomic adds,
    whose order, and so whose rounding, changes from run to run.  With
    ``MXNET_COMPILE_CACHE_DIR`` set, the package goes through the
    persistent compile cache, keyed by the exported program, the
    backend and `fname` with the options."""
    import torch._inductor
    from . import compile_cache as _cc
    from ._native import openmp_compiler
    path = os.path.join(out_dir, fname)
    key = None
    if _cc.enabled():
        # the persistent compile cache (`compile_cache`): a hit copies
        # the package another export compiled and compiles nothing
        key = _cc.cache_key(program, extra={
            "kind": "aoti", "package": fname,
            "deterministic": bool(deterministic),
            "options": {k: repr(v) for k, v in sorted(options.items())}})
        hit = _cc.get(key)
        if hit is not None:
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(hit[0])
            os.replace(tmp, path)
            return fname
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    t0 = time.perf_counter()
    try:
        if deterministic:
            torch.use_deterministic_algorithms(True, warn_only=True)
        with torch._inductor.config.patch(
                {"cpp.cxx": (None, openmp_compiler()),
                 "aot_inductor.compile_wrapper_opt_level": "O0",
                 **options}):
            torch._inductor.aoti_compile_and_package(
                program, package_path=path)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    secs = time.perf_counter() - t0
    _cc.note_compile(secs)
    if key is not None:
        with open(path, "rb") as f:
            _cc.put(key, f.read(), compile_seconds=secs)
    return fname


def _dims(t):
    """`<dtype> <rank> <dims>` of a sidecar line."""
    return " ".join([dtype_name(t.dtype), str(len(t.shape)),
                     *(str(d) for d in t.shape)])


def _write_sidecar(out_dir, fname, packages, lines, head=()):
    with open(os.path.join(out_dir, fname), "w") as f:
        f.write("format 1\n")
        for line in head:
            f.write(line + "\n")
        for plat, pkg in packages.items():
            f.write(f"platform {plat} {pkg}\n")
        for line in lines:
            f.write(line + "\n")


def export_training(block, loss, example_inputs, example_label, out_dir,
                    optimizer="sgd", optimizer_params=None, platforms=None):
    """Write the whole dense training step for framework-free training
    (counterpart of the JAX `export_training`): for each platform
    (default: the one the block's parameters lie on),
    `train_native_<p>.pt2` computes

        (params..., states..., t, input..., label)
            -> (loss (1,), params'..., states'...)

    `ParallelTrainer`'s step (`functional_step`) traced with `make_fx`,
    then `torch.export` and AOTInductor.  params are every parameter in
    `collect_params` order; states are float32, zeros to start, one
    momentum a trained parameter for sgd (kept also without momentum)
    and m then v of each for adam; t is float32 (1,), 1 at the first
    step.  The step is compiled deterministic, so its runs repeat bit
    for bit.  The JAX step also takes a PRNG key; this one takes none,
    as no dropout-free configuration draws.  Also writes `params.npz`
    (`arr_<i>` in param order), `native_train_meta.txt` (the JAX
    sidecar with its `optimizer` line) and the manifest.  Returns
    out_dir."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from .parallel import ParallelTrainer
    from .parallel.mesh import Mesh

    params = list(block.collect_params().values())
    first = next((p for p in params if p._data is not None), None)
    if first is None:
        raise MXNetError("export_training: parameters are uninitialized — "
                         "call initialize() (or load weights) first")
    home = first._data.device
    batch = [_as_tensor(x, home) for x in [*example_inputs, example_label]]
    tr = ParallelTrainer(block, loss, optimizer, optimizer_params,
                         mesh=Mesh(home))
    step = tr.functional_step(*batch)
    params = tr.params
    states = tr.state_shapes()
    if platforms is None:
        platforms = ("cuda" if home.type == "cuda" else "cpu",)
    os.makedirs(out_dir, exist_ok=True)
    packages = {}
    for plat in platforms:
        dev = _platform_device(plat)
        flat = ([p._data.detach().to(dev) for p in params]
                + [torch.zeros(s, device=dev) for s in states]
                + [torch.ones(1, device=dev)] + [t.to(dev) for t in batch])
        graph = make_fx(step, tracing_mode="fake")(*flat)
        # Inductor's loop reordering after fusion asserts on the CUDA
        # step's fused optimizer groups (torch 2.11); it only reorders
        # loops for speed, so it is off for the step.  The step is
        # deterministic, so a run of the package repeats bit for bit
        packages[plat] = _package(
            torch.export.export(_Traced(graph), tuple(flat)), out_dir,
            f"train_native_{plat}.pt2", deterministic=True,
            loop_ordering_after_fusion=False)
    names = [p.name for p in params]
    nd.save(os.path.join(out_dir, "params.npz"),
            {n: p._data for n, p in zip(names, params)})
    lines = [f"param {n} {_dims(p._data)}" for n, p in zip(names, params)]
    lines += [f"state {_dims(torch.empty(s, device='meta'))}"
              for s in states]
    lines += [f"input {_dims(t)}" for t in batch]
    lines += ["output float32 1 1"]
    _write_sidecar(out_dir, "native_train_meta.txt", packages, lines,
                   head=(f"optimizer {tr.kind}",))
    _write_manifest(out_dir, ["params.npz", "native_train_meta.txt",
                              *packages.values()])
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
    if meta.get("int8"):
        from .contrib.quantization import restore_int8
        stored = nd.load_tensors(os.path.join(artifact_dir, "int8.npz"))
        restore_int8(block, {k: nd.NDArray(t.to(device))
                             for k, t in stored.items()}, meta["int8"])
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
