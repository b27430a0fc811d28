"""Sharded checkpoint files, written and read by one process
(counterpart of `incubator_mxnet_tpu/parallel/checkpoint.py`).

The format is the JAX package's, so checkpoints cross between the
packages both ways:

- `<dir>/manifest.json`: the step, the process count, `extra` (a small
  JSON dict), `{shape, dtype}` of every array under `arrays`, and the
  sha256 of every shard file under `shard_sha256`;
- `<dir>/shards-{process:05d}.npz`: each array's shards under
  `name##start:stop,...` (one key per shard, the empty index for a 0-d
  array), each stored as its raw little-endian bytes viewed as uint8,
  so bfloat16 needs no numpy dtype.

One process writes `shards-00000.npz`, one shard per array.  Reading
assembles an array from whatever shards of it the listed files hold,
so a checkpoint the JAX package wrote over several devices loads too.
A shard file whose sha256 differs from the manifest's fails, naming
the file.  The manifest is written last, durably (fsync of the file and
its directory around an atomic rename).
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as _np
import torch

from ..base import MXNetError, dtype_name

__all__ = ["save_sharded", "load_sharded", "read_manifest", "file_sha256",
           "write_durable"]


def file_sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_durable(path, blob):
    """Write `blob` to `path` through a temporary file fsync'd before an
    atomic rename, then fsync the directory: a crash leaves the old file
    or the whole new one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")
    return path


def read_manifest(directory):
    """`<dir>/manifest.json`, parsed (validation without shard I/O)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)


def _carrier(name):
    """A numpy dtype of the same bytes as dtype `name` (bfloat16, which
    numpy lacks, rides as int16)."""
    return _np.dtype(_np.int16) if name == "bfloat16" else _np.dtype(name)


def _bytes_of(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(_np.uint8)


def save_sharded(directory, arrays, step=0, extra=None):
    """Write {name: tensor} as one process's shard file and the
    manifest."""
    os.makedirs(directory, exist_ok=True)
    manifest = {"step": int(step), "process_count": 1,
                "extra": extra or {}, "arrays": {}}
    payload = {}
    for name, t in arrays.items():
        if "##" in name:
            raise MXNetError("array names must not contain '##'")
        shape = [int(d) for d in t.shape]
        manifest["arrays"][name] = {"shape": shape,
                                    "dtype": dtype_name(t.dtype)}
        payload[name + "##" + ",".join(f"0:{d}" for d in shape)] = \
            _bytes_of(t)
    fname = "shards-00000.npz"
    _np.savez(os.path.join(directory, fname), **payload)
    manifest["shard_sha256"] = {
        fname: file_sha256(os.path.join(directory, fname))}
    write_durable(os.path.join(directory, "manifest.json"),
                  json.dumps(manifest, indent=2).encode())
    return directory


def _parse_index(key):
    if not key:
        return []
    return [tuple(int(v) for v in part.split(":"))
            for part in key.split(",")]


def load_sharded(directory, names=None, manifest=None):
    """({name: CPU tensor}, manifest) of the arrays `names` (default:
    all) saved by either package's `save_sharded`.  Pass a pre-read
    `manifest` to skip parsing it again."""
    if manifest is None:
        manifest = read_manifest(directory)
    for fname, digest in (manifest.get("shard_sha256") or {}).items():
        fpath = os.path.join(directory, fname)
        if os.path.exists(fpath) and file_sha256(fpath) != digest:
            raise MXNetError(
                f"checkpoint restore: shard file {fname!r} in {directory} "
                f"is corrupt (sha256 mismatch against the manifest)")
    files = [os.path.join(directory, f"shards-{p:05d}.npz")
             for p in range(int(manifest.get("process_count", 1)))]
    files = [_np.load(f) for f in files if os.path.exists(f)]
    if not files:
        raise MXNetError(f"no shard files found in {directory}")
    out = {}
    try:
        for name, meta in manifest["arrays"].items():
            if names is not None and name not in names:
                continue
            shape, dt = tuple(meta["shape"]), meta["dtype"]
            carrier = _carrier(dt)
            full = _np.empty(shape, carrier)
            filled = _np.zeros(shape, bool)
            prefix = name + "##"
            for z in files:
                for k in z.files:
                    if not k.startswith(prefix):
                        continue
                    bounds = _parse_index(k[len(prefix):])
                    sl = tuple(slice(a, b) for a, b in bounds)
                    full[sl] = _np.frombuffer(z[k].tobytes(), carrier) \
                        .reshape(tuple(b - a for a, b in bounds))
                    filled[sl] = True
            if not filled.all():
                raise MXNetError(
                    f"checkpoint restore: array {name!r} has missing "
                    f"shards in {directory}")
            t = torch.from_numpy(full)
            out[name] = t.view(torch.bfloat16) if dt == "bfloat16" else t
    finally:
        for z in files:
            z.close()
    return out, manifest
