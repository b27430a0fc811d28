"""Local pretrained-weight store (counterpart of
`incubator_mxnet_tpu/gluon/model_zoo/model_store.py`, its own copy).

Upstream MXNet keeps a name → sha1 table and downloads
`{name}-{sha1[:8]}.params` files.  Here the store is a local directory,
`$MXNET_HOME/models` (default `~/.mxnet/models`), or the `root` a caller
gives, with the same file names and sha1 check and a `manifest.json`
{name: {"file", "sha1"}}: `publish_model_file` registers a parameter
file, `get_model_file` finds and checks it, `load_pretrained` loads it
into a block.  Nothing is downloaded.  The manifest and the files are
the JAX package's, so a file either package publishes loads in the
other (both write parameters in the same `.npz` layout).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

from ...base import MXNetError

__all__ = ["get_model_file", "publish_model_file", "purge",
           "load_pretrained"]

_MANIFEST = "manifest.json"


def _default_root():
    home = os.environ.get("MXNET_HOME",
                          os.path.join(os.path.expanduser("~"), ".mxnet"))
    return os.path.join(home, "models")


def _sha1(path):
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _read_manifest(root):
    path = os.path.join(root, _MANIFEST)
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise MXNetError(f"corrupt model-store manifest {path!r}: {e}")


def _write_manifest(root, manifest):
    """Replace the manifest atomically: a reader never sees half of it."""
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, os.path.join(root, _MANIFEST))


class _ManifestLock:
    """An flock around the manifest's read-modify-write, so concurrent
    publishers keep each other's entries."""

    def __init__(self, root):
        os.makedirs(root, exist_ok=True)
        self._path = os.path.join(root, _MANIFEST + ".lock")

    def __enter__(self):
        import fcntl
        self._f = open(self._path, "w")
        fcntl.flock(self._f, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        import fcntl
        fcntl.flock(self._f, fcntl.LOCK_UN)
        self._f.close()
        return False


def publish_model_file(name, params_path, root=None):
    """Copy a parameter file into the store under `name` and record its
    sha1; returns the stored path."""
    root = root or _default_root()
    if not os.path.exists(params_path):
        raise MXNetError(f"no such params file: {params_path!r}")
    sha1 = _sha1(params_path)
    fname = f"{name}-{sha1[:8]}.params"
    os.makedirs(root, exist_ok=True)
    dst = os.path.join(root, fname)
    if os.path.abspath(params_path) != os.path.abspath(dst):
        shutil.copyfile(params_path, dst)
    with _ManifestLock(root):
        manifest = _read_manifest(root)
        manifest[name] = {"file": fname, "sha1": sha1}
        _write_manifest(root, manifest)
    return dst


def get_model_file(name, root=None):
    """The path of `name`'s parameter file, after its sha1 is checked."""
    root = root or _default_root()
    manifest = _read_manifest(root)
    if name not in manifest:
        raise MXNetError(
            f"no pretrained weights for {name!r} in {root!r}: weights are "
            f"not downloaded; train the model and register the file with "
            f"gluon.model_zoo.model_store.publish_model_file")
    entry = manifest[name]
    path = os.path.join(root, entry["file"])
    if not os.path.exists(path):
        raise MXNetError(f"manifest entry for {name!r} points to missing "
                         f"file {path!r}")
    if _sha1(path) != entry["sha1"]:
        raise MXNetError(f"checksum mismatch for {path!r}: the file is "
                         f"corrupted; remove it or publish it again")
    return path


def purge(root=None):
    """Remove every stored parameter file and the manifest."""
    root = root or _default_root()
    if os.path.isdir(root):
        for f in os.listdir(root):
            if f.endswith(".params") or f == _MANIFEST:
                os.remove(os.path.join(root, f))


def load_pretrained(net, name, root=None, ctx=None):
    """Load `name`'s stored weights into `net`; parameters not yet
    initialized are created on `ctx` (the card by default)."""
    net.load_parameters(get_model_file(name, root), ctx=ctx)
    return net
