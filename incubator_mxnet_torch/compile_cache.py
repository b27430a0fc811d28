"""Persistent compile cache for the port's AOTInductor packages
(counterpart of `incubator_mxnet_tpu/compile_cache.py`).

`deploy.export_serving(..., platforms=)` and `deploy.export_training`
compile each package with AOTInductor, minutes apiece for BERT-base.
With ``MXNET_COMPILE_CACHE_DIR`` set, each finished package is kept in
a shared directory, and a later export of the same program (this
process or another) copies the package's bytes instead of compiling.

Key anatomy -- an entry is addressed by the sha256 of three parts, as
in the JAX package:

* **program fingerprint** -- sha256 of the exported program: its graph
  code, its input and output specs (names, shapes, dtypes, devices) and
  the values of any constants it lifted.  Parameters are inputs of the
  port's exported programs, so weights do not enter the key.
* **backend token** -- torch and CUDA versions, the card's name and
  compute capability, and this module's ``FORMAT_VERSION``.  Any
  component changing invalidates the key.
* **caller extra** -- a small JSON dict from the call site (the package
  file name, which names its platform, and the compile options).

Durability: writes go to a same-directory temporary file and then
``os.replace``, so a reader never sees a half-written entry and two
writers of one key leave one whole entry; every read re-validates the
magic, the header version, the lengths and the payload's sha256 (a bad
entry is unlinked and is a miss, never an error).  The directory is
LRU-capped at ``MXNET_COMPILE_CACHE_MAX_MB`` (default 1024): a hit
touches the entry, and a put that takes the directory over the cap
evicts the oldest entries.

Telemetry: ``compile_cache_hits`` / ``compile_cache_misses`` /
``compile_cache_bytes`` (+ errors, evictions); surfaced in
``/-/tunerz`` and `tools/diagnose.py`.
"""

import hashlib
import json
import os
import threading
import time

from . import telemetry as _telemetry
from .base import get_env

__all__ = ["enabled", "cache_dir", "max_bytes", "backend_token",
           "fingerprint", "cache_key", "get", "put", "note_compile",
           "stats", "entry_count", "total_bytes", "cachez",
           "FORMAT_VERSION"]

# Bump on any change to the entry layout or key derivation: old
# entries become unreachable (different key) AND unreadable (header
# check), both of which are misses.
FORMAT_VERSION = 1

_MAGIC = b"MXCT1\n"
_SUFFIX = ".cce"

_tm_hits = _telemetry.counter(
    "compile_cache_hits", "Persistent compile-cache hits")
_tm_misses = _telemetry.counter(
    "compile_cache_misses", "Persistent compile-cache misses (lookup "
    "ran with the cache enabled and found no loadable entry)")
_tm_bytes = _telemetry.gauge(
    "compile_cache_bytes", "Total bytes of cache entries on disk")
_tm_evictions = _telemetry.counter(
    "compile_cache_evictions", "Entries removed by the LRU size cap")
_tm_errors = _telemetry.counter(
    "compile_cache_errors", "Tolerated cache failures by kind "
    "(corrupt entry, io)", ("kind",))

_lock = threading.Lock()
_compile_seconds = 0.0      # compile wall paid by THIS process
_puts = 0


def enabled():
    """True when ``MXNET_COMPILE_CACHE_DIR`` names a cache directory."""
    return bool(get_env("MXNET_COMPILE_CACHE_DIR", ""))


def cache_dir():
    d = get_env("MXNET_COMPILE_CACHE_DIR", "")
    return os.path.abspath(d) if d else None


def max_bytes():
    return int(get_env("MXNET_COMPILE_CACHE_MAX_MB", 1024, float)
               * 1024 * 1024)


def backend_token():
    """Version/backend components of the key — anything that could
    change what a package holds or whether it loads."""
    import torch
    tok = {"format": FORMAT_VERSION, "torch": torch.__version__,
           "cuda": torch.version.cuda, "device_kind": "cpu",
           "capability": None}
    try:
        if torch.cuda.is_available():
            tok["device_kind"] = torch.cuda.get_device_name(0)
            tok["capability"] = "%d.%d" % torch.cuda.get_device_capability(0)
    except Exception:   # noqa: BLE001 — a probe must not raise
        pass
    return tok


def _spec_of(node):
    val = node.meta.get("val")
    shape = getattr(val, "shape", None)
    return [node.op, node.name,
            None if shape is None else [str(d) for d in shape],
            str(getattr(val, "dtype", None)),
            str(getattr(val, "device", None))]


def fingerprint(program):
    """sha256 of an exported program (`torch.export.ExportedProgram`):
    its graph code, the specs of its inputs and outputs, and the bytes
    of every constant it lifted — the program identity."""
    import torch
    h = hashlib.sha256()
    h.update(program.graph_module.code.encode())
    for node in program.graph.nodes:
        if node.op in ("placeholder", "output"):
            h.update(json.dumps(_spec_of(node)).encode())
    h.update(str(program.graph_signature).encode())
    for name, t in sorted({**program.state_dict,
                           **program.constants}.items()):
        h.update(name.encode())
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().contiguous().reshape(-1)
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def cache_key(program, extra=None):
    """Full entry key (hex sha256) for an exported program + caller
    extra.  See the module docstring for the key anatomy."""
    doc = {"fingerprint": fingerprint(program),
           "backend": backend_token(),
           "extra": extra or {}}
    blob = json.dumps(doc, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def _entry_path(key):
    return os.path.join(cache_dir(), key + _SUFFIX)


def _read_entry(path):
    """(header, blob) — raises on any inconsistency; the caller turns
    every raise into a miss."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError("bad magic")
        hlen = int.from_bytes(f.read(8), "big")
        if not 0 < hlen <= 1 << 20:
            raise ValueError("implausible header length")
        header = json.loads(f.read(hlen).decode())
        if header.get("version") != FORMAT_VERSION:
            raise ValueError("format version mismatch")
        blob = f.read(int(header["blob_len"]))
        if len(blob) != header["blob_len"] or f.read(1):
            raise ValueError("truncated or overlong entry")
        if hashlib.sha256(blob).hexdigest() != header.get("blob_sha256"):
            raise ValueError("payload checksum mismatch")
    return header, blob


def get(key):
    """The cached package bytes for `key`: ``(blob, stats)`` on a hit
    (stats as recorded at put time, plus ``"cache": "hit"``) or None on
    a miss.  A corrupt / truncated / stale-format entry is unlinked and
    reported as a miss — never an error."""
    if not enabled():
        return None
    path = _entry_path(key)
    if not os.path.exists(path):
        _tm_misses.inc()
        return None
    try:
        header, blob = _read_entry(path)
    except Exception:   # noqa: BLE001 — a bad entry is a miss
        _tm_errors.labels("corrupt").inc()
        _tm_misses.inc()
        try:
            os.unlink(path)
        except OSError:
            pass
        return None
    try:        # LRU recency: a hit is a touch
        os.utime(path, None)
    except OSError:
        pass
    _tm_hits.inc()
    stats = dict(header.get("stats") or {})
    stats["cache"] = "hit"
    return blob, stats


def put(key, blob, stats=None, compile_seconds=None):
    """Store `blob` (a package's bytes) under `key` (atomic rename; then
    LRU eviction).  Returns True when the entry landed."""
    global _puts
    if not enabled():
        return False
    header = {"version": FORMAT_VERSION, "key": key,
              "backend": backend_token(),
              "stats": dict(stats or {}),
              "compile_seconds": compile_seconds,
              "created": time.time(),
              "blob_len": len(blob),
              "blob_sha256": hashlib.sha256(blob).hexdigest()}
    hbytes = json.dumps(header, default=str).encode()
    d = cache_dir()
    path = _entry_path(key)
    # pid alone is not unique enough: two threads racing the same key
    # would share a temp file and one os.replace would lose it
    tmp = os.path.join(
        d, f".tmp-{os.getpid()}-{threading.get_ident()}-{key[:12]}")
    try:
        os.makedirs(d, exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(len(hbytes).to_bytes(8, "big"))
            f.write(hbytes)
            f.write(blob)
        os.replace(tmp, path)
    except OSError:
        _tm_errors.labels("io").inc()
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    with _lock:
        _puts += 1
    _evict(keep=path)
    return True


def _entries():
    """[(path, mtime, size)] for every entry in the cache dir."""
    d = cache_dir()
    out = []
    try:
        for name in os.listdir(d):
            if not name.endswith(_SUFFIX):
                continue
            p = os.path.join(d, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append((p, st.st_mtime, st.st_size))
    except OSError:
        pass
    return out


def _evict(keep=None):
    """Drop oldest-mtime entries until the directory fits the cap.
    The just-written entry (`keep`) goes last — it is only evicted if
    it alone exceeds the cap."""
    cap = max_bytes()
    entries = _entries()
    total = sum(s for _, _, s in entries)
    if total > cap:
        order = sorted(entries, key=lambda e: (e[0] == keep, e[1]))
        for path, _, size in order:
            if total <= cap:
                break
            try:
                os.unlink(path)
                total -= size
                _tm_evictions.inc()
            except OSError:
                pass
    _tm_bytes.set(max(0, total))


def note_compile(seconds):
    """Account compile wall paid by this process (cache on or off)."""
    global _compile_seconds
    with _lock:
        _compile_seconds += float(seconds)


def entry_count():
    return len(_entries()) if enabled() else 0


def total_bytes():
    return sum(s for _, _, s in _entries()) if enabled() else 0


def stats():
    """Process-local + on-disk view, for debugz/diagnose/smokes."""
    return {
        "enabled": enabled(),
        "dir": cache_dir(),
        "max_mb": round(max_bytes() / 1024 / 1024, 1),
        "hits": int(_tm_hits.value),
        "misses": int(_tm_misses.value),
        "puts": _puts,
        "evictions": int(_tm_evictions.value),
        "entries": entry_count(),
        "bytes": total_bytes(),
        "compile_seconds": round(_compile_seconds, 3),
    }


def cachez():
    """Debugz payload block (rides ``/-/tunerz``)."""
    s = stats()
    if s["enabled"]:
        s["backend"] = backend_token()
    return s


def _reset_for_tests():
    global _compile_seconds, _puts
    with _lock:
        _compile_seconds = 0.0
        _puts = 0
