"""Build and load the port's host libraries.

The sources `csrc/*.cc` (the JPEG codec, the RecordIO reader and writer
and the threaded image-record pipeline) are host C++ with plain C entry
points.  At first use they are compiled together by the host's C++
compiler (`c++ -O3 -std=c++17 -shared -fPIC -pthread`) into one library
under `build/host/` at the repository root, a directory git ignores, and
loaded with ctypes.  The file name carries a hash of the sources and of
the headers `csrc/*.h`, so an edited source is rebuilt and a stale
library never loaded.  Each build writes a temporary file of its own and
renames it into place, so processes that start together (test workers)
never load a half-written library.  A failed build raises with the
compiler's output: nothing falls back to another decoder.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .base import MXNetError

__all__ = ["SOURCES", "BUILD_DIR", "library", "entry", "build",
           "compiler_version"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")
SOURCES = ("jpeg_codec.cc", "recordio.cc", "image_pipeline.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off")

_lock = threading.Lock()
_lib = None
_entries = {}


def _compiler():
    for cand in (os.environ.get("CXX"), shutil.which("c++"),
                 shutil.which("g++"), shutil.which("clang++")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("no C++ compiler (c++) found: the port's host "
                     "libraries (csrc/*.cc) are built at first use")


def compiler_version():
    """The first line of the compiler's `--version`."""
    out = subprocess.run([_compiler(), "--version"], capture_output=True,
                         text=True, timeout=60)
    return (out.stdout or out.stderr).splitlines()[0].strip()


def _target():
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".h"))
    for name in list(SOURCES) + headers:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmxhost-{h.hexdigest()[:16]}.so")


def build(timeout=600):
    """Compile the host library unless it is on disk.  Returns
    {"built": bool, "seconds": float, "path": str}."""
    so = _target()
    if os.path.exists(so):
        return {"built": False, "seconds": 0.0, "path": so}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
    srcs = [os.path.join(_CSRC, s) for s in SOURCES]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp, *srcs],
                              capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        raise MXNetError(f"building the host library exceeded {timeout}s"
                         ) from None
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise MXNetError(f"building the host library failed (exit "
                         f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return {"built": True, "seconds": time.perf_counter() - t0, "path": so}


def library():
    """The loaded host library, built if needed."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                build()
                _lib = ctypes.CDLL(_target())
    return _lib


def entry(fn_name, argtypes, restype=ctypes.c_int):
    """The C function `fn_name` of the host library with its signature
    set, built and loaded at first use."""
    fn = _entries.get(fn_name)
    if fn is None:
        fn = getattr(library(), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _entries[fn_name] = fn
    return fn
