"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C entry point.  It is
compiled at first use with `nvcc` for Hopper (`sm_90a`) into
`build/kernels/` at the repository root, a directory git ignores, and
loaded with ctypes.  The library's file name carries a hash of its
source and of the shared headers `csrc/*.cuh`, so an edited kernel is
rebuilt and a stale one is never loaded.
Nothing is built when a module is imported: a CPU-only machine without
`nvcc` imports every module and never calls this.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from .base import MXNetError

__all__ = ["SOURCES", "library", "build_all", "entry", "route", "stream"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("flash_short_fwd", "flash_short_bthd_bwd", "flash_fwd",
           "flash_bwd", "bottleneck_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
_entries = {}


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found: the port's CUDA kernels are built "
                     "at first use on a machine with the CUDA toolkit")


def _target(name):
    src = os.path.join(_CSRC, f"{name}.cu")
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(_CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start_build(name):
    """(process or None, target path, log path): None when the library
    is already built."""
    src, so = _target(name)
    if os.path.exists(so):
        return None, so, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    log = f"{so}.log"
    with open(log, "w") as out:
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=out, stderr=subprocess.STDOUT)
    return (proc, tmp), so, log


def _finish_build(name, job, so, log, timeout):
    proc, tmp = job
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise MXNetError(f"nvcc for {name} exceeded {timeout}s") from None
    with open(log) as f:
        text = f.read()
    if rc != 0:
        raise MXNetError(f"nvcc failed for {name} (exit {rc}):\n{text}")
    os.replace(tmp, so)
    return text


def build_all(names=SOURCES, timeout=600):
    """Compile every kernel library at once, one `nvcc` per source, all
    started together.  Returns {name: compiler output} for the sources
    it built (ptxas register and shared-memory reports)."""
    with _lock:
        jobs = {n: _start_build(n) for n in names}
        return {n: _finish_build(n, job, so, log, timeout)
                for n, (job, so, log) in jobs.items() if job is not None}


def library(name):
    """The loaded ctypes library of kernel `name`, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(_target(name)[1])
    return lib


def entry(name, fn_name, argtypes, restype=ctypes.c_int):
    """The C function `fn_name` of kernel library `name`, built and
    loaded at first use, with its ctypes signature set."""
    fn = _entries.get(fn_name)
    if fn is None:
        fn = getattr(library(name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _entries[fn_name] = fn
    return fn


def route(name, t, launch, plain):
    """launch() for a CUDA tensor or device `t`, plain() for a CPU one;
    any other device raises.  The wrappers' one dispatch rule: a CUDA
    tensor never reaches a plain version."""
    device = getattr(t, "device", t)
    if device.type == "cuda":
        return launch()
    if device.type == "cpu":
        return plain()
    raise MXNetError(f"{name}: no kernel for device {device}")


def stream(t):
    """The current CUDA stream of `t`'s device, as the int the C entry
    points take."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
