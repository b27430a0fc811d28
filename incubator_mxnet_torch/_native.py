"""Build and load the port's host libraries, and build the C ABI.

The sources `csrc/*.cc` (the JPEG codec, the RecordIO reader and writer,
the threaded image-record pipeline, the host dependency engine and the
pooled host storage) are host C++ with plain C entry points.  At first use they are compiled together by the host's C++
compiler (`c++ -O3 -std=c++17 -shared -fPIC -pthread`) into one library
under `build/host/` at the repository root, a directory git ignores, and
loaded with ctypes.  The file name carries a hash of the sources and of
its header `csrc/jpeg_codec.h`, so an edited source is rebuilt and a stale
library never loaded.  Every build here goes through `_build`, as the
kernels' do: a temporary file of its own renamed into place, and a
failed build raises with the compiler's output: nothing falls back to
another decoder.

`build_native()` builds the C ABI that runs `deploy` artifacts with no
Python in the process, into one directory `build/native/<hash>/` keyed
by the sources and the torch build:

    libmxtorch_infer.so   csrc/mxtorch_infer.cc, `c++ -std=c++20` against
                          torch's headers, linked to libtorch (and its
                          CUDA libraries where torch has them) with an
                          rpath to torch/lib
    serve_native          csrc/serve_main.cc, the CLI
    infer_test, train_test  csrc/infer_test.c, train_test.c, plain C
    libmxtorch_ops.so     with `cuda`: csrc/mxtorch_ops.cu by nvcc for
                          `sm_90a` against torch's headers, linked to
                          the short kernel's library that `_kernels`
                          builds and the Python wrappers load (an
                          rpath to build/kernels/)

The consumers link libmxtorch_infer with an rpath to their own
directory, where it loads libmxtorch_ops.so for a cuda session.  The
compiles that need nothing built start together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from . import _build
from .base import MXNetError

__all__ = ["SOURCES", "BUILD_DIR", "library", "entry", "build",
           "compiler_version", "openmp_compiler", "NATIVE_SOURCES",
           "build_native"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")
SOURCES = ("jpeg_codec.cc", "recordio.cc", "image_pipeline.cc",
           "engine.cc", "storage.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off")

_lock = threading.Lock()
_lib = None
_entries = {}
_omp_cxx = None


def _compiler():
    for cand in (os.environ.get("CXX"), shutil.which("c++"),
                 shutil.which("g++"), shutil.which("clang++")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("no C++ compiler (c++) found: the port's host "
                     "libraries (csrc/*.cc) are built at first use")


def openmp_compiler():
    """The first C++ compiler of $CXX, g++ and c++ that links an OpenMP
    program: AOTInductor builds every package with `-fopenmp`, and a
    compiler named by $CXX may lack OpenMP's spec file.  Probed once a
    process (a tiny program under `build/host/`)."""
    global _omp_cxx
    if _omp_cxx is None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        probe = os.path.join(BUILD_DIR, f"omp-probe-{os.getpid()}")
        with open(probe + ".cc", "w") as f:
            f.write("#include <omp.h>\nint main() { return "
                    "omp_get_max_threads() > 0 ? 0 : 1; }\n")
        tried = []
        try:
            for cand in (os.environ.get("CXX"), shutil.which("g++"),
                         shutil.which("c++")):
                if not cand or cand in tried or not os.path.exists(cand):
                    continue
                tried.append(cand)
                r = subprocess.run([cand, "-fopenmp", probe + ".cc", "-o",
                                    probe], capture_output=True, timeout=120)
                if r.returncode == 0:
                    _omp_cxx = cand
                    break
        finally:
            for path in (probe, probe + ".cc"):
                if os.path.exists(path):
                    os.remove(path)
        if _omp_cxx is None:
            raise MXNetError(f"no C++ compiler links an OpenMP program "
                             f"(tried {tried}): AOTInductor needs one")
    return _omp_cxx


def compiler_version():
    """The first line of the compiler's `--version`."""
    out = subprocess.run([_compiler(), "--version"], capture_output=True,
                         text=True, timeout=60)
    return (out.stdout or out.stderr).splitlines()[0].strip()


def _target():
    h = hashlib.sha256()
    headers = ["jpeg_codec.h"]
    for name in list(SOURCES) + headers:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmxhost-{h.hexdigest()[:16]}.so")


def build(timeout=600):
    """Compile the host library unless it is on disk (`_build`).
    Returns {"built": bool, "seconds": float, "path": str}."""
    so = _target()
    srcs = [os.path.join(_CSRC, s) for s in SOURCES]
    t0 = time.perf_counter()
    job = _build.start(so, lambda tmp: [_compiler(), *CXX_FLAGS, "-o", tmp,
                                        *srcs], "the host library")
    _build.finish([job], timeout)
    return {"built": job is not None, "seconds": time.perf_counter() - t0,
            "path": so}


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


# ---------------------------------------------------------------------
# the C ABI (`build_native`)
# ---------------------------------------------------------------------

NATIVE_SOURCES = ("mxtorch_infer.h", "mxtorch_infer.cc", "native_consumer.h",
                  "serve_main.cc", "infer_test.c", "train_test.c",
                  "mxtorch_ops.cu")
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
_CONSUMERS = {"serve_native": "serve_main.cc", "infer_test": "infer_test.c",
              "train_test": "train_test.c"}


def _torch_paths():
    """(include dirs, library dir, link flags, ABI define) of the
    installed torch."""
    import torch
    root = os.path.dirname(torch.__file__)
    inc = os.path.join(root, "include")
    lib = os.path.join(root, "lib")
    libs = ["torch", "torch_cpu", "c10"] + [
        n for n in ("torch_cuda", "c10_cuda")
        if os.path.exists(os.path.join(lib, f"lib{n}.so"))]
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"
    return ([inc, os.path.join(inc, "torch", "csrc", "api", "include")], lib,
            [f"-L{lib}", f"-Wl,-rpath,{lib}", "-Wl,--no-as-needed",
             *(f"-l{n}" for n in libs), "-Wl,--as-needed", "-ldl"], abi)


def native_dir():
    """build/native/<hash of the sources, the short kernel's library name
    (itself a hash of its source) and the torch build>."""
    import torch
    from ._kernels import _target as kernel_target
    h = hashlib.sha256()
    for name in NATIVE_SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(os.path.basename(kernel_target("flash_short_fwd")[1]).encode())
    h.update(f"{torch.__version__} {torch.version.cuda}".encode())
    return os.path.join(NATIVE_DIR, h.hexdigest()[:16])


def _cc():
    for cand in (os.environ.get("CC"), shutil.which("cc"), shutil.which("gcc")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("no C compiler (cc) found: the C ABI's consumers are "
                     "built at first use")


def build_native(cuda=None, timeout=900):
    """Build the C ABI unless it is on disk (the module docstring), every
    compile started as soon as what it links against exists (`_build`).
    `cuda` (default: whether torch sees a CUDA device) adds
    libmxtorch_ops.so, which needs nvcc.  Returns {"dir": the directory,
    "seconds": {part: seconds from the start until it was built}} (empty
    for parts on disk).  A failed build raises with the compiler's
    output."""
    import torch
    from . import _kernels
    if cuda is None:
        cuda = torch.cuda.is_available()
    d = native_dir()
    incs, lib, link, abi = _torch_paths()
    isys = [f"-I{i}" for i in incs]
    t0 = time.perf_counter()
    seconds = {}

    def done(jobs, part):
        if _build.finish(jobs, timeout):
            seconds[part] = time.perf_counter() - t0

    infer = _build.start(
        os.path.join(d, "libmxtorch_infer.so"),
        lambda tmp: [_compiler(), "-std=c++20", "-O2", "-shared", "-fPIC",
                     abi, *isys, "-o", tmp,
                     os.path.join(_CSRC, "mxtorch_infer.cc"), *link],
        "libmxtorch_infer.so")
    ops = os.path.join(d, "libmxtorch_ops.so")
    ops_obj = os.path.join(d, "mxtorch_ops.o")
    obj = None
    if cuda and not os.path.exists(ops):
        flags = [f for f in _kernels.NVCC_FLAGS
                 if f not in ("-shared", "-std=c++17")]
        obj = _build.start(
            ops_obj, lambda tmp: [_kernels._nvcc(), *flags, "-std=c++20", abi,
                                  *isys, "-c", "-o", tmp,
                                  os.path.join(_CSRC, "mxtorch_ops.cu")],
            "mxtorch_ops.o")
    done([infer], "libmxtorch_infer.so")
    consumers = []
    for exe, src in _CONSUMERS.items():
        cc = [_compiler(), "-std=c++20"] if src.endswith(".cc") else \
            [_cc(), "-std=c11", "-D_GNU_SOURCE"]
        consumers.append(_build.start(
            os.path.join(d, exe),
            lambda tmp, cc=cc, src=src: [
                *cc, "-O2", f"-I{_CSRC}", "-o", tmp,
                os.path.join(_CSRC, src), f"-L{d}", "-lmxtorch_infer",
                "-Wl,-rpath,$ORIGIN", "-ldl"], exe))
    if cuda:
        # the short kernel's own library, as the Python wrappers load it
        kernel = _kernels.library_path("flash_short_fwd")
        done([obj], "mxtorch_ops.o")
        kdir = os.path.relpath(os.path.dirname(kernel), d)
        done([_build.start(ops, lambda tmp: [
            _kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-shared", "-o", tmp, ops_obj,
            f"-L{os.path.dirname(kernel)}", "-Xlinker",
            f"-l:{os.path.basename(kernel)}", "-Xlinker",
            f"-rpath,$ORIGIN/{kdir}", f"-L{lib}", "-Xlinker",
            f"-rpath,{lib}", "-ltorch", "-ltorch_cpu", "-lc10",
            "-ltorch_cuda", "-lc10_cuda"], "libmxtorch_ops.so")],
            "libmxtorch_ops.so")
    done(consumers, "consumers")
    return {"dir": d, "seconds": seconds}
