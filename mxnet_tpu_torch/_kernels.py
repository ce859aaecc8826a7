"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded
with ``ctypes``. The build happens at first use (or up front through
:func:`build`), from the sources in the checkout, into ``build/kernels/``
at the repository root; the library's file name carries a hash of its
source, of the headers beside it (``csrc/*.cuh``) and of the flags,
so an edited source or header is rebuilt and a stale library is never
loaded. Nothing here runs at import: this module imports on
machines without ``nvcc`` or a card, where only the kernels' plain
PyTorch versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build", "load"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# kernel library name -> its source under csrc/
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "bn_train": "bn_train.cu", "nms": "nms.cu",
           "multi_tensor": "multi_tensor.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built on this machine")


def _lib_path(name):
    """The library's path under ``BUILD_DIR``: its name carries a hash of
    its source, of every header under ``csrc/`` (a source may include
    any of them) and of the flags, so editing any of those rebuilds it."""
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")) + sorted(CSRC.glob("*.h")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest.hexdigest()[:12]))


def build(names=None):
    """Compile the named kernel libraries (default: all) that are not
    built yet, one ``nvcc`` per source, all started together. Returns
    ``{name: {"path", "seconds", "log"}}`` where ``log`` is nvcc's
    output (``-Xptxas -v``: registers, shared memory, spills) for the
    libraries built by this call. Raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    t0 = time.perf_counter()
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_suffix(".so.tmp%d" % os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (name, proc.returncode, log))
            continue
        os.replace(tmp, path)
        out[name] = {"path": str(path),
                     "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def _declare(name, lib):
    c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_fwd":
        lib.flash_fwd.argtypes = [c_p, c_p, c_p, c_p, c_p,   # q k v o lse
                                  c_i, c_i, c_i, c_i,        # bh t tk d
                                  c_f, c_i, c_i, c_i,        # scale causal
                                                             # window offset
                                  c_i, c_p]                  # dtype stream
        lib.flash_fwd.restype = c_i
    elif name == "flash_bwd":
        lib.flash_bwd.argtypes = [c_p, c_p, c_p, c_p,        # q k v do
                                  c_p, c_p,                  # lse delta
                                  c_p, c_p, c_p,             # dq dk dv
                                  c_p, c_p,                  # dq_acc turns
                                  c_i, c_i, c_i, c_i,        # bh t tk d
                                  c_f, c_i, c_i, c_i,        # scale causal
                                                             # window offset
                                  c_i, c_p]                  # dtype stream
        lib.flash_bwd.restype = c_i
    elif name == "bn_train":
        lib.bn_slabs.argtypes = [c_i, c_i, c_i]              # n c hw
        lib.bn_slabs.restype = c_i
        lib.bn_stats.argtypes = [c_p, c_p, c_p, c_p, c_p,    # x shift s1 s2
                                                             # work
                                 c_i, c_i, c_i, c_i, c_p]    # n c hw dtype
                                                             # stream
        lib.bn_stats.restype = c_i
        lib.bn_apply.argtypes = [c_p, c_p, c_p, c_p,         # x a b y
                                 c_i, c_i, c_i, c_i, c_p]    # n c hw dtype
                                                             # stream
        lib.bn_apply.restype = c_i
        lib.bn_bwd_reduce.argtypes = [c_p, c_p, c_p,         # dy x mean
                                      c_p, c_p, c_p,         # db dxc work
                                      c_i, c_i, c_i, c_i,    # n c hw dtype
                                      c_p]                   # stream
        lib.bn_bwd_reduce.restype = c_i
        lib.bn_bwd_dx.argtypes = [c_p, c_p, c_p, c_p, c_p,   # dy x a c2 b
                                  c_p, c_p,                  # mean dx
                                  c_i, c_i, c_i, c_i, c_p]   # n c hw dtype
                                                             # stream
        lib.bn_bwd_dx.restype = c_i
    elif name == "nms":
        # the threshold as c_float: rounded to f32 as jnp and torch round
        # a Python float compared with f32 values
        lib.nms_keep.argtypes = [c_p, c_p, c_p, c_p,          # boxes cls
                                                             # valid keep
                                 c_i, c_i, c_f, c_i, c_p]    # b a thr force
                                                             # stream
        lib.nms_keep.restype = c_i
        lib.nms_launch_shape.argtypes = [c_i, c_p]            # a out[4]
        lib.nms_launch_shape.restype = c_i
    elif name == "multi_tensor":
        c_ll = ctypes.c_longlong
        lib.multi_tensor_update.argtypes = [
            c_i, c_i, c_i, ctypes.POINTER(c_ll),             # kind dtype n
                                                             # sizes
            c_p, c_p, c_p, c_p,                              # w g s0 s1
            c_p, c_p, c_p,                                   # outs
            ctypes.POINTER(c_f),                             # hyper[9]
            c_p, c_p, c_p, c_p, c_i, c_p,                    # lr gscale inv
                                                             # flag donate
                                                             # stream
            ctypes.POINTER(c_i)]                             # launched
        lib.multi_tensor_update.restype = c_i
        lib.multi_tensor_norm_parts.argtypes = [c_i, ctypes.POINTER(c_ll)]
        lib.multi_tensor_norm_parts.restype = c_i
        lib.multi_tensor_norm_finite.argtypes = [
            c_i, c_i, ctypes.POINTER(c_ll), c_p,             # n grads sizes
                                                             # ptrs
            ctypes.POINTER(c_i), c_f, c_f, c_f,              # dtypes inject
                                                             # rescale clip
            c_p, c_p, c_p,                                   # inv partial okp
            c_p, c_p, c_p, c_p,                              # sumsq finite
                                                             # gscale stream
            ctypes.POINTER(c_i)]                             # launched
        lib.multi_tensor_norm_finite.restype = c_i
    lib.kernel_error_string.argtypes = [c_i]
    lib.kernel_error_string.restype = ctypes.c_char_p


def load(name):
    """The loaded library for kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build([name])[name]["path"]
            lib = ctypes.CDLL(path)
            _declare(name, lib)
            _loaded[name] = lib
        return lib


def check(lib, rc, what):
    """Raise if a kernel's C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d (%s)" % (
            what, rc, lib.kernel_error_string(rc).decode()))
