"""Native (C++) host components of the data plane, built with g++ at
first use: ``recordio.cc`` (the mmap'd RecordIO scanner behind
``NativeRecordFile``) and ``imgdecode.cc`` (the batched JPEG/PNG decode,
crop, resize and mirror behind ``image.native_decode``). They are copies
of the JAX package's sources, built with its g++ flags, so both packages
decode the same bytes to the same pixels.

A library is built into ``build/native/`` at the repository root (never
beside the sources); its file name carries a hash of its source and of
its flags, so an edited source is rebuilt and a stale library is never
loaded. The compiler writes a per-process temporary name that is then
renamed, so concurrent first builds do not clash. A source's
``// LINK: -lfoo`` comment gives its link flags. Where the machine has
no development files for a library named there (no header, no
``libfoo.so``), the build links the copy that Pillow's wheel ships
(``pillow.libs/libfoo-<hash>.so.<n>``) and takes the declarations from
``compat/`` (searched after the system's include directories).

Every native path has a Python fallback: without a toolchain the
readers and the decoder run in Python and PIL, slower and otherwise the
same. Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CXX_FLAGS", "load", "NativeRecordFile"]

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIBS = {}


def _link_flags(src):
    """Extra linker flags from a leading '// LINK: -lfoo -lbar' comment."""
    try:
        with open(src) as f:
            for line in f.read(4096).splitlines():
                if line.startswith("// LINK:"):
                    return line.split(":", 1)[1].split()
    except OSError:
        pass
    return []


def _wheel_libs(flags):
    """The link flags with each ``-lfoo`` replaced by the path of the
    ``libfoo`` that Pillow's wheel ships, plus an rpath to it and the
    ``compat/`` headers; None when a library has no such copy."""
    try:
        import PIL
    except ImportError:
        return None
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    out, dirs = [], set()
    for flag in flags:
        if not flag.startswith("-l"):
            out.append(flag)
            continue
        pat = re.compile(r"lib%s\d*-[0-9a-f]+\.so" % re.escape(flag[2:]))
        found = sorted(p for p in glob.glob(os.path.join(libs, "*.so*"))
                       if pat.match(os.path.basename(p)))
        if not found:
            return None
        out.append(found[0])
        dirs.add(libs)
    return ["-idirafter", str(_DIR / "compat")] + out + \
        ["-Wl,-rpath,%s" % d for d in sorted(dirs)]


def _lib_path(name, flags):
    digest = hashlib.sha256((_DIR / (name + ".cc")).read_bytes())
    digest.update(" ".join(flags).encode())
    if "-idirafter" in flags:
        for header in sorted((_DIR / "compat").glob("*.h")):
            digest.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest.hexdigest()[:12]))


def _candidates(name):
    """(path, extra flags) of each way to build <name>.cc: the system's
    libraries first, then the copies in Pillow's wheel."""
    link = _link_flags(_DIR / (name + ".cc"))
    tries = [link]
    wheel = _wheel_libs(link) if link else None
    if wheel is not None:
        tries.append(wheel)
    return [(_lib_path(name, list(CXX_FLAGS) + extra), extra)
            for extra in tries]


def _build(name, path, extra):
    """Compile <name>.cc into ``path``; False on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # per-process temp name: concurrent first-use builds (e.g. loader
    # worker processes) must not interleave writes
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_DIR / (name + ".cc")), "-o",
                        tmp] + extra, check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, path)
        return True
    except Exception:  # noqa: BLE001 — try the next way, else Python
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def load(name):
    """ctypes handle for the library of <name>.cc (cached), built at first
    use; None if no way of building it gives a library that loads here
    (callers fall back to Python). Libraries built already (one copied
    from another machine may not find its libraries here) are tried
    before any build."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        lib = None
        cands = _candidates(name)
        for path, extra in sorted(cands, key=lambda c: not c[0].exists()):
            if not path.exists() and not _build(name, path, extra):
                continue
            try:
                lib = ctypes.CDLL(str(path))
                break
            except OSError:
                continue
        _LIBS[name] = lib
        return lib


_MAGIC_BYTES = b"\x0a\x23\xd7\xce"


class NativeRecordFile:
    """mmap-backed access to a .rec file: the C++ scanner builds the
    record index once (recordio.cc); the exported offset table lets
    reads slice a Python mmap directly — zero per-record FFI, one
    memcpy per record. Raises ImportError when the native library is
    unavailable and IOError when the scan refuses the file (torn or not
    RecordIO) — callers catch and fall back to the Python reader."""

    def __init__(self, path):
        import mmap as _mmap

        import numpy as np

        lib = load("recordio")
        if lib is None:
            raise ImportError("native recordio library unavailable")
        lib.rio_open.restype = ctypes.c_void_p
        lib.rio_open.argtypes = [ctypes.c_char_p]
        lib.rio_count.restype = ctypes.c_long
        lib.rio_count.argtypes = [ctypes.c_void_p]
        lib.rio_num_parts.restype = ctypes.c_long
        lib.rio_num_parts.argtypes = [ctypes.c_void_p]
        lib.rio_export.argtypes = [ctypes.c_void_p] + \
            [np.ctypeslib.ndpointer(np.int64)] * 4
        lib.rio_close.argtypes = [ctypes.c_void_p]

        handle = lib.rio_open(path.encode())
        if not handle:
            raise IOError("cannot open/scan %r" % path)
        try:
            count = lib.rio_count(handle)
            n_parts = lib.rio_num_parts(handle)
            rec_starts = np.empty(count + 1, np.int64)
            part_offs = np.empty(max(n_parts, 1), np.int64)
            part_lens = np.empty(max(n_parts, 1), np.int64)
            hdr_offs = np.empty(max(count, 1), np.int64)
            lib.rio_export(handle, rec_starts, part_offs, part_lens,
                           hdr_offs)
        finally:
            lib.rio_close(handle)
        # plain lists: scalar indexing in the per-record hot loop is
        # ~3x faster than numpy item access
        self._rec_starts = rec_starts.tolist()
        self._part_ends = (part_offs + part_lens).tolist()
        self._part_offs = part_offs.tolist()
        self._hdr_offs = hdr_offs[:count]

        self._count = count
        self._file = open(path, "rb")
        self._mm = _mmap.mmap(self._file.fileno(), 0,
                              access=_mmap.ACCESS_READ)
        self.size = self._mm.size()
        self.path = path

    def __len__(self):
        return self._count

    def read(self, i):
        """Assembled payload bytes of record ``i``."""
        if not 0 <= i < self._count:
            raise IndexError(i)
        lo, hi = self._rec_starts[i], self._rec_starts[i + 1]
        if hi == lo + 1:                       # common case: one part
            return self._mm[self._part_offs[lo]:self._part_ends[lo]]
        parts = [self._mm[self._part_offs[p]:self._part_ends[p]]
                 for p in range(lo, hi)]
        return _MAGIC_BYTES.join(parts)

    def find_offset(self, offset):
        """Record ordinal whose header lives at byte ``offset`` (the
        .idx sidecar stores these), or -1."""
        import numpy as np
        i = int(np.searchsorted(self._hdr_offs, offset))
        if i < self._count and self._hdr_offs[i] == offset:
            return i
        return -1

    def offset(self, i):
        return int(self._hdr_offs[i]) if 0 <= i < self._count else -1

    def close(self):
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._file.close()
            self._mm = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
