"""ctypes wrapper for the native batched image decoder
(_native/imgdecode.cc — the analogue of ImageRecordIOParser2's OMP
decode+augment loop, src/io/iter_image_recordio_2.cc:121-319).

One FFI call decodes, crops, bilinear-resizes, and optionally mirrors a
whole batch on a C++ thread pool, writing straight into one HWC uint8
buffer — the Python side only computes crop rectangles (cheap RNG) and
does the final vectorized normalize/transpose.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import _native

_lib = None
_checked = False


def _load():
    global _lib, _checked
    if not _checked:
        _checked = True
        lib = _native.load("imgdecode")
        if lib is not None:
            lib.imgd_probe.restype = ctypes.c_int
            lib.imgd_probe.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int32)]
            lib.imgd_batch.restype = ctypes.c_int
            lib.imgd_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                np.ctypeslib.ndpointer(np.int64),
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.float32),
                np.ctypeslib.ndpointer(np.uint8),
                ctypes.c_int, ctypes.c_int,
                np.ctypeslib.ndpointer(np.uint8),
                ctypes.c_int]
        _lib = lib
    return _lib


def available():
    return _load() is not None


def probe(buf):
    """(height, width) from the image header, or None if undecodable."""
    lib = _load()
    hw = np.empty(2, np.int32)
    if lib is None or lib.imgd_probe(bytes(buf), len(buf), hw) != 0:
        return None
    return int(hw[0]), int(hw[1])


def decode_batch(buffers, rects, flips, out_hw, n_threads=4):
    """Decode+crop+resize a list of encoded buffers.

    rects: (n, 4) float32 [x0, y0, cw, ch] in source pixels (cw<=0 means
    whole image); flips: (n,) uint8; out_hw: (H, W) output size.
    Returns (n, H, W, 3) uint8. Raises RuntimeError naming the first
    record that failed to decode.
    """
    lib = _load()
    if lib is None:
        raise ImportError("native image decoder unavailable")
    n = len(buffers)
    oh, ow = out_hw
    bufs = [bytes(b) for b in buffers]
    arr = (ctypes.c_char_p * n)(*bufs)
    lens = np.array([len(b) for b in bufs], np.int64)
    rects = np.ascontiguousarray(rects, np.float32)
    flips = np.ascontiguousarray(flips, np.uint8)
    out = np.empty((n, oh, ow, 3), np.uint8)
    rc = lib.imgd_batch(arr, lens, n, rects, flips, oh, ow, out,
                        int(n_threads))
    if rc != 0:
        raise RuntimeError("native decode failed for record %d of the "
                           "batch" % (rc - 1))
    return out
