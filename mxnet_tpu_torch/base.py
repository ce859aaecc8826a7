"""Shared plumbing: the framework's error type, dtype resolution and the
guard every CUDA-graph capture runs under.

The PyTorch twin of ``mxnet_tpu/base.py``. Dtypes resolve to
``torch.dtype`` here, because numpy has no bfloat16.
"""
from __future__ import annotations

import contextlib
import gc

import numpy as np
import torch

__all__ = ["MXNetError", "string_types", "numeric_types", "torch_dtype",
           "np_dtype", "_as_list"]


class MXNetError(RuntimeError):
    """Error raised by the framework (reference: base.py MXNetError)."""


string_types = (str,)
numeric_types = (float, int, np.generic)

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def torch_dtype(dtype):
    """Normalize user dtype input (torch dtype, np dtype, type, or a
    string such as 'float32' / 'bfloat16') to a ``torch.dtype``.
    ``None`` means float32, the framework default."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16" or \
            getattr(dtype, "name", "") == "bfloat16":
        return torch.bfloat16
    return _NP_TO_TORCH[np.dtype(dtype)]


def np_dtype(dtype):
    """The numpy dtype for a torch dtype, or ``torch.bfloat16`` itself
    for bf16, which numpy lacks."""
    dtype = torch_dtype(dtype)
    if dtype == torch.bfloat16:
        return torch.bfloat16
    return _TORCH_TO_NP[dtype]


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return [obj]


@contextlib.contextmanager
def gc_paused():
    """The cyclic garbage collector off for a block: a CUDA graph's
    capture. A collection during a capture that frees an earlier graph
    (one held in a reference cycle) destroys that graph's executable on
    the capturing thread, which invalidates the capture
    (cudaErrorStreamCaptureInvalidated). ``torch.cuda.graph`` collects
    once before it starts capturing; this keeps it from collecting
    inside."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()
