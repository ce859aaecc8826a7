"""NDArray — the minimal PyTorch twin of ``mxnet_tpu/ndarray/ndarray.py``.

An ``NDArray`` wraps one ``torch.Tensor`` (``.handle``) and reports its
shape, dtype and context; ``asnumpy`` copies to the host, turning bf16
into float32 there because numpy has no bf16. ``arr[key] = value``
writes into the backing tensor in place (the JAX package swaps in a new
immutable array; the effect on the NDArray is the same), which is how
initializers fill ``zeros`` arrays. ``save`` / ``load`` read and write
the JAX package's ``.npz`` format both ways. Operator methods, the eager
``mx.nd.*`` namespace and autograd come with ROADMAP Queue A item 1.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..base import np_dtype, torch_dtype
from ..context import context_of, current_context

__all__ = ["NDArray", "array", "zeros", "load", "save"]


class NDArray:
    """An n-dimensional array on one device, backed by a torch tensor."""

    __slots__ = ("_data", "__weakref__")

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        if ctx is not None:
            data = data.to(ctx.torch_device())
        self._data = data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype, or ``torch.bfloat16`` for bf16 (numpy has none)."""
        return np_dtype(self._data.dtype)

    @property
    def context(self):
        return context_of(self._data.device)

    @property
    def handle(self):
        """The backing torch.Tensor."""
        return self._data

    def asnumpy(self):
        """A fresh host copy; bf16 becomes float32."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def __setitem__(self, key, value):
        """Write ``value`` (a scalar, numpy array, NDArray or tensor,
        broadcast to the indexed shape and cast to this array's dtype)
        into the array in place."""
        if isinstance(key, NDArray):
            key = key._data
        if isinstance(value, NDArray):
            value = value._data
        if not isinstance(value, (torch.Tensor, float, int, bool)):
            value = _from_numpy(np.asarray(value))
        if isinstance(value, torch.Tensor):
            value = value.to(device=self._data.device,
                             dtype=self._data.dtype)
        self._data[key] = value

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(d) for d in self.shape),
                                     self.context)


def _wrap(data):
    return NDArray(data)


def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` (default: the current context, gpu(0) unless
    a ``with mx.cpu():`` scope says otherwise). Like the reference,
    float64 sources become float32 and int64 become int32 unless
    ``dtype`` is given."""
    ctx = ctx or current_context()
    if isinstance(source_array, NDArray):
        data = source_array._data
    elif isinstance(source_array, torch.Tensor):
        data = source_array
    else:
        src = np.asarray(source_array)
        if dtype is None:
            if src.dtype == np.float64:
                src = src.astype(np.float32)
            elif src.dtype == np.int64:
                src = src.astype(np.int32)
        data = _from_numpy(src)
    if dtype is not None:
        data = data.to(torch_dtype(dtype))
    return NDArray(data, ctx=ctx)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    """A zero-filled NDArray on ``ctx`` (default: the current context)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.zeros(shape, dtype=torch_dtype(dtype)),
                   ctx=ctx or current_context())


def _from_numpy(arr):
    """Host tensor from a numpy array. A 2-byte void array is bf16 as the
    JAX package saves it (ml_dtypes bfloat16 lands in .npz as raw |V2)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _to_numpy_exact(data):
    """Host numpy copy for saving: bf16 stays bf16, as raw |V2 words —
    the bytes the JAX package's save writes for an ml_dtypes array."""
    t = data.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")).copy()
    return t.numpy()


# ---------------------------------------------------------------------------
# save / load — the JAX package's .npz container: a dict saves under its
# keys, a list under "__mx_list__:<i>" keys (ndarray.py:624-705).
# ---------------------------------------------------------------------------

_SAVE_LIST_PREFIX = "__mx_list__:"
_SPARSE_NS = "__mx_sparse__"


def _payload_entry(payload, key, v):
    if key.startswith(_SPARSE_NS):
        raise ValueError("array names must not start with %r (reserved "
                         "for the sparse save format)" % _SPARSE_NS)
    payload[key] = _to_numpy_exact(v._data) if isinstance(v, NDArray) \
        else np.asarray(v)


def save(fname, data):
    if isinstance(data, NDArray):
        data = [data]
    payload = {}
    if isinstance(data, dict):
        for k, v in data.items():
            _payload_entry(payload, k, v)
    elif isinstance(data, (list, tuple)):
        for i, v in enumerate(data):
            _payload_entry(payload, _SAVE_LIST_PREFIX + str(i), v)
    else:
        raise ValueError("data must be NDArray, list of NDArrays or dict")
    with open(fname, "wb") as f:
        np.savez(f, **payload)


def load(fname, ctx=None):
    """Arrays saved by ``save`` (either package) as a dict or a list, on
    ``ctx`` (default: the current context). Sparse entries wait for the
    sparse storage types."""
    with np.load(fname, allow_pickle=False) as npz:
        if _SPARSE_NS + ".manifest" in npz.files:
            manifest = json.loads(bytes(npz[_SPARSE_NS + ".manifest"])
                                  .decode())
            raise NotImplementedError(
                "%s holds sparse arrays %r; sparse storage is not ported "
                "yet (ROADMAP Queue A item 10)"
                % (fname, [m["key"] for m in manifest]))
        entries = {k: NDArray(_from_numpy(npz[k]), ctx=ctx or
                              current_context())
                   for k in npz.files}
    if entries and all(k.startswith(_SAVE_LIST_PREFIX) for k in entries):
        order = sorted(entries,
                       key=lambda k: int(k[len(_SAVE_LIST_PREFIX):]))
        return [entries[k] for k in order]
    return entries
