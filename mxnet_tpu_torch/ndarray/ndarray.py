"""NDArray — the PyTorch twin of ``mxnet_tpu/ndarray/ndarray.py``.

An ``NDArray`` wraps one ``torch.Tensor`` (``.handle``) and reports its
shape, dtype and context; ``asnumpy`` copies to the host, turning bf16
into float32 there because numpy has no bf16. As in the JAX package,
whose arrays are immutable, an NDArray's tensor is never written in
place: ``arr[key] = value``, ``x += 1``, ``out=`` and the aux-state
writebacks give the array a new tensor (``_set_data``). So two arrays
that share storage (a reshape is a view) never see each other's writes,
and a tensor that an autograd graph saved stays as it was.

Operator methods (``x.sum()``, ``x + y``, ``x.exp()`` ...) go through the
shared op registry (``ops.registry.invoke_eager``), so eager and symbolic
code run the same functions and kernels and autograd sees every call.
``attach_grad``/``backward`` are ``autograd``'s. ``save``/``load`` read
and write the JAX package's ``.npz`` format both ways, sparse entries
included. The sparse storage types (``sparse.py``) subclass NDArray;
``tostype`` converts between them, and a dense array is never copied into
sparse storage.
"""
from __future__ import annotations

import functools
import json

import numpy as np
import torch

from ..base import MXNetError, np_dtype, numeric_types, torch_dtype
from ..context import Context, context_of, current_context
from ..ops import registry as _reg
from ..ops.matrix import _getitem, _normalize_index

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "zeros_like", "ones_like", "concatenate", "waitall", "load",
           "save", "moveaxis", "onehot_encode"]


class NDArray:
    """An n-dimensional array on one device, backed by a torch tensor."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    # numpy should defer to us in mixed expressions
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        if ctx is not None:
            data = data.to(ctx.torch_device())
        self._data = data
        self._grad = None
        self._grad_req = "null"

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype, or ``torch.bfloat16`` for bf16 (numpy has none)."""
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return context_of(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def handle(self):
        """The backing torch.Tensor."""
        return self._data

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        return self.transpose()

    # -- data movement ------------------------------------------------------
    def _set_data(self, data):
        """Give the array a new tensor. A marked variable gets a fresh
        leaf holding it (autograd: the old leaf, which a graph may hold,
        is never written)."""
        from ..autograd import _is_variable, _leaf_for
        self._data = _leaf_for(self, data) if _is_variable(self) else data

    def asnumpy(self):
        """A fresh host copy; bf16 becomes float32. One counted blocking
        host sync (``profiler.host_sync_count``)."""
        from ..profiler import count_host_sync
        count_host_sync("asnumpy")
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def wait_to_read(self):
        from ..profiler import count_host_sync
        count_host_sync("wait")
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    def copy(self):
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        if isinstance(other, NDArray):
            if other.stype != "default":
                raise TypeError(
                    "cannot copy a dense array into %s storage — cast "
                    "with tostype(%r) instead"
                    % (type(other).__name__, other.stype))
            other._set_data(self._data.detach().to(other._data.device,
                                                   copy=True))
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True))
        raise TypeError("copyto does not support type %s" % type(other))

    def as_in_context(self, context):
        if context == self.context:
            return self
        return NDArray(self._data.detach().to(context.torch_device()))

    def astype(self, dtype, copy=True):
        dt = torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return NDArray(self._data.detach().to(dt, copy=True))

    def detach(self):
        return NDArray(self._data.detach())

    def tostype(self, stype):
        from .sparse import tostype as _tostype
        return _tostype(self, stype)

    # -- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Give the array a zero gradient buffer and make it a variable
        of later ``autograd.record()`` scopes."""
        from ..autograd import mark_variables
        mark_variables([self], [NDArray(torch.zeros_like(
            self._data.detach()))], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # -- printing / conversion ---------------------------------------------
    def __repr__(self):
        shape_info = "x".join(str(s) for s in self.shape)
        return "\n%s\n<%s %s @%s>" % (self.asnumpy(), type(self).__name__,
                                      shape_info, self.context)

    __str__ = __repr__

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __getstate__(self):
        return {"data": self.asnumpy(), "dtype": str(self._data.dtype),
                "device": str(self._data.device)}

    def __setstate__(self, state):
        data = torch.from_numpy(state["data"])
        dt = state.get("dtype")
        if dt == "torch.bfloat16":
            data = data.to(torch.bfloat16)
        self._data = data.to(state.get("device", "cpu"))
        self._grad = None
        self._grad_req = "null"

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, key):
        from .. import autograd
        if isinstance(key, NDArray):
            key = key._data
        if isinstance(key, (torch.Tensor, np.ndarray)):
            key = torch.as_tensor(key)
            if key.dtype == torch.bool:
                raise NotImplementedError(
                    "boolean-mask indexing gives a data-dependent shape, "
                    "which the JAX package cannot compile either; use "
                    "nd.where instead")
            # advanced (integer array) indexing along axis 0 == take
            return _op("take")(self, _wrap(key.to(self._data.device)),
                               axis=0)
        norm = _normalize_index(key)
        if autograd.is_recording():
            return _op("_index")(self, index=norm)
        with torch.no_grad():
            return _wrap(_getitem(self._data, key).detach())

    def __setitem__(self, key, value):
        """Write ``value`` (a scalar, numpy array, NDArray or tensor,
        broadcast to the indexed shape and cast to this array's dtype)
        into a new tensor for this array."""
        from .. import autograd
        if autograd.is_recording() and self._data.grad_fn is not None:
            raise MXNetError(
                "in-place assignment to an array produced inside "
                "autograd.record() would silently corrupt gradients; "
                "compute a new array instead (e.g. via nd.where)")
        if isinstance(key, NDArray):
            key = key._data
        if isinstance(value, NDArray):
            value = value._data
        if not isinstance(value, (torch.Tensor, float, int, bool)):
            value = _from_numpy(np.asarray(value))
        if isinstance(value, torch.Tensor):
            value = value.detach().to(device=self._data.device,
                                      dtype=self._data.dtype)
        with torch.no_grad():
            old = self._data.detach()
            if isinstance(key, slice) and key == slice(None):
                new = torch.empty_like(old)
                new[...] = value
            elif not _has_negative_step(key):
                new = old.clone()
                new[key] = value
            else:
                # torch's slices take positive steps only: write through
                # the flat positions _getitem selects
                new = old.clone()
                pos = _getitem(torch.arange(old.numel(), device=old.device)
                               .reshape(old.shape), key)
                src = torch.as_tensor(value, dtype=old.dtype,
                                      device=old.device)
                new.view(-1)[pos.reshape(-1)] = src.expand(
                    pos.shape).reshape(-1)
        self._set_data(new)

    def slice(self, begin, end, step=None, **kw):
        return _op("slice")(self, begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return _op("slice_axis")(self, axis=axis, begin=begin, end=end)

    # -- reshaping (methods the reference defines natively) ----------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        return _op("reshape")(self, shape=shape)

    def reshape_like(self, other):
        return _op("reshape")(self, shape=other.shape)

    def broadcast_to(self, shape):
        return _op("broadcast_to")(self, shape=tuple(shape))

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def expand_dims(self, axis):
        return _op("expand_dims")(self, axis=axis)

    # -- arithmetic ---------------------------------------------------------
    def _inplace(self, res):
        self._set_data(res._data)
        return self

    def __add__(self, other):
        return _binary("broadcast_add", "_plus_scalar", self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __iadd__(self, other):
        return self._inplace(self.__add__(other))

    def __sub__(self, other):
        return _binary("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _binary_r("_rminus_scalar", self, other)

    def __isub__(self, other):
        return self._inplace(self.__sub__(other))

    def __mul__(self, other):
        return _binary("broadcast_mul", "_mul_scalar", self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __imul__(self, other):
        return self._inplace(self.__mul__(other))

    def __truediv__(self, other):
        return _binary("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _binary_r("_rdiv_scalar", self, other)

    def __itruediv__(self, other):
        return self._inplace(self.__truediv__(other))

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __mod__(self, other):
        return _binary("broadcast_mod", "_mod_scalar", self, other)

    def __rmod__(self, other):
        return _binary_r("_rmod_scalar", self, other)

    def __pow__(self, other):
        return _binary("broadcast_power", "_power_scalar", self, other)

    def __rpow__(self, other):
        return _binary_r("_rpower_scalar", self, other)

    def __neg__(self):
        return _op("negative")(self)

    def __abs__(self):
        return _op("abs")(self)

    def __eq__(self, other):
        return _binary("broadcast_equal", "_equal_scalar", self, other)

    def __ne__(self, other):
        return _binary("broadcast_not_equal", "_not_equal_scalar", self,
                       other)

    def __gt__(self, other):
        return _binary("broadcast_greater", "_greater_scalar", self, other)

    def __ge__(self, other):
        return _binary("broadcast_greater_equal", "_greater_equal_scalar",
                       self, other)

    def __lt__(self, other):
        return _binary("broadcast_lesser", "_lesser_scalar", self, other)

    def __le__(self, other):
        return _binary("broadcast_lesser_equal", "_lesser_equal_scalar",
                       self, other)

    def __hash__(self):
        return id(self)

    # -- generic op-method fallback ----------------------------------------
    # Any registered op is available as a method with the array as first
    # argument: x.sum(axis=1), x.relu(), x.topk(k=3), ...
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            opdef = _reg.get_op(name)
        except KeyError:
            raise AttributeError(
                "'NDArray' object has no attribute %r" % (name,)) from None
        return functools.partial(_invoke_named, opdef, self)


_TENSOR_LIKE = (NDArray, torch.Tensor, np.ndarray)


def _has_negative_step(key):
    keys = key if isinstance(key, tuple) else (key,)
    return any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in keys)


def _invoke_named(opdef, self_nd, *args, **kwargs):
    out = kwargs.pop("out", None)
    kwargs.pop("name", None)
    inputs = [self_nd]
    scalars = []
    for a in args:
        if isinstance(a, _TENSOR_LIKE):
            inputs.append(a)
        else:
            scalars.append(a)
    attrs = {k: v for k, v in kwargs.items() if not isinstance(v, NDArray)}
    for k, v in list(kwargs.items()):
        if isinstance(v, NDArray):
            inputs.append(v)
    if scalars:
        # positional attrs map onto the op's parameter order, as the
        # reference's hand-stamped NDArray methods do (x.sum(1), x.clip(-2,2))
        free = [k for k in opdef.defaults if k not in attrs]
        if len(scalars) > len(free):
            raise TypeError("%s: too many positional arguments %r (attrs: %r)"
                            % (opdef.name, scalars, list(opdef.defaults)))
        for k, v in zip(free, scalars):
            attrs[k] = v
    return _reg.invoke_eager(opdef, inputs, attrs, out=out)


def _op(name):
    """nd-level invoker for a registered op."""
    opdef = _reg.get_op(name)

    def f(*args, out=None, **attrs):
        inputs = [a for a in args if isinstance(a, NDArray)]
        return _reg.invoke_eager(opdef, inputs, attrs, out=out)
    return f


def _binary(tensor_op, scalar_op, lhs, rhs):
    if isinstance(rhs, NDArray):
        return _op(tensor_op)(lhs, rhs)
    if isinstance(rhs, numeric_types):
        return _op(scalar_op)(lhs, scalar=float(rhs))
    if isinstance(rhs, (np.ndarray, torch.Tensor)):
        return _op(tensor_op)(lhs, array(rhs, ctx=lhs.context))
    raise TypeError("unsupported operand type %s" % type(rhs))


def _binary_r(scalar_op, lhs, rhs):
    if isinstance(rhs, numeric_types):
        return _op(scalar_op)(lhs, scalar=float(rhs))
    raise TypeError("unsupported operand type %s" % type(rhs))


def _wrap(data):
    return NDArray(data)


# ---------------------------------------------------------------------------
# creation and module-level functions (reference ndarray.py free functions)
# ---------------------------------------------------------------------------

def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` (default: the current context, gpu(0) unless
    a ``with mx.cpu():`` scope says otherwise). Like the reference,
    float64 and int64 arrays become float32 and int32, and a Python list
    or scalar becomes float32, unless ``dtype`` is given."""
    ctx = ctx or current_context()
    if isinstance(source_array, NDArray):
        data = source_array._data.detach()
    elif isinstance(source_array, torch.Tensor):
        data = source_array.detach()
    else:
        src = np.asarray(source_array)
        if dtype is None:
            if not isinstance(source_array, np.ndarray):
                src = src.astype(np.float32)
            elif src.dtype == np.float64:
                src = src.astype(np.float32)
            elif src.dtype == np.int64:
                src = src.astype(np.int32)
        data = _from_numpy(src)
    if dtype is not None:
        data = data.to(torch_dtype(dtype))
    return NDArray(data, ctx=ctx)


def _shape_of(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _device(ctx):
    return (ctx or current_context()).torch_device()


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=None, stype=None, **kwargs):
    """A zero-filled NDArray on ``ctx`` (default: the current context);
    an empty sparse array for a sparse ``stype``."""
    if stype not in (None, "default"):
        from .sparse import zeros as sparse_zeros
        return sparse_zeros(stype, shape, ctx=ctx, dtype=dtype)
    return NDArray(torch.zeros(_shape_of(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.ones(_shape_of(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None, out=None):
    res = NDArray(torch.full(_shape_of(shape), val, dtype=torch_dtype(dtype),
                             device=_device(ctx)))
    if out is not None:
        out._set_data(res._data)
        return out
    return res


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    return NDArray(_reg.get_op("_arange").fn(
        start=start, stop=stop, step=step, repeat=repeat,
        dtype=dtype or "float32", ctx=ctx or current_context()))


def zeros_like(other, **kw):
    return NDArray(torch.zeros_like(other._data.detach()))


def ones_like(other, **kw):
    return NDArray(torch.ones_like(other._data.detach()))


def moveaxis(tensor, source, destination):
    return _wrap(torch.movedim(tensor._data.detach(), source, destination))


def concatenate(arrays, axis=0, always_copy=True):
    return _wrap(torch.cat([a._data.detach() for a in arrays], dim=axis))


def onehot_encode(indices, out):
    depth = out.shape[1]
    eye = torch.eye(depth, dtype=out._data.dtype, device=out._data.device)
    out._set_data(eye[indices._data.detach().to(torch.int32).long()])
    return out


def waitall():
    """Block until all queued device work completes (reference:
    MXNDArrayWaitAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
# keys, a list under "__mx_list__:<i>" keys; a sparse array's components
# under the reserved "__mx_sparse__.<i>." keys with a JSON manifest of
# (key, stype, shape) (ndarray.py:624-705).
# ---------------------------------------------------------------------------

_SAVE_LIST_PREFIX = "__mx_list__:"
_SPARSE_NS = "__mx_sparse__"


def _save_entry(payload, manifest, key, v):
    """A dense array stores under its key; a sparse one stores its
    components under the reserved namespace with a manifest entry, so no
    user key collides with them."""
    from .sparse import BaseSparseNDArray, CSRNDArray
    if key.startswith(_SPARSE_NS):
        raise ValueError("array names must not start with %r (reserved "
                         "for the sparse save format)" % _SPARSE_NS)
    if isinstance(v, BaseSparseNDArray):
        i = len(manifest)
        manifest.append({"key": key, "stype": v.stype,
                         "shape": list(v.shape)})
        payload["%s.%d.data" % (_SPARSE_NS, i)] = _to_numpy_exact(v._data)
        payload["%s.%d.indices" % (_SPARSE_NS, i)] = \
            _to_numpy_exact(v._indices)
        if isinstance(v, CSRNDArray):
            payload["%s.%d.indptr" % (_SPARSE_NS, i)] = \
                _to_numpy_exact(v._indptr)
        return
    payload[key] = _to_numpy_exact(v._data) if isinstance(v, NDArray) \
        else np.asarray(v)


def save(fname, data):
    if isinstance(data, NDArray):
        data = [data]
    payload, manifest = {}, []
    if isinstance(data, dict):
        for k, v in data.items():
            _save_entry(payload, manifest, k, v)
    elif isinstance(data, (list, tuple)):
        for i, v in enumerate(data):
            _save_entry(payload, manifest, _SAVE_LIST_PREFIX + str(i), v)
    else:
        raise ValueError("data must be NDArray, list of NDArrays or dict")
    if manifest:
        payload[_SPARSE_NS + ".manifest"] = np.frombuffer(
            json.dumps(manifest).encode(), np.uint8)
    with open(fname, "wb") as f:
        np.savez(f, **payload)


def load(fname, ctx=None):
    """Arrays saved by ``save`` (either package) as a dict or a list, on
    ``ctx`` (default: the current context), sparse entries as their
    storage types."""
    from .sparse import CSRNDArray, RowSparseNDArray
    ctx = ctx or current_context()
    with np.load(fname, allow_pickle=False) as npz:
        entries = {k: NDArray(_from_numpy(npz[k]), ctx=ctx)
                   for k in npz.files if not k.startswith(_SPARSE_NS)}
        mkey = _SPARSE_NS + ".manifest"
        if mkey in npz.files:
            manifest = json.loads(bytes(npz[mkey]).decode())
            for i, meta in enumerate(manifest):
                part = "%s.%d." % (_SPARSE_NS, i)
                vals = _from_numpy(npz[part + "data"])
                idx = npz[part + "indices"]
                if meta["stype"] == "csr":
                    entries[meta["key"]] = CSRNDArray(
                        vals, idx, npz[part + "indptr"], meta["shape"],
                        ctx=ctx)
                else:
                    entries[meta["key"]] = RowSparseNDArray(
                        vals, idx, meta["shape"], ctx=ctx)
    if entries and all(k.startswith(_SAVE_LIST_PREFIX) for k in entries):
        order = sorted(entries,
                       key=lambda k: int(k[len(_SAVE_LIST_PREFIX):]))
        return [entries[k] for k in order]
    return entries
