"""Sparse NDArray storage types, ``row_sparse`` and ``csr`` — the PyTorch
twin of ``mxnet_tpu/ndarray/sparse.py`` (reference:
python/mxnet/ndarray/sparse.py, include/mxnet/ndarray.h:82-87,
src/operator/tensor/dot-inl.h, cast_storage-inl.h).

A sparse array carries its index structure as torch tensors on the
array's device: ``RowSparseNDArray`` holds values (nnz, ...) and sorted
row ``indices`` (nnz,); ``CSRNDArray`` holds values (nnz,), column
``indices`` (nnz,) and ``indptr`` (rows + 1,). Indices are int32, as in
the JAX package, and the logical dense shape is metadata. ``_data`` is the
values tensor, so ``context`` and ``dtype`` are the values'.

Every kernel here is a gather, an elementwise product and a fixed-order
segment sum over the nnz axis (``ops/_segment.py``): ``dot`` (csr @ dense
and csr.T @ dense; lhs is never densified), ``add``'s union and
``take_grad``. None of them adds with float atomics, so a result is the
same bits run after run on the card. The lazy ``sgd_update``,
``sgd_mom_update`` and ``adam_update`` write only the rows present in
the gradient (weight decay and state included) into new tensors of the
weight and state: an NDArray's tensor is never written in place.

What needs a data-dependent size syncs with the host, where the
reference allocates after counting too: ``cast_storage`` from dense
(``torch.nonzero`` on the array's device), ``add``'s index union and
``take_grad``'s unique ids (numpy on the host, as in the JAX package),
and the csr row slice. Each such read counts one host sync
(``profiler.host_sync_count``).

``_install_sparse_dispatch`` wraps the generated ``mx.nd`` functions
(and the ``ndarray/op.py`` attributes the optimizers call) so that a
sparse input takes these routes (the reference's FComputeEx dispatch);
every other op refuses a sparse input (``ops/registry.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import numeric_types, torch_dtype
from ..context import current_context
from ..profiler import count_host_sync
from ..ops._segment import segment_sum
from .ndarray import NDArray, _from_numpy, _wrap

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "tostype", "cast_storage",
           "zeros", "empty", "array", "dot", "retain", "add",
           "take_grad"]


def _device(x, ctx=None):
    """Where a sparse array built from ``x`` lives: ``ctx``, else x's
    device, else the current context."""
    if ctx is not None:
        return ctx.torch_device()
    if isinstance(x, NDArray):
        return x._data.device
    if isinstance(x, torch.Tensor):
        return x.device
    return current_context().torch_device()


def _as_tensor(x, dtype=None, device=None):
    """A detached tensor from an NDArray, a tensor or host data. Host
    float64 and int64 become float32 and int32, as ``jnp.asarray`` makes
    them."""
    if isinstance(x, NDArray):
        t = x._data.detach()
    elif isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        a = np.asarray(x)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        t = _from_numpy(a)
    if t.dtype == torch.float64:
        t = t.float()
    if device is not None:
        t = t.to(device)
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t


def _host(x):
    """A host numpy copy of an NDArray, tensor or array-like (a device
    tensor's read counts one host sync)."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            count_host_sync("sparse")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _nonzero(t, **kw):
    """``torch.nonzero``: its size is read on the host (one sync)."""
    if t.device.type != "cpu":
        count_host_sync("sparse")
    return torch.nonzero(t, **kw)


class BaseSparseNDArray(NDArray):
    """Common behaviour: ``_data`` holds the values; the logical shape is
    ``_sshape``. Dense-only NDArray operations are refused rather than
    run on the values."""

    __slots__ = ("_sshape",)

    # -- logical geometry ---------------------------------------------------
    @property
    def shape(self):
        return self._sshape

    @property
    def size(self):
        out = 1
        for d in self._sshape:
            out *= int(d)
        return out

    @property
    def ndim(self):
        return len(self._sshape)

    @property
    def data(self):
        """The values array (reference sparse.py: .data)."""
        return _wrap(self._data)

    @property
    def nnz(self):
        return int(self._data.shape[0])

    def asnumpy(self):
        return self.todense().asnumpy()

    def tostype(self, stype):
        return tostype(self, stype)

    def __repr__(self):
        shape_info = "x".join(str(s) for s in self._sshape)
        return "\n<%s %s @%s>" % (type(self).__name__, shape_info,
                                  self.context)

    __str__ = __repr__

    def _deny(self, what):
        raise TypeError("%s is not supported on %s — convert with "
                        "tostype('default') first"
                        % (what, type(self).__name__))

    def __getitem__(self, key):
        self._deny("indexing")

    def __setitem__(self, key, value):
        self._deny("assignment")

    def attach_grad(self, grad_req="write", stype=None):
        self._deny("attach_grad")

    def __iter__(self):
        self._deny("iteration")

    # arithmetic: only what has a sparse meaning
    def __mul__(self, other):
        if isinstance(other, numeric_types):
            return self._with_values(self._data * other)
        self._deny("multiplication by a non-scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, numeric_types):
            return self._with_values(self._data / other)
        self._deny("division by a non-scalar")

    def __neg__(self):
        return self._with_values(-self._data)

    def copy(self):
        return self._with_values(self._data.clone())

    def astype(self, dtype, copy=True):
        return self._with_values(self._data.to(torch_dtype(dtype)))

    def _copy_check(self, other):
        """Refuse a copy into another storage type or a non-array."""
        if isinstance(other, BaseSparseNDArray):
            raise TypeError("cannot copy %s into %s — storage types must "
                            "match (tostype first)"
                            % (self.stype, type(other).__name__))
        if not isinstance(other, NDArray):
            raise TypeError("copyto does not support %r" % (other,))


class RowSparseNDArray(BaseSparseNDArray):
    """Mostly-zero rows: values (nnz, *row_shape) and sorted row
    ``indices`` (nnz,). The representation of embedding gradients and
    row_sparse_pull results (reference sparse.py:RowSparseNDArray)."""

    __slots__ = ("_indices",)

    def __init__(self, values, indices, shape, ctx=None):
        dev = _device(values, ctx)
        values = _as_tensor(values, device=dev)
        indices = _as_tensor(indices, torch.int32, dev).reshape(-1)
        if indices.shape[0] > 1:
            order = torch.argsort(indices, stable=True)
            indices = indices[order]
            values = values[order]
        self._fill(values, indices, shape)

    def _fill(self, values, indices, shape):
        NDArray.__init__(self, values)
        self._indices = indices
        self._sshape = tuple(int(d) for d in shape)
        return self

    @classmethod
    def _make(cls, values, indices, shape):
        """From values and indices already sorted, on one device."""
        return cls.__new__(cls)._fill(values, indices, shape)

    @property
    def stype(self):
        return "row_sparse"

    @property
    def indices(self):
        return _wrap(self._indices)

    def _with_values(self, values):
        return RowSparseNDArray._make(values, self._indices, self._sshape)

    def as_in_context(self, context):
        if context == self.context:
            return self
        dev = context.torch_device()
        return RowSparseNDArray._make(self._data.to(dev),
                                      self._indices.to(dev), self._sshape)

    def todense(self):
        dense = self._data.new_zeros(self._sshape)
        if self.nnz:
            dense[self._indices.long()] = self._data
        return _wrap(dense)

    def retain(self, row_ids):
        return retain(self, row_ids)

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            return add(self, other)
        self._deny("addition with %s" % type(other).__name__)

    def copyto(self, other):
        if isinstance(other, RowSparseNDArray):
            dev = other._data.device
            other._set_data(self._data.to(dev))
            other._indices = self._indices.to(dev)
            other._sshape = self._sshape
            return other
        self._copy_check(other)
        other._set_data(self.todense()._data.to(other._data.device))
        return other


class CSRNDArray(BaseSparseNDArray):
    """2-D compressed sparse rows: values (nnz,), column ``indices``
    (nnz,), ``indptr`` (rows + 1,)."""

    __slots__ = ("_indices", "_indptr")

    def __init__(self, values, indices, indptr, shape, ctx=None):
        dev = _device(values, ctx)
        self._fill(_as_tensor(values, device=dev),
                   _as_tensor(indices, torch.int32, dev).reshape(-1),
                   _as_tensor(indptr, torch.int32, dev).reshape(-1), shape)

    def _fill(self, values, indices, indptr, shape):
        NDArray.__init__(self, values)
        self._indices = indices
        self._indptr = indptr
        self._sshape = tuple(int(d) for d in shape)
        if len(self._sshape) != 2:
            raise ValueError("csr storage requires a 2D shape")
        return self

    @classmethod
    def _make(cls, values, indices, indptr, shape):
        return cls.__new__(cls)._fill(values, indices, indptr, shape)

    @property
    def stype(self):
        return "csr"

    @property
    def indices(self):
        return _wrap(self._indices)

    @property
    def indptr(self):
        return _wrap(self._indptr)

    @property
    def _rows(self):
        """Row id of each stored value (int64), in storage order, so
        non-decreasing: indptr expanded on the device without a sync."""
        counts = (self._indptr[1:] - self._indptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self._sshape[0], device=counts.device), counts,
            output_size=self.nnz)

    def _with_values(self, values):
        return CSRNDArray._make(values, self._indices, self._indptr,
                                self._sshape)

    def as_in_context(self, context):
        if context == self.context:
            return self
        dev = context.torch_device()
        return CSRNDArray._make(self._data.to(dev), self._indices.to(dev),
                                self._indptr.to(dev), self._sshape)

    def todense(self):
        dense = self._data.new_zeros(self._sshape)
        if self.nnz:
            dense[self._rows, self._indices.long()] = self._data
        return _wrap(dense)

    def __getitem__(self, key):
        """Row slicing (the reference's csr supports it); returns csr."""
        if isinstance(key, slice):
            start, stop, step = key.indices(self._sshape[0])
            if step != 1:
                self._deny("strided slicing")
            ptr = _host(self._indptr)
            lo, hi = int(ptr[start]), int(ptr[stop])
            return CSRNDArray._make(self._data[lo:hi],
                                    self._indices[lo:hi],
                                    self._indptr[start:stop + 1] - lo,
                                    (stop - start, self._sshape[1]))
        self._deny("indexing")

    def copyto(self, other):
        if isinstance(other, CSRNDArray):
            dev = other._data.device
            other._set_data(self._data.to(dev))
            other._indices = self._indices.to(dev)
            other._indptr = self._indptr.to(dev)
            other._sshape = self._sshape
            return other
        self._copy_check(other)
        other._set_data(self.todense()._data.to(other._data.device))
        return other


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """From (data, indices), a shape (all zeros), or any dense source
    (a storage cast)."""
    if isinstance(arg1, tuple) and all(
            isinstance(d, (int, np.integer)) for d in arg1):
        return zeros("row_sparse", arg1, ctx=ctx, dtype=dtype)
    if isinstance(arg1, tuple) and len(arg1) == 2:
        values, indices = arg1
        values = _as_tensor(values, dtype, _device(values, ctx))
        indices = _host(indices).astype(np.int64)
        if shape is None:
            top = int(indices.max()) + 1 if indices.size else 0
            shape = (top,) + tuple(values.shape[1:])
        return RowSparseNDArray(values, indices, shape, ctx=ctx)
    return cast_storage(_dense_source(arg1, dtype, ctx), "row_sparse",
                        ctx=ctx)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """From (data, indices, indptr) or any dense source."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        values, indices, indptr = arg1
        if shape is None:
            indptr_np, idx_np = _host(indptr), _host(indices)
            shape = (len(indptr_np) - 1,
                     int(idx_np.max()) + 1 if idx_np.size else 0)
        return CSRNDArray(_as_tensor(values, dtype, _device(values, ctx)),
                          indices, indptr, shape, ctx=ctx)
    return cast_storage(_dense_source(arg1, dtype, ctx), "csr", ctx=ctx)


def _dense_source(arg1, dtype=None, ctx=None):
    if isinstance(arg1, BaseSparseNDArray):
        arg1 = arg1.todense()
    if isinstance(arg1, NDArray):
        return arg1 if dtype is None else arg1.astype(dtype)
    return _wrap(_as_tensor(np.asarray(arg1, dtype), None,
                            _device(arg1, ctx)))


def zeros(stype, shape, ctx=None, dtype=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dev = (ctx or current_context()).torch_device()
    dt = torch_dtype(dtype)
    i32 = torch.int32
    if stype == "row_sparse":
        return RowSparseNDArray._make(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros((0,), dtype=i32, device=dev), shape)
    if stype == "csr":
        return CSRNDArray._make(
            torch.zeros((0,), dtype=dt, device=dev),
            torch.zeros((0,), dtype=i32, device=dev),
            torch.zeros((shape[0] + 1,), dtype=i32, device=dev), shape)
    if stype == "default":
        return _wrap(torch.zeros(shape, dtype=dt, device=dev))
    raise ValueError("unknown stype %r" % stype)


empty = zeros


def array(source_array, ctx=None, dtype=None):
    """Sparse-preserving array(): a sparse input gives a copy of the same
    storage type."""
    if isinstance(source_array, BaseSparseNDArray):
        return source_array.copy()
    raise ValueError("sparse.array expects a sparse input; use "
                     "nd.array for dense sources")


# ---------------------------------------------------------------------------
# storage casting
# ---------------------------------------------------------------------------

def cast_storage(arr, stype, ctx=None):
    """Storage conversion (reference cast_storage-inl.h). dense -> sparse
    counts the non-zeros with ``torch.nonzero`` on the array's device:
    one host sync, the one the reference pays when it allocates."""
    if stype in (None, "default"):
        if isinstance(arr, BaseSparseNDArray):
            return arr.todense()
        return _wrap(arr._data)
    if isinstance(arr, BaseSparseNDArray):
        if arr.stype == stype:
            return arr.copy()
        arr = arr.todense()
    a = arr._data.detach()
    if ctx is not None:
        a = a.to(ctx.torch_device())
    if stype == "row_sparse":
        nz = _nonzero((a.reshape(a.shape[0], -1) != 0).any(dim=1)).reshape(
            -1)
        return RowSparseNDArray._make(a[nz], nz.to(torch.int32),
                                      tuple(a.shape))
    if stype == "csr":
        if a.dim() != 2:
            raise ValueError("csr requires 2D")
        rows, cols = _nonzero(a, as_tuple=True)   # row-major order
        indptr = torch.searchsorted(
            rows, torch.arange(a.shape[0] + 1, device=a.device))
        return CSRNDArray._make(a[rows, cols], cols.to(torch.int32),
                                indptr.to(torch.int32), tuple(a.shape))
    raise ValueError("unknown stype %r" % stype)


def tostype(arr, stype):
    return cast_storage(arr, stype)


# ---------------------------------------------------------------------------
# sparse kernels: gathers and fixed-order segment sums over the nnz axis
# ---------------------------------------------------------------------------

def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """csr @ dense, and csr.T @ dense with ``transpose_a``, without
    densifying lhs (the reference's SpMV/SpMM path, dot-inl.h): each
    stored value times its rhs row, summed by output row in storage
    order."""
    if not isinstance(lhs, CSRNDArray) or isinstance(rhs,
                                                     BaseSparseNDArray):
        raise TypeError("sparse.dot supports csr @ dense")
    if transpose_b:
        raise NotImplementedError("transpose_b on the sparse dot")
    vals, cols, rows = lhs._data, lhs._indices, lhs._rows
    dense = rhs._data.detach()
    vals = vals.reshape((-1,) + (1,) * (dense.dim() - 1))
    if not transpose_a:
        out = segment_sum(vals * dense.index_select(0, cols), rows,
                          lhs.shape[0], ids_sorted=True)
    else:
        out = segment_sum(vals * dense.index_select(0, rows), cols,
                          lhs.shape[1])
    return _wrap(out)


def _gather_rows(arr, ids):
    """Values of row-sparse ``arr`` at ``ids``, in ids order; absent rows
    are zeros. Shape (len(ids), ...)."""
    ids = _as_tensor(ids, torch.int32, arr._data.device).reshape(-1)
    nnz = arr._data.shape[0]
    if nnz == 0:
        return arr._data.new_zeros((ids.shape[0],) + arr._data.shape[1:])
    pos = torch.clamp(torch.searchsorted(arr._indices, ids), 0, nnz - 1)
    found = arr._indices[pos] == ids
    return torch.where(
        found.reshape((-1,) + (1,) * (arr._data.dim() - 1)),
        arr._data[pos], arr._data.new_zeros(()))


def retain(arr, row_ids):
    """Keep only the ``row_ids`` rows (reference _sparse_retain): the
    output's indices are exactly the requested ids, sorted; absent rows
    are zeros. row_sparse_pull is built on it."""
    if not isinstance(arr, RowSparseNDArray):
        raise TypeError("retain expects a RowSparseNDArray")
    ids = torch.sort(_as_tensor(row_ids, torch.int32,
                                arr._data.device).reshape(-1))[0]
    return RowSparseNDArray._make(_gather_rows(arr, ids), ids, arr.shape)


def add(lhs, rhs):
    """row_sparse + row_sparse -> row_sparse over the index union (the
    union on the host: the output's nnz is data-dependent, the sync the
    reference pays in FComputeEx). Each union row is lhs's value plus
    rhs's, by the segment sum."""
    if not (isinstance(lhs, RowSparseNDArray) and
            isinstance(rhs, RowSparseNDArray)):
        raise TypeError("sparse.add expects two RowSparseNDArrays, got "
                        "%s + %s" % (type(lhs).__name__,
                                     type(rhs).__name__))
    if lhs.shape != rhs.shape:
        raise ValueError("shape mismatch %s vs %s" % (lhs.shape,
                                                      rhs.shape))
    li, ri = _host(lhs._indices), _host(rhs._indices)
    union = np.union1d(li, ri)
    pos = np.concatenate([np.searchsorted(union, li),
                          np.searchsorted(union, ri)])
    dev = lhs._data.device
    vals = segment_sum(torch.cat([lhs._data, rhs._data.to(dev)]),
                       torch.from_numpy(pos).to(dev), len(union))
    return RowSparseNDArray._make(
        vals, torch.from_numpy(union.astype(np.int32)).to(dev), lhs.shape)


def take_grad(indices, ograd, num_rows):
    """The row-sparse gradient of an Embedding/take forward: ``ograd``'s
    rows summed by looked-up index (the unique ids on the host, the sums
    by the segment sum). The dense (num_rows, dim) gradient is never
    made."""
    idx_arr = _host(indices).astype(np.int64)
    idx = idx_arr.ravel()
    og = _as_tensor(ograd)
    row_shape = tuple(og.shape[idx_arr.ndim:])
    og = og.reshape((idx.shape[0],) + row_shape)
    rows, inverse = np.unique(idx, return_inverse=True)
    vals = segment_sum(og, torch.from_numpy(inverse.reshape(-1)).to(
        og.device), len(rows))
    shape = (int(num_rows),) + tuple(og.shape[1:])
    return RowSparseNDArray._make(
        vals, torch.from_numpy(rows.astype(np.int32)).to(og.device), shape)


# ---------------------------------------------------------------------------
# sparse (lazy) optimizer updates — reference optimizer_op.cc rowsparse
# kernels: only the rows present in the gradient are touched (weight
# decay included); every other row keeps its value and its state.
# ---------------------------------------------------------------------------

def _prep_grad(grad, rescale_grad, clip_gradient):
    g = grad._data * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _put_rows(dst, src, idx, rows):
    """``dst`` gets a new tensor: ``src``'s with ``rows`` written at
    ``idx`` (unique ids: no accumulation)."""
    dst._set_data(src._data.detach().index_put((idx,), rows))


def sgd_update(weight, grad, out=None, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=None, **_):
    idx = grad._indices.long()
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    rows = weight._data.detach()[idx]
    new_rows = rows - lr * (g + wd * rows)
    dst = weight if out is None else out
    _put_rows(dst, weight, idx, new_rows)
    return dst


def sgd_mom_update(weight, grad, mom, out=None, lr=0.01, momentum=0.0,
                   wd=0.0, rescale_grad=1.0, clip_gradient=None, **_):
    idx = grad._indices.long()
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    w_rows = weight._data.detach()[idx]
    m_rows = momentum * mom._data.detach()[idx] - lr * (g + wd * w_rows)
    _put_rows(mom, mom, idx, m_rows)
    dst = weight if out is None else out
    _put_rows(dst, weight, idx, w_rows + m_rows)
    return dst


def adam_update(weight, grad, mean, var, out=None, lr=0.01, beta1=0.9,
                beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                clip_gradient=None, **_):
    idx = grad._indices.long()
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    w_rows = weight._data.detach()[idx]
    g = g + wd * w_rows
    m_rows = beta1 * mean._data.detach()[idx] + (1 - beta1) * g
    v_rows = beta2 * var._data.detach()[idx] + (1 - beta2) * torch.square(g)
    _put_rows(mean, mean, idx, m_rows)
    _put_rows(var, var, idx, v_rows)
    new_rows = w_rows - lr * m_rows / (torch.sqrt(v_rows) + epsilon)
    dst = weight if out is None else out
    _put_rows(dst, weight, idx, new_rows)
    return dst


_SPARSE_UPDATES = {"sgd_update": sgd_update,
                   "sgd_mom_update": sgd_mom_update,
                   "adam_update": adam_update}


def _install_sparse_dispatch(pkg_globals, op_module):
    """Wrap the generated nd.* entry points so that sparse inputs take the
    routes above (the analogue of FComputeEx dispatch,
    c_api_ndarray.cc:521-549); dense calls fall through unchanged."""
    def wrap(name, choose, handles_out=False):
        dense_fn = getattr(op_module, name)

        def dispatch(*args, **kwargs):
            fn = choose(args, kwargs)
            if fn is None:
                return dense_fn(*args, **kwargs)
            if handles_out:
                return fn(*args, **kwargs)
            # out= for the sparse routes (copyto raises on a storage-type
            # mismatch rather than writing the wrong storage)
            out = kwargs.pop("out", None)
            res = fn(*args, **kwargs)
            if out is not None:
                res.copyto(out)
                return out
            return res
        dispatch.__name__ = name
        dispatch.__doc__ = dense_fn.__doc__
        setattr(op_module, name, dispatch)
        pkg_globals[name] = dispatch

    wrap("dot", lambda a, kw: dot if a and isinstance(a[0], CSRNDArray)
         else None)

    def _cast_choose(args, kwargs):
        if not args or not isinstance(args[0], NDArray):
            return None
        stype = kwargs.get("stype")
        if stype is None:
            pos_str = [x for x in args[1:] if isinstance(x, str)]
            stype = pos_str[0] if pos_str else "default"
        if not (isinstance(args[0], BaseSparseNDArray) or
                stype not in (None, "default")):
            return None    # dense -> default: the registry op honours out=
        return lambda data, *_a, **_kw: cast_storage(data, stype)
    wrap("cast_storage", _cast_choose)

    wrap("_sparse_retain",
         lambda a, kw: (lambda data, indices, **_kw: retain(data, indices))
         if a and isinstance(a[0], RowSparseNDArray) else None)
    wrap("_square_sum",
         lambda a, kw: (lambda data, **_kw: _wrap(
             torch.sum(torch.square(data._data)).reshape((1,))))
         if a and isinstance(a[0], BaseSparseNDArray) else None)

    def _eadd_choose(args, kwargs):
        if len(args) < 2:
            return None
        l_rs = isinstance(args[0], RowSparseNDArray)
        r_rs = isinstance(args[1], RowSparseNDArray)
        if l_rs and r_rs:
            return lambda l, r, **_kw: add(l, r)
        if l_rs or r_rs:
            # row_sparse + dense -> dense (the reference's elemwise_add
            # FComputeEx fallback densifies the sparse side)
            def _mixed(l, r, **_kw):
                ld = l.todense() if isinstance(l, BaseSparseNDArray) else l
                rd = r.todense() if isinstance(r, BaseSparseNDArray) else r
                return _wrap(ld._data + rd._data)
            return _mixed
        return None
    wrap("elemwise_add", _eadd_choose)

    for upd in _SPARSE_UPDATES:
        wrap(upd, lambda a, kw, _u=upd: _SPARSE_UPDATES[_u]
             if len(a) > 1 and isinstance(a[1], RowSparseNDArray)
             else None, handles_out=True)
