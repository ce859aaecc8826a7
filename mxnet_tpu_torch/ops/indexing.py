"""Indexing ops — ``Embedding``, ``take``, ``batch_take``, ``pick``,
``one_hot``, ``gather_nd`` and ``scatter_nd`` — with the semantics of
``mxnet_tpu/ops/indexing.py``, including jax's index rules where torch
would raise: a negative index counts from the end; out of range,
``take_along_axis`` (batch_take, pick) reads NaN (an int table, its
least value), an ``x[idx]`` gather (gather_nd) clamps, and a scatter
(scatter_nd) drops the update. ``_sparse_retain`` and ``_square_sum``
are their dense compute paths (a sparse input takes
``ndarray/sparse.py``'s route through ``mx.nd``).
"""
from __future__ import annotations

import torch

from .registry import register


def _gather_rows(weight, ids):
    """``jnp.take(weight, ids, axis=0)`` with jax's default index rule: a
    negative id in [-rows, 0) counts from the end, and an id outside
    [-rows, rows) reads NaN (an int table, 0) instead of failing — it
    never reaches the device as a bad index."""
    rows = weight.shape[0]
    valid = (ids >= -rows) & (ids < rows)
    out = weight[torch.where(ids < 0, ids + rows, ids).clamp(0, rows - 1)]
    fill = float("nan") if weight.is_floating_point() else 0
    return torch.where(valid.unsqueeze(-1), out,
                       torch.full((), fill, dtype=weight.dtype,
                                  device=weight.device))


@register("Embedding", arg_names=("data", "weight"), nondiff_inputs=(0,),
          defaults={"input_dim": 0, "output_dim": 0, "dtype": "float32"})
def _embedding(data, weight, **_):
    # float ids are cast to int32, truncating toward zero, as astype does
    ids = data.to(torch.int32).long()
    flat = _gather_rows(weight, ids.reshape(-1))
    return flat.reshape(tuple(ids.shape) + tuple(weight.shape[1:]))


@register("take", arg_names=("a", "indices"), nondiff_inputs=(1,),
          defaults={"axis": 0, "mode": "clip"})
def _take(a, indices, axis=0, mode="clip", **_):
    idx = indices.to(torch.int32).long()
    n = a.shape[axis]
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    axis = axis % a.dim()
    return out.reshape(tuple(a.shape[:axis]) + tuple(idx.shape)
                       + tuple(a.shape[axis + 1:]))


def _along_axis(a, idx, axis):
    """``jnp.take_along_axis(a, idx, axis)`` in its default "fill" mode."""
    n = a.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = torch.gather(a, axis, idx.clamp(0, n - 1))
    fill = float("nan") if a.is_floating_point() else \
        torch.iinfo(a.dtype).min
    return torch.where(valid, out, torch.full((), fill, dtype=a.dtype,
                                              device=a.device))


@register("batch_take", arg_names=("a", "indices"), nondiff_inputs=(1,))
def _batch_take(a, indices, **_):
    idx = indices.to(torch.int32).long()
    return _along_axis(a, idx[:, None], 1)[:, 0]


@register("pick", arg_names=("data", "index"), nondiff_inputs=(1,),
          defaults={"axis": -1, "keepdims": False})
def _pick(data, index, axis=-1, keepdims=False, **_):
    idx = index.to(torch.int32).long()
    idx_exp = torch.unsqueeze(idx, axis if axis >= 0 else data.dim() + axis)
    out = _along_axis(data, idx_exp, axis)
    if not keepdims:
        out = torch.squeeze(out, dim=axis)
    return out


@register("one_hot", arg_names=("indices",), differentiable=False,
          defaults={"depth": 0, "on_value": 1.0, "off_value": 0.0,
                    "dtype": "float32"})
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0,
             dtype="float32", **_):
    from ..base import torch_dtype
    idx = indices.to(torch.int32)
    oh = (idx[..., None] == torch.arange(depth, device=idx.device)).to(
        torch_dtype(dtype))
    return oh * on_value + (1 - oh) * off_value


def _nd_index(idx, shape):
    """The m index rows of gather_nd/scatter_nd, each negative index
    counted from the end of its dim."""
    return [torch.where(idx[i] < 0, idx[i] + shape[i], idx[i])
            for i in range(idx.shape[0])]


@register("gather_nd", arg_names=("data", "indices"), nondiff_inputs=(1,))
def _gather_nd(data, indices, **_):
    idx = _nd_index(indices.to(torch.int32).long(), data.shape)
    return data[tuple(i.clamp(0, data.shape[d] - 1)
                      for d, i in enumerate(idx))]


@register("scatter_nd", arg_names=("data", "indices"), nondiff_inputs=(1,),
          defaults={"shape": ()})
def _scatter_nd(data, indices, shape=(), **_):
    shape = tuple(shape)
    m = indices.shape[0]
    idx = _nd_index(indices.to(torch.int32).long(), shape)
    # one linear index over the m scattered dims; an update out of range
    # goes to one spare row past the end, which is then cut away
    rows = 1
    for d in shape[:m]:
        rows *= d
    lin = torch.zeros_like(idx[0])
    valid = torch.ones_like(idx[0], dtype=torch.bool)
    for d, i in enumerate(idx):
        lin = lin * shape[d] + i
        valid = valid & (i >= 0) & (i < shape[d])
    lin = torch.where(valid, lin, rows)
    out = torch.zeros((rows + 1,) + shape[m:], dtype=data.dtype,
                      device=data.device)
    out = out.index_put((lin.reshape(-1),),
                        data.reshape((-1,) + shape[m:]))
    return out[:rows].reshape(shape)


@register("_sparse_retain", arg_names=("data", "indices"), nondiff_inputs=(1,))
def _sparse_retain(data, indices, **_):
    """The rows of ``data`` named by ``indices`` kept, the others zero. An
    id in [-rows, 0) counts from the end and one outside [-rows, rows) is
    dropped, as jax's ``.at[ids].set`` does."""
    n = data.shape[0]
    ids = indices.reshape(-1).to(torch.int64)
    ids = torch.where(ids < 0, ids + n, ids)
    ids = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))
    mask = torch.zeros(n + 1, dtype=torch.bool, device=data.device)
    mask = mask.index_fill(0, ids, True)[:n]
    return torch.where(mask.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))


@register("_square_sum", arg_names=("data",),
          defaults={"axis": None, "keepdims": False})
def _square_sum(x, axis=None, keepdims=False, **_):
    if axis is None:
        axis = tuple(range(x.dim()))
    elif isinstance(axis, int):
        axis = (axis,)
    out = torch.sum(torch.square(x), dim=tuple(axis), keepdim=keepdims)
    return out.reshape((1,)) if out.dim() == 0 else out
