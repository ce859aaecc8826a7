"""Indexing ops of the serving slice — ``Embedding`` and ``take`` — with
the semantics of ``mxnet_tpu/ops/indexing.py``. Its other ops, and the
Embedding backward choice, wait for the op-catalog slice.
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
