"""Gluon utilities — the PyTorch twin of ``mxnet_tpu/gluon/utils.py``
(reference: python/mxnet/gluon/utils.py)."""
from __future__ import annotations

import math

import torch

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split along batch_axis into num_slice slices (reference
    utils.py:split_data). With even_split=False the last slice absorbs
    the remainder."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError("cannot cut axis %d of %s into %d slices"
                         % (batch_axis, data.shape, num_slice))
    if even_split and size % num_slice:
        raise ValueError(
            "axis %d of %s is not divisible by %d; pad the batch or pass "
            "even_split=False" % (batch_axis, data.shape, num_slice))

    step = size // num_slice
    bounds = [(i * step, size if i == num_slice - 1 else (i + 1) * step)
              for i in range(num_slice)]
    if batch_axis == 0:
        return [data[lo:hi] for lo, hi in bounds]
    return [nd.slice_axis(data, batch_axis, lo, hi) for lo, hi in bounds]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split and place on contexts (reference
    utils.py:split_and_load): one slice a context, in order."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(c) for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Rescale arrays so total L2 norm <= max_norm (reference
    utils.py:clip_global_norm)."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    # each array's sum of squares in its own dtype on its device, their
    # sum in float64: one host read for the lot
    sums = [torch.sum(t * t).double()
            for t in (a._data.detach() for a in arrays)]
    total = math.sqrt(float(torch.stack(
        [s.to(sums[0].device) for s in sums]).sum()))
    if total > max_norm:
        scale = max_norm / (total + 1e-8)
        for a in arrays:
            a *= scale
    return total
