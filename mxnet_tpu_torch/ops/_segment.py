"""A segment sum in a fixed order: the port's one scatter-free reduction
(ROADMAP Queue C 21; the JAX package lowers the same sums to
``jax.ops.segment_sum``).

``segment_sum(values, segment_ids, num_segments)`` returns
``out[s] = sum of values[i] over i with segment_ids[i] == s`` for every
``s`` in ``[0, num_segments)``; ids outside that range are dropped and an
empty segment sums to zero, as in ``jax.ops.segment_sum``. On every device
each segment's rows are added one after another in the order they arrive:

* the ids are sorted stably (skipped when the caller says they arrive
  sorted, as a CSR's row ids do), so equal ids keep their order;
* each segment's bounds in the sorted ids come from ``searchsorted``;
* ``torch.segment_reduce`` over those offsets sums each segment. The
  values are given as a 2-D (rows, width) array, for which its CUDA
  kernel runs one thread a (segment, column) that adds the segment's rows
  in index order (a 1-D input would take CUB's tree reduction instead).

So no float atomics are used (no ``index_add_``, ``index_put_(...,
accumulate=True)`` or ``scatter_add_``), and two runs on one card give
the same bits.
"""
from __future__ import annotations

import torch

__all__ = ["segment_sum"]


def segment_sum(values, segment_ids, num_segments, ids_sorted=False):
    """(num_segments,) + values.shape[1:] sums of ``values``' rows by
    ``segment_ids`` (an integer tensor of values.shape[0] ids), each
    segment's rows added in arrival order. ``ids_sorted``: the ids are
    already non-decreasing, so the stable sort is skipped."""
    num_segments = int(num_segments)
    tail = tuple(values.shape[1:])
    n = values.shape[0]
    if n == 0 or num_segments == 0:
        return values.new_zeros((num_segments,) + tail)
    ids = segment_ids.reshape(-1).to(torch.int64)
    flat = values.reshape(n, -1)
    if not ids_sorted:
        ids, order = torch.sort(ids, stable=True)
        flat = flat.index_select(0, order)
    bounds = torch.arange(num_segments + 1, device=ids.device)
    offsets = torch.searchsorted(ids, bounds)
    out = torch.segment_reduce(flat, "sum", offsets=offsets, axis=0,
                               unsafe=True)
    return out.reshape((num_segments,) + tail)
