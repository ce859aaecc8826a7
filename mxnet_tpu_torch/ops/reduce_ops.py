"""Reductions ported so far — ``L2Normalization`` and ``softmax`` — with
the semantics of ``mxnet_tpu/ops/reduce_ops.py``. The rest of that
file's ops wait for the op-catalog slice (ROADMAP Queue A item 2).
"""
from __future__ import annotations

import torch

from .registry import register


@register("L2Normalization", arg_names=("data",),
          defaults={"eps": 1e-10, "mode": "instance"})
def _l2norm(x, eps=1e-10, mode="instance", **_):
    # eps is added inside the sqrt, as the JAX op (and the reference) do
    if mode == "instance":
        n = torch.sqrt(torch.sum(torch.square(x.reshape(x.shape[0], -1)),
                                 dim=1) + eps)
        return x / n.reshape((-1,) + (1,) * (x.dim() - 1))
    if mode == "channel":
        n = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)
                       + eps)
        return x / n
    if mode == "spatial":
        axes = tuple(range(2, x.dim()))
        n = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)
                       + eps)
        return x / n
    raise ValueError("unknown mode %r" % mode)


@register("softmax", arg_names=("data",),
          defaults={"axis": -1, "temperature": None})
def _softmax(x, axis=-1, temperature=None, **_):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.softmax(x, dim=axis)
