"""Elementwise ops ported so far: ``broadcast_add`` (and its aliases),
``_plus_scalar`` and ``_copy`` (``identity``), with the semantics of
``mxnet_tpu/ops/elemwise.py``. The rest of that file's ops wait for the
op-catalog slice (ROADMAP Queue A item 2).
"""
from __future__ import annotations

import torch

from .registry import register


@register("broadcast_add", arg_names=("lhs", "rhs"),
          aliases=("broadcast_plus", "elemwise_add", "_plus", "_Plus"),
          doc="broadcasting broadcast_add")
def _broadcast_add(lhs, rhs, **_):
    return torch.add(lhs, rhs)


@register("_plus_scalar", arg_names=("data",), aliases=("_PlusScalar",),
          defaults={"scalar": 0.0})
def _plus_scalar(x, scalar=0.0, **_):
    # the scalar takes x's dtype first (jnp.asarray(scalar, x.dtype)):
    # an int tensor stays int, and a bf16 tensor adds the bf16-rounded
    # scalar
    return x + torch.as_tensor(scalar, dtype=x.dtype, device=x.device)


@register("_copy", arg_names=("data",), aliases=("identity",))
def _copy(x, **_):
    return x
