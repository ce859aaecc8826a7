"""Elementwise ops ported so far: ``broadcast_add`` and ``broadcast_mul``
(and their aliases), ``_plus_scalar``, ``_mul_scalar`` and ``_copy``
(``identity``), with the semantics of ``mxnet_tpu/ops/elemwise.py``.
The rest of that file's ops wait for the op-catalog slice (ROADMAP
Queue A item 2).
"""
from __future__ import annotations

import torch

from .registry import register


@register("broadcast_add", arg_names=("lhs", "rhs"),
          aliases=("broadcast_plus", "elemwise_add", "_plus", "_Plus"),
          doc="broadcasting broadcast_add")
def _broadcast_add(lhs, rhs, **_):
    return torch.add(lhs, rhs)


@register("broadcast_mul", arg_names=("lhs", "rhs"),
          aliases=("elemwise_mul", "_mul", "_Mul"),
          doc="broadcasting broadcast_mul")
def _broadcast_mul(lhs, rhs, **_):
    return torch.mul(lhs, rhs)


def _as_scalar(x, scalar):
    # the scalar takes x's dtype first (jnp.asarray(scalar, x.dtype)):
    # an int tensor stays int, and a bf16 tensor takes the bf16-rounded
    # scalar
    return torch.as_tensor(scalar, dtype=x.dtype, device=x.device)


@register("_plus_scalar", arg_names=("data",), aliases=("_PlusScalar",),
          defaults={"scalar": 0.0})
def _plus_scalar(x, scalar=0.0, **_):
    return x + _as_scalar(x, scalar)


@register("_mul_scalar", arg_names=("data",), aliases=("_MulScalar",),
          defaults={"scalar": 0.0})
def _mul_scalar(x, scalar=0.0, **_):
    return x * _as_scalar(x, scalar)


@register("_copy", arg_names=("data",), aliases=("identity",))
def _copy(x, **_):
    return x
