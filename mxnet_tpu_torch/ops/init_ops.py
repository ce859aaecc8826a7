"""Creation ops (no tensor inputs) and ``*_like``, with the semantics of
``mxnet_tpu/ops/init_ops.py``.

An op with no tensor input has nothing to take its device from: it makes
its tensor on ``device`` when the caller passes one (the graph evaluator
passes its inputs' device, shape inference passes ``meta``), else on
the ``ctx`` attr's device, else on the current context's. ``_arange``
and ``_eye`` fill on the host with numpy, as ``jnp.arange`` and
``jnp.eye`` do for concrete arguments, so their values are the same bits
in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import np_dtype, torch_dtype
from ..context import Context, current_context
from .registry import register


def _device(ctx, device):
    if device is not None:
        return torch.device(device)
    if isinstance(ctx, Context):
        return ctx.torch_device()
    return current_context().torch_device()


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _from_host(arr, dtype, device):
    if device.type == "meta":
        return torch.empty(arr.shape, dtype=dtype, device=device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                          dtype=dtype)


@register("_zeros", arg_names=(), differentiable=False,
          defaults={"shape": (), "dtype": "float32", "ctx": None})
def _zeros(shape=(), dtype="float32", ctx=None, device=None, **_):
    return torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                       device=_device(ctx, device))


@register("_ones", arg_names=(), differentiable=False,
          defaults={"shape": (), "dtype": "float32", "ctx": None})
def _ones(shape=(), dtype="float32", ctx=None, device=None, **_):
    return torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                      device=_device(ctx, device))


@register("_full", arg_names=(), differentiable=False,
          defaults={"shape": (), "dtype": "float32", "value": 0.0,
                    "ctx": None})
def _full(shape=(), dtype="float32", value=0.0, ctx=None, device=None,
          **_):
    return torch.full(_shape(shape), value, dtype=torch_dtype(dtype),
                      device=_device(ctx, device))


def _host_dtype(dtype):
    dt = np_dtype(dtype)
    return np.float32 if dt is torch.bfloat16 else dt


@register("_arange", arg_names=(), differentiable=False,
          defaults={"start": 0.0, "stop": None, "step": 1.0, "repeat": 1,
                    "dtype": "float32", "ctx": None})
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            ctx=None, device=None, **_):
    out = np.arange(start, stop, step, dtype=_host_dtype(dtype))
    if repeat > 1:
        out = np.repeat(out, repeat)
    return _from_host(out, torch_dtype(dtype), _device(ctx, device))


@register("zeros_like", arg_names=("data",), differentiable=False)
def _zeros_like(x, **_):
    return torch.zeros_like(x)


@register("ones_like", arg_names=("data",), differentiable=False)
def _ones_like(x, **_):
    return torch.ones_like(x)


@register("_eye", arg_names=(), differentiable=False,
          defaults={"N": 0, "M": 0, "k": 0, "dtype": "float32", "ctx": None})
def _eye(N=0, M=0, k=0, dtype="float32", ctx=None, device=None, **_):
    out = np.eye(N, M or None, k=k, dtype=_host_dtype(dtype))
    return _from_host(out, torch_dtype(dtype), _device(ctx, device))
