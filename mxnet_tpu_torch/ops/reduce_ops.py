"""Reductions, broadcasting helpers and the softmax family, with the
semantics of ``mxnet_tpu/ops/reduce_ops.py``.

MXNet's reduce rules: ``axis=None`` reduces everything to shape (1,);
``keepdims`` keeps the reduced dims; ``exclude`` inverts the axis set.
Integer sums and products stay in the input's dtype (jax without x64
never widens to int64, torch does), and max/min pass the gradient to
every tied maximum in equal shares, as ``jnp.max`` does.
``softmax_cross_entropy`` SUMS over the batch.
"""
from __future__ import annotations

import torch

from .registry import register


def _axes(x, axis, exclude=False):
    if axis is None or axis == ():
        axes = tuple(range(x.dim()))
    elif isinstance(axis, int):
        axes = (axis % x.dim(),)
    else:
        axes = tuple(a % x.dim() for a in axis)
    if exclude:
        axes = tuple(a for a in range(x.dim()) if a not in axes)
    return axes


def _keep_int(fn):
    """A torch reduction that widens ints to int64, narrowed back to the
    input's dtype as jnp's does."""
    def f(x, a, k):
        out = fn(x, a, k)
        if not x.is_floating_point() and out.dtype != x.dtype:
            out = out.to(torch.int32 if x.dtype == torch.bool else x.dtype)
        return out
    return f


def _prod(x, a, k):
    for ax in sorted(a, reverse=True):
        x = torch.prod(x, dim=ax, keepdim=k)
    return x


def _amax(x, a, k):
    return torch.amax(x, dim=a, keepdim=k)


def _amin(x, a, k):
    return torch.amin(x, dim=a, keepdim=k)


def _mean(x, a, k):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=a, keepdim=k)


def _reduce(name, fn, differentiable=True, aliases=()):
    @register(name, arg_names=("data",), differentiable=differentiable,
              aliases=aliases,
              defaults={"axis": None, "keepdims": False, "exclude": False})
    def _f(x, axis=None, keepdims=False, exclude=False, **_):
        axes = _axes(x, axis, exclude)
        out = fn(x, axes, keepdims) if axes else x   # torch: () = all
        if axis is None and not keepdims:
            out = out.reshape((1,)) if out.dim() == 0 else out
        return out
    return _f


_reduce("sum", _keep_int(lambda x, a, k: torch.sum(x, dim=a, keepdim=k)),
        aliases=("sum_axis",))
_reduce("mean", _mean)
_reduce("prod", _keep_int(_prod))
_reduce("nansum", _keep_int(
    lambda x, a, k: torch.nansum(x, dim=a, keepdim=k)
    if x.is_floating_point() else torch.sum(x, dim=a, keepdim=k)))
_reduce("nanprod", _keep_int(
    lambda x, a, k: _prod(torch.where(torch.isnan(x), torch.ones_like(x), x)
                          if x.is_floating_point() else x, a, k)))
_reduce("max", _amax, aliases=("max_axis",))
_reduce("min", _amin, aliases=("min_axis",))


def _arg_reduce(fn, x, axis, keepdims):
    out = fn(x.reshape(-1) if axis is None else x,
             dim=0 if axis is None else axis)
    out = out.to(torch.float32)
    if keepdims and axis is not None:
        out = torch.unsqueeze(out, axis)
    return out


@register("argmax", arg_names=("data",), differentiable=False,
          defaults={"axis": None, "keepdims": False})
def _argmax(x, axis=None, keepdims=False, **_):
    return _arg_reduce(torch.argmax, x, axis, keepdims)


@register("argmin", arg_names=("data",), differentiable=False,
          defaults={"axis": None, "keepdims": False})
def _argmin(x, axis=None, keepdims=False, **_):
    return _arg_reduce(torch.argmin, x, axis, keepdims)


@register("argmax_channel", arg_names=("data",), differentiable=False)
def _argmax_channel(x, **_):
    return torch.argmax(x, dim=-1).to(torch.float32)


@register("norm", arg_names=("data",),
          defaults={"ord": 2, "axis": None, "keepdims": False})
def _norm(x, ord=2, axis=None, keepdims=False, **_):
    if axis is None:
        return torch.sqrt(torch.sum(torch.square(x))).reshape((1,))
    # numpy's rules, as jnp.linalg.norm: a vector norm over one axis, a
    # matrix norm over two
    return torch.linalg.norm(x, ord=ord, dim=axis, keepdim=keepdims)


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


@register("broadcast_axis", arg_names=("data",), aliases=("broadcast_axes",),
          defaults={"axis": (), "size": ()})
def _broadcast_axis(x, axis=(), size=(), **_):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    shape = list(x.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return torch.broadcast_to(x, tuple(shape))


@register("broadcast_to", arg_names=("data",), defaults={"shape": ()})
def _broadcast_to(x, shape=(), **_):
    tgt = tuple(s if s != 0 else x.shape[i] for i, s in enumerate(shape))
    return torch.broadcast_to(x, tgt)


@register("broadcast_like", arg_names=("lhs", "rhs"), nondiff_inputs=(1,))
def _broadcast_like(lhs, rhs, **_):
    return torch.broadcast_to(lhs, rhs.shape)


# -- softmax family -----------------------------------------------------------

@register("softmax", arg_names=("data",),
          defaults={"axis": -1, "temperature": None})
def _softmax(x, axis=-1, temperature=None, **_):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.softmax(x, dim=axis)


@register("log_softmax", arg_names=("data",),
          defaults={"axis": -1, "temperature": None})
def _log_softmax(x, axis=-1, temperature=None, **_):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.log_softmax(x, dim=axis)


@register("softmax_cross_entropy", arg_names=("data", "label"),
          nondiff_inputs=(1,))
def _softmax_xent(data, label, **_):
    logp = torch.log_softmax(data, dim=-1)
    idx = label.to(torch.int32).long()
    picked = torch.gather(logp, -1, idx[:, None])
    return -torch.sum(picked).reshape((1,))
