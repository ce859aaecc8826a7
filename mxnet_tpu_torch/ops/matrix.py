"""Shape ops ported so far — ``reshape`` (with the MXNet special codes
and ``reverse``), ``Flatten``, ``transpose``, ``expand_dims``,
``slice_axis``, ``Concat`` —
with the semantics of ``mxnet_tpu/ops/matrix.py``. The rest of that
file's ops wait for the op-catalog slice (ROADMAP Queue A item 2).
"""
from __future__ import annotations

import torch

from .registry import register


def _reshape_target(in_shape, shape, reverse):
    """The MXNet special codes: 0 copy dim, -1 infer, -2 copy rest,
    -3 merge two, -4 split (src/operator/tensor/matrix_op-inl.h
    InferReshapeShape)."""
    src = list(in_shape[::-1]) if reverse else list(in_shape)
    out = []
    i = 0
    shp = list(shape[::-1]) if reverse else list(shape)
    k = 0
    while k < len(shp):
        s = shp[k]
        if s == 0:
            out.append(src[i]); i += 1
        elif s == -1:
            out.append(-1); i += 1
        elif s == -2:
            out.extend(src[i:]); i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif s == -4:
            a, b = shp[k + 1], shp[k + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b]); i += 1; k += 2
        else:
            out.append(s)
            if i < len(src):
                i += 1
        k += 1
    if reverse:
        out = out[::-1]
    return tuple(out)


@register("reshape", arg_names=("data",), aliases=("Reshape",),
          defaults={"shape": (), "reverse": False})
def _reshape(x, shape=(), reverse=False, **_):
    shape = tuple(shape)
    if not shape:
        return x
    return x.reshape(_reshape_target(tuple(x.shape), shape, reverse))


@register("Flatten", arg_names=("data",), aliases=("flatten",))
def _flatten(x, **_):
    return x.reshape(x.shape[0], -1)


@register("transpose", arg_names=("data",), defaults={"axes": ()})
def _transpose(x, axes=(), **_):
    axes = tuple(axes) if axes else tuple(range(x.dim() - 1, -1, -1))
    return x.permute(axes)


@register("expand_dims", arg_names=("data",), defaults={"axis": 0})
def _expand_dims(x, axis=0, **_):
    return torch.unsqueeze(x, axis)


@register("slice_axis", arg_names=("data",),
          defaults={"axis": 0, "begin": 0, "end": None})
def _slice_axis(x, axis=0, begin=0, end=None, **_):
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


@register("Concat", arg_names=None, aliases=("concat",),
          defaults={"dim": 1, "num_args": 0})
def _concat(*args, dim=1, **_):
    # jnp.concatenate promotes mixed dtypes; torch.cat does the same
    return torch.cat(args, dim=dim)
