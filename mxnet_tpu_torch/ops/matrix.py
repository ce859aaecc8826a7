"""Shape-manipulation and matrix ops, with the semantics of
``mxnet_tpu/ops/matrix.py``: reshape (the MXNet special codes), transpose,
slices (negative steps included: torch's slices take positive steps
only, so ``_getitem`` flips first), the assign ops (functional: a new
tensor, as ``.at[].set`` gives), repeat, tile, reverse, stack, split,
where, pad, dot and batch_dot (``torch.matmul``; the JAX package computes
them outside any Pallas kernel too), and topk/sort/argsort, whose ties
keep the lower index first as ``lax.top_k`` and jax's stable sorts do
(``lax.top_k`` ranks -0.0 below +0.0, the sorts tie them).
``cast_storage`` is the identity on a dense array, as in the JAX package:
a sparse input or target takes ``ndarray/sparse.py``'s route.
"""
from __future__ import annotations

import numpy as np
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


# -- indexing helpers ---------------------------------------------------------

class _IdxWrap:
    """Hashable wrapper marking a list index (fancy indexing) so it can be
    an attr of the ``_index`` op."""
    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key

    def __hash__(self):
        return hash(("_IdxWrap", self.key))

    def __eq__(self, other):
        return isinstance(other, _IdxWrap) and self.key == other.key


def _normalize_index(key):
    """An index made hashable and canonical, for the ``_index`` op."""
    if isinstance(key, tuple):
        return tuple(_normalize_index(k) for k in key)
    if isinstance(key, slice) or key is None or key is Ellipsis:
        return key
    if isinstance(key, (int, np.integer)):
        return int(key)
    if isinstance(key, list):
        return _IdxWrap(tuple(key))
    return key


def _unwrap_index(key):
    """Inverse of _normalize_index."""
    if isinstance(key, _IdxWrap):
        return list(key.key)
    if isinstance(key, tuple):
        return tuple(_unwrap_index(k) for k in key)
    return key


def _getitem(x, key):
    """``x[key]`` with numpy's rules, negative slice steps included: each
    dim a negative-step slice reads is flipped first, and the slice
    becomes the positive one over the flipped dim."""
    key = key if isinstance(key, tuple) else (key,)
    consumed = sum(1 for k in key if k is not None and k is not Ellipsis)
    out, flips, dim = [], [], 0
    for k in key:
        if k is Ellipsis:
            dim += x.dim() - consumed
        elif k is not None:
            if isinstance(k, slice) and k.step is not None and k.step < 0:
                n = x.shape[dim]
                r = range(*k.indices(n))
                if len(r):
                    flips.append(dim)
                    k = slice(n - 1 - r[0], n - r[-1], -k.step)
                else:
                    k = slice(0, 0)
            dim += 1
        out.append(k)
    if flips:
        x = torch.flip(x, flips)
    return x[tuple(out)]


def _assign_index(begin, end):
    return tuple(slice(b, e) for b, e in zip(begin, end))


@register("SwapAxis", arg_names=("data",), aliases=("swapaxes",),
          defaults={"dim1": 0, "dim2": 0})
def _swapaxes(x, dim1=0, dim2=0, **_):
    return torch.swapaxes(x, dim1, dim2)


@register("squeeze", arg_names=("data",), defaults={"axis": None})
def _squeeze(x, axis=None, **_):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=axis)


@register("slice", arg_names=("data",), aliases=("crop",),
          defaults={"begin": (), "end": (), "step": None})
def _slice(x, begin=(), end=(), step=None, **_):
    begin = (begin,) if isinstance(begin, int) else tuple(begin)
    end = (end,) if isinstance(end, int) else tuple(end)
    step = tuple(step) if step else (None,) * len(begin)
    return _getitem(x, tuple(slice(b, e, s)
                             for b, e, s in zip(begin, end, step)))


@register("slice_like", arg_names=("data", "shape_like"), nondiff_inputs=(1,),
          defaults={"axes": ()})
def _slice_like(x, ref, axes=(), **_):
    axes = tuple(axes) if axes else tuple(range(min(x.dim(), ref.dim())))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a] = slice(0, ref.shape[a])
    return x[tuple(idx)]


@register("_index", arg_names=("data",), defaults={"index": ()})
def _index_op(x, index=(), **_):
    return _getitem(x, _unwrap_index(index))


@register("_slice_assign", arg_names=("lhs", "rhs"),
          defaults={"begin": (), "end": (), "step": None})
def _slice_assign(lhs, rhs, begin=(), end=(), step=None, **_):
    out = lhs.clone()
    out[_assign_index(begin, end)] = rhs
    return out


@register("_crop_assign_scalar", arg_names=("data",),
          defaults={"begin": (), "end": (), "scalar": 0.0})
def _crop_assign_scalar(x, begin=(), end=(), scalar=0.0, **_):
    out = x.clone()
    out[_assign_index(begin, end)] = scalar
    return out


@register("repeat", arg_names=("data",),
          defaults={"repeats": 1, "axis": None})
def _repeat(x, repeats=1, axis=None, **_):
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("tile", arg_names=("data",), defaults={"reps": ()})
def _tile(x, reps=(), **_):
    return torch.tile(x, tuple(reps))


@register("reverse", arg_names=("data",), aliases=("flip",),
          defaults={"axis": ()})
def _reverse(x, axis=(), **_):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(x, axis)


@register("stack", arg_names=None, defaults={"axis": 0, "num_args": 0})
def _stack(*args, axis=0, **_):
    dt = args[0].dtype
    for a in args[1:]:
        dt = torch.promote_types(dt, a.dtype)
    return torch.stack([a.to(dt) for a in args], dim=axis)


@register("SliceChannel", arg_names=("data",), aliases=("split",),
          defaults={"num_outputs": 1, "axis": 1, "squeeze_axis": False})
def _slice_channel(x, num_outputs=1, axis=1, squeeze_axis=False, **_):
    if x.shape[axis] % num_outputs:
        raise ValueError("SliceChannel: axis %d of size %d does not split "
                         "into %d equal parts"
                         % (axis, x.shape[axis], num_outputs))
    parts = torch.split(x, x.shape[axis] // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, dim=axis) for p in parts]
    return tuple(parts)


@register("where", arg_names=("condition", "x", "y"), nondiff_inputs=(0,))
def _where(cond, x, y, **_):
    if cond.shape != x.shape and cond.dim() == 1:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond != 0, x, y)


def _pad_indices(n, before, after, mode, device):
    """Source index of every padded position along one dim: numpy's own
    edge/reflect rule over the positions."""
    idx = np.pad(np.arange(n), (before, after), mode=mode)
    return torch.as_tensor(idx, dtype=torch.long, device=device)


@register("Pad", arg_names=("data",), aliases=("pad",),
          defaults={"mode": "constant", "pad_width": (),
                    "constant_value": 0.0})
def _pad(x, mode="constant", pad_width=(), constant_value=0.0, **_):
    pw = tuple(pad_width)
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if mode == "constant":
        flat = []
        for b, a in reversed(pairs):
            flat += [b, a]
        return torch.nn.functional.pad(x, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError("unknown pad mode %r" % mode)
    for d, (b, a) in enumerate(pairs):
        if b or a:
            x = torch.index_select(x, d, _pad_indices(x.shape[d], b, a, mode,
                                                      x.device))
    return x


@register("dot", arg_names=("lhs", "rhs"),
          defaults={"transpose_a": False, "transpose_b": False})
def _dot(lhs, rhs, transpose_a=False, transpose_b=False, **_):
    if transpose_a:
        lhs = lhs.T if lhs.dim() == 2 else torch.movedim(lhs, 0, -1)
    if transpose_b:
        rhs = rhs.T if rhs.dim() == 2 else torch.movedim(rhs, -1, 0)
    if lhs.dim() == 1 and rhs.dim() == 1:
        return torch.dot(lhs, rhs).reshape((1,))
    return torch.tensordot(lhs, rhs, dims=([lhs.dim() - 1], [0]))


@register("batch_dot", arg_names=("lhs", "rhs"),
          defaults={"transpose_a": False, "transpose_b": False})
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **_):
    if transpose_a:
        lhs = torch.swapaxes(lhs, -1, -2)
    if transpose_b:
        rhs = torch.swapaxes(rhs, -1, -2)
    return torch.matmul(lhs, rhs)


@register("cast_storage", arg_names=("data",), defaults={"stype": "default"})
def _cast_storage(x, stype="default", **_):
    """The dense compute path: storage is metadata (``mx.nd.cast_storage``
    routes a sparse input or target through ndarray/sparse.py), and a
    graph is dense throughout."""
    return x


# -- ordering -----------------------------------------------------------------

def _order_key(x):
    """Integer keys in the order ``lax.top_k`` uses for floats (a total
    order: -0.0 before +0.0; jnp.sort and argsort tie them), the values
    themselves for ints."""
    if not x.is_floating_point():
        return x.long()
    bits = {4: torch.int32, 2: torch.int16}[x.element_size()]
    k = x.view(bits).long()
    return torch.where(k < 0, k ^ torch.iinfo(bits).max, k)


def _ordered_indices(x, axis, ascending):
    """Indices along ``axis`` in order, ties lower index first."""
    k = _order_key(x)
    return torch.argsort(k if ascending else ~k, dim=axis, stable=True)


@register("topk", arg_names=("data",), differentiable=False,
          defaults={"axis": -1, "k": 1, "ret_typ": "indices",
                    "is_ascend": False})
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False, **_):
    axis = axis % x.dim() if axis is not None else x.dim() - 1
    idx = torch.narrow(_ordered_indices(x, axis, is_ascend), axis, 0, k)
    vals = torch.gather(x, axis, idx)
    if ret_typ == "indices":
        return idx.to(torch.float32)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return (vals, idx.to(torch.float32))
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(axis, idx, 1)
    raise ValueError("unknown ret_typ %r" % ret_typ)


@register("sort", arg_names=("data",), differentiable=False,
          defaults={"axis": -1, "is_ascend": True})
def _sort(x, axis=-1, is_ascend=True, **_):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort", arg_names=("data",), differentiable=False,
          defaults={"axis": -1, "is_ascend": True})
def _argsort(x, axis=-1, is_ascend=True, **_):
    out = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch.float32)
