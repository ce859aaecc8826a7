"""The graph's ops on this rank's batch rows under the replica axes
(``data``, ``fsdp``): the rules that keep a graph evaluated rank by rank
the JAX package's one global program (ROADMAP Queue C 17).

The executor tracks which tensors hold this rank's rows of the batch on
dim 0 (the batch inputs, and every op output with such an input) and,
under an active replica axis, runs each op that has a rule here through
it instead of calling it alone:

* covered: ``sum`` (``sum_axis``), ``nansum``, ``mean``, ``prod``,
  ``nanprod``, ``max`` (``max_axis``), ``min`` (``min_axis``), ``norm``
  (axis None or one axis) and ``softmax_cross_entropy``. When the
  reduced axes include the batch axis (axis None among them) each
  reduces locally, then over the replica axes: a sum (``mean`` divides
  by the global count; ``norm`` is the root of the global sum of
  squares), a product of the ranks' products, or the extreme of the
  ranks' extremes. The result is the same on every rank and no longer
  holds batch rows. Backward: the partial cotangents of the ranks are
  summed (every rank's loss covers its own rows); an extreme's goes to
  the elements equal to it, in equal shares over all ranks' ties, as
  ``jnp.max`` shares it.
* refused (``MXNetError`` naming Queue C 17) when they mix batch rows:
  ``slice_axis``, ``take`` and ``pick`` along axis 0; ``slice`` cutting
  dim 0; a ``reshape`` whose result's rows are not this rank's block of
  the global result's (the batch axis merged into a later position, or
  split); ``transpose``, ``SwapAxis``, ``expand_dims`` and ``stack``
  moving the batch axis off dim 0; ``dot`` contracting over it (or
  taking a batched right operand) and ``batch_dot`` on a batched
  operand of fewer than 3 dims; ``softmax``, ``log_softmax``, ``sort``,
  ``argsort``, ``topk``, ``argmax``, ``argmin``, ``reverse``,
  ``Concat`` and ``SliceChannel`` along axis 0 (or over the flattened
  tensor).

A graph output that holds no batch rows (a reduced loss, a parameter
penalty) is the same on every rank, and every rank's head cotangent
covers all of it: its cotangent is divided by the replica count, so the
ranks' gradients sum to the one global program's.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..parallel import _comm
from .matrix import _reshape_target
from .reduce_ops import _axes
from .registry import get_op

__all__ = ["RULES", "scale_replicated"]


def _refuse(op, why):
    raise MXNetError(
        "%s %s under a replica mesh axis (data/fsdp split the batch over "
        "ranks, and this op would mix batch rows across them); not "
        "supported (ROADMAP Queue C 17)" % (op, why))


def _gsum(t, rep):
    return _comm.global_sum(t, rep.mesh, rep.axes)


class _Extreme(torch.autograd.Function):
    """The extreme over the ranks of each rank's local extreme ``local``;
    ``ties`` counts the local elements equal to it."""

    @staticmethod
    def forward(ctx, local, ties, mesh, axes, op):
        g = local.detach().clone()
        _comm.all_reduce_([g], mesh, axes, op)
        hit = local.detach() == g
        total = torch.where(hit, ties, torch.zeros_like(ties))
        _comm.all_reduce_([total], mesh, axes, "sum")
        ctx.save_for_backward(hit, ties, total)
        ctx.args = (mesh, axes)
        return g

    @staticmethod
    def backward(ctx, grad):
        hit, ties, total = ctx.saved_tensors
        mesh, axes = ctx.args
        g = grad.contiguous().clone()
        _comm.all_reduce_([g], mesh, axes, "sum")
        share = torch.where(hit, g * ties / total.clamp_min(1),
                            torch.zeros_like(g))
        return share.to(grad.dtype), None, None, None, None


def _reduction(kind):
    def rule(fn, xs, attrs, batched, rep, name):
        x = xs[0]
        axes = _axes(x, attrs.get("axis"), attrs.get("exclude", False))
        if 0 not in axes:
            return fn(*xs, **attrs), True
        if kind == "sum":
            return _gsum(fn(*xs, **attrs), rep), False
        if kind == "mean":
            xf = x if x.is_floating_point() else x.to(torch.float32)
            s = get_op("sum").fn(xf, **attrs)
            count = math.prod(x.shape[a] for a in axes) * rep.n
            return _gsum(s, rep) / count, False
        if kind == "prod":
            local = fn(*xs, **attrs)
            stack = _comm.all_gather_axes(local.unsqueeze(0), rep.mesh,
                                          rep.axes, 0)
            return torch.prod(stack, dim=0).to(local.dtype), False
        if kind == "norm":
            ord_ = attrs.get("ord", 2)
            axis = attrs.get("axis")
            if (axis is not None and not isinstance(axis, int) and
                    len(tuple(axis)) > 1) or ord_ not in (2, None, "fro"):
                _refuse(name, "(a matrix norm or ord=%r over the batch "
                        "axis)" % (ord_,))
            keep = bool(attrs.get("keepdims", False)) and axis is not None
            ss = torch.sum(torch.square(x), dim=axes, keepdim=keep)
            out = torch.sqrt(_gsum(ss, rep))
            return (out.reshape((1,)) if axis is None else out), False
        # max / min: the local extreme, then the extreme over the ranks
        op = "max" if kind == "max" else "min"
        local = fn(*xs, **attrs)
        ext = torch.amax if kind == "max" else torch.amin
        loc_k = ext(x.detach(), dim=axes, keepdim=True)
        ties = (x.detach() == loc_k).sum(dim=axes, keepdim=True).to(
            local.dtype if local.is_floating_point() else torch.float32)
        return _Extreme.apply(local, ties.reshape(local.shape), rep.mesh,
                              rep.axes, op), False
    return rule


def _xent(fn, xs, attrs, batched, rep, name):
    """softmax_cross_entropy sums over the whole batch."""
    return _gsum(fn(*xs, **attrs), rep), False


def _checked(mixes):
    """A rule calling the op once ``mixes(xs, attrs, batched, rep)`` said it
    keeps batch rows apart (a string says how it mixes them)."""
    def rule(fn, xs, attrs, batched, rep, name):
        why = mixes(xs, attrs, batched, rep)
        if why:
            _refuse(name, why)
        return fn(*xs, **attrs), True
    return rule


def _along0(key, default):
    """Mixes when the op works along axis 0 (or the flattened tensor)
    of its batched first input."""
    def mixes(xs, attrs, batched, rep):
        if not batched[0]:
            return None
        axis = attrs.get(key, default)
        if axis is None or (isinstance(axis, int)
                            and axis % max(xs[0].dim(), 1) == 0):
            return "along the batch axis (%s=%r)" % (key, axis)
        return None
    return mixes


def _reshape_mixes(xs, attrs, batched, rep):
    if not batched[0] or not attrs.get("shape"):
        return None
    x, shape, rev = xs[0], tuple(attrs["shape"]), attrs.get("reverse",
                                                            False)
    local = list(x.shape)
    glob = [local[0] * rep.n] + local[1:]

    def solve(src):
        out = list(_reshape_target(tuple(src), shape, rev))
        if -1 in out:
            known = math.prod(d for d in out if d != -1)
            out[out.index(-1)] = math.prod(src) // max(known, 1)
        return out
    try:
        lo, gl = solve(local), solve(glob)
    except (IndexError, ZeroDivisionError):
        return "with a target shape %r that does not keep the batch axis " \
            "first" % (shape,)
    if not lo or lo[1:] != gl[1:] or lo[0] * rep.n != gl[0]:
        return "to %r, which moves or merges the batch axis out of " \
            "dim 0" % (shape,)
    return None


def _transpose_mixes(xs, attrs, batched, rep):
    if not batched[0] or xs[0].dim() < 2:
        return None
    axes = tuple(attrs.get("axes") or ())
    first = axes[0] if axes else xs[0].dim() - 1
    return None if first % xs[0].dim() == 0 else \
        "moving the batch axis (axes=%r)" % (axes,)


def _swap_mixes(xs, attrs, batched, rep):
    d1, d2 = attrs.get("dim1", 0), attrs.get("dim2", 0)
    nd = max(xs[0].dim(), 1)
    if batched[0] and d1 % nd != d2 % nd and 0 in (d1 % nd, d2 % nd):
        return "swapping the batch axis (dim1=%r, dim2=%r)" % (d1, d2)
    return None


def _expand_mixes(xs, attrs, batched, rep):
    if batched[0] and attrs.get("axis", 0) % (xs[0].dim() + 1) == 0:
        return "inserting a dim before the batch axis"
    return None


def _dot_mixes(xs, attrs, batched, rep):
    if batched[0] and attrs.get("transpose_a"):
        return "contracting over the batch axis (transpose_a)"
    if len(batched) > 1 and batched[1]:
        return "with a batched right operand (contracting over the " \
            "batch axis, or moving it off dim 0)"
    return None


def _batch_dot_mixes(xs, attrs, batched, rep):
    if any(b and x.dim() < 3 for b, x in zip(batched, xs)):
        return "on a batched operand of fewer than 3 dims"
    return None


def _take_mixes(xs, attrs, batched, rep):
    if batched[0] and attrs.get("axis", 0) % max(xs[0].dim(), 1) == 0:
        return "along the batch axis"
    return None


def _slice_mixes(xs, attrs, batched, rep):
    if not batched[0]:
        return None
    begin, end = attrs.get("begin", ()), attrs.get("end", ())
    step = attrs.get("step") or ()
    begin = (begin,) if isinstance(begin, int) else tuple(begin)
    end = (end,) if isinstance(end, int) else tuple(end)
    step = (step,) if isinstance(step, int) else tuple(step)
    b0 = begin[0] if begin else None
    e0 = end[0] if end else None
    s0 = step[0] if step else None
    if b0 not in (None, 0) or e0 not in (None, xs[0].shape[0]) or \
            s0 not in (None, 1):
        return "cutting the batch axis"
    return None


def _concat_mixes(xs, attrs, batched, rep):
    if any(batched) and attrs.get("dim", 1) % max(xs[0].dim(), 1) == 0:
        return "along the batch axis"
    return None


def _stack_mixes(xs, attrs, batched, rep):
    if any(batched) and attrs.get("axis", 0) % (xs[0].dim() + 1) == 0:
        return "along a new dim before the batch axis"
    return None


def _reverse_mixes(xs, attrs, batched, rep):
    axis = attrs.get("axis", ())
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    if batched[0] and any(a % max(xs[0].dim(), 1) == 0 for a in axis):
        return "along the batch axis"
    return None


RULES = {
    "sum": _reduction("sum"), "nansum": _reduction("sum"),
    "mean": _reduction("mean"), "prod": _reduction("prod"),
    "nanprod": _reduction("prod"), "max": _reduction("max"),
    "min": _reduction("min"), "norm": _reduction("norm"),
    "softmax_cross_entropy": _xent,
    "slice_axis": _checked(_along0("axis", 0)),
    "take": _checked(_take_mixes),
    "pick": _checked(_along0("axis", -1)),
    "slice": _checked(_slice_mixes),
    "reshape": _checked(_reshape_mixes),
    "transpose": _checked(_transpose_mixes),
    "SwapAxis": _checked(_swap_mixes),
    "expand_dims": _checked(_expand_mixes),
    "stack": _checked(_stack_mixes),
    "dot": _checked(_dot_mixes),
    "batch_dot": _checked(_batch_dot_mixes),
    "softmax": _checked(_along0("axis", -1)),
    "log_softmax": _checked(_along0("axis", -1)),
    "sort": _checked(_along0("axis", -1)),
    "argsort": _checked(_along0("axis", -1)),
    "topk": _checked(_along0("axis", -1)),
    "argmax": _checked(_along0("axis", None)),
    "argmin": _checked(_along0("axis", None)),
    "reverse": _checked(_reverse_mixes),
    "Concat": _checked(_concat_mixes),
    "SliceChannel": _checked(_along0("axis", 1)),
}


def run(op, xs, attrs, batched, rep):
    """(raw outputs, whether they hold batch rows) of ``op`` on ``xs``
    whose batch flags are ``batched`` under the active replica ``rep``."""
    rule = RULES.get(op.name)
    if rule is None or not any(batched):
        return op.fn(*xs, **attrs), any(batched)
    return rule(op.fn, xs, attrs, batched, rep, op.name)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.k, None


def scale_replicated(out, rep):
    """A graph output that holds no batch rows, with its cotangent
    divided by the replica count (see the module doc)."""
    if not out.requires_grad or not out.is_floating_point():
        return out
    return _ScaleGrad.apply(out, 1.0 / rep.n)
