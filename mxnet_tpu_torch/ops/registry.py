"""The operator registry — the PyTorch twin of ``mxnet_tpu/ops/registry.py``.

Every op is ONE function ``fn(*tensors, **attrs)`` on ``torch.Tensor``s,
registered with the same ``OpDef`` fields as the JAX package, so the
Symbol graph, its JSON, the eager ``mx.nd`` path (``invoke_eager``) and
autograd all share one entry per op and reach the same kernels.
PyTorch runs eagerly: there is no per-(op, attrs) compile cache here.

Under the replica mesh axes (``data``, ``fsdp``: the batch split over
ranks) a graph's tensors hold this rank's batch rows, and the ops that
reduce over or mix the batch axis follow ``ops/_batch_global.py``'s
rules (ROADMAP Queue C 17):

* global when the reduced axes include the batch axis (axis None among
  them): ``sum``/``sum_axis``, ``nansum``, ``mean`` (the global count),
  ``prod``, ``nanprod``, ``max``/``max_axis``, ``min``/``min_axis``,
  ``norm`` (axis None or one axis) and ``softmax_cross_entropy``; the
  loss heads' divisors (``SoftmaxOutput``, ``MakeLoss``,
  ``_contrib_ChunkedSoftmaxCE``), ``BatchNorm``'s statistics on every
  route, ``Dropout``'s counters and the MoE route are global in the ops
  themselves;
* refused with ``MXNetError`` naming Queue C 17 when they mix batch rows:
  ``slice_axis``, ``take``, ``pick`` along axis 0, ``slice`` cutting dim
  0, a ``reshape`` that moves or merges the batch axis out of dim 0,
  ``transpose``, ``SwapAxis``, ``expand_dims`` and ``stack`` moving it,
  ``dot`` contracting over it, ``batch_dot`` on a batched operand of
  fewer than 3 dims, and ``softmax``, ``log_softmax``, ``sort``,
  ``argsort``, ``topk``, ``argmax``, ``argmin``, ``reverse``, ``Concat``,
  ``SliceChannel`` along axis 0.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from .. import profiler as _profiler

__all__ = ["OpDef", "register", "get_op", "list_ops", "canon_attrs",
           "set_arg_select", "set_param_shapes", "invoke_eager"]

_OP_REGISTRY: dict[str, "OpDef"] = {}
_ALIASES: dict[str, str] = {}


@dataclass
class OpDef:
    """One operator.

    fn: function ``(*tensors, **attrs) -> tensor | tuple``. When
        ``needs_rng`` it must also accept an ``rng`` keyword (a threefry
        key, numpy ``uint32[2]``: ``mxnet_tpu_torch.random``); when ``takes_is_train`` it receives
        ``is_train: bool``.
    arg_names: tensor-input names in order; None => variadic (add_n, Concat).
    num_visible: user-facing outputs (BatchNorm computes 5, exposes 3 —
        mirroring num_visible_outputs in the reference's nnvm registration).
    state_inputs: input indices that receive the trailing fn outputs as
        in-place updates (aux states: BN moving_mean/var; optimizer weight).
    """
    name: str
    fn: Callable
    arg_names: Optional[tuple] = None
    differentiable: bool = True
    needs_rng: bool = False
    takes_is_train: bool = False
    num_visible: Optional[int] = None
    state_inputs: tuple = ()
    nondiff_inputs: tuple = ()   # input indices with no gradient (e.g. indices)
    aliases: Sequence[str] = field(default_factory=tuple)
    defaults: dict = field(default_factory=dict)
    doc: str = ""
    # symbolic-composition hooks (set post-registration, see set_arg_select /
    # set_param_shapes): ListArguments (arg list depends on params, e.g.
    # no_bias drops "bias") and backward shape inference (weight shapes
    # from the data shape)
    arg_select: Optional[Callable] = None     # attrs -> tuple of active arg names
    param_shapes: Optional[Callable] = None   # (in_shapes list, attrs) -> list
    # attr names whose values are per-step scalars (Adam's bias-corrected
    # lr, schedules); kept for registry parity with the JAX package
    traced_attrs: tuple = ()

    @property
    def num_state(self):
        return len(self.state_inputs)

    def active_args(self, attrs):
        """Tensor-argument names active under these attrs."""
        if self.arg_names is None:
            return None
        if self.arg_select is not None:
            return tuple(self.arg_select(attrs))
        return self.arg_names


def set_arg_select(name, fn):
    """Install the ListArguments-style hook: fn(attrs) -> active arg names."""
    get_op(name).arg_select = fn


def set_param_shapes(name, fn):
    """Install backward shape inference: fn(in_shapes, attrs) -> full list of
    input shapes (in_shapes has None for unknown entries)."""
    get_op(name).param_shapes = fn


def register(name, *, arg_names=None, differentiable=True, needs_rng=False,
             takes_is_train=False, num_visible=None, state_inputs=(),
             nondiff_inputs=(), aliases=(), defaults=None, doc="",
             traced_attrs=()):
    """Decorator: register a torch fn as an operator."""
    def deco(fn):
        op = OpDef(name=name, fn=fn,
                   arg_names=tuple(arg_names) if arg_names is not None else None,
                   differentiable=differentiable, needs_rng=needs_rng,
                   takes_is_train=takes_is_train, num_visible=num_visible,
                   state_inputs=tuple(state_inputs),
                   nondiff_inputs=tuple(nondiff_inputs),
                   aliases=tuple(aliases), defaults=dict(defaults or {}),
                   doc=doc or fn.__doc__ or "",
                   traced_attrs=tuple(traced_attrs))
        if name in _OP_REGISTRY:
            raise ValueError("duplicate op registration %r" % name)
        _OP_REGISTRY[name] = op
        for a in op.aliases:
            _ALIASES[a] = name
        return fn
    return deco


def get_op(name) -> OpDef:
    if name in _OP_REGISTRY:
        return _OP_REGISTRY[name]
    if name in _ALIASES:
        return _OP_REGISTRY[_ALIASES[name]]
    raise KeyError("operator %r is not registered (not ported yet, or "
                   "unknown)" % (name,))


def list_ops():
    return sorted(set(_OP_REGISTRY) | set(_ALIASES))


# ---------------------------------------------------------------------------
# attr canonicalization — attrs arrive as python values or strings (symbol
# JSON round-trip, reference dmlc::Parameter string parsing).
# ---------------------------------------------------------------------------

def _parse_attr_value(v):
    if isinstance(v, str):
        s = v.strip()
        low = s.lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("none", "null"):
            return None
        try:
            return ast.literal_eval(s)
        except (ValueError, SyntaxError):
            return v
    return v


def _hashable(v):
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, np.ndarray):
        return tuple(v.ravel().tolist()) if v.size < 64 else v.tobytes()
    if isinstance(v, np.generic):
        return v.item()
    return v


def canon_attrs(opdef, attrs):
    """Merge defaults, parse string values, make everything hashable."""
    out = dict(opdef.defaults)
    for k, v in attrs.items():
        if v is None and k not in opdef.defaults:
            out[k] = None
            continue
        out[k] = _hashable(_parse_attr_value(v))
    return out


# ---------------------------------------------------------------------------
# eager dispatch
# ---------------------------------------------------------------------------

def invoke_eager(opdef, nd_inputs, attrs, out=None):
    """Run one op eagerly (``_invoke_eager``); under the profiler's
    ``mode='all'`` the call is timed into its host timeline under the
    op's registry name, category ``"operator"`` (reference: the engine
    profiler's kAllOperator mode). Stopped, this costs one attribute
    read."""
    if _profiler._P.timing_ops:
        with _profiler.scope(opdef.name, "operator"):
            return _invoke_eager(opdef, nd_inputs, attrs, out)
    return _invoke_eager(opdef, nd_inputs, attrs, out)


def _invoke_eager(opdef, nd_inputs, attrs, out=None):
    """Imperative invoke (analogue of ImperativeInvokeImpl,
    src/c_api/c_api_ndarray.cc:491; the JAX package's
    ``ops/registry.py:invoke_eager``): unwrap NDArrays, run the op's
    function once, wrap the visible outputs, write the state outputs back
    (BatchNorm's moving stats, the fused updates' weights and moments)
    and honour ``out=``.

    Under ``autograd.record()`` a differentiable op runs with torch's
    grad mode on, so its outputs carry their backward; otherwise (and for
    a non-differentiable op) grad mode is off and the outputs are
    detached, so arrays that carry ``attach_grad`` build no graph outside
    ``record()``. Inputs listed in ``nondiff_inputs`` enter detached and
    never receive a gradient. Writebacks and ``out=`` give their arrays
    new tensors (``NDArray._set_data``) and take no part in the graph."""
    import torch
    from ..ndarray.ndarray import NDArray, _wrap, array
    from .. import autograd
    from .. import random as mx_random

    arrays = []
    for i, x in enumerate(nd_inputs):
        if isinstance(x, NDArray):
            if x.stype != "default":
                # a dense op would read the (nnz, ...) values; only the
                # sparse dispatch (ndarray/sparse.py) routes sparse storage
                raise TypeError(
                    "operator %r has no sparse implementation for a %s "
                    "input — cast with tostype('default') first"
                    % (opdef.name, x.stype))
            t = x._data
        else:
            t = array(x, ctx=_input_context(nd_inputs))._data
        arrays.append(t.detach() if i in opdef.nondiff_inputs else t)

    attrs = canon_attrs(opdef, attrs)
    if opdef.takes_is_train and "is_train" not in attrs:
        attrs["is_train"] = autograd.is_training()
    if opdef.needs_rng:
        # one split of the global stream per call, as the JAX package
        attrs["rng"] = mx_random.next_key()

    recording = autograd.is_recording() and opdef.differentiable
    with torch.set_grad_enabled(recording):
        raw = opdef.fn(*arrays, **attrs)
    outs = list(raw) if isinstance(raw, (tuple, list)) else [raw]
    if not recording:
        outs = [o.detach() for o in outs]

    n_state = opdef.num_state
    if n_state:
        state_outs = outs[-n_state:]
        outs = outs[:-n_state]
        for idx, val in zip(opdef.state_inputs, state_outs):
            if idx < len(nd_inputs) and isinstance(nd_inputs[idx], NDArray):
                nd_inputs[idx]._set_data(val.detach())

    n_vis = opdef.num_visible if opdef.num_visible is not None else len(outs)
    nd_outs = [_wrap(o) for o in outs[:n_vis]]

    if out is not None:
        out_list = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(out_list, nd_outs):
            dst._set_data(src._data)
        return out
    if len(nd_outs) == 1:
        return nd_outs[0]
    return nd_outs


def _input_context(nd_inputs):
    """The context of the first NDArray input (else the current one):
    where a host array given beside it is placed."""
    from ..context import current_context
    from ..ndarray.ndarray import NDArray
    for x in nd_inputs:
        if isinstance(x, NDArray):
            return x.context
    return current_context()
