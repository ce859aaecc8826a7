"""The operator registry — the PyTorch twin of ``mxnet_tpu/ops/registry.py``.

Every op is ONE function ``fn(*tensors, **attrs)`` on ``torch.Tensor``s,
registered with the same ``OpDef`` fields as the JAX package, so the
Symbol graph, its JSON and (in a later slice) the eager ``mx.nd`` path
and autograd all share one entry per op. PyTorch runs eagerly: there is
no per-(op, attrs) compile cache here.

The eager dispatch (``invoke_eager``) comes with NDArray autograd
(ROADMAP Queue A item 1).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["OpDef", "register", "get_op", "list_ops", "canon_attrs",
           "set_arg_select", "set_param_shapes"]

_OP_REGISTRY: dict[str, "OpDef"] = {}
_ALIASES: dict[str, str] = {}


@dataclass
class OpDef:
    """One operator.

    fn: function ``(*tensors, **attrs) -> tensor | tuple``. When
        ``needs_rng`` it must also accept an ``rng`` keyword (a
        ``torch.Generator``); when ``takes_is_train`` it receives
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
