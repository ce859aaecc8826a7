"""The ``Custom`` operator — user-defined Python ops in a graph — the
PyTorch twin of ``mxnet_tpu/ops/custom.py``.

Reference: src/operator/custom/custom.cc + python/mxnet/operator.py.
One ``torch.autograd.Function`` runs the user's ``CustomOp``: its forward
calls ``CustomOp.forward`` with the port's NDArrays on the op's device
(``req`` "write"), its backward ``CustomOp.backward``; the user's code
runs inside that device's context scope, so the arrays it makes land
there. It is a host round trip by construction, as in the reference,
and a CUDA graph cannot capture it: ``refuse_capture`` names the Custom
nodes of a graph that an export or a captured step would hold.

The prop registry lives here; the user-facing classes (CustomOp,
CustomOpProp, register) are in ``mxnet_tpu_torch/operator.py``. One
``CustomOp`` is made a (prop, input shapes, dtypes, device) at its first
call and kept, as the reference keeps one a bound executor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from .registry import register, set_param_shapes

_PROP_REGISTRY: dict[str, type] = {}
_PROP_CACHE: dict[tuple, object] = {}


def register_prop(reg_name, prop_cls):
    _PROP_REGISTRY[reg_name] = prop_cls
    for key in [k for k in _PROP_CACHE if k[0] == reg_name]:
        del _PROP_CACHE[key]


def create_prop(op_type, kwargs):
    """Prop instance for (op_type, kwargs) — cached, since num_outputs /
    shape-inference queries hit this several times per graph node."""
    if op_type not in _PROP_REGISTRY:
        raise KeyError(
            "custom op type %r is not registered — decorate its "
            "CustomOpProp with @mx.operator.register(%r)"
            % (op_type, op_type))
    try:
        key = (op_type, tuple(sorted(kwargs.items())))
        hash(key)
    except TypeError:
        return _PROP_REGISTRY[op_type](**kwargs)
    if key not in _PROP_CACHE:
        _PROP_CACHE[key] = _PROP_REGISTRY[op_type](**kwargs)
    return _PROP_CACHE[key]


def _infer(prop, in_shapes, in_dtypes):
    """Run the prop's shape/type inference; returns (in_shapes,
    out_shapes, in_dtypes, out_dtypes) as plain lists."""
    shape_res = prop.infer_shape([list(s) for s in in_shapes])
    ishapes, oshapes = shape_res[0], shape_res[1]
    aux = shape_res[2] if len(shape_res) > 2 else []
    if aux:
        raise NotImplementedError(
            "auxiliary states on Custom ops are not supported (the graph "
            "has no mutable slots for host-managed aux); thread such state "
            "through explicit outputs instead")
    type_res = prop.infer_type(list(in_dtypes))
    itypes, otypes = type_res[0], type_res[1]
    return ([tuple(int(d) for d in s) for s in ishapes],
            [tuple(int(d) for d in s) for s in oshapes],
            [np.dtype(t) for t in itypes], [np.dtype(t) for t in otypes])


def _operator(prop, ishapes, itypes, device):
    """The prop's CustomOp for these shapes, dtypes and device: made at
    the first call, then kept."""
    ops = prop.__dict__.setdefault("_port_operators", {})
    key = (tuple(ishapes), tuple(str(t) for t in itypes), str(device))
    if key not in ops:
        from ..context import context_of
        ops[key] = prop.create_operator(context_of(device), ishapes, itypes)
    return ops[key]


def _run_user(op_type, what, device, fn):
    """Call the user's forward or backward inside the op's device scope
    with recording paused; an error names the op type."""
    from .. import autograd
    from ..context import context_of
    try:
        with context_of(device), autograd.pause():
            fn()
    except Exception as e:  # noqa: BLE001  (re-raised with the op's name)
        raise MXNetError("Custom op %r: its %s raised %s: %s"
                         % (op_type, what, type(e).__name__, e)) from e


class _CustomFn(torch.autograd.Function):
    """One Custom node: forward and backward run the user's CustomOp."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        from ..ndarray.ndarray import NDArray
        op_type, cop, is_train, oshapes, otypes = spec
        dev = inputs[0].device if inputs else torch.device("cpu")
        in_data = [NDArray(x.detach()) for x in inputs]
        out_data = [NDArray(torch.zeros(s, dtype=torch_dtype(t), device=dev))
                    for s, t in zip(oshapes, otypes)]
        _run_user(op_type, "forward", dev, lambda: cop.forward(
            is_train, ["write"] * len(out_data), in_data, out_data, []))
        outs = tuple(o._data for o in out_data)
        ctx.spec = spec
        ctx.device = dev
        ctx.save_for_backward(*inputs, *outs)
        ctx.n_in = len(inputs)
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        from ..ndarray.ndarray import NDArray
        op_type, cop = ctx.spec[0], ctx.spec[1]
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        in_data = [NDArray(x.detach()) for x in ins]
        out_data = [NDArray(o.detach()) for o in outs]
        out_grad = [NDArray(g.detach()) for g in gouts]
        in_grad = [NDArray(torch.zeros_like(x)) for x in ins]
        _run_user(op_type, "backward", ctx.device, lambda: cop.backward(
            ["write"] * len(in_grad), out_grad, in_data, out_data, in_grad,
            []))
        return (None,) + tuple(
            g._data if need else None
            for g, need in zip(in_grad, ctx.needs_input_grad[1:]))


@register("Custom", arg_names=None, takes_is_train=True,
          defaults={"op_type": None})
def _custom(*inputs, op_type=None, is_train=False, **kwargs):
    """Run one Custom node: the user's forward now, its backward when
    autograd reaches the outputs."""
    prop = create_prop(op_type, kwargs)
    n_out = len(prop.list_outputs())
    in_shapes = [tuple(int(d) for d in x.shape) for x in inputs]
    in_dtypes = [np.dtype(str(x.dtype).replace("torch.", ""))
                 for x in inputs]
    ishapes, oshapes, itypes, otypes = _infer(prop, in_shapes, in_dtypes)
    if any(x.device.type == "meta" for x in inputs):
        outs = tuple(torch.empty(s, dtype=torch_dtype(t), device="meta")
                     for s, t in zip(oshapes, otypes))
    else:
        cop = _operator(prop, ishapes, itypes, inputs[0].device if inputs
                        else torch.device("cpu"))
        outs = _CustomFn.apply((op_type, cop, bool(is_train), oshapes,
                                otypes), *inputs)
    return tuple(outs) if n_out > 1 else outs[0]


def custom_num_outputs(attrs):
    """Output count of a Custom node (Symbol num_outputs hook)."""
    kwargs = {k: v for k, v in attrs.items() if k != "op_type"}
    return len(create_prop(attrs.get("op_type"), kwargs).list_outputs())


def custom_param_shapes(shapes, attrs):
    """Backward shape inference: let the prop fill unknown input shapes
    (e.g. an auto-created label variable)."""
    kwargs = {k: v for k, v in attrs.items() if k != "op_type"}
    prop = create_prop(attrs.get("op_type"), kwargs)
    known = [list(s) if s is not None else None for s in shapes]
    if known and known[0] is not None:
        res = prop.infer_shape(known)
        return [tuple(s) if s is not None else None for s in res[0]]
    return shapes


set_param_shapes("Custom", custom_param_shapes)


def refuse_capture(symbol, what):
    """Raise if ``symbol`` holds a Custom node: ``what`` (an export, a
    captured step or forward) would hold a host callback, which a CUDA
    graph cannot capture, and nothing runs it eagerly instead."""
    from ..symbol.symbol import _topo_order
    nodes = [n for n in _topo_order(symbol._entries)
             if n.op is not None and n.op.name == "Custom"]
    if nodes:
        raise MXNetError(
            "%s: the graph holds Custom node(s) %s (op_type %s), whose "
            "Python forward and backward run on the host; a CUDA graph "
            "cannot capture them. Run this graph through Module, Executor "
            "or Predictor instead" % (
                what, ", ".join(repr(n.name) for n in nodes),
                ", ".join(sorted({repr(n.attrs.get("op_type"))
                                  for n in nodes}))))
