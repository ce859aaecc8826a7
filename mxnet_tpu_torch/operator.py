"""User-defined operators in Python (``mx.operator``) — the PyTorch twin
of ``mxnet_tpu/operator.py``.

Reference surface: python/mxnet/operator.py:413-459 (CustomOp /
CustomOpProp) and :593 (register). The user's forward and backward run
in one ``torch.autograd.Function`` with the port's NDArrays on the op's
device (``mxnet_tpu_torch/ops/custom.py``).

Differences from the reference, by design:
- ``declare_backward_dependency`` is accepted but unused: the node
  always keeps its inputs and outputs for the backward.
- auxiliary states are not supported; thread state through explicit
  outputs.
- a graph with a Custom node runs through Module, Executor and
  Predictor; an export or a captured (CUDA graph) step of it raises.
"""
from __future__ import annotations

from .ops import custom as _custom

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered"]


class CustomOp(object):
    """Base class for the runtime part of a custom operator."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Compute outputs: write results into ``out_data`` via
        :meth:`assign` (NDArray in/out, numpy allowed inside)."""
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Compute input gradients into ``in_grad`` via :meth:`assign`."""
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Store ``src`` into ``dst`` honouring the write request."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise ValueError("unknown req %r" % (req,))


class CustomOpProp(object):
    """Static description of a custom operator: names, shapes, dtypes,
    and the factory for its :class:`CustomOp`."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        """Default: all outputs (and unknown inputs) share in_shape[0]."""
        return ([in_shape[0]] * len(in_shape),
                [in_shape[0]] * len(self.list_outputs()), [])

    def infer_type(self, in_type):
        return ([in_type[0]] * len(in_type),
                [in_type[0]] * len(self.list_outputs()), [])

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Class decorator: make a CustomOpProp subclass reachable as
    ``mx.nd.Custom(..., op_type=reg_name)`` / ``mx.sym.Custom(...)``."""
    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise TypeError("register expects a CustomOpProp subclass")
        _custom.register_prop(reg_name, prop_cls)
        return prop_cls
    return do_register


def get_all_registered():
    return sorted(_custom._PROP_REGISTRY)


def _ordered_custom_call(namespace_fn, variable_fn=None):
    """Wrap the auto-generated Custom entry so keyword tensor inputs land
    in ``list_arguments`` order and (symbolically) missing inputs become
    auto-created variables — reference compose semantics."""
    def Custom(*args, **kwargs):
        op_type = kwargs.get("op_type")
        name = kwargs.pop("name", None)
        slots = {}
        attrs = {}
        for k, v in kwargs.items():
            if hasattr(v, "shape") or type(v).__name__ == "Symbol":
                slots[k] = v
            else:
                attrs[k] = v
        prop_kwargs = {k: v for k, v in attrs.items() if k != "op_type"}
        arg_names = _custom.create_prop(op_type, prop_kwargs)\
            .list_arguments()
        ordered = list(args)
        for an in arg_names[len(ordered):]:
            if an in slots:
                ordered.append(slots.pop(an))
            elif variable_fn is not None:
                # symbolic compose auto-creates missing inputs (the
                # reference's softmax example never declares its label)
                ordered.append(variable_fn(
                    "%s_%s" % (name or "custom", an)))
            else:
                break
        if slots:
            raise TypeError("Custom(%s): unexpected tensor arguments %r"
                            % (op_type, sorted(slots)))
        if name is not None:
            attrs["name"] = name
        return namespace_fn(*ordered, **attrs)
    return Custom


def _install_namespace_wrappers():
    from . import ndarray as _nd
    from . import symbol as _sym
    from .ndarray import op as _nd_op
    from .symbol import op as _sym_op
    nd_custom = _ordered_custom_call(_nd_op.Custom)
    sym_custom = _ordered_custom_call(_sym_op.Custom, _sym.Variable)
    for mod, fn in ((_nd, nd_custom), (_nd_op, nd_custom),
                    (_sym, sym_custom), (_sym_op, sym_custom)):
        setattr(mod, "Custom", fn)


_install_namespace_wrappers()
