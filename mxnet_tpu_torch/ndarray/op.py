"""The generated ``mx.nd.*`` operator namespace, one function an op of
the registry (the JAX package's ``ndarray/op.py``; reference:
python/mxnet/ndarray/op.py:52-174).

Positional NDArrays (and numpy arrays or tensors) are the op's tensor
inputs in order; positional scalars are attrs in the op's parameter
order; keyword tensors land in their ``active_args`` slots.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import registry as _reg
from .ndarray import NDArray, array

_ARRAY_LIKE = (NDArray, torch.Tensor, np.ndarray)


def _to_nd(x, like):
    if isinstance(x, NDArray):
        return x
    return array(x, ctx=like[0].context if like else None)


def _make_nd_function(opdef):
    def generic_op(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        if opdef.arg_names is None:
            if len(args) == 1 and isinstance(args[0], (list, tuple)):
                args = tuple(args[0])
            inputs = []
            for a in list(args) + list(kwargs.values()):
                if isinstance(a, _ARRAY_LIKE):
                    inputs.append(_to_nd(a, inputs))
            attrs = {k: v for k, v in kwargs.items()
                     if not isinstance(v, _ARRAY_LIKE)}
        else:
            inputs = []
            scalars = []
            for a in args:
                if isinstance(a, _ARRAY_LIKE):
                    inputs.append(_to_nd(a, inputs))
                else:
                    scalars.append(a)
            # split named tensor inputs from attrs, then append them in the
            # op's active-argument order
            tensor_kw, attrs = {}, {}
            arg_set = set(opdef.arg_names)
            for k, v in kwargs.items():
                if k in arg_set and isinstance(v, _ARRAY_LIKE):
                    tensor_kw[k] = v
                elif k in arg_set and v is None:
                    pass
                else:
                    attrs[k] = v
            if tensor_kw:
                names = opdef.active_args(
                    _reg.canon_attrs(opdef, attrs)) or opdef.arg_names
                for an in names[len(inputs):]:
                    if an in tensor_kw:
                        inputs.append(_to_nd(tensor_kw.pop(an), inputs))
                    else:
                        break
                if tensor_kw:
                    raise TypeError("%s: unexpected tensor arguments %r"
                                    % (opdef.name, sorted(tensor_kw)))
            if scalars:
                # positional attrs map onto parameter declaration order
                free = [k for k in opdef.defaults if k not in attrs]
                if len(scalars) > len(free):
                    raise TypeError(
                        "%s: too many positional arguments %r (attrs: %r)"
                        % (opdef.name, scalars, list(opdef.defaults)))
                for k, v in zip(free, scalars):
                    attrs[k] = v
        return _reg.invoke_eager(opdef, inputs, attrs, out=out)

    generic_op.__name__ = opdef.name
    generic_op.__qualname__ = opdef.name
    generic_op.__doc__ = opdef.doc
    return generic_op


def _populate(target_module_name):
    mod = sys.modules[target_module_name]
    for name in _reg.list_ops():
        fn = _make_nd_function(_reg.get_op(name))
        fn.__name__ = name
        setattr(mod, name, fn)


_populate(__name__)
