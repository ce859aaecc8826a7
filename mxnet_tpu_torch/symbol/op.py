"""Auto-generation of the ``mx.sym.*`` operator namespace from the registry.

Reference: python/mxnet/symbol/op.py:54-207 — one composing function stamped
per registered op. Symbol inputs may be positional or keyword (by arg name);
missing parameter inputs become auto-named variables.
"""
from __future__ import annotations

import sys

from ..ops import registry as _reg
from .symbol import Symbol, _sym_invoke


def _make_sym_function(opdef):
    def generic_op(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        inputs = [a for a in args if isinstance(a, Symbol)]
        scalars = [a for a in args if not isinstance(a, Symbol)]
        kw_inputs = {}
        attrs = {}
        arg_set = set(opdef.arg_names or ())
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                if opdef.arg_names is not None and k in arg_set:
                    kw_inputs[k] = v
                else:
                    inputs.append(v)
            elif v is not None or k in (opdef.defaults or {}):
                attrs[k] = v
        if scalars:
            free = [k for k in opdef.defaults if k not in attrs]
            if len(scalars) > len(free):
                raise TypeError(
                    "%s: too many positional arguments %r" % (
                        opdef.name, scalars))
            for k, v in zip(free, scalars):
                attrs[k] = v
        out = _sym_invoke(opdef, inputs, attrs, name, kw_inputs=kw_inputs)
        if attr:
            for (node, _i) in out._entries:
                if node.op is not None:
                    node.misc_attrs.update(attr)
        return out

    generic_op.__name__ = opdef.name
    generic_op.__qualname__ = opdef.name
    generic_op.__doc__ = opdef.doc
    return generic_op


def _populate(target_module_name):
    mod = sys.modules[target_module_name]
    for name in _reg.list_ops():
        opdef = _reg.get_op(name)
        setattr(mod, name, _make_sym_function(opdef))


_populate(__name__)
