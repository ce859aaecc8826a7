"""``mx.sym.contrib`` namespace (reference: python/mxnet/symbol/
contrib.py) — `_contrib_*` ops under their short names."""
from __future__ import annotations

import sys

from ..ops import registry as _reg
from . import op as _op


def _populate():
    mod = sys.modules[__name__]
    for name in _reg.list_ops():
        if name.startswith("_contrib_"):
            setattr(mod, name[len("_contrib_"):], getattr(_op, name))


_populate()
