"""``mx.nd.contrib`` namespace: every ``_contrib_*`` registry op under
its short name (the JAX package's ``ndarray/contrib.py``)."""
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
