"""NDArray namespace (``mx.nd``): the array type, creation, save/load and
the generated operator namespace (the JAX package's
``ndarray/__init__.py``, without sparse storage)."""
from .ndarray import (NDArray, array, arange, concatenate, empty, full,  # noqa: F401,E501
                      load, moveaxis, ones, ones_like, onehot_encode, save,
                      waitall, zeros, zeros_like, _wrap)

from . import op
from .op import *  # noqa: F401,F403 — generated operator functions

# re-export every generated op (including _underscore internals) at
# package level, as the reference does via _init_ops
from ..ops import registry as _reg

for _name in _reg.list_ops():
    globals()[_name] = getattr(op, _name)
del _name

from . import contrib  # noqa: E402,F401 (mx.nd.contrib)


def __getattr__(name):
    err = _reg.not_ported(name)
    if err is not None:
        raise err
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
