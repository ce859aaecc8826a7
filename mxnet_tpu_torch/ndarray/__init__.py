"""NDArray namespace (``mx.nd``): the array type, creation, save/load,
the sparse storage types and the generated operator namespace (the JAX
package's ``ndarray/__init__.py``)."""
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
from . import sparse  # noqa: E402
from .sparse import CSRNDArray, RowSparseNDArray  # noqa: E402,F401

# sparse inputs take the sparse routes of the generated entry points (the
# analogue of the reference's FComputeEx dispatch)
sparse._install_sparse_dispatch(globals(), op)
