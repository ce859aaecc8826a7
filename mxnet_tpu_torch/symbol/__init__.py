"""Symbol API (reference: python/mxnet/symbol/)."""
from .symbol import Symbol, Variable, var, Group, load, load_json
from .op import *          # noqa: F401,F403 — generated op namespace
from . import op           # noqa: F401
# creation helpers mirroring mx.sym.zeros/ones/arange
from .op import _zeros as zeros, _ones as ones, _arange as arange  # noqa: F401,E501

# `import *` skips underscore-prefixed generated ops (_contrib_*, ...);
# surface them all, as the reference namespace does
from ..ops import registry as _reg
for _n in _reg.list_ops():
    globals()[_n] = getattr(op, _n)
del _n

from . import contrib  # noqa: E402,F401 (mx.sym.contrib)
