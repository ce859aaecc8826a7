"""The serving wire's framing: a 4-byte big-endian length, then a pickle
(protocol 4) of the frame — the JAX package's ``parallel/ps_async.py``
``_send_msg`` / ``_recv_msg``, byte for byte, so a port replica and a JAX
replica (or router) speak to each other.

The decode side differs on purpose. The JAX unpickler resolves any module
a frame names; here :class:`_FrameUnpickler` resolves only what a serving
frame holds — builtins' plain containers, numpy arrays and scalars, and
``collections`` — and raises :class:`WireRefused` on anything else. A
frame that names a ``mxnet_tpu`` class would otherwise import the JAX
package into the port's process. Typed serving errors cross the wire as
``("err", kind, message)`` strings (``engine.typed_error``), never as
pickled exception objects, so nothing more is needed.

bfloat16 arrays: the port ships them as raw 2-byte ``|V2`` words (the
bytes ``export_kv_rows`` writes); the JAX package ships
``ml_dtypes.bfloat16`` arrays. A frame naming ``ml_dtypes`` resolves only
where that package is importable, and otherwise raises
:class:`WireRefused` naming the dtype — it is never reinterpreted
silently (ROADMAP Queue C).

Fault points (``MXNET_FAULT_SPEC``) fire through
``parallel.resilience.active_injector`` exactly as in the JAX package.
"""
from __future__ import annotations

import importlib
import io
import pickle
import struct

from ..parallel.resilience import active_injector

__all__ = ["WireRefused"]


class WireRefused(pickle.UnpicklingError):
    """A frame named a global the serving wire does not resolve."""


_BUILTINS = frozenset(("set", "frozenset", "complex", "bytearray", "slice",
                       "range", "bytes", "str", "int", "float", "bool",
                       "list", "tuple", "dict"))
_NUMPY_MODULES = frozenset((
    "numpy", "numpy.core.multiarray", "numpy._core.multiarray",
    "numpy.core.numeric", "numpy._core.numeric"))
_NUMPY_NAMES = frozenset(("ndarray", "dtype", "_reconstruct", "scalar",
                          "_frombuffer"))
_COLLECTIONS = frozenset(("OrderedDict", "deque", "defaultdict"))


class _FrameUnpickler(pickle.Unpickler):
    """Resolves builtins' plain types, numpy's array and scalar
    reconstructors, ``collections`` containers and (where importable)
    ``ml_dtypes``' bfloat16; refuses every other global."""

    def find_class(self, module, name):
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        if module == "collections" and name in _COLLECTIONS:
            return super().find_class(module, name)
        if module == "ml_dtypes" or module.startswith("ml_dtypes."):
            try:
                mod = importlib.import_module(module)
            except ImportError:
                raise WireRefused(
                    "frame carries a %s.%s array, and ml_dtypes is not "
                    "importable here: the port reads bfloat16 as raw |V2 "
                    "words and will not reinterpret another package's "
                    "dtype silently" % (module, name)) from None
            return getattr(mod, name)
        raise WireRefused("frame names %s.%s, which the serving wire does "
                          "not resolve" % (module, name))


def _loads(data):
    return _FrameUnpickler(io.BytesIO(data)).load()


def _send_msg(sock, obj, fault_point=None):
    """Frame + send. ``fault_point`` names this call site for the
    deterministic FaultInjector (``MXNET_FAULT_SPEC``); None exempts the
    call so injection counts stay reproducible."""
    payload = pickle.dumps(obj, protocol=4)
    frame = struct.pack(">I", len(payload)) + payload
    if fault_point is not None:
        inj = active_injector()
        if inj is not None:
            inj.on_send(fault_point, sock, frame)
    sock.sendall(frame)


def _recv_msg(sock, fault_point=None):
    """Read one frame; None on a clean EOF or a torn frame."""
    if fault_point is not None:
        inj = active_injector()
        if inj is not None:
            inj.on_recv(fault_point, sock)
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack(">I", hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return _loads(bytes(buf))
