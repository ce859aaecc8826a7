"""Device context — the PyTorch twin of ``mxnet_tpu/context.py``.

``Context(device_type, device_id)`` with a thread-local "current
context" scope (reference: ``python/mxnet/context.py``), mapped onto a
``torch.device``:

* ``gpu(i)``  -> ``cuda:i``
* ``cpu(i)``  -> ``cpu`` (one host device; the id is kept for the
  reference's serialization codes only)
* ``tpu(i)``  -> alias of ``gpu(i)`` so scripts written against the TPU
  package run unmodified
* ``cpu_pinned(i)`` -> ``cpu``

The default context is ``gpu(0)``. Resolving a ``gpu`` context on a
machine without CUDA raises: the port never falls back to the CPU
silently. CPU work is asked for explicitly, with ``ctx=mx.cpu()`` or a
``with mx.cpu():`` scope.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "current_context"]


class Context:
    """A device context (reference: python/mxnet/context.py:28-140)."""

    # Keep the reference's numeric type codes for serialization compat.
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 4: "tpu"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "tpu": 4}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in self.devstr2type:
                raise ValueError("unknown device type %r" % (device_type,))
            self.device_typeid = self.devstr2type[device_type]
            self.device_id = device_id
        self._old_ctx = None

    @property
    def device_type(self):
        return self.devtype2str[self.device_typeid]

    def torch_device(self):
        """The ``torch.device`` backing this context. Raises MXNetError
        for an accelerator context when CUDA is not available."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "context %s needs a CUDA device and none is available; "
                "pass ctx=mx.cpu() to run on the CPU" % (self,))
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise MXNetError("context %s: only %d CUDA device(s)"
                             % (self, n))
        return torch.device("cuda", self.device_id)

    # -- equality / hashing -------------------------------------------------
    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    # -- scope --------------------------------------------------------------
    def __enter__(self):
        self._old_ctx = current_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx


def context_of(device):
    """The Context naming a ``torch.device``."""
    device = torch.device(device)
    if device.type == "cuda":
        return Context("gpu", device.index or 0)
    return Context("cpu", 0)


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Alias of ``gpu(device_id)``."""
    return Context("gpu", device_id)


def current_context():
    """The innermost ``with ctx:`` scope of this thread, else gpu(0)."""
    cur = getattr(Context._default_ctx, "value", None)
    return cur if cur is not None else Context("gpu", 0)
