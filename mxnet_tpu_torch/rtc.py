"""Runtime kernel compilation (``mx.rtc``) — the PyTorch twin of
``mxnet_tpu/rtc.py``.

Reference: python/mxnet/rtc.py + src/common/mxrtc.cc, user CUDA C
compiled by NVRTC at run time and launched on NDArrays. As in the JAX
package the source is Python: it defines a function over the input
tensors (``torch`` tensors here) that returns the output tensor or
tensors. The namespace binds ``torch``, and where the ``triton`` package
imports (a CUDA machine), ``triton`` and ``triton.language`` as ``tl``,
so a source can define a ``@triton.jit`` kernel and launch it: the
counterpart of the JAX package's ``pl``/``pltpu``. The source is
registered with ``linecache`` under ``<mx.rtc:name>``, so ``inspect``
finds it (``triton.jit`` reads a kernel's source) and tracebacks show
it. Grid and block dims are accepted for the reference's signature and
ignored: the source launches its own grid.
"""
from __future__ import annotations

import linecache

import torch

__all__ = ["Rtc"]


class Rtc:
    """Compile ``kernel`` (Python source) defining the function ``name``,
    which takes the input tensors and returns the output tensor(s)
    (reference rtc.py:Rtc(name, inputs, outputs, kernel)).

    inputs/outputs: sequences of names, kept for the reference's
    signature and for the arity checks."""

    def __init__(self, name, inputs, outputs, kernel):
        self.name = name
        self._in_names = list(inputs)
        self._out_names = list(outputs)
        ns = {"torch": torch}
        try:
            import triton
            import triton.language as tl
        except ImportError:
            pass
        else:
            ns.update(triton=triton, tl=tl)
        filename = "<mx.rtc:%s>" % name
        linecache.cache[filename] = (len(kernel), None,
                                     kernel.splitlines(True), filename)
        exec(compile(kernel, filename, "exec"), ns)
        if name not in ns or not callable(ns[name]):
            raise ValueError(
                "kernel source must define a function named %r" % name)
        self._fn = ns[name]

    def push(self, ins, outs, grid_dims=None, block_dims=None):
        """Run the kernel on the inputs' tensors; each result, cast to its
        output's dtype and device, becomes that output's data (reference
        Rtc.push; grid/block dims ignored)."""
        if len(ins) != len(self._in_names):
            raise ValueError("expected %d inputs" % len(self._in_names))
        with torch.no_grad():
            res = self._fn(*[x.handle for x in ins])
        if not isinstance(res, (tuple, list)):
            res = (res,)
        if len(res) != len(outs):
            raise ValueError("kernel returned %d outputs, expected %d"
                             % (len(res), len(outs)))
        for o, r in zip(outs, res):
            o._set_data(r.to(device=o.handle.device, dtype=o.handle.dtype))
        return outs
