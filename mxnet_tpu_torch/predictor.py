"""Deploy-time inference: the predict-only API — the PyTorch twin of
``mxnet_tpu/predictor.py``'s ``Predictor``.

Reference: src/c_api/c_predict_api.cc (MXPredCreate/SetInput/Forward/
GetOutput — load a symbol JSON + param blob, run forward-only). The AOT
``export`` / ``CompiledPredictor`` deploy chain waits (ROADMAP Queue A
item 8).
"""
from __future__ import annotations

import numpy as np
import torch

from .context import current_context
from .executor import _graph_eval_fn
from .ndarray import NDArray, _wrap
from .ndarray.ndarray import _from_numpy

__all__ = ["Predictor"]


def _as_tensor(x, device):
    if isinstance(x, NDArray):
        x = x.handle
    elif not isinstance(x, torch.Tensor):
        x = _from_numpy(np.asarray(x))
    return x.to(device)


class Predictor:
    """Forward-only executor with its parameters held on one device
    (reference MXAPIPredictor). Inputs are positional by ``data_names``
    or keyword; outputs are NDArrays on that device.

    ctx: the device (default: the current context, which is gpu(0)
    unless a ``with mx.cpu():`` scope says otherwise). Without CUDA,
    a gpu context raises; pass ``ctx=mx.cpu()`` to run on the CPU.

    Loss-head label variables that feed the loss DIRECTLY are
    zero-filled via shape inference; labels that pass through reshaping
    ops first are not inferable from data alone — declare them in
    ``data_names`` and feed dummy arrays (loss heads ignore labels
    outside training)."""

    def __init__(self, symbol, arg_params, aux_params=None,
                 data_names=("data",), ctx=None):
        self._symbol = symbol
        self._data_names = list(data_names)
        self._output_names = symbol.list_outputs()
        self._device = (ctx or current_context()).torch_device()
        dev = self._device
        self._params = {k: _as_tensor(v, dev) for k, v in arg_params.items()}
        self._auxs = {k: _as_tensor(v, dev)
                      for k, v in (aux_params or {}).items()}
        self._missing = [n for n in symbol.list_arguments()
                         if n not in self._params
                         and n not in self._data_names]
        not_labels = [n for n in self._missing if "label" not in n]
        if not_labels:
            raise ValueError("predictor missing parameters %r"
                             % not_labels)
        self._eval_fn = _graph_eval_fn(symbol)
        self._outputs = None

    @property
    def device(self):
        return self._device

    def _fwd(self, *data):
        arg_vals = dict(self._params)
        arg_vals.update(zip(self._data_names, data))
        if self._missing:
            # loss-layer labels are dead at inference; zero-fill with
            # inferred shapes (reference: MXPredCreate binds provided
            # args only — loss heads ignore labels when not training)
            shapes, _o, _a = self._symbol.infer_shape_partial(
                **{n: tuple(arg_vals[n].shape) for n in self._data_names})
            for n, s in zip(self._symbol.list_arguments(), shapes):
                if n in self._missing and s is not None:
                    arg_vals[n] = torch.zeros(s, dtype=data[0].dtype,
                                              device=self._device)
        outs, _aux = self._eval_fn(arg_vals, dict(self._auxs), 0, False)
        return outs

    def forward(self, *args, **kwargs):
        """Run inference; accepts arrays positionally (data_names order)
        or by name (reference MXPredSetInput + MXPredForward)."""
        if kwargs:
            args = [kwargs[n] for n in self._data_names]
        with torch.inference_mode():
            self._outputs = self._fwd(
                *[_as_tensor(a, self._device) for a in args])
        return [_wrap(o) for o in self._outputs]

    def get_output(self, index):
        if self._outputs is None:
            raise RuntimeError("run forward() first")
        return _wrap(self._outputs[index])

    @property
    def output_names(self):
        return list(self._output_names)
