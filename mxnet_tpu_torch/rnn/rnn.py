"""RNN checkpoint helpers — the PyTorch twin of ``mxnet_tpu/rnn/rnn.py``
(reference python/mxnet/rnn/rnn.py):
checkpoints store cells' weights in the canonical UNPACKED per-gate
layout, so fused and unfused variants of the same network load each
other's checkpoints."""
from __future__ import annotations

from .. import model as _model
from ..base import _as_list

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint", "rnn_unroll"]


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC"):  # pragma: no cover
    """Deprecated alias of cell.unroll (reference rnn.py:rnn_unroll)."""
    import warnings
    warnings.warn("rnn_unroll is deprecated; call cell.unroll directly",
                  DeprecationWarning, stacklevel=2)
    outputs, _ = cell.unroll(length, inputs, begin_state=begin_state,
                             layout=layout)
    return outputs


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """save_checkpoint with cell weights unpacked to per-gate arrays
    (reference rnn.py:save_rnn_checkpoint)."""
    args = dict(arg_params)
    for cell in _as_list(cells):
        args = cell.unpack_weights(args)
    _model.save_checkpoint(prefix, epoch, symbol, args, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """load_checkpoint, repacking per-gate arrays into the cells'
    fused layout (reference rnn.py:load_rnn_checkpoint)."""
    sym, args, aux = _model.load_checkpoint(prefix, epoch)
    for cell in _as_list(cells):
        args = cell.pack_weights(args)
    return sym, args, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback writing rnn checkpoints (reference
    rnn.py:do_rnn_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg,
                                aux)
    return _callback
