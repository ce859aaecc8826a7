"""Checkpoint helpers — ``save_checkpoint`` and ``load_checkpoint`` of
``mxnet_tpu/model.py``, with its file format: ``prefix-symbol.json`` and
``prefix-NNNN.params`` (the ``.npz`` container, keys prefixed ``arg:`` /
``aux:``), so a checkpoint written by either package loads in the other.
The legacy ``FeedForward`` API and the kvstore helpers wait for the
Module slice (ROADMAP Queue A item 5).
"""
from __future__ import annotations

import logging

from . import guardrail
from . import ndarray as nd
from . import symbol as sym
from .ndarray import NDArray

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write prefix-symbol.json + prefix-NNNN.params (reference
    model.py:340). Values are NDArrays or tensors, saved from the host.
    The params file is published crash-durably: written to a temporary
    name, then fsync'd and renamed over the destination."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {"arg:%s" % k: NDArray(v) for k, v in arg_params.items()}
    save_dict.update({"aux:%s" % k: NDArray(v)
                      for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    tmp_name = param_name + ".tmp"
    nd.save(tmp_name, save_dict)
    guardrail.durable_replace(tmp_name, param_name)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """Load (symbol, arg_params, aux_params) from a checkpoint (reference
    model.py:370); the arrays land on the current context."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
