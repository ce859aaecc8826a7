"""Carry the JAX package's parameters across to the port, by name, so both
packages compute the same thing from the same weights.

``params_from_jax`` takes the name -> array dict that the JAX package's
``Predictor`` / ``TrainStep`` use (numpy arrays, or anything
``np.asarray`` reads, bf16 included); ``load_params`` reads a ``.params``
file that ``mxnet_tpu.model.save_checkpoint`` (or ``nd.save``) wrote,
through the port's ``nd.load``. ``state_from_jax`` carries a whole
training state — parameters, optimizer state and aux — so both
packages' ``TrainStep`` can start from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import torch_dtype
from .context import context_of
from .ndarray import load as _nd_load
from .ndarray.ndarray import _from_numpy

__all__ = ["params_from_jax", "load_params", "state_from_jax"]


def _cast(t, device, dtype):
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(torch_dtype(dtype))
    return t


def params_from_jax(arg_params, device, dtype=None):
    """{name: array} -> {name: torch.Tensor on ``device``}. ``dtype``
    (e.g. 'bfloat16') casts the floating-point entries; integer entries
    keep their type."""
    device = torch.device(device)
    return {name: _cast(_from_numpy(np.asarray(v)), device, dtype)
            for name, v in arg_params.items()}


def load_params(fname, device, dtype=None):
    """(arg_params, aux_params) from a checkpoint ``.params`` file, whose
    keys carry the reference's "arg:" / "aux:" prefixes; a file without
    prefixes loads wholly as arg_params."""
    device = torch.device(device)
    loaded = _nd_load(fname, ctx=context_of(device))
    if isinstance(loaded, list):
        raise ValueError("%s holds an unnamed array list, not parameters"
                         % (fname,))
    args, auxs = {}, {}
    for key, arr in loaded.items():
        kind, sep, name = key.partition(":")
        if sep and kind == "aux":
            auxs[name] = _cast(arr.handle, device, dtype)
        elif sep and kind == "arg":
            args[name] = _cast(arr.handle, device, dtype)
        else:
            args[key] = _cast(arr.handle, device, dtype)
    return args, auxs


def state_from_jax(state, device):
    """A JAX ``TrainStep`` state ``(params, opt_state, aux)`` — dicts of
    arrays, ``opt_state``'s values tuples of arrays, read as numpy — as
    the port's ``TrainStep`` state: the same structure of fresh tensors
    on ``device``, in their own dtypes."""
    params, opt_state, aux = state
    device = torch.device(device)
    return (params_from_jax(params, device),
            {name: tuple(_from_numpy(np.asarray(s)).to(device)
                         for s in slots)
             for name, slots in opt_state.items()},
            params_from_jax(aux, device))
