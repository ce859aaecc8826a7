"""Neural-network layer ops of the serving slice — ``FullyConnected``,
``LayerNorm``, ``Activation`` — with the semantics of
``mxnet_tpu/ops/nn.py``. The matrix products go to ``torch.matmul``
(cuBLAS on the card), as the JAX package leaves them to XLA. The other
layers (Convolution, Pooling, BatchNorm, Dropout, ...) wait for the
op-catalog slice (ROADMAP Queue A item 2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register


@register("FullyConnected", arg_names=("data", "weight", "bias"),
          defaults={"num_hidden": 0, "no_bias": False, "flatten": True})
def _fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True, **_):
    x = data.reshape(data.shape[0], -1) if flatten else data
    if weight.dtype != x.dtype:
        weight = weight.to(x.dtype)
    # weight layout (num_hidden, in), as the reference stores it
    out = torch.matmul(x, weight.t())
    if not no_bias and bias is not None:
        out = out + bias
    return out


@register("LayerNorm", arg_names=("data", "gamma", "beta"),
          defaults={"axis": -1, "eps": 1e-5, "output_mean_var": False})
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5,
                output_mean_var=False, **_):
    mean = torch.mean(data, dim=axis, keepdim=True)
    # population variance, as jnp.var
    var = torch.var(data, dim=axis, keepdim=True, correction=0)
    out = (data - mean) * torch.rsqrt(var + eps)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    out = out * gamma.reshape(bshape) + beta.reshape(bshape)
    if output_mean_var:
        return out, torch.squeeze(mean, axis), torch.squeeze(var, axis)
    return out


@register("Activation", arg_names=("data",),
          defaults={"act_type": "relu"})
def _activation(data, act_type="relu", **_):
    if act_type == "relu":
        return torch.clamp_min(data, 0)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return data / (1 + torch.abs(data))
    raise ValueError("unknown act_type %r" % act_type)
