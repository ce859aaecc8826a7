"""Fused optimizer update ops, with the names, attrs, state slots and
arithmetic of ``mxnet_tpu/ops/optimizer_ops.py`` (reference
src/operator/optimizer_op.*).

Each op is one function of (weight, grad, *state) returning the new
weight (and the new state tensors, which ``state_inputs`` names), in
plain PyTorch under ``torch.no_grad()``. The gradient is prepared in one
order everywhere: rescale, then clip, then ``+ wd * weight``. Adam has
no bias correction here, exactly as the op in the JAX package (the
Optimizer class folds it into ``lr``).
"""
from __future__ import annotations

import torch

from .registry import register


def _prep(grad, wd, weight, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


_COMMON = {"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0,
           "clip_gradient": -1.0}


@register("sgd_update", traced_attrs=('lr', 'wd', 'rescale_grad'),
          arg_names=("weight", "grad"), differentiable=False,
          defaults=_COMMON)
@torch.no_grad()
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, **_):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    return weight - lr * g


@register("sgd_mom_update",
          traced_attrs=('lr', 'momentum', 'wd', 'rescale_grad'),
          arg_names=("weight", "grad", "mom"), differentiable=False,
          state_inputs=(2,), defaults={**_COMMON, "momentum": 0.0})
@torch.no_grad()
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, **_):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


@register("mp_sgd_update", traced_attrs=('lr', 'wd', 'rescale_grad'),
          arg_names=("weight", "grad", "weight32"), differentiable=False,
          state_inputs=(2,), defaults=_COMMON)
@torch.no_grad()
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, **_):
    g = _prep(grad.float(), wd, weight32, rescale_grad, clip_gradient)
    new_w32 = weight32 - lr * g
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update",
          traced_attrs=('lr', 'momentum', 'wd', 'rescale_grad'),
          arg_names=("weight", "grad", "mom", "weight32"),
          differentiable=False, state_inputs=(2, 3),
          defaults={**_COMMON, "momentum": 0.0})
@torch.no_grad()
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, **_):
    g = _prep(grad.float(), wd, weight32, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("adam_update",
          traced_attrs=('lr', 'beta1', 'beta2', 'epsilon', 'wd',
                        'rescale_grad'),
          arg_names=("weight", "grad", "mean", "var"),
          differentiable=False, state_inputs=(2, 3),
          defaults={**_COMMON, "beta1": 0.9, "beta2": 0.999,
                    "epsilon": 1e-8})
@torch.no_grad()
def _adam_update(weight, grad, mean, var, lr=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0, **_):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


@register("rmsprop_update",
          traced_attrs=('lr', 'gamma1', 'epsilon', 'wd', 'rescale_grad'),
          arg_names=("weight", "grad", "n"), differentiable=False,
          state_inputs=(2,),
          defaults={**_COMMON, "gamma1": 0.95, "epsilon": 1e-8,
                    "clip_weights": -1.0})
@torch.no_grad()
def _rmsprop_update(weight, grad, n, lr=0.01, gamma1=0.95, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0, **_):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_w = weight - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n


@register("rmspropalex_update",
          traced_attrs=('lr', 'gamma1', 'gamma2', 'epsilon', 'wd',
                        'rescale_grad'),
          arg_names=("weight", "grad", "n", "g", "delta"),
          differentiable=False, state_inputs=(2, 3, 4),
          defaults={**_COMMON, "gamma1": 0.95, "gamma2": 0.9,
                    "epsilon": 1e-8, "clip_weights": -1.0})
@torch.no_grad()
def _rmspropalex_update(weight, grad, n, g, delta, lr=0.01, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0, **_):
    gr = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    new_n = (1 - gamma1) * torch.square(gr) + gamma1 * n
    new_g = (1 - gamma1) * gr + gamma1 * g
    new_delta = gamma2 * delta - lr * gr / \
        torch.sqrt(new_n - torch.square(new_g) + epsilon)
    new_w = weight + new_delta
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n, new_g, new_delta


@register("ftrl_update",
          traced_attrs=('lr', 'lamda1', 'beta', 'wd', 'rescale_grad'),
          arg_names=("weight", "grad", "z", "n"), differentiable=False,
          state_inputs=(2, 3),
          defaults={**_COMMON, "lamda1": 0.01, "beta": 1.0})
@torch.no_grad()
def _ftrl_update(weight, grad, z, n, lr=0.01, lamda1=0.01, beta=1.0,
                 wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, **_):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= lamda1, 0.0,
        -(new_z - torch.sign(new_z) * lamda1) /
        ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_w, new_z, new_n


@register("signsgd_update", traced_attrs=('lr', 'wd', 'rescale_grad'),
          arg_names=("weight", "grad"), differentiable=False,
          defaults=_COMMON)
@torch.no_grad()
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, **_):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    return weight - lr * torch.sign(g)
