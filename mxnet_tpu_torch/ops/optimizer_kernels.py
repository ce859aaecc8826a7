"""The training step's optimizer update and gradient reduction over every
parameter at once, on the hand-written Hopper kernels of
``csrc/multi_tensor.cu``.

The JAX package fuses the whole step into one ``jax.jit`` program, so XLA
fuses the update of every parameter and the guardrail's checks into it
(``mxnet_tpu/parallel/trainer.py`` ``_build_step``). The port's step is
eager; the registry's Adam update costs about eighteen eager launches a
parameter. Two kernels take their place, a launch or two a step:

* ``opt_update`` — the fused optimizer update of every (weight, grad,
  state): ``multi_tensor_opt_update_cuda`` for ``adam_update`` and
  ``sgd_mom_update`` (SGD, with momentum 0 for plain SGD) over tensors
  on the card that are all float32 or all bfloat16, bit-equal to the
  registry op applied parameter by parameter. Other optimizers (rmsprop,
  ftrl, signum) take the per-parameter registry route
  ``_opt_update_reference``, by name, decided before anything launches.
* ``norm_finite`` — the global sum of squares of the gradients in float32
  (fixed order, no float atomics), the all-finite flag over the
  gradients and the loss outputs, and the clip scale ``gscale = min(1,
  clip_norm / max(rescale * sqrt(S), 1e-12))``, all on the device:
  ``multi_tensor_norm_finite_cuda``.

Each ``*_cuda`` wrapper launches its kernels on CUDA tensors, adds the
kernels it launched to its ``.launches`` (one a ``MAX_TENSORS`` tensors,
and the reduction's second pass) and raises on anything else (another
dtype too); on CPU (and meta) tensors the dispatchers run the plain
versions (``_opt_update_reference``, ``_norm_finite_reference``).
Nothing falls back from one to the other.

The three device scalars of the guarded step ride into the update: the
guard's finite flag (when false nothing changes: in place, or copied to
fresh outputs with ``donate=False``), the clip scale and the loss
scaler's ``1/scale``; the gradient is multiplied by ``1/scale``, then by
``gscale`` (each in float32, rounded once to the gradient's dtype), then
prepared as the registry op prepares it. ``lr`` is a host float, or a
0-d float32 device tensor that the kernel reads when it runs: a step
captured as a CUDA graph then takes a new lr at each replay.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels
from .registry import get_op

__all__ = ["MT_OPS", "MAX_TENSORS", "opt_update", "norm_finite",
           "multi_tensor_opt_update_cuda", "multi_tensor_norm_finite_cuda"]

# the update ops the kernel computes -> (kind code, state tensors)
MT_OPS = {"sgd_mom_update": (0, 1), "adam_update": (1, 2)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# tensors a launch (kMaxTensors of csrc/multi_tensor.cu)
MAX_TENSORS = 256


def _f32(x):
    """A Python scalar rounded to float32 as PyTorch rounds it against a
    float32 tensor."""
    return float(np.float32(x))


def _hyper(op_name, lr, attrs):
    """The kernel's 9 floats: lr (0 when the kernel reads it from the
    device), rescale, clip (-1: none), wd, then adam's beta1, 1 - beta1,
    beta2, 1 - beta2, epsilon or sgd's momentum. ``1 - beta`` is
    computed in double and rounded once, as ``(1 - beta1) * g`` rounds
    the Python scalar."""
    defaults = get_op(op_name).defaults
    a = {**defaults, **attrs}
    clip = a.get("clip_gradient")
    clip = -1.0 if clip is None or not clip > 0 else clip
    lr = 0.0 if isinstance(lr, torch.Tensor) else _f32(lr)
    common = [lr, _f32(a["rescale_grad"]), _f32(clip), _f32(a["wd"])]
    if op_name == "adam_update":
        b1, b2 = a["beta1"], a["beta2"]
        rest = [_f32(b1), _f32(1 - b1), _f32(b2), _f32(1 - b2),
                _f32(a["epsilon"])]
    else:
        rest = [_f32(a["momentum"]), 0.0, 0.0, 0.0, 0.0]
    return common + rest


# ---------------------------------------------------------------------------
# plain versions (the per-parameter registry route)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _opt_update_reference(op_name, weights, grads, states, lr, attrs,
                          flag=None, gscale=None, inv_scale=None,
                          donate=True):
    """The registry op ``op_name`` applied parameter by parameter, after
    the gradient's unscale (``g * inv_scale``) and clip (``* gscale``),
    each in float32 and rounded to the gradient's dtype; the results
    masked by ``torch.where(flag, new, old)``. Returns (new weights, new
    state tuples); with ``donate`` they are the given tensors, written in
    place."""
    opt_fn = get_op(op_name).fn
    n_state = get_op(op_name).num_state
    new_w, new_s = [], []
    for w, g, s in zip(weights, grads, states):
        if inv_scale is not None:
            g = (g.float() * inv_scale).to(g.dtype)
        if gscale is not None:
            g = (g.float() * gscale).to(g.dtype)
        res = opt_fn(w, g, *s, lr=float(lr), **attrs)
        nw = res[0] if n_state else res
        ns = tuple(res[1:]) if n_state else ()
        if flag is not None:
            nw = torch.where(flag, nw, w)
            ns = tuple(torch.where(flag, a, b) for a, b in zip(ns, s))
        if donate:
            w.copy_(nw)
            for old, new in zip(s, ns):
                old.copy_(new)
            nw, ns = w, tuple(s)
        new_w.append(nw)
        new_s.append(tuple(ns))
    return new_w, new_s


@torch.no_grad()
def _norm_finite_reference(grads, outs=(), inject=1.0, inv_scale=None,
                           rescale=1.0, clip_norm=None):
    """(sumsq, finite, gscale), 0-d tensors: sumsq = sum of
    ``(g * inject * inv_scale)^2`` in float32 over the gradients (tensor
    by tensor), finite = every ``g * inject`` and every output finite,
    gscale = ``min(1, clip_norm / max(rescale * sqrt(sumsq), 1e-12))``
    (1 without ``clip_norm``), with NaN kept as ``jnp.minimum`` keeps it."""
    dev = grads[0].device if grads else (outs[0].device if outs
                                         else torch.device("cpu"))
    sumsq = torch.zeros((), dtype=torch.float32, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for g in grads:
        x = g.float() * inject
        finite = torch.logical_and(finite, torch.isfinite(x).all())
        if inv_scale is not None:
            x = x * inv_scale
        sumsq = sumsq + torch.sum(torch.square(x))
    for o in outs:
        finite = torch.logical_and(finite, torch.isfinite(o).all())
    if clip_norm is None:
        gscale = torch.ones((), dtype=torch.float32, device=dev)
    else:
        gnorm = _f32(rescale) * torch.sqrt(sumsq)
        clip = torch.full((), clip_norm, dtype=torch.float32, device=dev)
        gscale = torch.clamp(clip / torch.clamp_min(gnorm, 1e-12), max=1.0)
    return sumsq, finite, gscale


# ---------------------------------------------------------------------------
# the CUDA launchers
# ---------------------------------------------------------------------------

def _check_cuda(what, tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("%s: every tensor must be on one CUDA device, "
                             "got %s and %s" % (what, dev, t.device))
        if t.dtype not in _DTYPE_CODE:
            raise TypeError("%s: tensors must be %s, got %s"
                            % (what, " or ".join(map(str, _DTYPE_CODE)),
                               t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: tensors must be contiguous" % what)
    return dev


def _scalar_ptr(what, t, dtype, dev):
    if t is None:
        return None
    if t.device != dev or t.dtype != dtype or t.numel() != 1:
        raise ValueError("%s: device scalar must be one %s on %s, got %r "
                         "%s on %s" % (what, dtype, dev, tuple(t.shape),
                                       t.dtype, t.device))
    return t.data_ptr()


def _ptrs(tensors):
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[t.data_ptr() for t in tensors])


def multi_tensor_opt_update_cuda(op_name, weights, grads, states, lr, attrs,
                                 flag=None, gscale=None, inv_scale=None,
                                 donate=True):
    """Launch the multi-tensor update (``adam_update`` or
    ``sgd_mom_update``) over every (weight, grad, state) on one card, all
    float32 or all bfloat16: one launch a ``MAX_TENSORS`` tensors.
    ``lr`` is a host float or a 0-d float32 device tensor; ``flag``
    (bool), ``gscale`` and ``inv_scale`` (float32) are 0-d device
    tensors or None. Returns (new weights, new state tuples);
    with ``donate`` they are the given tensors, updated in place.
    ``multi_tensor_opt_update_cuda.launches`` counts the launches."""
    if op_name not in MT_OPS:
        raise ValueError("multi_tensor_opt_update_cuda: %r is not one of %s"
                         % (op_name, sorted(MT_OPS)))
    kind, n_state = MT_OPS[op_name]
    if not (len(weights) == len(grads) == len(states)):
        raise ValueError("multi_tensor_opt_update_cuda: %d weights, %d "
                         "grads, %d states" % (len(weights), len(grads),
                                               len(states)))
    flat = list(weights) + list(grads) + [s for ss in states for s in ss]
    if not flat:
        return [], []
    dev = _check_cuda("multi_tensor_opt_update_cuda", flat)
    dtype = flat[0].dtype
    if any(t.dtype != dtype for t in flat):
        raise TypeError("multi_tensor_opt_update_cuda: weights, grads and "
                        "states must share one dtype, got %s"
                        % sorted({str(t.dtype) for t in flat}))
    for w, g, ss in zip(weights, grads, states):
        if g.shape != w.shape or len(ss) != n_state or any(
                s.shape != w.shape for s in ss):
            raise ValueError("multi_tensor_opt_update_cuda: a gradient or "
                             "state differs from its weight's shape %r, or "
                             "not %d states" % (tuple(w.shape), n_state))
    ptr = {"lr": _scalar_ptr("lr", lr, torch.float32, dev)
           if isinstance(lr, torch.Tensor) else None,
           "flag": _scalar_ptr("flag", flag, torch.bool, dev),
           "gscale": _scalar_ptr("gscale", gscale, torch.float32, dev),
           "inv": _scalar_ptr("inv_scale", inv_scale, torch.float32, dev)}
    if donate:
        w_out, s_out = list(weights), [tuple(ss) for ss in states]
    else:
        w_out = [torch.empty_like(w) for w in weights]
        s_out = [tuple(torch.empty_like(s) for s in ss) for ss in states]
    n = len(weights)
    s0 = [ss[0] for ss in states]
    s1 = [ss[1] for ss in states] if n_state == 2 else s0
    s0o = [ss[0] for ss in s_out]
    s1o = [ss[1] for ss in s_out] if n_state == 2 else s0o
    sizes = (ctypes.c_longlong * n)(*[w.numel() for w in weights])
    hyper = (ctypes.c_float * 9)(*_hyper(op_name, lr, attrs))
    lib = _kernels.load("multi_tensor")
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.multi_tensor_update(
            kind, _DTYPE_CODE[dtype], n, sizes, _ptrs(weights), _ptrs(grads),
            _ptrs(s0), _ptrs(s1), _ptrs(w_out), _ptrs(s0o), _ptrs(s1o),
            hyper, ptr["lr"], ptr["gscale"], ptr["inv"], ptr["flag"],
            int(bool(donate)), stream, ctypes.byref(launched))
    multi_tensor_opt_update_cuda.launches += launched.value
    _kernels.check(lib, rc, "multi_tensor_update")
    return w_out, s_out


multi_tensor_opt_update_cuda.launches = 0


def multi_tensor_norm_finite_cuda(grads, outs=(), inject=1.0,
                                  inv_scale=None, rescale=1.0,
                                  clip_norm=None):
    """Launch the gradient reduction: (sumsq, finite, gscale) as 0-d
    tensors on the card (``_norm_finite_reference``'s function), the sum
    in a fixed order. ``grads`` and ``outs`` float32 or bfloat16;
    ``inject`` and ``rescale`` host floats, ``inv_scale`` a 0-d float32
    device tensor or None. ``multi_tensor_norm_finite_cuda.launches``
    counts the launches: one a ``MAX_TENSORS`` tensors, and the pass
    that sums their partials."""
    tensors = list(grads) + list(outs)
    if not tensors:
        raise ValueError("multi_tensor_norm_finite_cuda: no tensors")
    dev = _check_cuda("multi_tensor_norm_finite_cuda", tensors)
    inv = _scalar_ptr("inv_scale", inv_scale, torch.float32, dev)
    n = len(tensors)
    sizes = (ctypes.c_longlong * n)(*[t.numel() for t in tensors])
    dtypes = (ctypes.c_int * n)(*[_DTYPE_CODE[t.dtype] for t in tensors])
    lib = _kernels.load("multi_tensor")
    parts = max(1, lib.multi_tensor_norm_parts(n, sizes))
    partial = torch.empty(parts, dtype=torch.float32, device=dev)
    okp = torch.empty(parts, dtype=torch.int32, device=dev)
    sumsq = torch.empty((), dtype=torch.float32, device=dev)
    finite = torch.empty((), dtype=torch.bool, device=dev)
    gscale = torch.empty((), dtype=torch.float32, device=dev)
    clip = -1.0 if clip_norm is None else _f32(clip_norm)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.multi_tensor_norm_finite(
            n, len(grads), sizes, _ptrs(tensors), dtypes, _f32(inject),
            _f32(rescale), clip, inv, partial.data_ptr(), okp.data_ptr(),
            sumsq.data_ptr(), finite.data_ptr(), gscale.data_ptr(), stream,
            ctypes.byref(launched))
    multi_tensor_norm_finite_cuda.launches += launched.value
    _kernels.check(lib, rc, "multi_tensor_norm_finite")
    return sumsq, finite, gscale


multi_tensor_norm_finite_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatchers
# ---------------------------------------------------------------------------

def _device_type(tensors):
    types = {t.device.type for t in tensors}
    if len(types) != 1:
        raise ValueError("tensors on several device types: %s"
                         % sorted(types))
    return types.pop()


def opt_update(op_name, weights, grads, states, lr, attrs, flag=None,
               gscale=None, inv_scale=None, donate=True):
    """The step's optimizer update of every parameter: the multi-tensor
    kernel for ``adam_update`` / ``sgd_mom_update`` on CUDA tensors
    (which raises on a dtype it does not take), else the per-parameter
    registry route (CPU and meta tensors, other optimizers)."""
    flat = list(weights) + list(grads) + [s for ss in states for s in ss]
    kind = _device_type(flat) if flat else "cpu"
    if kind == "cuda" and op_name in MT_OPS:
        return multi_tensor_opt_update_cuda(
            op_name, weights, grads, states, lr, attrs, flag=flag,
            gscale=gscale, inv_scale=inv_scale, donate=donate)
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError("opt_update has no implementation for device type "
                         "%s" % kind)
    return _opt_update_reference(op_name, weights, grads, states, lr,
                                 attrs, flag=flag, gscale=gscale,
                                 inv_scale=inv_scale, donate=donate)


def norm_finite(grads, outs=(), inject=1.0, inv_scale=None, rescale=1.0,
                clip_norm=None):
    """(sumsq, finite, gscale) on the gradients' device: the kernel on
    CUDA tensors, the plain version on CPU and meta tensors."""
    tensors = list(grads) + list(outs)
    kind = _device_type(tensors)
    if kind == "cuda":
        return multi_tensor_norm_finite_cuda(grads, outs, inject, inv_scale,
                                             rescale, clip_norm)
    if kind in ("cpu", "meta"):
        return _norm_finite_reference(grads, outs, inject, inv_scale,
                                      rescale, clip_norm)
    raise ValueError("norm_finite has no implementation for device type %s"
                     % kind)
