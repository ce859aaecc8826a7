"""Elementwise unary, binary, scalar and logic ops, with the semantics of
``mxnet_tpu/ops/elemwise.py``: one plain PyTorch function an op.

The rules the JAX ops follow and these keep:

- a scalar attr takes the tensor's dtype first (``jnp.asarray(scalar,
  x.dtype)``): an int tensor stays int (``_div_scalar`` then divides as
  true division, into float32), and a bf16 tensor takes the
  bf16-rounded scalar;
- comparisons and logic ops give 0/1 in the left input's dtype;
- ``broadcast_mod`` gives 0 where the divisor is 0;
- ``maximum``/``minimum`` (and so ``relu`` and ``clip``) pass half the
  gradient to each side of a tie, as ``jnp.maximum`` does.
"""
from __future__ import annotations

import math

import torch

from ..base import torch_dtype
from .registry import register


def _u(name, fn, aliases=(), differentiable=True):
    @register(name, arg_names=("data",), aliases=aliases,
              differentiable=differentiable, doc="elementwise %s" % name)
    def _f(x, **_):
        return fn(x)
    return _f


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _sigmoid(x):
    # both branches of the JAX op's where, so that the gradient is the
    # same expression as there
    e = torch.exp(x)
    return torch.where(x >= 0, 1.0 / (1.0 + torch.exp(-x)), e / (1.0 + e))


def _zero_like_scalar(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


# -- unary math ---------------------------------------------------------------
_u("abs", torch.abs)
_u("sign", torch.sign)
_u("negative", torch.neg)
_u("reciprocal", lambda x: 1.0 / x)
_u("rcbrt", lambda x: 1.0 / _cbrt(x))
_u("cbrt", _cbrt)
_u("sqrt", torch.sqrt)
_u("rsqrt", torch.rsqrt)
_u("square", torch.square)
_u("exp", torch.exp)
_u("expm1", torch.expm1)
_u("log", torch.log)
_u("log10", torch.log10)
_u("log1p", torch.log1p)
_u("log2", torch.log2)
_u("sin", torch.sin)
_u("cos", torch.cos)
_u("tan", torch.tan)
_u("sinh", torch.sinh)
_u("cosh", torch.cosh)
_u("tanh", torch.tanh)
_u("arcsin", torch.asin)
_u("arccos", torch.acos)
_u("arctan", torch.atan)
_u("arcsinh", torch.asinh)
_u("arccosh", torch.acosh)
_u("arctanh", torch.atanh)
_u("degrees", lambda x: x * (180.0 / math.pi))
_u("radians", lambda x: x * (math.pi / 180.0))
_u("gamma", lambda x: torch.exp(torch.lgamma(x)))
_u("gammaln", torch.lgamma)
_u("relu", lambda x: torch.maximum(x, _zero_like_scalar(x)))
_u("sigmoid", _sigmoid)
_u("softsign", lambda x: x / (1.0 + torch.abs(x)))
_u("ceil", torch.ceil, differentiable=False)
_u("floor", torch.floor, differentiable=False)
_u("rint", torch.round, differentiable=False)
_u("round", torch.round, differentiable=False)   # half to even, as jnp
_u("fix", torch.trunc, differentiable=False)
_u("trunc", torch.trunc, differentiable=False)
_u("erf", torch.erf)
_u("logical_not", lambda x: (x == 0).to(x.dtype), differentiable=False)


@register("_copy", arg_names=("data",), aliases=("identity",))
def _copy(x, **_):
    return x


@register("BlockGrad", arg_names=("data",), aliases=("stop_gradient",))
def _block_grad(x, **_):
    return x.detach()


@register("make_loss", arg_names=("data",))
def _make_loss_t(x, **_):
    return x


@register("_identity_with_attr_like_rhs", arg_names=("lhs", "rhs"),
          nondiff_inputs=(1,))
def _identity_like_rhs(lhs, rhs, **_):
    return lhs


@register("Cast", arg_names=("data",), aliases=("cast",))
def _cast(x, dtype="float32", **_):
    return x.to(torch_dtype(dtype))


# -- binary broadcasting ------------------------------------------------------

def _b(name, fn, aliases=(), differentiable=True):
    @register(name, arg_names=("lhs", "rhs"), aliases=aliases,
              differentiable=differentiable, doc="broadcasting %s" % name)
    def _f(lhs, rhs, **_):
        return fn(lhs, rhs)
    return _f


def _mod(lhs, rhs):
    # fmod by a safe divisor, then 0 where the divisor is 0 (an int fmod
    # by 0 would raise; a float one would put a NaN into the gradient)
    nz = rhs != 0
    safe = torch.where(nz, rhs, torch.ones((), dtype=rhs.dtype,
                                           device=rhs.device))
    out = torch.fmod(lhs, safe)
    return torch.where(nz, out, torch.zeros((), dtype=out.dtype,
                                            device=out.device))


def _cmp(fn):
    return lambda l, r: fn(l, r).to(l.dtype)


_b("broadcast_add", torch.add, aliases=("broadcast_plus", "elemwise_add",
                                        "_plus", "_Plus"))
_b("broadcast_sub", torch.sub, aliases=("broadcast_minus", "elemwise_sub",
                                        "_minus", "_Minus", "_sub"))
_b("broadcast_mul", torch.mul, aliases=("elemwise_mul", "_mul", "_Mul"))
_b("broadcast_div", torch.true_divide, aliases=("elemwise_div", "_div",
                                                "_Div"))
_b("broadcast_mod", _mod, aliases=("_mod",))
_b("broadcast_power", torch.pow, aliases=("_power", "_Power", "pow"))
_b("broadcast_maximum", torch.maximum, aliases=("_maximum", "_Maximum",
                                                "maximum"))
_b("broadcast_minimum", torch.minimum, aliases=("_minimum", "_Minimum",
                                                "minimum"))
_b("broadcast_hypot", torch.hypot, aliases=("_hypot", "hypot"))
_b("_grad_add", torch.add)

_b("broadcast_equal", _cmp(torch.eq), aliases=("_equal", "equal"),
   differentiable=False)
_b("broadcast_not_equal", _cmp(torch.ne),
   aliases=("_not_equal", "not_equal"), differentiable=False)
_b("broadcast_greater", _cmp(torch.gt), aliases=("_greater", "greater"),
   differentiable=False)
_b("broadcast_greater_equal", _cmp(torch.ge),
   aliases=("_greater_equal", "greater_equal"), differentiable=False)
_b("broadcast_lesser", _cmp(torch.lt), aliases=("_lesser", "lesser"),
   differentiable=False)
_b("broadcast_lesser_equal", _cmp(torch.le),
   aliases=("_lesser_equal", "lesser_equal"), differentiable=False)
_b("broadcast_logical_and", _cmp(lambda l, r: (l != 0) & (r != 0)),
   differentiable=False)
_b("broadcast_logical_or", _cmp(lambda l, r: (l != 0) | (r != 0)),
   differentiable=False)
_b("broadcast_logical_xor", _cmp(lambda l, r: (l != 0) ^ (r != 0)),
   differentiable=False)


@register("add_n", aliases=("ElementWiseSum", "_sum"), arg_names=None)
def _add_n(*args, **_):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# -- scalar ops ---------------------------------------------------------------

def _as_scalar(x, scalar):
    # the scalar takes x's dtype first (jnp.asarray(scalar, x.dtype)):
    # an int tensor stays int, and a bf16 tensor takes the bf16-rounded
    # scalar; filled on the device (no copy from the host, so a captured
    # CUDA graph can hold it)
    return torch.full((), scalar, dtype=x.dtype, device=x.device)


def _s(name, fn, aliases=(), differentiable=True):
    @register(name, arg_names=("data",), aliases=aliases,
              differentiable=differentiable, defaults={"scalar": 0.0})
    def _f(x, scalar=0.0, **_):
        return fn(x, _as_scalar(x, scalar))
    return _f


_s("_plus_scalar", torch.add, aliases=("_PlusScalar",))
_s("_minus_scalar", torch.sub, aliases=("_MinusScalar",))
_s("_rminus_scalar", lambda x, s: s - x, aliases=("_RMinusScalar",))
_s("_mul_scalar", torch.mul, aliases=("_MulScalar",))
_s("_div_scalar", torch.true_divide, aliases=("_DivScalar",))
_s("_rdiv_scalar", lambda x, s: torch.true_divide(s, x),
   aliases=("_RDivScalar",))
_s("_mod_scalar", torch.fmod, aliases=("_ModScalar",))
_s("_rmod_scalar", lambda x, s: torch.fmod(s, x), aliases=("_RModScalar",))
_s("_power_scalar", torch.pow, aliases=("_PowerScalar",))
_s("_rpower_scalar", lambda x, s: torch.pow(s, x),
   aliases=("_RPowerScalar",))
_s("_maximum_scalar", torch.maximum, aliases=("_MaximumScalar",))
_s("_minimum_scalar", torch.minimum, aliases=("_MinimumScalar",))
_s("_hypot_scalar", torch.hypot, aliases=("_HypotScalar",))
_s("_equal_scalar", _cmp(torch.eq), differentiable=False)
_s("_not_equal_scalar", _cmp(torch.ne), differentiable=False)
_s("_greater_scalar", _cmp(torch.gt), differentiable=False)
_s("_greater_equal_scalar", _cmp(torch.ge), differentiable=False)
_s("_lesser_scalar", _cmp(torch.lt), differentiable=False)
_s("_lesser_equal_scalar", _cmp(torch.le), differentiable=False)


@register("clip", arg_names=("data",),
          defaults={"a_min": 0.0, "a_max": 1.0})
def _clip(x, a_min=0.0, a_max=1.0, **_):
    # jnp.clip is maximum then minimum against weakly-typed scalars: a
    # float bound turns an int tensor into float32, a bf16 tensor rounds
    # the bound to bf16, and a tie passes half the gradient
    lo = torch.full((), a_min, device=x.device)
    hi = torch.full((), a_max, device=x.device)
    return torch.minimum(hi, torch.maximum(lo, x))


@register("smooth_l1", arg_names=("data",), defaults={"scalar": 1.0})
def _smooth_l1(x, scalar=1.0, **_):
    s2 = scalar * scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)
