"""Random samplers — the PyTorch twin of ``mxnet_tpu/ops/random_ops.py``
(reference src/operator/random/).

Every op takes the caller's threefry key (``rng``: one split of the
global stream for an eager call, ``fold_in(key, uid)`` in a graph) and
draws through ``_threefry``, so uniform, normal (to the ulps of its
``log1p``), exponential, shuffle and multinomial give the JAX package's
values, and gamma, poisson and the negative binomials run its
algorithms on the same per-element keys (ROADMAP Queue C records where
a draw still differs). A creation op makes its tensor on ``device``
when the caller passes one, else on the ``ctx`` attr's device, else on
the current context's; on ``meta`` (shape inference) it draws nothing.
"""
from __future__ import annotations

import math

import torch

from .. import _threefry as tf
from ..base import torch_dtype
from .init_ops import _device
from .registry import register


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _rand(name, sampler, defaults, aliases=()):
    @register(name, arg_names=(), differentiable=False, needs_rng=True,
              aliases=aliases,
              defaults={**defaults, "shape": None, "dtype": "float32",
                        "ctx": None})
    def _f(shape=None, dtype="float32", ctx=None, device=None, rng=None,
           **kw):
        s, dt, dev = _shape(shape), torch_dtype(dtype), _device(ctx, device)
        if dev.type == "meta":
            return torch.empty(s, dtype=dt, device=dev)
        return sampler(rng, s, dt, dev, kw)
    return _f


_rand("_random_uniform",
      lambda rng, s, dt, dev, kw: tf.uniform(
          rng, s, dt, kw.get("low", 0.0), kw.get("high", 1.0), dev),
      {"low": 0.0, "high": 1.0}, aliases=("uniform", "random_uniform"))

_rand("_random_normal",
      lambda rng, s, dt, dev, kw: tf.fma(
          tf.normal(rng, s, dt, dev),
          torch.full((), kw.get("scale", 1.0), dtype=dt, device=dev),
          torch.full((), kw.get("loc", 0.0), dtype=dt, device=dev)),
      {"loc": 0.0, "scale": 1.0}, aliases=("normal", "random_normal",
                                           "randn"))

_rand("_random_exponential",
      lambda rng, s, dt, dev, kw: tf.exponential(rng, s, dt, dev) /
      kw.get("lam", 1.0),
      {"lam": 1.0}, aliases=("random_exponential", "exponential"))

_rand("_random_gamma",
      lambda rng, s, dt, dev, kw: tf.gamma(
          rng, kw.get("alpha", 1.0), s, dt, dev) * kw.get("beta", 1.0),
      {"alpha": 1.0, "beta": 1.0}, aliases=("random_gamma",))

_rand("_random_poisson",
      lambda rng, s, dt, dev, kw: tf.poisson(
          rng, kw.get("lam", 1.0), s, device=dev).to(dt),
      {"lam": 1.0}, aliases=("random_poisson", "poisson"))

_rand("_random_negative_binomial",
      lambda rng, s, dt, dev, kw: _neg_binomial(
          rng, kw.get("k", 1), kw.get("p", 1.0), s, dev).to(dt),
      {"k": 1, "p": 1.0}, aliases=("random_negative_binomial",
                                   "negative_binomial"))

_rand("_random_generalized_negative_binomial",
      lambda rng, s, dt, dev, kw: _gen_neg_binomial(
          rng, kw.get("mu", 1.0), kw.get("alpha", 1.0), s, dev).to(dt),
      {"mu": 1.0, "alpha": 1.0},
      aliases=("random_generalized_negative_binomial",
               "generalized_negative_binomial"))


def _neg_binomial(rng, k, p, shape, device=None):
    """A gamma(k) rate times (1 - p) / p, then a poisson draw of it; k
    and p scalars or tensors of ``shape``."""
    k1, k2 = tf.split(rng)
    lam = tf.gamma(k1, k, shape, device=device) * ((1 - p) / p)
    return tf.poisson(k2, lam, shape)


def _gen_neg_binomial(rng, mu, alpha, shape, device=None):
    r = 1.0 / alpha
    return _neg_binomial(rng, r, r / (r + mu), shape, device)


@register("sample_multinomial", arg_names=("data",), differentiable=False,
          needs_rng=True, aliases=("_sample_multinomial",),
          defaults={"shape": None, "get_prob": False, "dtype": "int32"})
def _sample_multinomial(data, shape=None, get_prob=False, dtype="int32",
                        rng=None, **_):
    n = math.prod(_shape(shape)) if shape else 1
    dt = torch_dtype(dtype)
    rows = () if data.dim() == 1 else (data.shape[0],)
    if data.device.type == "meta":
        out = torch.empty(rows + ((n,) if shape else ()), dtype=dt,
                          device="meta")
        return (out, out.float()) if get_prob else out
    logits = torch.log(torch.clamp_min(data, 1e-20))
    if data.dim() == 1:
        samples = tf.categorical(rng, logits, shape=(n,))
    else:
        samples = tf.categorical(rng, logits[:, None, :], axis=-1,
                                 shape=(data.shape[0], n))
    out = samples if shape else samples[..., 0]
    out = out.to(dt)
    if get_prob:
        idx = out.to(torch.int64)
        if data.dim() == 1:
            lp = torch.log(torch.clamp_min(data[idx], 1e-20))
        else:
            lp = torch.log(torch.clamp_min(torch.gather(
                data, -1, idx.reshape(data.shape[0], -1)), 1e-20)
            ).reshape(out.shape)
        return out, lp
    return out


def _sample_vec(name, sampler):
    """`_sample_*` ops: a draw per distribution parameter (reference
    src/operator/random/sample_op.cc multi-distribution samplers)."""
    @register(name, arg_names=None, differentiable=False, needs_rng=True,
              defaults={"shape": None, "dtype": "float32"})
    def _f(*params, shape=None, dtype="float32", rng=None, **_):
        s, dt = _shape(shape), torch_dtype(dtype)
        p0 = params[0]
        full = tuple(p0.shape) + s
        if p0.device.type == "meta":
            return torch.empty(full, dtype=dt, device="meta")
        ps = [torch.broadcast_to(p.reshape(tuple(p.shape) + (1,) * len(s)),
                                 full) for p in params]
        return sampler(rng, ps, full, dt, p0.device).to(dt)
    return _f


_sample_vec("_sample_uniform",
            lambda rng, ps, s, dt, dev: tf.fma(
                tf.uniform(rng, s, dt, device=dev), ps[1] - ps[0], ps[0]))
_sample_vec("_sample_normal",
            lambda rng, ps, s, dt, dev: tf.fma(
                ps[1], tf.normal(rng, s, dt, dev), ps[0]))
_sample_vec("_sample_exponential",
            lambda rng, ps, s, dt, dev: tf.exponential(rng, s, dt, dev) /
            ps[0])
_sample_vec("_sample_gamma",
            lambda rng, ps, s, dt, dev: tf.gamma(rng, ps[0], s, dt) *
            ps[1])
_sample_vec("_sample_poisson",
            lambda rng, ps, s, dt, dev: tf.poisson(rng, ps[0], s).to(dt))
_sample_vec("_sample_negative_binomial",
            lambda rng, ps, s, dt, dev: _neg_binomial(rng, ps[0], ps[1], s))
_sample_vec("_sample_generalized_negative_binomial",
            lambda rng, ps, s, dt, dev: _gen_neg_binomial(rng, ps[0], ps[1],
                                                          s))


@register("shuffle", arg_names=("data",), differentiable=False,
          needs_rng=True, aliases=("_shuffle",))
def _shuffle(data, rng=None, **_):
    if data.device.type == "meta":
        return torch.empty_like(data)
    return tf.permutation(rng, data, axis=0)
