"""Threefry-2x32 keys and samplers, bit-compatible with ``jax.random``.

The JAX package draws every random number from jax's threefry2x32 keys
(``jax_default_prng_impl=threefry2x32`` with the "partitionable" bit
layout, ``jax_threefry_partitionable=True``, and 32-bit default ints).
This module is that scheme in PyTorch integer ops, so that one key gives
the same bits, and the samplers the same values, in both packages:

- a key is a numpy ``uint32[2]`` on the host (``PRNGKey``, ``split``,
  ``fold_in`` run there and cost no device sync), or an int64 tensor of
  two 32-bit words on a device (``PRNGKey`` of a device seed tensor, and
  ``fold_in`` of such a key, run there with no host value: what a step
  captured as a CUDA graph draws from);
- ``random_bits`` hashes a flat counter over a shape on a device: the
  counter's index ``i`` is the pair ``(i >> 32, i & 0xffffffff)``
  (jax's ``iota_2x32_shape``), the hash gives ``(b1, b2)``, and 32-bit
  draws are ``b1 ^ b2``, 8 and 16-bit draws its low bits, 64-bit draws
  ``b1 << 32 | b2`` (jax ``_threefry_random_bits_partitionable``);
- ``split(key, n)[i]`` hashes the counter ``(0, i)`` and ``fold_in(key,
  d)`` the counter ``(0, d)``, so ``split(key, 2)[1] == fold_in(key, 1)``.

Device lanes are int64 tensors holding 32-bit values, masked after each
add and shift (torch's uint32 has few CUDA kernels, and ``>>`` on int32
is arithmetic). The samplers follow ``jax/_src/random.py`` operation by
operation: ``uniform`` puts mantissa bits under an exponent of 1 and
subtracts 1, ``normal`` is ``sqrt(2) * erf_inv(u)`` with XLA's float32
``erf_inv`` polynomial (Giles), ``gamma`` runs Marsaglia-Tsang with one
key an element and ``poisson`` Knuth's and Hormann's loops over one
key stream. ``normal``, ``gamma`` and ``poisson`` also go through
``log``/``log1p``/``lgamma``, whose last bit may differ from XLA's
(ROADMAP Queue C).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import torch_dtype
from .context import current_context

__all__ = ["PRNGKey", "as_key", "split", "fold_in", "random_bits",
           "threefry2x32", "fma", "uniform", "bernoulli", "normal",
           "erf_inv", "randint", "permutation", "gumbel", "categorical",
           "exponential", "gamma", "poisson"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds; Random123, jax
    ``_threefry2x32_lowering``) of the counter words ``(x1, x2)`` under
    the key words ``(k1, k2)``. Every argument is a Python int, a numpy
    int64 array or a torch int64 tensor holding 32-bit values; they
    broadcast. Returns the two output words, masked to 32 bits."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + k1) & _M32
    x2 = (x2 + k2) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _key_words(key):
    """The key's two words: Python ints of a host key, 0-d int64 tensors
    of a device key."""
    if not isinstance(key, torch.Tensor):
        key = np.asarray(key)
    if tuple(key.shape) != (2,):
        raise ValueError("a threefry key is a uint32[2], got shape %r"
                         % (tuple(key.shape),))
    if isinstance(key, torch.Tensor):
        return key[0], key[1]
    return int(key[0]), int(key[1])


def _as_key(w1, w2):
    if isinstance(w1, torch.Tensor):
        return torch.stack([w1, w2])
    return np.array([int(w1), int(w2)], dtype=np.uint32)


def PRNGKey(seed):  # noqa: N802 (jax's name)
    """The key of an integer seed, as ``jax.random.PRNGKey`` makes it
    with 32-bit default ints: the seed's low 32 bits under a zero high
    word (jax ``threefry_seed``). A 0-d integer tensor seed gives a
    device key, computed on its device."""
    if isinstance(seed, torch.Tensor):
        seed = seed.to(torch.int64)
        return torch.stack([torch.zeros_like(seed), seed & _M32])
    return _as_key(0, int(seed) & _M32)


def as_key(rng):
    """A key from a key (any uint32[2] array-like, a jax key's too, or a
    device key tensor, returned as it is) or an int seed
    (``PRNGKey(seed)``)."""
    if isinstance(rng, torch.Tensor):
        _key_words(rng)
        return rng
    if isinstance(rng, (int, np.integer)):
        return PRNGKey(int(rng))
    return np.asarray(rng, dtype=np.uint32)


def fold_in(key, data):
    """``jax.random.fold_in``: the key hashed with the counter
    ``(0, data)`` (data taken as uint32); on the key's device for a
    device key."""
    k1, k2 = _key_words(key)
    y1, y2 = threefry2x32(k1, k2, 0, int(data) & _M32)
    return _as_key(y1, y2)


def _const(value, dtype, device):
    """``value`` as a 0-d tensor of ``dtype`` on ``device`` (a tensor is
    converted; a Python number is filled on the device, which needs no
    copy from the host, so a captured CUDA graph can hold it)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.full((), value, dtype=dtype, device=device)


def split(key, num=2):
    """``jax.random.split``: ``num`` keys (an int or a shape), key ``i``
    being the hash of the counter ``(i >> 32, i & 0xffffffff)``. Returns
    a numpy uint32 array of shape ``(*num, 2)`` for a host key, and an
    int64 tensor of that shape on the key's device for a device key
    (computed there, with no host value: a captured decode step splits
    its key so)."""
    shape = tuple(num) if isinstance(num, (tuple, list)) else (int(num),)
    k1, k2 = _key_words(key)
    n = math.prod(shape)
    if isinstance(key, torch.Tensor):
        idx = torch.arange(n, dtype=torch.int64, device=key.device)
        y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
        return torch.stack([y1, y2], dim=-1).reshape(shape + (2,))
    idx = np.arange(n, dtype=np.int64)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return np.stack([y1, y2], axis=-1).astype(np.uint32).reshape(
        shape + (2,))


def _device(device):
    if device is not None:
        return torch.device(device)
    return current_context().torch_device()


def _counter_bits(k1, k2, shape, device, offset=0, total=None):
    """The hash words of every element of ``shape`` on ``device`` (int64
    tensors of ``shape``); ``k1``/``k2`` are ints or per-element
    tensors. ``offset``/``total``: the elements are the flat positions
    [offset, offset + prod(shape)) of a draw over ``total`` elements (a
    rank's slice of a draw over the whole batch)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    total = n if total is None else int(total)
    idx = torch.arange(int(offset), int(offset) + n, dtype=torch.int64,
                       device=device)
    hi = (idx >> 32) if total > _M32 else 0
    y1, y2 = threefry2x32(k1, k2, hi, idx & _M32)
    return y1.reshape(shape), y2.reshape(shape)


def random_bits(key, shape=(), bit_width=32, device=None, offset=0,
                total=None):
    """``jax.random.bits``: uniform random bits of ``bit_width`` (8, 16,
    32 or 64) over ``shape`` on ``device``, as an int64 tensor holding
    the unsigned value (for 64 bits, its two's-complement pattern).
    offset/total: the flat slice [offset, offset + prod(shape)) of a draw
    over ``total`` elements (``_counter_bits``)."""
    if bit_width not in (8, 16, 32, 64):
        raise ValueError("bit_width must be 8, 16, 32 or 64, got %r"
                         % (bit_width,))
    device = _device(device)
    if device.type == "meta":       # shape inference: no key, no bits
        return torch.empty(tuple(shape), dtype=torch.int64, device=device)
    k1, k2 = _key_words(key)
    b1, b2 = _counter_bits(k1, k2, shape, device, offset, total)
    return _combine(b1, b2, bit_width)


def _combine(b1, b2, bit_width):
    """The draw of ``bit_width`` bits from the hash words."""
    if bit_width == 64:
        # b1 << 32 | b2 without leaving int64: the high word signed
        return torch.where(b1 >= 2 ** 31, b1 - 2 ** 32, b1) * 2 ** 32 + b2
    bits = b1 ^ b2
    return bits if bit_width == 32 else bits & ((1 << bit_width) - 1)


# ---------------------------------------------------------------------------
# samplers (jax/_src/random.py)
# ---------------------------------------------------------------------------

# dtype -> (bits, mantissa bits)
_FLOAT_BITS = {torch.float32: (32, 23), torch.float64: (64, 52),
               torch.float16: (16, 10), torch.bfloat16: (16, 7)}


def _unit_floats(bits, rng_bits, dtype):
    """``bitcast(bits >> (rng_bits - nmant) | bits_of(1.0)) - 1``: the
    mantissa over 2**nmant, exact in ``dtype``."""
    nmant = _FLOAT_BITS[dtype][1]
    shift = rng_bits - nmant
    mant = (bits >> shift) & ((1 << (rng_bits - shift)) - 1)
    return mant.to(dtype) * 2.0 ** -nmant


def fma(a, b, c):
    """``a * b + c`` as XLA's CPU backend computes it: contracted into
    one rounding for float32 and float16; bfloat16 and float64 round
    each step. The product is exact one format up (float64 for float32,
    float32 for float16); the sum there is rounded to odd (an inexact
    sum with an even last bit moves to its neighbour toward the exact
    value, found by TwoSum), so the one cast back rounds as a single
    correctly rounded FMA would, midpoints included."""
    wide, word = {torch.float32: (torch.float64, torch.int64),
                  torch.float16: (torch.float32, torch.int32)}.get(
                      a.dtype, (None, None))
    if wide is None:
        return a * b + c
    p = a.to(wide) * b.to(wide)
    # a Python float takes the default float dtype first, as as_tensor
    # would give it
    c = c.to(wide) if isinstance(c, torch.Tensor) else \
        torch.full((), c, device=p.device).to(wide)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)              # TwoSum: exact p + c - s
    nudge = torch.isfinite(s) & (err != 0) & ((s.view(word) & 1) == 0)
    s = torch.where(nudge, torch.nextafter(s, torch.where(
        err > 0, math.inf, -math.inf).to(wide)), s)
    return s.to(a.dtype)


def _range(floats, minval, maxval, dtype):
    """jax ``_uniform``'s last lines: scale into [minval, maxval) (one
    fused multiply-add), then ``max(minval, .)``, in ``dtype``."""
    if not isinstance(minval, torch.Tensor) and \
            not isinstance(maxval, torch.Tensor) and \
            float(minval) == 0.0 and float(maxval) == 1.0:
        return floats          # floats * 1 + 0, exactly
    lo = _const(minval, dtype, floats.device)
    hi = _const(maxval, dtype, floats.device)
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0,
            device=None, offset=0, total=None):
    """``jax.random.uniform``: values in [minval, maxval) of a float
    ``dtype`` (8-bit draws for dtypes with fewer than 8 mantissa bits,
    as jax makes bfloat16's). offset/total as in ``random_bits``."""
    dtype = torch_dtype(dtype)
    nbits, nmant = _FLOAT_BITS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, rng_bits, device, offset, total)
    return _range(_unit_floats(bits, rng_bits, dtype), minval, maxval,
                  dtype)


def bernoulli(key, p=0.5, shape=None, device=None, offset=0, total=None):
    """``jax.random.bernoulli``: ``uniform(key, shape, dtype of p) < p``.
    A Python float ``p`` means a float32 uniform, whatever the data's
    dtype (as the JAX package's Dropout draws). offset/total: this
    tensor is the flat slice [offset, offset + numel) of a draw over
    ``total`` elements (``random_bits``)."""
    if isinstance(p, torch.Tensor):
        dtype, dev = p.dtype, p.device if device is None else device
        shape = tuple(p.shape) if shape is None else shape
        pt = p
    else:
        dtype, dev = torch.float32, device
        shape = () if shape is None else shape
        pt = float(p)
    u = uniform(key, shape, dtype, device=dev, offset=offset, total=total)
    return u < _const(pt, dtype, u.device)


# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"),
# the polynomial chlo.erf_inv lowers to: coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x):
    """XLA's erf_inv: Giles' polynomial in float32 for float32 and
    narrower inputs (computed in float32, rounded back), torch.erfinv
    for float64."""
    if x.dtype == torch.float64:
        return torch.erfinv(x)
    dtype = x.dtype
    x = x.float()
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _const(_ERFINV_LT5[i], x.dtype, x.device),
                           _const(_ERFINV_GE5[i], x.dtype, x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, w, coef(i))
    out = torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)
    return out.to(dtype)


def _normal_from_uniform(u, dtype):
    return _const(math.sqrt(2), dtype, u.device) * erf_inv(u)


def _normal_lo(dtype):
    """nextafter(-1, 0) in ``dtype``."""
    return -(1.0 - 2.0 ** -(_FLOAT_BITS[dtype][1] + 1))


def normal(key, shape=(), dtype=torch.float32, device=None):
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)`` for u uniform on
    (nextafter(-1, 0), 1)."""
    dtype = torch_dtype(dtype)
    u = uniform(key, shape, dtype, _normal_lo(dtype), 1.0, device)
    return _normal_from_uniform(u, dtype)


def exponential(key, shape=(), dtype=torch.float32, device=None):
    """``jax.random.exponential``: ``-log1p(-u)``."""
    u = uniform(key, shape, dtype, device=device)
    return -torch.log1p(-u)


def gumbel(key, shape=(), dtype=torch.float32, device=None):
    """``jax.random.gumbel`` (its default "low" mode):
    ``-log(-log(u))`` for u uniform on [tiny, 1)."""
    dtype = torch_dtype(dtype)
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0, device)
    return -torch.log(-torch.log(u))


def categorical(key, logits, axis=-1, shape=None):
    """``jax.random.categorical`` with replacement: the argmax of
    gumbel noise plus the logits (first index at a tie), over ``axis``.
    ``shape`` must end with the batch shape (the logits' shape without
    ``axis``)."""
    nd = logits.dim()
    axis = axis % nd
    batch_shape = tuple(s for i, s in enumerate(logits.shape) if i != axis)
    shape = batch_shape if shape is None else tuple(shape)
    prefix = shape[:len(shape) - len(batch_shape)]
    noise_shape = list(shape[len(prefix):])
    noise_shape.insert(axis, logits.shape[axis])
    noise = gumbel(key, prefix + tuple(noise_shape), logits.dtype,
                   logits.device)
    lg = logits.reshape((1,) * len(prefix) + tuple(logits.shape))
    return torch.argmax(noise + lg, dim=len(prefix) + axis)


def randint(key, shape, minval, maxval, dtype=torch.int32, device=None):
    """``jax.random.randint`` for 32-bit (and narrower) dtypes: two
    32-bit draws combined modulo the span, in uint32 arithmetic."""
    dtype = torch_dtype(dtype)
    info = torch.iinfo(dtype)
    lo_c, hi_c = max(info.min, -2 ** 31), min(info.max, 2 ** 31 - 1)
    k1, k2 = split(key)
    higher = random_bits(k1, shape, 32, device)
    lower = random_bits(k2, shape, 32, device)
    dev = higher.device
    minval = torch.as_tensor(minval, device=dev).to(torch.int64)
    maxval = torch.as_tensor(maxval, device=dev).to(torch.int64)
    out_of_range = maxval > hi_c
    minval = minval.clamp(lo_c, hi_c)
    maxval = maxval.clamp(lo_c, hi_c)
    span = (maxval - minval) & _M32
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    span = torch.where(out_of_range & (maxval > minval), (span + 1) & _M32,
                       span)
    # a span of 2**32 wraps to 0: the remainders then leave the draw as
    # it is, as uint32 arithmetic does
    wide = span == 0
    safe = torch.where(wide, torch.full_like(span, 2 ** 32), span)
    mult = (2 ** 16) % safe
    mult = _mul32(mult, mult) % safe
    offset = (_mul32(higher % safe, mult) + lower % safe) & _M32
    offset = offset % safe
    return (minval + offset).to(dtype)


def _mul32(a, b):
    """(a * b) mod 2**32 for 32-bit values, without leaving int64."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & _M32


def permutation(key, x, axis=0, device=None):
    """``jax.random.permutation``: an int ``x`` permutes ``arange(x)``,
    a tensor is permuted along ``axis`` (whole slices). Rounds of a
    stable sort under fresh 32-bit keys, as many as jax takes."""
    if isinstance(x, int):
        x = torch.arange(x, device=_device(device))
        axis = 0
    n = x.shape[axis]
    if x.dim() != 1:
        order = permutation(key, torch.arange(n, device=x.device))
        return torch.index_select(x, axis, order)
    rounds = int(np.ceil(3 * np.log(max(1, x.numel()))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        sort_keys = random_bits(sub, x.shape, 32, x.device)
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x


def _split_each(k1, k2, n):
    """``split`` of a key an element: n pairs of per-element words."""
    return [threefry2x32(k1, k2, 0, i) for i in range(n)]


def _uniform_each(k1, k2, dtype, minval=0.0, maxval=1.0):
    """A shape-() ``uniform`` draw for a key an element."""
    b1, b2 = threefry2x32(k1, k2, 0, 0)
    nbits, nmant = _FLOAT_BITS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = _combine(b1, b2, rng_bits)
    return _range(_unit_floats(bits, rng_bits, dtype), minval, maxval,
                  dtype)


def gamma(key, a, shape=None, dtype=torch.float32, device=None):
    """``jax.random.gamma`` (log_space=False): Marsaglia-Tsang, one key
    an element (``split(key, n)``), each element's rejection loop run
    to its own end (all elements at once, masked)."""
    dtype = torch_dtype(dtype)
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(float(a), device=_device(device))
    shape = tuple(a.shape) if shape is None else tuple(shape)
    alpha = torch.broadcast_to(a.to(dtype), shape).reshape(-1)
    dev = alpha.device
    keys = torch.from_numpy(split(key, alpha.numel()).astype(np.int64)).to(
        dev)
    k1, k2 = keys[:, 0], keys[:, 1]

    def c(v):
        return torch.tensor(v, dtype=dtype, device=dev)
    one, zero = c(1.0), c(0.0)
    boost_mask = alpha >= one
    alpha_orig = alpha
    alpha = torch.where(boost_mask, alpha, alpha + one)
    d = alpha - c(1.0 / 3.0)
    cc = c(1.0 / 3.0) / torch.sqrt(d)
    (k1, k2), (s1, s2) = _split_each(k1, k2, 2)
    X, V, U = zero.expand_as(d), one.expand_as(d), c(2.0).expand_as(d)

    def cond(X, V, U):
        return (U >= one - c(0.0331) * (X * X)) & \
            (torch.log(U) >= X * c(0.5) + d * ((one - V) + torch.log(V)))

    active = cond(X, V, U)
    while bool(active.any()):
        (nk1, nk2), (xk1, xk2), (uk1, uk2) = _split_each(k1, k2, 3)
        # inner loop: draw normals until v = 1 + x c > 0
        x, v = zero.expand_as(d), (-one).expand_as(d)
        need = torch.ones_like(active)
        while bool(need.any()):
            (xk1n, xk2n), (sk1, sk2) = _split_each(xk1, xk2, 2)
            xn = _normal_from_uniform(
                _uniform_each(sk1, sk2, dtype, _normal_lo(dtype), 1.0),
                dtype)
            vn = one + xn * cc
            x, v = torch.where(need, xn, x), torch.where(need, vn, v)
            xk1, xk2 = torch.where(need, xk1n, xk1), torch.where(need, xk2n,
                                                                  xk2)
            need = need & (v <= zero)
        Xn, Vn = x * x, (v * v) * v
        Un = _uniform_each(uk1, uk2, dtype)
        X, V, U = (torch.where(active, Xn, X), torch.where(active, Vn, V),
                   torch.where(active, Un, U))
        k1, k2 = torch.where(active, nk1, k1), torch.where(active, nk2, k2)
        active = active & cond(X, V, U)
    samples = one - _uniform_each(s1, s2, dtype)
    boost = torch.where(boost_mask, one, torch.pow(samples, one / alpha_orig))
    return ((d * V) * boost).reshape(shape)


def poisson(key, lam, shape=None, dtype=torch.int32, device=None):
    """``jax.random.poisson``: Knuth's loop for lam < 10 and Hormann's
    transformed rejection otherwise, both over one key stream and
    selected elementwise; 0 where lam == 0."""
    dtype = torch_dtype(dtype)
    if not isinstance(lam, torch.Tensor):
        lam = torch.tensor(float(lam), device=_device(device))
    shape = tuple(lam.shape) if shape is None else tuple(shape)
    lam = torch.broadcast_to(lam, shape).to(torch.float32)
    use_knuth = torch.isnan(lam) | (lam < 10)
    lam_knuth = torch.where(use_knuth, lam, torch.zeros_like(lam))
    lam_rej = torch.where(use_knuth, torch.full_like(lam, 1e5), lam)
    out = torch.where(use_knuth, _poisson_knuth(key, lam_knuth, shape),
                      _poisson_rejection(key, lam_rej, shape))
    return torch.where(lam == 0, torch.zeros_like(out), out).to(dtype)


def _poisson_knuth(key, lam, shape):
    k = torch.zeros(shape, dtype=torch.int64, device=lam.device)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=lam.device)
    while bool((log_prod > -lam).any()):
        key, sub = split(key)
        k = torch.where(log_prod > -lam, k + 1, k)
        u = uniform(sub, shape, torch.float32, device=lam.device)
        log_prod = log_prod + torch.log(u)
    return (k - 1).to(torch.float32)


def _poisson_rejection(key, lam, shape):
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full(shape, -1.0, dtype=torch.float32, device=lam.device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=lam.device)
    while not bool(accepted.all()):
        key, s0, s1 = split(key, 3)
        u = uniform(s0, shape, torch.float32, device=lam.device) - 0.5
        v = uniform(s1, shape, torch.float32, device=lam.device)
        us = 0.5 - torch.abs(u)
        k = torch.floor((2 * a / us + b) * u + lam + 0.43)
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = -lam + k * log_lam - torch.lgamma(k + 1)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((us < 0.013) & (v > us))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
    return k_out
