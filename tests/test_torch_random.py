"""The port's threefry PRNG (``mxnet_tpu_torch._threefry``, the global
stream of ``mxnet_tpu_torch.random``) against jax 0.9's, on the CPU.

Keys, splits, folds, raw bits of every width, uniform, bernoulli,
randint, permutation and categorical must be equal bit for bit. Two
samplers go through ``log1p``, whose float32 last bit differs between
XLA's CPU code and PyTorch's: ``normal`` (sqrt(2) * erf_inv(u), XLA's
erf_inv polynomial ported with its fused multiply-adds) is held within
NORMAL_ULPS, ``exponential`` (-log1p(-u)) within EXPONENTIAL_ULPS
(ROADMAP Queue C). ``chip_smoke.PRNG_DIGESTS``, the table the card must
reproduce, is recomputed here from JAX's own draws.
"""
import hashlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _threefry as tf

import chip_smoke

# the most float32 ulps between the packages' draws (measured over 200000
# normals and 100000 exponentials: 3 and 1)
NORMAL_ULPS = 3
EXPONENTIAL_ULPS = 1

KEY = 7
SHAPES = [(), (7,), (3, 5), (70001,)]


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("key,counter,want", [
    ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
    ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
     (0x1cb996fc, 0xbb002be7)),
    ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
     (0xc4923a9c, 0x483df7a0))], ids=["zeros", "ones", "pi"])
def test_threefry_known_answers(key, counter, want):
    """The Random123 known-answer vectors, on Python ints and on int64
    tensors."""
    assert tf.threefry2x32(*key, *counter) == want
    t = tf.threefry2x32(*key, torch.tensor([counter[0]]),
                        torch.tensor([counter[1]]))
    assert (int(t[0][0]), int(t[1][0])) == want


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31, 2 ** 32 + 5, -1,
                                  2 ** 40 + 3])
def test_prng_key_split_fold_in_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    np.testing.assert_array_equal(tk, np.asarray(jk))
    assert tk.dtype == np.uint32
    for d in (0, 17, 2 ** 32 - 1):
        np.testing.assert_array_equal(tf.fold_in(tk, d),
                                      np.asarray(jax.random.fold_in(jk, d)))
    for num in (2, 5, (2, 3)):
        np.testing.assert_array_equal(tf.split(tk, num),
                                      np.asarray(jax.random.split(jk, num)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("width", [8, 16, 32, 64])
def test_random_bits_match_jax(shape, width):
    jdt = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32, 64: jnp.uint64}
    t = tf.random_bits(tf.PRNGKey(KEY), shape, width, "cpu").numpy()
    if width == 64:
        with jax.enable_x64(True):
            j = np.asarray(jax.random.bits(jax.random.PRNGKey(KEY), shape,
                                           jdt[width])).view(np.int64)
    else:
        j = np.asarray(jax.random.bits(jax.random.PRNGKey(KEY), shape,
                                       jdt[width])).astype(np.int64)
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 3.0),
                                   (0.125, 0.334)])
def test_uniform_matches_jax(dtype, lo, hi):
    j = jax.random.uniform(jax.random.PRNGKey(KEY), (5000,),
                           jnp.dtype(dtype), lo, hi)
    t = tf.uniform(tf.PRNGKey(KEY), (5000,), dtype, lo, hi, "cpu")
    assert t.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))


@pytest.mark.parametrize("p", [0.5, 0.1, 0.9])
@pytest.mark.parametrize("shape", [(), (513, 7), (70001,)], ids=str)
def test_bernoulli_matches_jax(p, shape):
    j = jax.random.bernoulli(jax.random.PRNGKey(KEY), p, shape)
    t = tf.bernoulli(tf.PRNGKey(KEY), p, shape, "cpu")
    assert t.dtype == torch.bool
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_bernoulli_tensor_p_matches_jax():
    p = np.random.RandomState(0).rand(6, 5).astype(np.float32)
    j = jax.random.bernoulli(jax.random.PRNGKey(KEY), jnp.asarray(p))
    t = tf.bernoulli(tf.PRNGKey(KEY), torch.from_numpy(p))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("lo,hi", [(0, 10), (-5, 7), (0, 2 ** 31 - 1),
                                   (-2 ** 31, 2 ** 31 - 1), (3, 3),
                                   (5, 2), (-2 ** 31, 0)])
def test_randint_matches_jax(lo, hi):
    j = jax.random.randint(jax.random.PRNGKey(KEY), (700,), lo, hi)
    t = tf.randint(tf.PRNGKey(KEY), (700,), lo, hi, device="cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("n", [1, 2, 10, 1000, 100003])
def test_permutation_matches_jax(n):
    j = jax.random.permutation(jax.random.PRNGKey(KEY), n)
    t = tf.permutation(tf.PRNGKey(KEY), n, device="cpu")
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_permutation_of_rows_matches_jax():
    x = np.random.RandomState(0).randn(9, 3).astype(np.float32)
    j = jax.random.permutation(jax.random.PRNGKey(KEY), jnp.asarray(x))
    t = tf.permutation(tf.PRNGKey(KEY), torch.from_numpy(x))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("axis,shape", [(-1, None), (-1, (5, 4)),
                                        (0, (3, 7))])
def test_categorical_matches_jax(axis, shape):
    lg = np.random.RandomState(1).randn(4, 7).astype(np.float32)
    j = jax.random.categorical(jax.random.PRNGKey(KEY), jnp.asarray(lg),
                               axis=axis, shape=shape)
    t = tf.categorical(tf.PRNGKey(KEY), torch.from_numpy(lg), axis, shape)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_normal_within_stated_ulps():
    j = np.asarray(jax.random.normal(jax.random.PRNGKey(KEY), (200000,)))
    t = tf.normal(tf.PRNGKey(KEY), (200000,), device="cpu").numpy()
    d = _ulps(t, j)
    assert d.max() <= NORMAL_ULPS, d.max()
    assert (d == 0).mean() > 0.98


def test_exponential_within_stated_ulps():
    j = np.asarray(jax.random.exponential(jax.random.PRNGKey(KEY),
                                          (100000,)))
    t = tf.exponential(tf.PRNGKey(KEY), (100000,), device="cpu").numpy()
    assert _ulps(t, j).max() <= EXPONENTIAL_ULPS


# a * b + c whose exact value lies just off a midpoint of the result's
# format, where a sum rounded one format up lands on the midpoint: one
# rounding (XLA's) and two (a plain sum, then the cast) part there
FMA_MIDPOINTS = {
    "float32": ([1 + 2 ** -12] * 2, [1 + 2 ** -12] * 2,
                [2.0 ** -80, -2.0 ** -80]),
    "float16": ([1 + 2 ** -5] * 2, [1 + 2 ** -6] * 2,
                [2.0 ** -24, -2.0 ** -24]),
}


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_fma_rounds_as_xla_does(dtype):
    """``fma`` equals XLA's CPU ``a * b + c`` bit for bit: on random
    triples across 42 binades of ``c``, and on the midpoint cases."""
    rng = np.random.RandomState(0)
    n = 200000
    a, b = rng.uniform(-2, 2, (2, n))
    c = rng.uniform(-1, 1, n) * 2.0 ** rng.randint(-30, 12, n)
    a, b, c = (np.concatenate([x, FMA_MIDPOINTS.get(dtype, [[]] * 3)[i]])
               for i, x in enumerate((a, b, c)))
    js = [jnp.asarray(x, jnp.float32).astype(dtype) for x in (a, b, c)]
    j = np.asarray(jax.jit(lambda a, b, c: a * b + c)(*js)
                   .astype(jnp.float32))
    ts = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype)) for x in js]
    np.testing.assert_array_equal(tf.fma(*ts).float().numpy(), j)


def test_erf_inv_edges_match_xla():
    """XLA's float32 erf_inv at the ends of its range and across the
    w < 5 / w >= 5 branch."""
    x = np.array([-1.0, -0.9999999, -0.999, -0.5, 0.0, 1e-30, 0.3, 0.99,
                  0.99999, 1.0], np.float32)
    j = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    t = tf.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    assert _ulps(t[~np.isinf(t)], j[~np.isinf(j)]).max() <= NORMAL_ULPS


@pytest.mark.parametrize("s", [0, 7, 12345])
def test_global_stream_after_seed_matches_jax(s):
    """mx.random.seed(s), then eager draws and keys in the same order:
    the same values in both packages."""
    jmx.random.seed(s)
    tmx.random.seed(s)
    with tmx.cpu():
        for shape in ((1000,), (3, 4)):
            np.testing.assert_array_equal(
                tmx.nd.uniform(shape=shape).asnumpy(),
                jmx.nd.uniform(shape=shape).asnumpy())
        np.testing.assert_array_equal(
            tmx.nd.random_uniform(low=-1, high=3, shape=(50,)).asnumpy(),
            jmx.nd.random_uniform(low=-1, high=3, shape=(50,)).asnumpy())
        x = np.arange(20, dtype=np.float32).reshape(10, 2)
        np.testing.assert_array_equal(
            tmx.nd.shuffle(tmx.nd.array(x)).asnumpy(),
            jmx.nd.shuffle(jmx.nd.array(x)).asnumpy())
        with tmx.autograd.train_mode(), jmx.autograd.train_mode():
            np.testing.assert_array_equal(
                tmx.nd.Dropout(tmx.nd.ones((40, 30)), p=0.4).asnumpy(),
                jmx.nd.Dropout(jmx.nd.ones((40, 30)), p=0.4).asnumpy())
    np.testing.assert_array_equal(tmx.random.next_key(),
                                  np.asarray(jmx.random.next_key()))
    np.testing.assert_array_equal(
        tmx.random.fork_key(3), np.asarray(jmx.random.fork_key(3)))


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_chip_smoke_digest_table_matches_jax():
    """The card reproduces PRNG_DIGESTS; here they come from JAX."""
    key0 = jax.random.PRNGKey(0)
    jmx.random.seed(7)
    want = {
        "bits_key0_1000": _digest(np.asarray(jax.random.bits(
            key0, (1000,), jnp.uint32)).astype(np.uint32)),
        "bernoulli_fold17_512x4096": _digest(np.packbits(np.asarray(
            jax.random.bernoulli(jax.random.fold_in(key0, 17), 0.5,
                                 (512, 4096))))),
        "seed7_nd_uniform_1000": _digest(
            jmx.nd.uniform(shape=(1000,)).asnumpy().astype(np.float32)),
    }
    assert chip_smoke.PRNG_DIGESTS == want
    # the port's draws on the CPU, through the function the card runs
    with tmx.cpu():
        assert chip_smoke.prng_digests(tmx, tmx.cpu()) == want
