"""The PyTorch port's flash attention against the JAX package's, forward
and backward.

On the CPU the JAX flash kernels (forward, dq, dk/dv) run in Pallas
interpret mode (small blocks, so every case spans several q and k
blocks) and the port runs the kernels' plain versions through the same
autograd Functions (``_Flash``, ``_FlashLse``) the card uses. float32
inputs agree within rtol 2e-5 / atol 2e-6 (the tolerance of the JAX
package's own kernel-vs-reference tests: only summation order differs),
outputs and gradients alike; bf16 inputs within 2e-2, compared in
float32 (p is rounded to bf16 at different points of the two
online/dense softmaxes). lse within 1e-5.

The CUDA kernels themselves are held against the plain versions in
``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch  # noqa: F401
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import registry as treg

F32 = dict(rtol=2e-5, atol=2e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _arrays(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _jax(x, dtype):
    return jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bf16"
                       else jnp.float32)


def _torch(x, dtype):
    t = torch.from_numpy(x.copy())
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# (id, BH, T, Tk, D, causal, window, dtype)
FLASH_CASES = [
    ("full", 2, 40, 40, 16, False, 0, "f32"),
    ("causal", 2, 40, 40, 16, True, 0, "f32"),
    ("ragged_causal", 3, 37, 37, 8, True, 0, "f32"),
    ("t_lt_tk_causal", 2, 24, 40, 16, True, 0, "f32"),
    ("t_gt_tk_causal", 2, 40, 24, 16, True, 0, "f32"),
    ("t_ne_tk_full", 2, 24, 41, 16, False, 0, "f32"),
    ("window", 2, 48, 48, 16, True, 8, "f32"),
    ("window_ragged", 1, 45, 45, 8, True, 13, "f32"),
    ("bf16_causal", 2, 40, 40, 16, True, 0, "bf16"),
    ("bf16_full_ragged", 2, 33, 47, 16, False, 0, "bf16"),
]


@pytest.mark.parametrize("BH,T,Tk,D,causal,window,dtype",
                         [c[1:] for c in FLASH_CASES],
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_3d_matches_jax(BH, T, Tk, D, causal, window,
                                        dtype):
    q, k, v = _arrays((BH, T, D), (BH, Tk, D), (BH, Tk, D))
    ref = jatt.flash_attention(_jax(q, dtype), _jax(k, dtype),
                               _jax(v, dtype), causal=causal, block_q=16,
                               block_k=16, window=window or None)
    out = tatt.flash_attention(_torch(q, dtype), _torch(k, dtype),
                               _torch(v, dtype), causal=causal,
                               block_q=16, block_k=16,
                               window=window or None)
    assert out.dtype == (torch.bfloat16 if dtype == "bf16"
                         else torch.float32)
    np.testing.assert_allclose(_np(out), _np(ref),
                               **(BF16 if dtype == "bf16" else F32))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_4d_matches_jax(causal):
    q, k, v = _arrays((2, 3, 20, 8), (2, 3, 28, 8), (2, 3, 28, 8), seed=1)
    ref = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=8,
                               block_k=8)
    out = tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    assert tuple(out.shape) == (2, 3, 20, 8)
    np.testing.assert_allclose(_np(out), _np(ref), **F32)


# (id, T, Tk, causal, window, band_offset, scale)
LSE_CASES = [
    ("full", 24, 32, False, 0, 0, None),
    ("causal", 32, 32, True, 0, 0, None),
    ("band_offset", 24, 40, True, 0, 16, None),
    ("window_band_offset", 32, 48, True, 12, 20, None),
    ("explicit_scale", 17, 29, True, 0, 3, 0.3),
]


@pytest.mark.parametrize("T,Tk,causal,window,band_offset,scale",
                         [c[1:] for c in LSE_CASES],
                         ids=[c[0] for c in LSE_CASES])
def test_flash_attention_with_lse_matches_jax(T, Tk, causal, window,
                                              band_offset, scale):
    q, k, v = _arrays((2, T, 16), (2, Tk, 16), (2, Tk, 16), seed=2)
    jo, jl = jatt.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        causal=causal, block_q=8, block_k=8, window=window,
        band_offset=band_offset)
    to, tl = tatt.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=scale, causal=causal, block_q=8, block_k=8, window=window,
        band_offset=band_offset)
    assert tuple(tl.shape) == (2, T) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **F32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("Hkv", [1, 2, 4])
def test_flash_op_gqa_matches_jax(Hkv):
    """_contrib_FlashAttention repeats k/v heads up to the q heads."""
    q, k, v = _arrays((2, 4, 24, 8), (2, Hkv, 24, 8), (2, Hkv, 24, 8),
                      seed=3)
    attrs = {"causal": True, "block_q": 8, "block_k": 8}
    jop = jreg.get_op("_contrib_FlashAttention")
    top = treg.get_op("_contrib_FlashAttention")
    ref = jop.fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 **jreg.canon_attrs(jop, attrs))
    out = top.fn(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), **treg.canon_attrs(top, attrs))
    np.testing.assert_allclose(_np(out), _np(ref), **F32)


def test_flash_op_rejects_bad_gqa_and_window_without_causal():
    q, k, v = _arrays((1, 4, 8, 8), (1, 3, 8, 8), (1, 3, 8, 8))
    top = treg.get_op("_contrib_FlashAttention")
    with pytest.raises(ValueError, match="multiple of kv heads"):
        top.fn(torch.from_numpy(q), torch.from_numpy(k),
               torch.from_numpy(v), causal=True)
    q, k, v = (torch.from_numpy(x) for x in _arrays(*[(2, 8, 8)] * 3))
    with pytest.raises(ValueError, match="requires causal"):
        tatt.flash_attention(q, k, v, causal=False, window=4)


# ---------------------------------------------------------------------------
# gradients: torch.autograd.grad through the port against jax.grad
# ---------------------------------------------------------------------------

def _grads_match(jfn, tfn, inputs, dtype, cot_shapes, seed=5):
    """Gradients of sum(out_i * cot_i) w.r.t. the inputs, the cotangents
    drawn from numpy: jax.grad of the JAX function against
    torch.autograd.grad of the port's."""
    rng = np.random.RandomState(seed)
    cots = [rng.randn(*sh).astype(np.float32) for sh in cot_shapes]

    def jloss(*xs):
        outs = jfn(*xs)
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(outs, cots))

    jg = jax.grad(jloss, argnums=tuple(range(len(inputs))))(
        *[_jax(x, dtype) for x in inputs])
    ts = [_torch(x, dtype).requires_grad_() for x in inputs]
    tl = sum(torch.sum(o.float() * torch.from_numpy(c))
             for o, c in zip(tfn(*ts), cots))
    tg = torch.autograd.grad(tl, ts)
    for name, a, b in zip("qkv", jg, tg):
        assert b.dtype == ts[0].dtype
        np.testing.assert_allclose(_np(b), _np(a), err_msg="d" + name,
                                   **(BF16 if dtype == "bf16" else F32))


@pytest.mark.parametrize("BH,T,Tk,D,causal,window,dtype",
                         [c[1:] for c in FLASH_CASES],
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_gradients_match_jax(BH, T, Tk, D, causal, window,
                                             dtype):
    q, k, v = _arrays((BH, T, D), (BH, Tk, D), (BH, Tk, D), seed=4)
    kw = dict(causal=causal, block_q=16, block_k=16, window=window or None)
    _grads_match(lambda *x: [jatt.flash_attention(*x, **kw)],
                 lambda *x: [tatt.flash_attention(*x, **kw)],
                 (q, k, v), dtype, [(BH, T, D)])


@pytest.mark.parametrize("T,Tk,causal,window,band_offset,scale",
                         [c[1:] for c in LSE_CASES],
                         ids=[c[0] for c in LSE_CASES])
def test_flash_attention_with_lse_gradients_match_jax(T, Tk, causal, window,
                                                      band_offset, scale):
    """Gradients through both outputs: a random cotangent on o and on
    the lse (which folds into delta as delta - dlse)."""
    q, k, v = _arrays((2, T, 16), (2, Tk, 16), (2, Tk, 16), seed=6)
    kw = dict(scale=scale, causal=causal, block_q=8, block_k=8,
              window=window, band_offset=band_offset)
    _grads_match(lambda *x: jatt.flash_attention_with_lse(*x, **kw),
                 lambda *x: tatt.flash_attention_with_lse(*x, **kw),
                 (q, k, v), "f32", [(2, T, 16), (2, T)])


def test_flash_attention_with_lse_bf16_gradients_match_jax():
    q, k, v = _arrays((2, 40, 16), (2, 40, 16), (2, 40, 16), seed=7)
    kw = dict(causal=True, block_q=16, block_k=16)
    _grads_match(lambda *x: jatt.flash_attention_with_lse(*x, **kw),
                 lambda *x: tatt.flash_attention_with_lse(*x, **kw),
                 (q, k, v), "bf16", [(2, 40, 16), (2, 40)])


@pytest.mark.parametrize("Hkv", [1, 2, 4])
def test_flash_op_gqa_gradients_match_jax(Hkv):
    """k/v repeated to the q heads before the kernel: the repeat's
    gradient sums the repeated heads, as jnp.repeat's VJP does."""
    q, k, v = _arrays((2, 4, 24, 8), (2, Hkv, 24, 8), (2, Hkv, 24, 8),
                      seed=8)
    attrs = {"causal": True, "block_q": 8, "block_k": 8}
    jop = jreg.get_op("_contrib_FlashAttention")
    top = treg.get_op("_contrib_FlashAttention")
    ja, ta = jreg.canon_attrs(jop, attrs), treg.canon_attrs(top, attrs)
    _grads_match(lambda *x: [jop.fn(*x, **ja)],
                 lambda *x: [top.fn(*x, **ta)],
                 (q, k, v), "f32", [(2, 4, 24, 8)])


# ---------------------------------------------------------------------------
# head dims that are not a multiple of 8: the card's padded route
# ---------------------------------------------------------------------------

@pytest.fixture
def padded_route(monkeypatch):
    """Route the port's flash entries as on the card, the plain versions
    standing in for the kernels: q, k, v (and do) zero-padded to a
    multiple of 8 by ``_on_padded_head_dim`` and the outputs cut back.
    Yields the padded widths the plain versions were given."""
    widths = []

    def fwd(q, k, v, scale, causal, window=0, band_offset=0,
            want_lse=False):
        def run(q, k, v):
            widths.append(q.shape[-1])
            return tatt._flash_fwd_reference(q, k, v, scale, causal,
                                             window, band_offset)
        o, lse = tatt._on_padded_head_dim(run, q, k, v)
        return o, (lse if want_lse else None)

    def bwd(q, k, v, do, lse, delta, scale, causal, window=0,
            band_offset=0):
        def run(q, k, v, do):
            widths.append(q.shape[-1])
            args = (q, k, v, do, lse, delta, scale, causal, window,
                    band_offset)
            return (tatt._flash_dq_reference(*args),
                    *tatt._flash_dkv_reference(*args))
        return tatt._on_padded_head_dim(run, q, k, v, do)

    monkeypatch.setattr(tatt, "flash_fwd", fwd)
    monkeypatch.setattr(tatt, "flash_bwd", bwd)
    return widths


# (id, D, T, Tk, causal, window, band_offset)
PADDED_CASES = [
    ("d4_band_offset", 4, 24, 40, True, 0, 16),
    ("d12_window", 12, 32, 48, True, 12, 20),
    ("d20_full", 20, 17, 29, False, 0, 0),
]


@pytest.mark.parametrize("D,T,Tk,causal,window,band_offset",
                         [c[1:] for c in PADDED_CASES],
                         ids=[c[0] for c in PADDED_CASES])
def test_padded_head_dim_matches_jax(padded_route, D, T, Tk, causal, window,
                                     band_offset):
    """flash_attention_with_lse through the padded route at D = 4, 12,
    20 (the kernels take multiples of 8): o and lse against the JAX
    package's Pallas kernel (interpret mode), then gradients through
    both outputs against jax.grad."""
    q, k, v = _arrays((2, T, D), (2, Tk, D), (2, Tk, D), seed=D)
    kw = dict(causal=causal, block_q=8, block_k=8, window=window,
              band_offset=band_offset)
    jo, jl = jatt.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    to, tl = tatt.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert padded_route == [-(-D // 8) * 8]
    assert tuple(to.shape) == (2, T, D)
    np.testing.assert_allclose(_np(to), _np(jo), **F32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    _grads_match(lambda *x: jatt.flash_attention_with_lse(*x, **kw),
                 lambda *x: tatt.flash_attention_with_lse(*x, **kw),
                 (q, k, v), "f32", [(2, T, D), (2, T)])
    assert padded_route[1:] == [-(-D // 8) * 8] * 2   # forward, backward


# __graft_entry__.py's GQA config: transformer.get_symbol(32, 16,
# num_layers=1, num_heads=4, dim=16, num_kv_heads=2), head dim 4
@pytest.mark.parametrize("route", ["plain", "padded"])
def test_flash_op_graft_gqa_config_matches_jax(request, route):
    """_contrib_FlashAttention at the GQA config's shape (4 heads, head
    dim 4, 2 kv heads, causal), on the plain route and on the card's
    padded route: output and gradients against the JAX op."""
    if route == "padded":
        request.getfixturevalue("padded_route")
    q, k, v = _arrays((2, 4, 16, 4), (2, 2, 16, 4), (2, 2, 16, 4),
                      seed=9)
    attrs = {"causal": True}
    jop = jreg.get_op("_contrib_FlashAttention")
    top = treg.get_op("_contrib_FlashAttention")
    ja, ta = jreg.canon_attrs(jop, attrs), treg.canon_attrs(top, attrs)
    ref = jop.fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **ja)
    out = top.fn(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), **ta)
    np.testing.assert_allclose(_np(out), _np(ref), **F32)
    _grads_match(lambda *x: [jop.fn(*x, **ja)],
                 lambda *x: [top.fn(*x, **ta)],
                 (q, k, v), "f32", [(2, 4, 16, 4)])


def test_forward_only_calls_skip_the_lse_and_the_graph(monkeypatch):
    """Without a gradient the forward asks the kernel for no lse (as
    the JAX package's forward-only calls do); with one it asks for the
    lse and records the autograd Function."""
    seen = []
    real = tatt.flash_fwd

    def spy(*args, **kwargs):
        seen.append(kwargs.get("want_lse", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(tatt, "flash_fwd", spy)
    q, k, v = (torch.from_numpy(x) for x in _arrays(*[(2, 16, 8)] * 3))
    out = tatt.flash_attention(q, k, v, causal=True)
    assert seen == [False] and out.grad_fn is None
    out = tatt.flash_attention(q.requires_grad_(), k, v, causal=True)
    assert seen == [False, True]
    assert type(out.grad_fn).__name__ == "_FlashBackward"
