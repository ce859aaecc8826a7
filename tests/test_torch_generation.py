"""The port's decode path against the JAX package's, on the CPU: the cache
ops (``_contrib_CachedAttention`` and its per-row, rolling and int8
forms), the weight-only int8 ops, ``get_decode_symbol`` and
``generation.Generator``.

The same numpy weights (a JAX ``get_symbol``'s arguments, scaled normal)
and prompts go through both packages in float32. Tolerances: cache-op
outputs within rtol 1e-5 / atol 1e-6 (torch's softmax and float32 sums
against XLA's), the int8 cache rows and their scales bit for bit,
``log_likelihood`` within 1e-5, exported rows within 1e-5 (the SSM
state, a sum over the prompt's tokens, within rtol 1e-4); tokens (greedy,
seeded sampling, beam, speculative, int8 weights and caches, rolling,
hybrid SSM) equal token for token. Inside the port, the ``_on_device``
loops (captured on the card, the same steps uncaptured here) equal the
host loops.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as jmx
from mxnet_tpu.generation import Generator as JGenerator
from mxnet_tpu.generation import replay_key as jreplay_key
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import contrib_ops as jcontrib

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import generation as tgen
from mxnet_tpu_torch.models import transformer as ttransformer
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import contrib_ops as tcontrib

V, L, H, DIM, ML, B, P, N = 31, 2, 4, 32, 24, 2, 5, 8
OPS = dict(rtol=1e-5, atol=1e-6)
SAMPLED = dict(temperature=0.8, top_k=10, top_p=0.9, seed=3)


def _f32(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the cache ops
# ---------------------------------------------------------------------------

def _cache_case(Hkv, C=10, Tn=4, seed=0):
    q = _f32(B, H, Tn, 8, seed=seed)
    k = _f32(B, Hkv, Tn, 8, seed=seed + 1)
    v = _f32(B, Hkv, Tn, 8, seed=seed + 2)
    kc = _f32(B, Hkv, C, 8, seed=seed + 3)
    vc = _f32(B, Hkv, C, 8, seed=seed + 4)
    return q, k, v, kc, vc


@pytest.mark.parametrize("Hkv,window,pos", [
    (4, 0, [3.0]), (2, 0, [3.0]), (4, 3, [5.0]), (2, 2, [1.0, 6.0])],
    ids=["shared", "gqa", "window", "per_row_gqa_window"])
def test_cached_attention_matches_jax(Hkv, window, pos):
    q, k, v, kc, vc = _cache_case(Hkv)
    pos = np.asarray(pos, np.float32)
    jo, jk, jv = jatt.cached_attention(*map(jnp.asarray, (q, k, v, kc, vc)),
                                       jnp.asarray(pos), window=window)
    tk, tv = torch.tensor(kc), torch.tensor(vc)
    to, tk2, tv2 = tatt._cached_attention_op(
        *map(torch.tensor, (q, k, v)), tk, tv, torch.tensor(pos),
        window=window)
    assert tk2 is tk and tv2 is tv            # written in place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **OPS)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
def test_overrun_clamps_as_jax_under_jit(per_row):
    """A device pos past the capacity: the write starts at Tmax - Tnew
    and the mask reads the unclamped pos, as ``dynamic_update_slice``
    does under jit; a host pos raises, as the JAX op does eagerly."""
    q, k, v, kc, vc = _cache_case(4, C=6, Tn=3, seed=5)
    pos = np.asarray([5.0, 1.0] if per_row else [5.0], np.float32)
    jo, jk, jv = jax.jit(jatt.cached_attention)(
        *map(jnp.asarray, (q, k, v, kc, vc)), jnp.asarray(pos))
    tk, tv = torch.tensor(kc), torch.tensor(vc)
    to, _, _ = tatt.cached_attention(*map(torch.tensor, (q, k, v)), tk, tv,
                                     torch.tensor(pos))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **OPS)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError, match="overrun"):
        jatt.cached_attention(*map(jnp.asarray, (q, k, v, kc, vc)),
                              jnp.asarray(pos))
    with pytest.raises(ValueError, match="overrun"):
        tatt.cached_attention(*map(torch.tensor, (q, k, v, kc, vc)), pos)


def test_rolling_cached_attention_matches_jax():
    """A circular cache of capacity 6, window 4: a 3-token prefill and 6
    one-token steps, the last ones wrapping around."""
    C, W, Hkv = 6, 4, 2
    jax_rolling = jax.jit(lambda *a: jatt._rolling_cached_attention_op(
        *a, window=W))
    jk = jnp.zeros((B, Hkv, C, 8))
    jv = jnp.zeros((B, Hkv, C, 8))
    tk, tv = torch.zeros((B, Hkv, C, 8)), torch.zeros((B, Hkv, C, 8))
    p = 0
    for step, tn in enumerate((3, 1, 1, 1, 1, 1, 1)):
        q, k, v, _, _ = _cache_case(Hkv, Tn=tn, seed=10 * step)
        pos = np.asarray([p], np.float32)
        jo, jk, jv = jax_rolling(*map(jnp.asarray, (q, k, v)), jk, jv,
                                 jnp.asarray(pos))
        to, _, _ = tatt._rolling_cached_attention_op(
            *map(torch.tensor, (q, k, v)), tk, tv, torch.tensor(pos),
            window=W)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **OPS)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        p += tn


@pytest.mark.parametrize("pos", [[2.0], [0.0, 5.0]],
                         ids=["shared", "per_row"])
def test_q8_cache_matches_jax(pos):
    """The int8 rows and their float32 scales bit for bit (one
    ``_q8_quantize`` rule), the output within the op tolerance; an
    all-zero row stores zeros."""
    q, k, v, _, _ = _cache_case(2, Tn=3, seed=7)
    k[0, 0, 1] = 0.0
    pos = np.asarray(pos, np.float32)
    C = 10
    caches = (np.zeros((B, 2, C, 8), np.int8), np.zeros((B, 2, C, 8),
                                                        np.int8),
              np.zeros((B, 2, C), np.float32), np.zeros((B, 2, C),
                                                        np.float32))
    jout = jatt.cached_attention_q8(*map(jnp.asarray, (q, k, v)),
                                    *map(jnp.asarray, caches),
                                    jnp.asarray(pos), window=2)
    tc = [torch.tensor(c) for c in caches]
    tout = tatt._cached_attention_q8_op(*map(torch.tensor, (q, k, v)), *tc,
                                        torch.tensor(pos), window=2)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), **OPS)
    for t, j, c in zip(tout[1:], jout[1:], tc):
        assert t is c
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_quantized_ops_match_jax():
    w8 = np.random.RandomState(1).randint(-127, 128, (5, 6)).astype(np.int8)
    scale = np.abs(_f32(5, seed=2)) / 100
    bias = _f32(5, seed=3)
    for x, flatten in ((_f32(3, 4, 6), False), (_f32(3, 2, 3), True)):
        j = jcontrib._quantized_fc(jnp.asarray(x), jnp.asarray(w8),
                                   jnp.asarray(scale), jnp.asarray(bias),
                                   num_hidden=5, flatten=flatten)
        t = tcontrib._quantized_fc(torch.tensor(x), torch.tensor(w8),
                                   torch.tensor(scale), torch.tensor(bias),
                                   num_hidden=5, flatten=flatten)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **OPS)
    ids = np.asarray([[0, 4, 2], [3, 3, 1]], np.float32)
    e8 = np.random.RandomState(4).randint(-127, 128, (5, 6)).astype(np.int8)
    for dt in ("float32", "bfloat16"):
        j = jcontrib._quantized_embedding(
            jnp.asarray(ids), jnp.asarray(e8), jnp.asarray(scale), dtype=dt)
        t = tcontrib._quantized_embedding(
            torch.tensor(ids), torch.tensor(e8), torch.tensor(scale),
            dtype=dt)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# get_decode_symbol
# ---------------------------------------------------------------------------

KNOBS = {
    "plain": {}, "gqa": dict(num_kv_heads=2),
    "window": dict(attention_window=4),
    "rolling_rope": dict(attention_window=4, rolling_cache=True,
                         pos_encoding="rope"),
    "kv8": dict(kv_quantize=True), "per_row": dict(per_row_pos=True),
    "per_row_kv8": dict(per_row_pos=True, kv_quantize=True),
    "ssm": dict(block_type="ssm"),
    "hybrid_window": dict(block_type=("attention", "ssm"),
                          attention_window=4),
    "int8": dict(quantized=True, compute_dtype="bfloat16"),
}


def _decode_symbols(**kw):
    kw = dict(dict(num_layers=L, num_heads=H, dim=DIM), **kw)
    with jmx.name.NameManager():
        jsym = jtransformer.get_decode_symbol(V, ML, **kw)
    with tmx.name.NameManager():
        tsym = ttransformer.get_decode_symbol(V, ML, **kw)
    return jsym, tsym


@pytest.mark.parametrize("name", list(KNOBS))
def test_decode_symbol_equals_jax(name):
    jsym, tsym = _decode_symbols(**KNOBS[name])
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    per_row = KNOBS[name].get("per_row_pos")
    shapes = dict(data=(B, 3), positions=(B, 3) if per_row else (3,),
                  cache_pos=(B,) if per_row else (1,))
    if "kv_quantize" not in KNOBS[name]:
        # (the JAX package's infer_shape cannot type the int8 caches)
        assert tsym.infer_shape(**shapes) == jsym.infer_shape(**shapes)


@pytest.mark.parametrize("kw,match", [
    (dict(rolling_cache=True), "needs attention_window"),
    (dict(rolling_cache=True, attention_window=4, kv_quantize=True),
     "kv_quantize is not supported"),
    (dict(rolling_cache=True, attention_window=4, per_row_pos=True),
     "per_row_pos is not supported"),
    (dict(rolling_cache=True, attention_window=4,
          block_type=("attention", "ssm")), "no KV window to roll"),
    (dict(kv_quantize=True, block_type="ssm"), "at least one attention"),
    (dict(attention_window=4, block_type="ssm"), "at least one attention"),
    (dict(num_kv_heads=3), "multiple of num_kv_heads"),
    (dict(dim=30), "divisible"),
    (dict(pos_encoding="alibi"), "'learned' or 'rope'"),
    (dict(block_type=("ssm",)), "names each layer"),
], ids=["rolling_no_window", "rolling_kv8", "rolling_per_row", "rolling_ssm",
        "kv8_ssm", "window_ssm", "kv_heads", "dim", "pos", "block_count"])
def test_decode_symbol_refusals_match_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        _decode_symbols(**kw)
    with pytest.raises(ValueError, match=match):
        ttransformer.get_decode_symbol(
            V, ML, **dict(dict(num_layers=L, num_heads=H, dim=DIM), **kw))


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

_PARAMS = {}


def _params(**kw):
    """Scaled-normal weights of get_symbol's arguments (LayerNorm gamma
    1, beta 0), one set per architecture."""
    key = json.dumps(kw, sort_keys=True)
    if key not in _PARAMS:
        sym = jtransformer.get_symbol(V, 16, num_layers=L, num_heads=H,
                                      dim=DIM, max_len=ML, **kw)
        shapes, _, _ = sym.infer_shape(data=(B, 16), softmax_label=(B, 16))
        rng = np.random.RandomState(0)
        out = {}
        for n, s in zip(sym.list_arguments(), shapes):
            if n in ("data", "softmax_label"):
                continue
            out[n] = np.ones(s, np.float32) if n.endswith("_gamma") else \
                (rng.randn(*s) * 0.5).astype(np.float32)
        _PARAMS[key] = out
    return _PARAMS[key]


_PAIRS = {}


def _pair(train_kw=None, **kw):
    """(JAX Generator, port Generator on the CPU) over the same weights,
    one pair per configuration (the JAX one keeps its compiled steps)."""
    key = json.dumps([train_kw, kw], sort_keys=True)
    if key not in _PAIRS:
        p = _params(**(train_kw or {}))
        kw = dict(dict(num_layers=L, num_heads=H, dim=DIM, batch_size=B),
                  **kw)
        _PAIRS[key] = (JGenerator(p, V, ML, **kw),
                       tgen.Generator(p, V, ML, ctx=tmx.cpu(), **kw))
    return _PAIRS[key]


PROMPT = np.random.RandomState(1).randint(0, V, (B, P))

ARCHS = {
    "learned": ({}, {}),
    "hybrid_rope": (dict(block_type=("attention", "ssm"),
                         pos_encoding="rope"),
                    dict(block_type=("attention", "ssm"),
                         pos_encoding="rope")),
}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_generate_matches_jax(arch):
    """Greedy and seeded sampling, token for token; generate_on_device
    equals generate; log_likelihood within 1e-5; the decode-state sizes
    equal."""
    train_kw, kw = ARCHS[arch]
    j, t = _pair(train_kw, **kw)
    for skw in ({}, SAMPLED):
        want = j.generate(PROMPT, N, **skw)
        got = t.generate(PROMPT, N, **skw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t.generate_on_device(PROMPT, N, **skw),
                                      got)
    np.testing.assert_allclose(t.log_likelihood(PROMPT),
                               j.log_likelihood(PROMPT), rtol=0, atol=1e-5)
    assert t.kv_cache_bytes() == j.kv_cache_bytes()
    assert t.state_bytes_per_slot() == j.state_bytes_per_slot()


def test_top_p_at_the_jax_tests_settings():
    """tests/test_generation.py's nucleus settings: temperature 1, top_p
    0.9, seed 3, token for token against the JAX package; top_p 1e-9
    (only the argmax survives) is greedy on both loops."""
    j, t = _pair()
    kw = dict(temperature=1.0, top_p=0.9, seed=3)
    np.testing.assert_array_equal(t.generate(PROMPT, 5, **kw),
                                  j.generate(PROMPT, 5, **kw))
    tiny = dict(temperature=1.0, top_p=1e-9, seed=11)
    greedy = t.generate(PROMPT, 5)
    np.testing.assert_array_equal(t.generate(PROMPT, 5, **tiny), greedy)
    np.testing.assert_array_equal(t.generate_on_device(PROMPT, 5, **tiny),
                                  greedy)


@pytest.mark.parametrize("top_p", [0.9, 0.99])
def test_top_p_keep_set_differs_from_jax_only_at_the_boundary(top_p):
    """The nucleus is cut where the sorted probabilities' cumsum reaches
    top_p; torch's float32 cumsum and XLA's differ by up to ~1e-6, so a
    token whose cumulative mass sits that close to top_p can be kept by
    one package and cut by the other (ROADMAP Queue C). Over 4000 rows of
    1000 logits: no row differs by more than that one boundary token,
    and at most 0.5% of rows differ at all."""
    x = _f32(4000, 1000, seed=21, scale=2.0)
    srt = jnp.sort(jnp.asarray(x), axis=-1)[:, ::-1]
    probs = jax.nn.softmax(srt, axis=-1)
    jkeep = np.asarray(jnp.cumsum(probs, axis=-1) - probs < top_p)
    tsrt = torch.sort(torch.tensor(x), dim=-1, descending=True).values
    tprobs = torch.softmax(tsrt, dim=-1)
    tkeep = (torch.cumsum(tprobs, dim=-1) - tprobs < top_p).numpy()
    diff = (jkeep != tkeep).sum(axis=1)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.005


def test_on_device_eos_matches_jax():
    """With eos_id the device loop stops once every row is done and pads
    with eos, as the JAX package's while_loop does."""
    j, t = _pair()
    skw = dict(temperature=1.0, seed=2)
    want = j.generate_on_device(PROMPT, N, eos_id=3, **skw)
    got = t.generate_on_device(PROMPT, N, eos_id=3, **skw)
    np.testing.assert_array_equal(got, want)
    host = t.generate(PROMPT, N, eos_id=3, **skw)
    np.testing.assert_array_equal(got[:, :host.shape[1]], host)
    assert (got[:, host.shape[1]:] == 3).all()


def test_beam_search_matches_jax():
    """beam_search token for token against the JAX host loop (W 1 is
    greedy); beam_search_on_device equals the host loop, and with eos it
    pads the host loop's early stop with eos."""
    j, t = _pair()
    host = t.beam_search(PROMPT, 6, beam_size=3)
    np.testing.assert_array_equal(host,
                                  j.beam_search(PROMPT, 6, beam_size=3))
    np.testing.assert_array_equal(t.beam_search(PROMPT, 4, beam_size=1),
                                  t.generate(PROMPT, 4))
    np.testing.assert_array_equal(
        t.beam_search_on_device(PROMPT, 6, beam_size=3), host)
    kw = dict(beam_size=2, eos_id=int(host[0, P]), length_penalty=0.7)
    host = t.beam_search(PROMPT, 6, **kw)
    dev = t.beam_search_on_device(PROMPT, 6, **kw)
    np.testing.assert_array_equal(dev[:, :host.shape[1]], host)
    assert (dev[:, host.shape[1]:] == kw["eos_id"]).all()


def test_speculative_matches_jax():
    """A truncated draft sharing the target's weights: the host loop and
    the on-device loop both give the JAX package's generate tokens,
    greedy and seeded."""
    j, t = _pair()
    td = t.truncated_draft(1)
    assert td._params["lm_head_weight"].data_ptr() == \
        t._params["lm_head_weight"].data_ptr()
    for skw in ({}, dict(temperature=0.9, seed=1)):
        want = j.generate(PROMPT, N, **skw)
        np.testing.assert_array_equal(
            t.generate_speculative(td, PROMPT, N, lookahead=3, **skw), want)
        dev, rounds = t.generate_speculative_on_device(
            td, PROMPT, N, lookahead=3, return_rounds=True, **skw)
        np.testing.assert_array_equal(dev, want)
        assert 1 <= rounds <= N


def test_speculative_refusals_match_jax():
    _, t = _pair()
    _, hyb = _pair(ARCHS["hybrid_rope"][0], **ARCHS["hybrid_rope"][1])
    _, rolling = _pair(dict(pos_encoding="rope"), attention_window=4,
                       rolling_cache=True, pos_encoding="rope")
    for target in (hyb, rolling):
        with pytest.raises(ValueError, match="not supported"):
            target.generate_speculative(target, PROMPT, 4)
        with pytest.raises(ValueError, match="not supported"):
            target.truncated_draft(1)
    with pytest.raises(ValueError, match="max_len"):
        t.generate_speculative_on_device(t.truncated_draft(1), PROMPT,
                                         ML - P, lookahead=4)
    _, q8 = _pair(quantize="int8")
    with pytest.raises(ValueError, match="int8"):
        q8.truncated_draft(1)


@pytest.mark.parametrize("kw", [dict(quantize="int8"),
                                dict(quantize_kv=True, num_kv_heads=2)],
                         ids=["int8", "kv8_gqa"])
def test_quantized_generate_matches_jax(kw):
    train_kw = {"num_kv_heads": 2} if "num_kv_heads" in kw else {}
    j, t = _pair(train_kw, **kw)
    got = t.generate(PROMPT, N)
    np.testing.assert_array_equal(got, j.generate(PROMPT, N))
    np.testing.assert_array_equal(t.generate_on_device(PROMPT, N), got)
    assert t.kv_cache_bytes() == j.kv_cache_bytes()


def test_rolling_rope_generates_past_capacity_as_jax():
    """A rolling cache of capacity 8 with window 4 and RoPE: 14 tokens
    past a 5-token prompt wrap the cache twice."""
    j = JGenerator(_params(pos_encoding="rope"), V, 8, num_layers=L,
                   num_heads=H, dim=DIM, batch_size=B, attention_window=4,
                   rolling_cache=True, pos_encoding="rope")
    t = tgen.Generator(_params(pos_encoding="rope"), V, 8, num_layers=L,
                       num_heads=H, dim=DIM, batch_size=B, ctx=tmx.cpu(),
                       attention_window=4, rolling_cache=True,
                       pos_encoding="rope")
    got = t.generate(PROMPT, 14)
    np.testing.assert_array_equal(got, j.generate(PROMPT, 14))
    np.testing.assert_array_equal(t.generate_on_device(PROMPT, 14), got)


def test_export_kv_rows_matches_jax_and_is_a_copy():
    """The blob's rows equal the JAX package's, and they are copies: a
    later decode step writing the caches in place leaves them as they
    were."""
    j, t = _pair(ARCHS["hybrid_rope"][0], **ARCHS["hybrid_rope"][1])
    _, jaux = j._forward(j._fresh_aux(), PROMPT, 0)
    _, taux = t._forward(t._fresh_aux(), PROMPT, 0)
    jb, tb = j.export_kv_rows(jaux, 1, P), t.export_kv_rows(taux, 1, P)
    assert sorted(tb["rows"]) == sorted(jb["rows"]) and tb["pos"] == P
    assert tgen.kv_blob_nbytes(tb) == sum(
        int(a.nbytes) for a in jb["rows"].values())
    for name, arr in jb["rows"].items():
        # the SSM state sums P tokens' updates: rtol 1e-4 there
        np.testing.assert_allclose(tb["rows"][name], np.asarray(arr),
                                   rtol=1e-4 if "state" in name else 1e-5,
                                   atol=1e-5, err_msg=name)
    before = {n: a.copy() for n, a in tb["rows"].items()}
    _, taux2 = t._forward(taux, PROMPT[:, :1], P)
    assert all(taux2[n] is taux[n] for n in taux)     # in place
    for name, arr in before.items():
        np.testing.assert_array_equal(tb["rows"][name], arr)
    with pytest.raises(ValueError, match="do not match"):
        t.export_kv_rows({}, 0, P)


def test_replay_key_and_sampling_keys_match_jax():
    """replay_key equals the JAX package's; a device key's split (the
    captured loop's) equals the host split bit for bit."""
    for seed, picks in ((0, 0), (3, 5), (2 ** 31 + 7, 9)):
        key = tgen.replay_key(seed, picks)
        np.testing.assert_array_equal(key, np.asarray(jreplay_key(seed,
                                                                  picks)))
        dev = tgen._threefry.split(torch.from_numpy(key.astype(np.int64)))
        assert dev.dtype == torch.int64
        np.testing.assert_array_equal(dev.numpy(),
                                      tgen._threefry.split(key))


def test_generator_validation_matches_jax():
    p = _params()
    kw = dict(num_layers=L, num_heads=H, dim=DIM, batch_size=B)
    for bad, match in ((dict(quantize="int4"), "quantize must be"),
                       (dict(quantize_kv=True, rolling_cache=True,
                             attention_window=4), "quantize_kv"),):
        with pytest.raises(ValueError, match=match):
            JGenerator(p, V, ML, **kw, **bad)
        with pytest.raises(ValueError, match=match):
            tgen.Generator(p, V, ML, ctx=tmx.cpu(), **kw, **bad)
    with pytest.raises(ValueError, match="position table"):
        tgen.Generator(p, V, ML + 1, ctx=tmx.cpu(), **kw)
    _, t = _pair()
    with pytest.raises(ValueError, match="exceeds the cache"):
        t.generate(PROMPT, ML)
    with pytest.raises(ValueError, match="top_k/top_p"):
        t.generate(PROMPT, 2, top_k=3)
    with pytest.raises(ValueError, match="missing parameters"):
        tgen.Generator({}, V, ML, ctx=tmx.cpu(), **kw)


def test_defaults_and_routing():
    """ctx=cpu() runs on the CPU; the default context is the card (here,
    without CUDA, it raises rather than fall back); mesh= takes a
    make_mesh mesh (another object raises TypeError) and a one-rank
    data x model mesh decodes the tokens of no mesh; serving_decoder
    returns the continuous-batching decoder over this Generator (ported
    with item 8)."""
    p = _params()
    kw = dict(num_layers=L, num_heads=H, dim=DIM, batch_size=B)
    t = tgen.Generator(p, V, ML, ctx=tmx.cpu(), **kw)
    assert t.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in t._params.values())
    assert tmx.current_context() == tmx.gpu(0)
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="ctx=mx.cpu"):
            tgen.Generator(p, V, ML, **kw)
    with tmx.cpu():
        assert tgen.Generator(p, V, ML, **kw).device.type == "cpu"
    with pytest.raises(TypeError, match="make_mesh"):
        tgen.Generator(p, V, ML, ctx=tmx.cpu(), mesh=object(), **kw)
    from mxnet_tpu_torch.parallel import make_mesh
    one = tgen.Generator(p, V, ML, ctx=tmx.cpu(),
                         mesh=make_mesh({"data": 1, "model": 1}), **kw)
    prompt = np.arange(B * 3).reshape(B, 3) % V
    np.testing.assert_array_equal(one.generate(prompt, 4),
                                  t.generate(prompt, 4))
    from mxnet_tpu_torch.serve import ContinuousDecoder
    with t.serving_decoder(queue_cap=3) as dec:
        assert isinstance(dec, ContinuousDecoder) and dec._gen is t
        assert dec._cap == 3
    assert tmx.generation is tgen


def test_captures_run_with_the_cyclic_collector_paused():
    """Every CUDA-graph capture (the decode loops, CompiledPredictor,
    CompiledTrainStep) runs under ``base.gc_paused``: a collection inside
    a capture that frees an earlier graph invalidates the capture. The
    guard turns the collector off for its block and restores the state
    it found."""
    import gc
    import inspect
    from mxnet_tpu_torch import predictor
    from mxnet_tpu_torch.base import gc_paused
    from mxnet_tpu_torch.parallel import trainer
    for mod in (tgen, predictor, trainer):
        src = inspect.getsource(mod)
        assert src.count("torch.cuda.graph(") == src.count(
            "gc_paused(), torch.cuda.graph(") == 1, mod.__name__
    assert gc.isenabled()
    with gc_paused():
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with gc_paused():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
