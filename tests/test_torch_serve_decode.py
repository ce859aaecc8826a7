"""The port's continuous-batching decoder (``mxnet_tpu_torch/serve/
decode.py``) against the JAX package's, on the CPU.

The same numpy weights (a JAX ``get_symbol``'s arguments, scaled normal,
carried across with ``convert.params_from_jax``) and the same requests
go through both packages' ``ContinuousDecoder`` at the JAX serve tests'
width (vocab 50, 2 layers, 2 heads, dim 32, max_len 24, 3 slots), and
through the port's batch-1 ``Generator.generate`` (the JAX tests'
oracle). Tokens are compared exactly: greedy and seeded sampling,
learned positions and RoPE, GQA, int8 caches, SSM and hybrid slots,
speculative rounds over a truncated draft, chunked prefill, and sessions
migrated by ``evacuate`` -> ``submit(resume=)`` within the port and from
the JAX package's float32 export into the port. Exported cache rows are
compared within the float32 tolerance of the earlier port tests (rtol
1e-5, atol 1e-6 times the largest magnitude: three decode steps deep,
torch's float32 sums and XLA's part by a few ulps). Mid-decode
evacuations wait on the decoder's own condition variable, never on the
clock.
"""
import json
import threading

import numpy as np
import pytest

from mxnet_tpu.generation import Generator as JGenerator
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.serve import SessionEvacuated as JSessionEvacuated

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import telemetry as ttelemetry
from mxnet_tpu_torch.convert import params_from_jax
from mxnet_tpu_torch.generation import Generator as TGenerator
from mxnet_tpu_torch.serve import (ContinuousDecoder, EngineClosed,
                                   Overloaded, SessionEvacuated)
from mxnet_tpu_torch.serve.decode import prefill_chunk, spec_draft

V, L, H, DIM, T, B = 50, 2, 2, 32, 24, 3
ROWS = dict(rtol=1e-5, atol=1e-6)
SEEDED = dict(temperature=0.8, top_k=10, seed=3)
NUCLEUS = dict(temperature=1.0, top_p=0.9, seed=3)   # the JAX tests' own

_PARAMS = {}


def _params(**kw):
    """Scaled-normal weights of get_symbol's arguments (LayerNorm gamma
    1), one numpy set per architecture."""
    key = json.dumps(kw, sort_keys=True)
    if key not in _PARAMS:
        sym = jtransformer.get_symbol(V, 12, num_layers=L, num_heads=H,
                                      dim=DIM, max_len=T, **kw)
        shapes, _, _ = sym.infer_shape(data=(2, 12), softmax_label=(2, 12))
        rng = np.random.RandomState(0)
        out = {}
        for n, s in zip(sym.list_arguments(), shapes):
            if n in ("data", "softmax_label"):
                continue
            out[n] = np.ones(s, np.float32) if n.endswith("_gamma") else \
                (rng.randn(*s) * 0.5).astype(np.float32)
        _PARAMS[key] = out
    return _PARAMS[key]


def _pair(batch_size=B, train_kw=None, **kw):
    """(JAX Generator, port Generator on the CPU) over the same weights."""
    p = _params(**(train_kw or {}))
    kw = dict(dict(num_layers=L, num_heads=H, dim=DIM,
                   batch_size=batch_size), **kw)
    return (JGenerator(p, V, T, **kw),
            TGenerator(params_from_jax(p, "cpu"), V, T, ctx=tmx.cpu(),
                       **kw))


# ragged prompts, budgets and sampling: more requests than slots, eos and
# budget endings both exercised
REQS = [(4, 8, {}), (6, 3, SEEDED), (4, 12, {}), (5, 5, dict(SEEDED,
                                                            seed=9)),
        (4, 2, {}), (6, 9, NUCLEUS), (7, 4, {})]


def _requests(seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, V, (p,)), n, kw) for p, n, kw in REQS]


def _serve(gen, reqs, **dec_kw):
    """Every request through one decoder of ``gen``; (rows, stats)."""
    with gen.serving_decoder(**dec_kw) as dec:
        futs = [dec.submit(p, n, eos_id=0, **kw) for p, n, kw in reqs]
        rows = [f.result(120.0) for f in futs]
        return rows, dec.stats()


def _oracle(tgen1, reqs):
    return [tgen1.generate(p[None], n, eos_id=0, **kw)[0]
            for p, n, kw in reqs]


ARCHS = {
    "learned": ({}, {}),
    "rope_gqa": (dict(pos_encoding="rope", num_kv_heads=1),
                 dict(pos_encoding="rope", num_kv_heads=1)),
    "int8_kv": ({}, dict(quantize_kv=True)),
    "ssm": (dict(block_type="ssm"), dict(block_type="ssm")),
    "hybrid": (dict(block_type=("attention", "ssm")),
               dict(block_type=("attention", "ssm"))),
}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decoder_matches_jax_and_generate(arch):
    """Greedy and seeded requests, ragged through a 3-slot pool: the
    port's rows equal the JAX decoder's and the port's batch-1 generate
    token for token; slots turned over (more requests than slots) and
    the step graph count stayed 1."""
    train_kw, kw = ARCHS[arch]
    jg, tg = _pair(B, train_kw, **kw)
    _, t1 = _pair(1, train_kw, **kw)
    reqs = _requests()
    want, _ = _serve(jg, reqs)
    got, st = _serve(tg, reqs)
    for i, (w, g, o) in enumerate(zip(want, got, _oracle(t1, reqs))):
        np.testing.assert_array_equal(g, w, err_msg="request %d" % i)
        np.testing.assert_array_equal(g, o, err_msg="request %d" % i)
    assert st["finished"] == len(reqs) > B
    assert ttelemetry.gauge("serve.decode.jit_cache_size").value == 1


def test_step_graph_count_is_one_across_turnover():
    """Three waves of admissions through one pool: one step program
    (the captured graph on the card), the pool's cache tensors never
    replaced, and the kv_bytes_per_slot gauge equal to the JAX pool's."""
    jg, tg = _pair()
    rng = np.random.RandomState(5)
    with tg.serving_decoder() as dec:
        ptrs = {n: t.data_ptr() for n, t in dec._aux.items()}
        for wave in range(3):
            futs = [dec.submit(rng.randint(0, V, (3 + wave,)), 4 + i)
                    for i in range(4)]
            for f in futs:
                f.result(120.0)
            assert dec._row.programs == 1
        assert {n: t.data_ptr() for n, t in dec._aux.items()} == ptrs
        assert dec.stats()["finished"] == 12
        bytes_t = dec._kv_bytes_per_slot
        report = dec.describe(hbm_budget=1e6)
    with jg.serving_decoder() as jdec:
        assert jdec._kv_bytes_per_slot == bytes_t
    assert "kv_bytes_per_slot: %d" % bytes_t in report
    assert "%d slot(s) fit" % (10 ** 6 // bytes_t) in report


def test_speculative_equals_plain_and_jax():
    """A pool with a truncated draft (lookahead 2): speculative and plain
    requests share rounds; every row equals the JAX speculative pool's
    and the batch-1 generate; the draft's step is one program too."""
    jg, tg = _pair()
    _, t1 = _pair(1)
    rng = np.random.RandomState(7)
    reqs = [(rng.randint(0, V, (p,)), n, kw) for p, n, kw in
            [(4, 8, {}), (5, 6, SEEDED), (4, 10, {}), (6, 5, {})]]

    def run(gen):
        with gen.serving_decoder(draft=gen.truncated_draft(num_layers=1),
                                 lookahead=2) as dec:
            futs = [dec.submit(p, n, eos_id=0, speculative=(i % 2 == 0),
                               **kw) for i, (p, n, kw) in enumerate(reqs)]
            return [f.result(120.0) for f in futs], dec

    want, _ = run(jg)
    got, dec = run(tg)
    for w, g, o in zip(want, got, _oracle(t1, reqs)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)
    st = dec.stats()
    assert st["spec_rounds"] > 0 and st["spec_accepted"] > 0
    assert dec._row.programs == 1 and dec._drow.programs == 1
    assert ttelemetry.gauge(
        "serve.spec.draft_jit_cache_size").value == 1


def test_chunked_prefill_matches_monolithic(monkeypatch):
    """MXNET_PREFILL_CHUNK=4: a 10-token prompt prefills in 3 chunks
    while a short one decodes; both equal the JAX chunked pool's rows
    and generate's."""
    monkeypatch.setenv("MXNET_PREFILL_CHUNK", "4")
    assert prefill_chunk() == 4
    jg, tg = _pair()
    _, t1 = _pair(1)
    reqs = [(np.arange(1, 11), 6, {}), (np.arange(1, 4), 5, {}),
            (np.arange(2, 12), 5, SEEDED)]
    chunks = ttelemetry.counter("serve.decode.prefill_chunks")
    c0 = chunks.value
    want, _ = _serve(jg, reqs)
    got, _ = _serve(tg, reqs)
    for w, g, o in zip(want, got, _oracle(t1, reqs)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)
    assert chunks.value == c0 + 6
    monkeypatch.setenv("MXNET_PREFILL_CHUNK", "-1")
    with pytest.raises(ValueError, match="MXNET_PREFILL_CHUNK"):
        prefill_chunk()


def _evacuate_after(dec, fut, k):
    """Evacuate ``dec`` once ``fut`` has emitted ``k`` tokens: the k-th
    emission's sink holds the decode thread on the decoder's condition
    until the evacuation is registered, so the session is mid-decode
    whatever the host's load. Returns (sessions exported, state)."""
    reached = threading.Event()

    def sink(tok):
        if tok is not None and len(fut.emitted) == k:
            reached.set()
            with dec._cond:
                dec._cond.wait_for(lambda: dec._evac_waiters, 60.0)

    fut.subscribe(sink)
    assert reached.wait(60.0)
    n = dec.evacuate(60.0)
    with pytest.raises((SessionEvacuated, JSessionEvacuated)) as ei:
        fut.result(60.0)
    return n, ei.value.state


@pytest.mark.parametrize("arch", ["learned", "ssm"])
def test_evacuate_and_resume_within_the_port(arch):
    """A seeded session exported mid-decode (``evacuate``) resumes on a
    second pool at its own depth with no prefill: the remaining tokens
    equal an unmigrated generate; the exported rows are the pool's."""
    train_kw, kw = ARCHS[arch]
    _, tg = _pair(2, train_kw, **kw)
    _, tg2 = _pair(2, train_kw, **kw)
    _, t1 = _pair(1, train_kw, **kw)
    p = np.arange(1, 6)
    want = t1.generate(p[None], 9, **SEEDED)[0]
    d1, d2 = tg.serving_decoder(), tg2.serving_decoder()
    try:
        fut = d1.submit(p, 9, **SEEDED)
        n, state = _evacuate_after(d1, fut, 3)
        assert n == 1 and len(state["emitted"]) == 3
        assert state["kv_blob"]["pos"] == 5 + 2
        got = d2.submit(p, 9, resume=state, **SEEDED).result(120.0)
        np.testing.assert_array_equal(got, want)
        assert d2.stats()["resumed"] == 1 and d2.stats()["prefills"] == 0
        assert d1.stats()["evacuated"] == 1
    finally:
        d1.close()
        d2.close()


def test_resume_a_jax_session_in_the_port():
    """The JAX decoder's float32 session, exported mid-decode, resumes
    in the port's pool: the blob's rows pass the port's checks and the
    remaining tokens equal generate's."""
    jg, _ = _pair(2)
    _, tg = _pair(2)
    _, t1 = _pair(1)
    p = np.arange(3, 9)
    want = t1.generate(p[None], 8, **SEEDED)[0]
    jd, td = jg.serving_decoder(), tg.serving_decoder()
    try:
        fut = jd.submit(p, 8, **SEEDED)
        n, state = _evacuate_after(jd, fut, 2)
        assert n == 1
        got = td.submit(p, 8, resume=state, **SEEDED).result(120.0)
        np.testing.assert_array_equal(got, want)
        assert td.stats()["prefills"] == 0
    finally:
        jd.close()
        td.close()


def test_exported_rows_match_jax():
    """``export_session`` on a quiescent pool: the port's cache rows
    equal the JAX pool's within the float32 tolerance, the request
    contract equal."""
    jg, tg = _pair(2)
    p = np.arange(2, 8)
    states = []
    for gen in (jg, tg):
        dec = gen.serving_decoder()
        try:
            fut = dec.submit(p, 8, **SEEDED)
            states.append(_evacuate_after(dec, fut, 3)[1])
        finally:
            dec.close()
    js, ts = states
    assert ts["emitted"] == js["emitted"] and ts["pending"] == js["pending"]
    assert ts["kv_blob"]["pos"] == js["kv_blob"]["pos"]
    for name, arr in js["kv_blob"]["rows"].items():
        np.testing.assert_allclose(
            ts["kv_blob"]["rows"][name], arr, rtol=ROWS["rtol"],
            atol=ROWS["atol"] * float(np.abs(arr).max()))


def test_streamed_frames_equal_the_one_shot_row():
    """``handle_generate_stream``: the frames, concatenated, are the
    emitted tokens and the terminal value is the one-shot row."""
    _, tg = _pair()
    p = np.arange(1, 7)
    frames = []
    with tg.serving_decoder() as dec:
        one = dec.handle_generate({"prompt": p, "max_new_tokens": 7,
                                   **SEEDED})
        final = dec.handle_generate_stream(
            {"prompt": p, "max_new_tokens": 7, **SEEDED},
            lambda toks, off: frames.append((off, list(toks))))
    toks = [t for _, chunk in frames for t in chunk]
    assert [o for o, _ in frames] == list(
        np.cumsum([0] + [len(c) for _, c in frames])[:-1])
    np.testing.assert_array_equal(final, one)
    np.testing.assert_array_equal(toks, one[len(p):])


def test_refusals_match_jax():
    """Rolling caches, bad blobs, over-capacity requests, a full queue
    and a draining pool raise the JAX decoder's error types."""
    rp = _params(pos_encoding="rope")
    for G in (JGenerator, TGenerator):
        kw = dict(ctx=tmx.cpu()) if G is TGenerator else {}
        roll = G(rp, V, T, num_layers=L, num_heads=H, dim=DIM, batch_size=2,
                 pos_encoding="rope", attention_window=4,
                 rolling_cache=True, **kw)
        with pytest.raises(ValueError, match="rolling caches"):
            roll.serving_decoder()
    jg, tg = _pair(2)
    for gen in (jg, tg):
        with gen.serving_decoder(queue_cap=1) as dec:
            with pytest.raises(ValueError, match="exceeds the cache"):
                dec.submit(np.arange(1, 20), 10)
            with pytest.raises(ValueError, match="top_k/top_p"):
                dec.submit(np.arange(1, 4), 3, top_k=3)
            with pytest.raises(ValueError, match="export_kv_rows v1"):
                dec.submit(np.arange(1, 4), 3,
                           handoff={"first_token": 1, "kv_blob": 1})
            blob = {"v": 1, "pos": 3, "rows": {"bogus": np.zeros(3)}}
            with pytest.raises(ValueError, match="do not match this pool"):
                dec.submit(np.arange(1, 4), 3,
                           handoff={"first_token": 1, "kv_blob": blob})
            with pytest.raises(ValueError, match="resume wants"):
                dec.submit(np.arange(1, 4), 3, resume={"v": 2})
            assert dec.submit(np.arange(1, 4), 0).result(1.0).tolist() \
                == [1, 2, 3]
    # a float32 blob whose dtype or shape disagrees with the pool
    with tg.serving_decoder() as dec:
        good = tg.export_kv_rows(tg._fresh_aux(), 0, 3)
        bad = {"v": 1, "pos": 3, "rows": {
            n: a.astype(np.float64) for n, a in good["rows"].items()}}
        with pytest.raises(ValueError, match="disagree"):
            dec.submit(np.arange(1, 4), 3,
                       handoff={"first_token": 1, "kv_blob": bad})
    dec = tg.serving_decoder(queue_cap=0)
    with pytest.raises(Overloaded):
        dec.submit(np.arange(1, 4), 3)
    dec.close()
    with pytest.raises(EngineClosed):
        dec.submit(np.arange(1, 4), 3)


def test_spec_draft_knob_and_ssm_refusal(monkeypatch):
    """MXNET_SPEC_DRAFT attaches a truncated draft; an SSM pool refuses a
    draft with the JAX package's message."""
    monkeypatch.setenv("MXNET_SPEC_DRAFT", "layers=1,gamma=2")
    assert spec_draft() == (1, 2)
    _, tg = _pair()
    with tg.serving_decoder() as dec:
        assert dec._draft is not None and dec._gamma == 2
    monkeypatch.setenv("MXNET_SPEC_DRAFT", "")
    _, ts = _pair(2, dict(block_type="ssm"), block_type="ssm")
    with pytest.raises(ValueError, match="ssm"):
        ContinuousDecoder(ts, draft=_pair(2)[1])
