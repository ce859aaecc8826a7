"""The PyTorch port's serving slice end to end, against the JAX package.

The small transformer LM (2 layers, 4 heads, dim 32, vocab 50, T 16)
goes through the JAX ``Predictor`` and through the port's
``Predictor(ctx=cpu())`` from the same numpy-seeded weights, carried
across by ``params_from_jax`` and through a JAX-saved checkpoint; the
two must agree within rtol 1e-5 / atol 1e-5 (float32 on the CPU; only
summation order differs). The port's ``ServeEngine`` must answer
concurrent requests exactly as its predictor does, and the symbol JSON
and ``.params`` files must cross between the packages both ways.
"""
import json
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models import transformer as jtransformer
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_params, params_from_jax
from mxnet_tpu_torch.models import transformer as ttransformer
from mxnet_tpu_torch.serve import ServeEngine

V, T, LAYERS, HEADS, DIM = 50, 16, 2, 4, 32
DATA_NAMES = ("data", "softmax_label")


def _jax_symbol(**kw):
    with jmx.name.NameManager():
        return jtransformer.get_symbol(V, T, num_layers=LAYERS,
                                       num_heads=HEADS, dim=DIM, **kw)


def _port_symbol(**kw):
    with tmx.name.NameManager():
        return ttransformer.get_symbol(V, T, num_layers=LAYERS,
                                       num_heads=HEADS, dim=DIM, **kw)


def _params(sym, seed=0):
    shapes, _, _ = sym.infer_shape(data=(2, T), softmax_label=(2, T))
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.2).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in DATA_NAMES}


def _batch(rows, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (rows, T)).astype(np.float32),
            np.zeros((rows, T), np.float32))


@pytest.fixture(scope="module")
def lm():
    jsym = _jax_symbol()
    params = _params(jsym)
    jpred = jmx.Predictor(jsym, params, data_names=DATA_NAMES)
    return jsym, params, jpred


def test_port_graph_equals_jax_graph():
    """Same ops, names, attrs and parameter packing: the two packages
    serialize the LM to the same JSON, and infer the same shapes."""
    jsym, tsym = _jax_symbol(), _port_symbol()
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    shapes = dict(data=(3, T), softmax_label=(3, T))
    assert tsym.infer_shape(**shapes) == jsym.infer_shape(**shapes)
    partial = tsym.infer_shape_partial(data=(3, T))
    assert partial == jsym.infer_shape_partial(data=(3, T))


@pytest.mark.parametrize("kw", [dict(attention_window=4),
                                dict(num_kv_heads=2),
                                dict(block_type="ssm"),
                                dict(pos_encoding="rope"),
                                dict(loss_chunk=8)],
                         ids=["window", "gqa", "ssm", "rope", "loss_chunk"])
def test_port_graph_options_equal_jax(kw):
    jsym, tsym = _jax_symbol(**kw), _port_symbol(**kw)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())


def test_symbol_json_round_trips_both_ways():
    jsym = _jax_symbol(num_kv_heads=2)
    jjson = jsym.tojson()
    # JAX -> port -> JAX
    tsym = tmx.sym.load_json(jjson)
    assert json.loads(tsym.tojson()) == json.loads(jjson)
    back = jmx.sym.load_json(tsym.tojson())
    assert json.loads(back.tojson()) == json.loads(jjson)
    # port -> JAX -> port
    tjson = _port_symbol().tojson()
    again = tmx.sym.load_json(jmx.sym.load_json(tjson).tojson())
    assert json.loads(again.tojson()) == json.loads(tjson)


def test_predictor_matches_jax_via_params_from_jax(lm):
    jsym, params, jpred = lm
    toks, lab = _batch(3)
    ref = jpred.forward(data=toks, softmax_label=lab)[0].asnumpy()
    tpred = tmx.Predictor(_port_symbol(),
                          params_from_jax(params, "cpu"),
                          data_names=DATA_NAMES, ctx=tmx.cpu())
    out = tpred.forward(data=toks, softmax_label=lab)[0]
    assert out.shape == (3 * T, V) and out.context == tmx.cpu()
    np.testing.assert_allclose(out.asnumpy(), ref, rtol=1e-5, atol=1e-5)


def test_predictor_matches_jax_via_saved_checkpoint(lm, tmp_path):
    """A checkpoint the JAX package wrote (symbol JSON + .params npz)
    serves unchanged through the port."""
    jsym, params, jpred = lm
    prefix = str(tmp_path / "lm")
    jmx.model.save_checkpoint(
        prefix, 3, jsym, {k: jmx.nd.array(v) for k, v in params.items()},
        {})
    tsym = tmx.sym.load(prefix + "-symbol.json")
    args, auxs = load_params(prefix + "-0003.params", "cpu")
    assert sorted(args) == sorted(params) and auxs == {}
    tpred = tmx.Predictor(tsym, args, auxs, data_names=DATA_NAMES,
                          ctx=tmx.cpu())
    toks, lab = _batch(2, seed=4)
    ref = jpred.forward(toks, lab)[0].asnumpy()
    np.testing.assert_allclose(tpred.forward(toks, lab)[0].asnumpy(), ref,
                               rtol=1e-5, atol=1e-5)


def test_predictor_bf16_close_to_jax_f32(lm):
    """The serving dtype: bf16 weights through the port stay within bf16
    tolerance of the float32 JAX forward."""
    jsym, params, jpred = lm
    toks, lab = _batch(2, seed=5)
    ref = jpred.forward(toks, lab)[0].asnumpy()
    tpred = tmx.Predictor(_port_symbol(),
                          params_from_jax(params, "cpu", dtype="bfloat16"),
                          data_names=DATA_NAMES, ctx=tmx.cpu())
    out = tpred.forward(toks, lab)[0]
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.asnumpy(), ref, rtol=5e-2, atol=2e-2)


class _RowAligned:
    """(B*T, V) probabilities -> (B, T, V), the engine's row contract."""

    def __init__(self, pred):
        self.pred = pred

    def forward(self, data, label):
        return [self.pred.forward(data, label)[0].handle.reshape(-1, T, V)]


def test_serve_engine_answers_concurrent_requests(lm):
    _jsym, params, jpred = lm
    tpred = tmx.Predictor(_port_symbol(), params_from_jax(params, "cpu"),
                          data_names=DATA_NAMES, ctx=tmx.cpu())
    model = _RowAligned(tpred)
    rows = (1, 2, 1, 3, 1, 2)
    reqs = [_batch(r, seed=10 + i) for i, r in enumerate(rows)]
    results = [None] * len(reqs)
    barrier = threading.Barrier(len(reqs))

    def client(i):
        barrier.wait()
        results[i] = engine.infer(*reqs[i], timeout=60)

    with ServeEngine(model, buckets=(1, 2, 4, 8), max_wait_ms=100.0,
                     install_sigterm=False) as engine:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
        stats = engine.stats()
    assert stats["completed"] == len(reqs)
    assert stats["forwards"] < len(reqs)          # batching is real
    for (toks, lab), res in zip(reqs, results):
        alone = model.forward(toks, lab)[0].numpy()
        assert res[0].shape == (toks.shape[0], T, V)
        np.testing.assert_allclose(res[0], alone, rtol=1e-6, atol=1e-7)
        ref = jpred.forward(toks, lab)[0].asnumpy().reshape(-1, T, V)
        np.testing.assert_allclose(res[0], ref, rtol=1e-5, atol=1e-5)


def test_serve_engine_turns_bf16_outputs_into_f32():
    out = ServeEngine._to_np(torch.ones((2, 3), dtype=torch.bfloat16))
    assert out.dtype == np.float32 and out.shape == (2, 3)


def test_ndarray_save_load_cross_package(tmp_path):
    rng = np.random.RandomState(0)
    a = rng.randn(3, 4).astype(np.float32)
    b = np.arange(5, dtype=np.int32)
    # JAX writes, port reads (dict and list forms)
    jmx.nd.save(str(tmp_path / "j.npz"), {"a": jmx.nd.array(a),
                                          "b": jmx.nd.array(b)})
    got = tmx.nd.load(str(tmp_path / "j.npz"), ctx=tmx.cpu())
    np.testing.assert_array_equal(got["a"].asnumpy(), a)
    assert got["b"].dtype == np.int32
    jmx.nd.save(str(tmp_path / "jl.npz"), [jmx.nd.array(b),
                                           jmx.nd.array(a)])
    lst = tmx.nd.load(str(tmp_path / "jl.npz"), ctx=tmx.cpu())
    np.testing.assert_array_equal(lst[1].asnumpy(), a)
    # port writes, JAX reads
    with tmx.cpu():
        tmx.nd.save(str(tmp_path / "t.npz"), {"a": tmx.nd.array(a)})
        tmx.nd.save(str(tmp_path / "tl.npz"), [tmx.nd.array(b)])
    np.testing.assert_array_equal(
        jmx.nd.load(str(tmp_path / "t.npz"))["a"].asnumpy(), a)
    np.testing.assert_array_equal(
        jmx.nd.load(str(tmp_path / "tl.npz"))[0].asnumpy(), b)


def test_bf16_params_round_trip_through_npz(tmp_path):
    """bf16 is stored as the raw 2-byte words ml_dtypes arrays leave in
    an .npz, and reads back bit-exact (from numpy or a torch tensor)."""
    w = torch.randn(4, 6).to(torch.bfloat16)
    with tmx.cpu():
        tmx.nd.save(str(tmp_path / "w.npz"), {"w": tmx.nd.NDArray(w)})
        back = tmx.nd.load(str(tmp_path / "w.npz"))["w"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.handle, w)
    via_jax = params_from_jax(
        {"w": np.asarray(jmx.nd.array(w.float().numpy(),
                                      dtype="bfloat16").handle)}, "cpu")
    assert torch.equal(via_jax["w"], w)


@pytest.mark.parametrize("kw", [dict(num_experts=4), dict(seq_axis="sp")],
                         ids=["moe", "seq_axis"])
def test_unported_options_raise_not_implemented(kw):
    """The MoE FFN and ring attention are ported (ROADMAP Queue A item
    9a): the options build the JAX package's graph. The serving path's
    last option, a Generator over a mesh, is ported too (item 9b.3): it
    takes a make_mesh mesh and refuses any other object."""
    assert json.loads(_port_symbol(**kw).tojson()) == \
        json.loads(_jax_symbol(**kw).tojson())
    from mxnet_tpu_torch.generation import Generator
    with pytest.raises(TypeError, match="make_mesh"):
        Generator({}, V, T, ctx=tmx.cpu(), mesh=object())
