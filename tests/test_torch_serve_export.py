"""The port's deploy chain on the CPU: ``Predictor.export_buckets`` ->
``ServeEngine.from_export`` (``CompiledPredictor`` per bucket), against
the port's ``Predictor`` and the JAX package's from the same numpy
weights.

Models: the JAX serve tests' MLP (8 features, 16 hidden, 4 classes) and
a small transformer LM (vocab 40, seq 12, 2 layers, 2 heads, dim 16)
whose (B*T, V) probabilities are reshaped to (B, T, V) so a bucket's
rows slice back per request. Tolerances: the exported forward equals the
port's own Predictor bit for bit (the same graph on the same device);
against the JAX Predictor within rtol 1e-5 / atol 1e-6 (torch's float32
sums against XLA's), the tolerance of the earlier port tests.
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.predictor import Predictor as JPredictor

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import params_from_jax
from mxnet_tpu_torch.models import transformer as ttransformer
from mxnet_tpu_torch.predictor import (CompiledPredictor, Predictor,
                                       load_checkpoint_predictor)
from mxnet_tpu_torch.serve import ServeEngine

FEAT, CLASSES = 8, 4
LM_V, LM_T = 40, 12
TOL = dict(rtol=1e-5, atol=1e-6)
BUCKETS = (1, 2, 4)


def _mlp_sym(mx):
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, name="fc1", num_hidden=16)
    net = mx.sym.Activation(net, act_type="tanh")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=CLASSES)
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _lm_sym(mx, transformer):
    out = transformer.get_symbol(LM_V, LM_T, num_layers=2, num_heads=2,
                                 dim=16)
    return mx.sym.reshape(out, shape=(-1, LM_T, LM_V), name="probs")


def _weights(sym, names, data_shape, scale):
    shapes, _, _ = sym.infer_shape(**{n: data_shape for n in names})
    rng = np.random.RandomState(3)
    return {n: np.ones(s, np.float32) if n.endswith("_gamma") else
            (rng.randn(*s) * scale).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


MODELS = {
    "mlp": (lambda mx, tr: _mlp_sym(mx), (FEAT,), ("data",), 0.3),
    "lm": (_lm_sym, (LM_T,), ("data", "softmax_label"), 0.5),
}


def _inputs(model, b, seed=0):
    _, feat, names, _ = MODELS[model]
    rng = np.random.RandomState(seed)
    if model == "lm":
        toks = rng.randint(0, LM_V, (b,) + feat).astype(np.float32)
        return [toks, np.zeros_like(toks)]
    return [rng.rand(b, *feat).astype(np.float32)]


def _predictors(model):
    build, feat, names, scale = MODELS[model]
    jsym = build(jmx, jtransformer)
    w = _weights(jsym, names, (2,) + feat, scale)
    tsym = build(tmx, ttransformer)
    return (JPredictor(jsym, w, data_names=names),
            Predictor(tsym, params_from_jax(w, "cpu"), data_names=names,
                      ctx=tmx.cpu()))


@pytest.mark.parametrize("model", list(MODELS))
def test_export_buckets_serves_what_the_predictor_computes(model, tmp_path):
    """Every bucket of the export, loaded headless (no symbol or weights
    passed in) and served through ServeEngine.from_export, equals the
    port's Predictor bit for bit and the JAX Predictor within TOL; the
    manifest's and the bucket metas' keys are the JAX package's."""
    jp, tp = _predictors(model)
    _, feat, names, _ = MODELS[model]
    prefix = str(tmp_path / model)
    manifest = tp.export_buckets(prefix, [feat] * len(names),
                                 buckets=BUCKETS)
    jprefix = str(tmp_path / ("jax_" + model))
    jmanifest = jp.export_buckets(jprefix, [feat] * len(names),
                                  buckets=BUCKETS)
    with open(manifest) as f:
        mine = json.load(f)
    with open(jmanifest) as f:
        theirs = json.load(f)
    assert set(mine) == set(theirs)
    assert {k: mine[k] for k in mine if k != "model_id"} == \
        {k: theirs[k] for k in theirs if k != "model_id"}
    for b in BUCKETS:
        with open("%s.b%d.meta.json" % (prefix, b)) as f:
            meta = json.load(f)
        with open("%s.b%d.meta.json" % (jprefix, b)) as f:
            jmeta = json.load(f)
        assert set(meta) == set(jmeta) | {"torch_forward"}
        assert {k: meta[k] for k in jmeta} == jmeta
        cp = CompiledPredictor.load("%s.b%d" % (prefix, b), ctx=tmx.cpu())
        xs = _inputs(model, b, seed=b)
        got = cp.forward(*xs)[0].asnumpy()
        np.testing.assert_array_equal(got, tp.forward(*xs)[0].asnumpy())
        np.testing.assert_allclose(got, np.asarray(jp.forward(*xs)[0]
                                                   .asnumpy()), **TOL)
    engine = ServeEngine.from_export(prefix, ctx=tmx.cpu(), max_wait_ms=0.0,
                                     install_sigterm=False)
    try:
        assert engine.model_id == mine["model_id"]
        assert engine.model_id.startswith("gen-")
        for rows in (1, 3):
            xs = _inputs(model, rows, seed=10 + rows)
            out = engine.infer(*xs, timeout=60)
            np.testing.assert_array_equal(out[0],
                                          tp.forward(*xs)[0].asnumpy())
    finally:
        engine.close()


def test_model_id_is_a_content_hash(tmp_path):
    """Re-exporting the same weights gives the same stamp, other weights
    another; the stamp hashes the port's files, so it differs from the
    JAX package's for the same weights."""
    jp, tp = _predictors("mlp")
    stamps = []
    for name in ("a", "b"):
        with open(tp.export_buckets(str(tmp_path / name), [(FEAT,)],
                                    buckets=(1, 2))) as f:
            stamps.append(json.load(f)["model_id"])
    assert stamps[0] == stamps[1]
    with open(jp.export_buckets(str(tmp_path / "j"), [(FEAT,)],
                                buckets=(1, 2))) as f:
        assert json.load(f)["model_id"] != stamps[0]
    tp._params["fc1_bias"] = tp._params["fc1_bias"] + 1.0
    with open(tp.export_buckets(str(tmp_path / "c"), [(FEAT,)],
                                buckets=(1, 2))) as f:
        assert json.load(f)["model_id"] != stamps[0]
    with open(tp.export_buckets(str(tmp_path / "d"), [(FEAT,)],
                                buckets=(1,), model_id="v7")) as f:
        assert json.load(f)["model_id"] == "v7"


def test_missing_or_foreign_artifacts_raise(tmp_path):
    """A missing bucket artifact fails from_export; a JAX StableHLO
    artifact is refused by name; a wrong input shape is refused."""
    jp, tp = _predictors("mlp")
    prefix = str(tmp_path / "m")
    tp.export_buckets(prefix, [(FEAT,)], buckets=(1, 2))
    os.remove(prefix + ".b2.meta.json")
    with pytest.raises(FileNotFoundError):
        ServeEngine.from_export(prefix, ctx=tmx.cpu())
    jprefix = str(tmp_path / "j")
    jp.export(jprefix, {"data": (2, FEAT)})
    with pytest.raises(ValueError, match="StableHLO"):
        CompiledPredictor.load(jprefix, ctx=tmx.cpu())
    cp = CompiledPredictor.load(prefix + ".b1", ctx=tmx.cpu())
    with pytest.raises(ValueError, match="exported"):
        cp.forward(np.zeros((2, FEAT), np.float32))
    assert cp.output_names == tp.output_names


def test_load_checkpoint_predictor(tmp_path):
    """save_checkpoint -> load_checkpoint_predictor: the same outputs."""
    _, tp = _predictors("mlp")
    prefix = str(tmp_path / "ck")
    with tmx.cpu():
        tmx.model.save_checkpoint(prefix, 3, tp._symbol, tp._params, {})
        back = load_checkpoint_predictor(prefix, 3, ctx=tmx.cpu())
    x = _inputs("mlp", 2)
    np.testing.assert_array_equal(back.forward(*x)[0].asnumpy(),
                                  tp.forward(*x)[0].asnumpy())
