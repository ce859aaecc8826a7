"""Symbol composition and the pre-0.9 JSON upgrade of the port against
the JAX package's, on the CPU (after ``tests/test_symbol.py``
``test_compose_and_arguments`` and ``test_load_legacy_v08_json``).

Each graph is built, or loaded, in both packages the same way: the
arguments, auxiliary states and outputs are the same lists, ``tojson``
gives the same JSON, and bound to the same numpy values the port's
forward equals the JAX Executor's within rtol 1e-5 / atol 1e-6 (float32).
"""
import copy
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-6)


def _same_graph(t, j):
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    assert json.loads(t.tojson()) == json.loads(j.tojson())


def _forward(mx, sym, shapes, seed=0, is_train=False):
    """The forward of ``sym`` bound on the CPU to seeded normals."""
    ctx = mx.cpu()
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: np.abs(rng.standard_normal(s)).astype(np.float32) + 0.5
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    with ctx:
        exe = sym.bind(ctx, args={k: mx.nd.array(v) for k, v in args.items()},
                       aux_states={k: mx.nd.array(v) for k, v in aux.items()}
                       or None, grad_req="null")
        return [o.asnumpy() for o in exe.forward(is_train=is_train)]


def _parts(mx):
    """A feature extractor with a free variable and a head to compose
    onto it."""
    x = mx.sym.Variable("x")
    body = mx.sym.Activation(mx.sym.FullyConnected(x, num_hidden=6,
                                                   name="fc1"),
                             act_type="relu", name="act1")
    head_in = mx.sym.Variable("feat")
    head = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        head_in, num_hidden=3, name="fc2"), name="softmax")
    return body, head


@pytest.mark.parametrize("how", ["keyword", "positional"])
def test_compose_matches_jax(how):
    syms = []
    for mx in (jmx, tmx):
        body, head = _parts(mx)
        net = head(feat=body) if how == "keyword" else head(body)
        syms.append((net, head))
    (jnet, jhead), (tnet, thead) = syms
    _same_graph(tnet, jnet)
    assert tnet.list_arguments() == ["x", "fc1_weight", "fc1_bias",
                                     "fc2_weight", "fc2_bias",
                                     "softmax_label"]
    # composing works on a copy: the head keeps its free variable
    assert thead.list_arguments()[0] == "feat"
    _same_graph(thead, jhead)
    shapes = {"x": (4, 5), "softmax_label": (4,)}
    for t, j in zip(_forward(tmx, tnet, shapes),
                    _forward(jmx, jnet, shapes)):
        np.testing.assert_allclose(t, j, **TOL)


def test_compose_errors_match_jax():
    for mx in (jmx, tmx):
        body, head = _parts(mx)
        with pytest.raises(TypeError, match="either as positional"):
            head(body, feat=body)
        with pytest.raises(TypeError, match="too many"):
            head(body, body, body, body, body)
        with pytest.raises(ValueError, match="no variable named"):
            head(nope=body)
        with pytest.raises(TypeError, match="single-output"):
            head(feat=mx.sym.Group([body, body]))


def test_copies_are_independent():
    body, head = _parts(tmx)
    for dup in (copy.copy(head), copy.deepcopy(head), head._deepcopy()):
        _same_graph(dup, head)
        dup._compose(feat=body)
        assert head.list_arguments()[0] == "feat"
        assert dup.list_arguments()[0] == "x"


def _legacy_fc():
    return json.dumps({
        "nodes": [
            {"op": "null", "name": "data", "inputs": []},
            {"op": "FullyConnected", "name": "fc1",
             "param": {"num_hidden": "8", "lr_mult": "2.0"},
             "inputs": [[0, 0]]},          # weight/bias edges missing
            {"op": "Activation", "name": "act",
             "param": {"act_type": "relu", "ctx_group": "dev1"},
             "inputs": [[1, 0]]},
        ],
        "heads": [[2, 0, 0]],
    })


def _legacy_bn():
    """A v0.8 conv + BatchNorm graph: only data edges, with the
    BatchNorm's moving stats to become aux variables."""
    return json.dumps({
        "nodes": [
            {"op": "null", "name": "data", "inputs": []},
            {"op": "Convolution", "name": "conv",
             "param": {"kernel": "(3, 3)", "num_filter": "4",
                       "pad": "(1, 1)", "wd_mult": "0.5"},
             "inputs": [[0, 0]]},
            {"op": "BatchNorm", "name": "bn",
             "param": {"fix_gamma": "False", "eps": "0.001"},
             "inputs": [[1, 0]]},
            {"op": "Pooling", "name": "pool",
             "param": {"kernel": "(2, 2)", "stride": "(2, 2)",
                       "pool_type": "max"},
             "inputs": [[2, 0]]},
        ],
        "heads": [[3, 0, 0]],
    })


@pytest.mark.parametrize("legacy,shapes", [
    (_legacy_fc, {"data": (4, 3)}),
    (_legacy_bn, {"data": (2, 3, 6, 6)})], ids=["fc", "conv_bn"])
def test_legacy_v08_json_upgrades_as_jax(legacy, shapes):
    """param -> attrs, bare hidden keys -> __dunder__ attrs, missing
    parameter inputs (and BatchNorm's moving stats, as aux) -> variables:
    the same graph, JSON and outputs as the JAX package's upgrade."""
    t = tmx.sym.load_json(legacy())
    j = jmx.sym.load_json(legacy())
    _same_graph(t, j)
    assert t.attr_dict() == j.attr_dict()
    if "bn" in t.list_outputs()[0] or t.list_auxiliary_states():
        assert t.list_auxiliary_states() == ["bn_moving_mean",
                                             "bn_moving_var"]
    else:
        assert t.list_arguments() == ["data", "fc1_weight", "fc1_bias"]
        assert t.attr_dict()["fc1"]["__lr_mult__"] == "2.0"
        assert t.attr_dict()["act"]["__ctx_group__"] == "dev1"
    for a, b in zip(_forward(tmx, t, shapes), _forward(jmx, j, shapes)):
        np.testing.assert_allclose(a, b, **TOL)
    # the upgraded graph saves as a current one and loads unchanged
    _same_graph(tmx.sym.load_json(t.tojson()), t)
