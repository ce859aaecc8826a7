"""The detection slice end to end: SSD300 (VGG16-reduced) in the port
against the JAX package, on the CPU.

* The graph: ``chip_smoke.ssd300_symbol``, written once against the
  symbol API both packages share, gives SSD300's 8732 anchors in both
  packages, the same arguments and JSON, and each package loads the
  other's JSON to the same graph; ``Symbol.__mul__`` composes as the JAX
  package's does.
* The slice at every width / 16, 4 classes + background, batch 2,
  3x300x300, f32, from one set of numpy-seeded weights carried across by
  ``convert.params_from_jax`` (the ``relu4_3_scale`` variable with its
  explicit ``__shape__`` included): the heads (cls_prob, loc_preds,
  anchors) agree within rtol 1e-4 / atol 1e-5 (convolution stacks sum in
  different orders), and the port's ``Predictor`` detections equal the
  JAX ``Predictor``'s within 1e-6 on a seed where both packages' heads
  rank the NMS candidates alike and put every pair's IoU on the same
  side of the threshold, 8 ulps or more from it (so the summation order
  decides neither the sort nor a suppression).
* ``ServeEngine`` over the port's ``Predictor`` answers each request as
  the predictor alone does, bit for bit.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import params_from_jax
from mxnet_tpu_torch.ops import detection_ops as tdet
from mxnet_tpu_torch.serve import ServeEngine

import chip_smoke as cs
from test_torch_detection import _assert_margin, _iou_np

CLASSES, DIV, B = 4, 16, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these cases are many small eager ops, and the
    suite runs beside other workers on the same cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
SHAPE = (B, 3, 300, 300)


def _params(sym, seed):
    """He-scaled normal weights (the heads' a tenth of that, so the class
    scores spread out and the box offsets stay small), small normal
    biases, every scale 20."""
    shapes, _, _ = sym.infer_shape(data=SHAPE)
    rng = np.random.RandomState(seed)
    params = {}
    for name, shp in zip(sym.list_arguments(), shapes):
        if name == "data":
            continue
        if name.endswith("_scale"):
            params[name] = np.full(shp, 20.0, np.float32)
        elif name.endswith("_bias"):
            params[name] = (rng.randn(*shp) * 0.1).astype(np.float32)
        else:
            fan_in = int(np.prod(shp[1:]))
            std = np.sqrt(2.0 / fan_in) * (0.1 if "_pred_conv" in name
                                           else 1.0)
            params[name] = (rng.randn(*shp) * std).astype(np.float32)
    return params


def _ops(sym):
    return [n["op"] for n in json.loads(sym.tojson())["nodes"]]


@pytest.mark.parametrize("div", [1, 16])
def test_ssd300_graph_matches_jax(div):
    js = cs.ssd300_symbol(jmx.sym, 20, div)
    ts = cs.ssd300_symbol(tmx.sym, 20, div)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert _ops(ts) == _ops(js)
    shape = (1, 3, 300, 300)
    jshapes, tshapes = js.infer_shape(data=shape), ts.infer_shape(data=shape)
    assert [tuple(s) for s in tshapes[0]] == [tuple(s) for s in jshapes[0]]
    assert tshapes[1] == [(1, cs.SSD_ANCHORS, 6)]
    assert [tuple(s) for s in jshapes[1]] == [(1, cs.SSD_ANCHORS, 6)]
    args = dict(zip(ts.list_arguments(), tshapes[0]))
    assert args["relu4_3_scale"] == (1, 512 // div, 1, 1)
    # the heads: 8732 anchors, 21 classes
    th = cs.ssd300_symbol(tmx.sym, 20, div, heads=True)
    jh = cs.ssd300_symbol(jmx.sym, 20, div, heads=True)
    want = [(1, 21, cs.SSD_ANCHORS), (1, cs.SSD_ANCHORS * 4),
            (1, cs.SSD_ANCHORS, 4)]
    assert th.infer_shape(data=shape)[1] == want
    assert [tuple(s) for s in jh.infer_shape(data=shape)[1]] == want
    # each package loads the other's JSON to the same graph
    for loaded, orig in ((tmx.sym.load_json(js.tojson()), js),
                         (jmx.sym.load_json(ts.tojson()), ts)):
        assert loaded.list_arguments() == orig.list_arguments()
        assert _ops(loaded) == _ops(orig)
        assert [tuple(s) for s in loaded.infer_shape(data=shape)[1]] == \
            [(1, cs.SSD_ANCHORS, 6)]


def test_symbol_mul_matches_jax():
    """sym * sym, sym * scalar and scalar * sym compose to the JAX
    package's ops and values."""
    outs = []
    x = np.random.RandomState(0).randn(2, 3, 4).astype(np.float32)
    s = np.random.RandomState(1).randn(1, 3, 1).astype(np.float32)
    for S in (jmx.sym, tmx.sym):
        a, b = S.Variable("a"), S.Variable("b")
        g = S.Group([a * b, a * 2.5, 0.5 * b])
        outs.append((_ops(g), g))
    assert outs[0][0] == outs[1][0]
    jpred = jmx.Predictor(outs[0][1], {"b": s}, data_names=("a",))
    tpred = tmx.Predictor(outs[1][1], {"b": s}, data_names=("a",),
                          ctx=tmx.cpu())
    for j, t in zip(jpred.forward(x), tpred.forward(x)):
        np.testing.assert_array_equal(t.asnumpy(), np.asarray(j.asnumpy()))


@pytest.fixture(scope="module")
def small_ssd():
    jsym = cs.ssd300_symbol(jmx.sym, CLASSES, DIV)
    params = _params(jsym, seed=0)
    x = np.random.RandomState(1).standard_normal(SHAPE).astype(np.float32)
    return jsym, params, x


def _candidates(cls_prob, loc, anchor, attrs):
    """Per image: the stable score order of the NMS candidates (the top
    nms_topk rows and the first one past the cut) and their decoded
    boxes."""
    Bn, C, A = cls_prob.shape
    boxes = tdet._decode_boxes(torch.from_numpy(anchor[0]),
                               torch.from_numpy(loc).reshape(Bn, A, 4),
                               attrs["variances"], True).numpy()
    scores = cls_prob[:, 1:].max(axis=1)
    out = []
    for b in range(Bn):
        order = np.argsort(-scores[b], kind="stable")[:attrs["nms_topk"] + 1]
        assert scores[b, order[-1]] >= 0.01     # the cut falls on valid rows
        out.append((order, boxes[b, order[:-1]]))
    return out


def _precondition(jheads, theads, attrs):
    """The two packages' heads rank the candidates alike, and every pair's
    IoU lies on the same side of the threshold in both, at least 8 ulps
    from it: the summation order decides neither the sort nor a
    suppression."""
    thr = np.float32(attrs["nms_threshold"])
    for (jo, jb), (to, tb) in zip(_candidates(*jheads, attrs),
                                  _candidates(*theads, attrs)):
        np.testing.assert_array_equal(jo, to, "pick another seed")
        _assert_margin(jb, thr)
        _assert_margin(tb, thr)
        for s in range(0, len(jb), 128):
            assert np.array_equal(_iou_np(jb[s:s + 128], jb) >= thr,
                                  _iou_np(tb[s:s + 128], tb) >= thr)


def test_ssd300_slice_matches_jax(small_ssd):
    jsym, params, x = small_ssd
    # heads
    jh = jmx.Predictor(cs.ssd300_symbol(jmx.sym, CLASSES, DIV, heads=True),
                       params).forward(x)
    th = tmx.Predictor(cs.ssd300_symbol(tmx.sym, CLASSES, DIV, heads=True),
                       params_from_jax(params, "cpu"),
                       ctx=tmx.cpu()).forward(x)
    jheads = [np.asarray(h.asnumpy()) for h in jh]
    theads = [h.asnumpy() for h in th]
    for j, t in zip(jheads, theads):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5)
    _precondition(jheads, theads, cs.SSD_NMS)
    # detections: JAX Predictor (its default NMS route on the CPU) against
    # the port's on each route
    want = np.asarray(jmx.Predictor(jsym, params).forward(x)[0].asnumpy())
    assert want.shape == (B, cs.SSD_ANCHORS, 6)
    kept = (want[..., 0] >= 0).sum(axis=1)
    assert (kept > 0).all() and (kept <= 400).all()
    for impl in ("auto", "pallas", "xla"):
        tsym = cs.ssd300_symbol(tmx.sym, CLASSES, DIV, impl=impl)
        got = tmx.Predictor(tsym, params_from_jax(params, "cpu"),
                            ctx=tmx.cpu()).forward(x)[0].asnumpy()
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=impl)


def test_serve_engine_answers_as_the_predictor_alone(small_ssd):
    jsym, params, x = small_ssd
    pred = tmx.Predictor(cs.ssd300_symbol(tmx.sym, CLASSES, DIV),
                         params_from_jax(params, "cpu"), ctx=tmx.cpu())
    engine = ServeEngine(pred, buckets=(1, 2), max_wait_ms=0.0,
                         feature_shapes=[(3, 300, 300)])
    try:
        # one request at a time: each rides alone in its own bucket
        for rows in (x[:1], x[1:], x):
            got = engine.infer(rows, timeout=300)[0]
            assert got.shape == (len(rows), cs.SSD_ANCHORS, 6)
            np.testing.assert_array_equal(got,
                                          pred.forward(rows)[0].asnumpy())
    finally:
        engine.close()


def test_ssd300_checkpoint_crosses_packages(small_ssd, tmp_path):
    """SSD300's parameters, the explicitly shaped ``relu4_3_scale``
    included, cross both ways through checkpoints unchanged, and the
    port serves the JAX-written checkpoint as it serves the arrays."""
    from mxnet_tpu import model as jmodel
    from mxnet_tpu_torch import model as tmodel
    jsym, params, x = small_ssd
    carried = params_from_jax(params, "cpu")
    assert carried["relu4_3_scale"].shape == (1, 512 // DIV, 1, 1)
    for name, v in params.items():
        np.testing.assert_array_equal(carried[name].numpy(), v)
    jmodel.save_checkpoint(str(tmp_path / "jax"), 1, jsym,
                           {k: jmx.nd.array(v) for k, v in params.items()},
                           {})
    with tmx.cpu():
        sym, targs, taux = tmodel.load_checkpoint(str(tmp_path / "jax"), 1)
    assert taux == {} and sorted(targs) == sorted(params)
    for name, v in params.items():
        np.testing.assert_array_equal(targs[name].asnumpy(), v)
    got = tmx.Predictor(sym, targs, ctx=tmx.cpu()).forward(x)[0].asnumpy()
    want = tmx.Predictor(cs.ssd300_symbol(tmx.sym, CLASSES, DIV), carried,
                         ctx=tmx.cpu()).forward(x)[0].asnumpy()
    np.testing.assert_array_equal(got, want)
    tmodel.save_checkpoint(str(tmp_path / "port"), 2, sym,
                           {k: v.handle for k, v in targs.items()}, {})
    _, jargs, _ = jmodel.load_checkpoint(str(tmp_path / "port"), 2)
    for name, v in params.items():
        np.testing.assert_array_equal(np.asarray(jargs[name].asnumpy()), v)
