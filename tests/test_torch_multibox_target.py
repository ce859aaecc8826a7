"""SSD training's ops and graph in the port against the JAX package, on the
CPU: ``MultiBoxTarget``, ``ROIPooling`` and upstream's SSD300 training
graph (``chip_smoke.ssd300_symbol(train=True)``).

* MultiBoxTarget (the cases of ``tests/test_detection_ops.py`` and random
  batches: mining on and off, ``minimum_negative_samples``, no phase 2,
  an image without a valid gt, tied background probabilities): classes
  and masks equal, loc targets within rtol 1e-5 / atol 1e-6 (jnp's and
  torch's log differ in the last bit).
* ROIPooling: forward equal (a max), the gradient within rtol 1e-5 /
  atol 1e-6 of ``jax.vjp`` (the sums over rois run in other orders),
  ties included: a bin of tied zeros splits its gradient evenly.
* The SSD300 training graph at every width / 16, batch 2, one Module
  step (SGD momentum 0.9, wd 5e-4) from one set of weights: targets
  equal on a batch whose hard-negative cut is 8 ulps or more from a tie
  in both packages, outputs within rtol 1e-4 / atol 1e-5, parameters
  after the step within rtol 1e-5 / atol 1e-6.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import detection_ops as tdet
from mxnet_tpu_torch.ops import registry as treg

import chip_smoke as cs

LOC_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _simple():
    """tests/test_detection_ops.py's setup: 4 anchors, 2 gts."""
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                         [0.0, 0.5, 0.5, 1.0], [0.5, 0.0, 1.0, 0.5]]],
                       np.float32)
    label = np.array([[[0, 0.05, 0.05, 0.45, 0.45],
                       [1, 0.55, 0.55, 0.95, 0.95],
                       [-1, -1, -1, -1, -1]]], np.float32)
    return anchors, label, np.zeros((1, 3, 4), np.float32)


def _random(B, A, L, C, seed, counts=None):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 0.8, (1, A, 2))
    anchors = np.concatenate([xy, xy + rs.uniform(0.05, 0.4, (1, A, 2))],
                             -1).astype(np.float32)
    label = -np.ones((B, L, 6), np.float32)
    for b in range(B):
        n = counts[b] if counts else rs.randint(1, L + 1)
        for k in range(n):
            w, h = rs.uniform(0.1, 0.5, 2)
            x, y = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            label[b, k] = (rs.randint(0, C - 1), x, y, x + w, y + h, 0)
    return anchors, label, rs.randn(B, C, A).astype(np.float32)


def _mining(inputs):
    anchors, label, cls_pred = inputs
    cls_pred = cls_pred.copy()
    cls_pred[0, 0, :] = [0.1, 0.1, 0.1, 5.0]
    return anchors, label, cls_pred


def _tied(inputs):
    """Every anchor's logits equal: every background probability ties,
    and the stable sort keeps the lowest indices."""
    anchors, label, cls_pred = inputs
    return anchors, label, np.zeros_like(cls_pred)


TARGET_CASES = [
    ("simple", _simple(), {}),
    ("simple_mining", _mining(_simple()),
     {"negative_mining_ratio": 0.5, "negative_mining_thresh": 0.5}),
    ("no_gt", (np.array([[[0, 0, 0.5, 0.5]]], np.float32),
               -np.ones((1, 2, 5), np.float32),
               np.zeros((1, 2, 1), np.float32)), {}),
    ("random_ssd_rules", _random(3, 300, 6, 5, 1, (1, 0, 6)), cs.SSD_TARGET),
    ("random_min_negatives", _random(2, 200, 5, 4, 3),
     {"negative_mining_ratio": 2.0, "minimum_negative_samples": 40,
      "overlap_threshold": 0.3}),
    ("random_no_phase2", _random(2, 150, 4, 3, 4),
     {"overlap_threshold": 0.0, "negative_mining_ratio": 3.0}),
    ("tied_background", _tied(_random(2, 250, 5, 4, 5)),
     {"negative_mining_ratio": 3.0, "ignore_label": -2.0,
      "variances": (0.2, 0.2, 0.1, 0.1)}),
]


def _targets(reg, mod, inputs, attrs):
    op = reg.get_op("_contrib_MultiBoxTarget")
    fn = functools.partial(op.fn, **reg.canon_attrs(op, attrs))
    if reg is jreg:
        fn = jax.jit(fn)        # one compile, not one an eager jnp op
    return [np.asarray(o) for o in fn(*[mod(x) for x in inputs])]


@pytest.mark.parametrize("inputs,attrs", [c[1:] for c in TARGET_CASES],
                         ids=[c[0] for c in TARGET_CASES])
def test_multibox_target_matches_jax(inputs, attrs):
    want = _targets(jreg, jnp.asarray, inputs, attrs)
    got = _targets(treg, torch.from_numpy, inputs, attrs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], **LOC_TOL)


def test_multibox_target_hand_values():
    """tests/test_detection_ops.py's expectations, on the port."""
    loc_t, loc_m, cls_t = _targets(treg, torch.from_numpy, _simple(), {})
    assert list(cls_t[0]) == [1.0, 2.0, 0.0, 0.0]
    assert loc_m[0].reshape(4, 4)[:2].all()
    assert not loc_m[0].reshape(4, 4)[2:].any()
    a, g = _simple()[0][0, 0], _simple()[1][0, 0, 1:5]
    aw, ah = a[2] - a[0], a[3] - a[1]
    gw, gh = g[2] - g[0], g[3] - g[1]
    want = [((g[0] + g[2]) / 2 - (a[0] + a[2]) / 2) / aw / 0.1,
            ((g[1] + g[3]) / 2 - (a[1] + a[3]) / 2) / ah / 0.1,
            np.log(gw / aw) / 0.2, np.log(gh / ah) / 0.2]
    np.testing.assert_allclose(loc_t[0].reshape(4, 4)[0], want, rtol=1e-4,
                               atol=1e-5)
    _l, _m, mined = _targets(treg, torch.from_numpy, _mining(_simple()),
                             {"negative_mining_ratio": 0.5})
    assert list(mined[0]) == [1.0, 2.0, 0.0, -1.0]


def test_tied_background_takes_the_lowest_indices():
    """With every background probability tied, the negatives are the
    first candidates by index (a stable sort), as in the JAX package."""
    anchors, label, cls_pred = _tied(_random(1, 200, 3, 4, 7))
    _l, _m, cls_t = _targets(treg, torch.from_numpy,
                             (anchors, label, cls_pred),
                             {"negative_mining_ratio": 1.0})
    neg = np.nonzero(cls_t[0] == 0)[0]
    ignored = np.nonzero(cls_t[0] == -1)[0]
    assert len(neg) == (cls_t[0] > 0).sum()
    assert neg.max() < ignored.min()


def test_multibox_target_meta_shapes():
    anchors, label, cls_pred = _random(2, 50, 3, 4, 8)
    outs = tdet._multibox_target(
        *[torch.empty(x.shape, device="meta") for x in
          (anchors, label, cls_pred)])
    assert [tuple(o.shape) for o in outs] == [(2, 200), (2, 200), (2, 50)]


# ---------------------------------------------------------------------------
# ROIPooling
# ---------------------------------------------------------------------------

def _relu(shape, seed):
    return np.maximum(np.round(np.random.RandomState(seed).randn(*shape)
                               * 2), 0).astype(np.float32)


ROI_CASES = [
    ("vs_numpy", np.random.RandomState(1).randn(2, 3, 8, 8).astype(
        np.float32), np.array([[0, 0, 0, 7, 7], [1, 2, 2, 6, 6],
                               [0, 4, 4, 7, 5]], np.float32), (2, 2), 1.0),
    ("spatial_scale", np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4),
     np.array([[0, 0, 0, 15, 15]], np.float32), (1, 1), 0.25),
    ("relu_ties", _relu((2, 4, 9, 11), 2),
     np.array([[0, 0, 0, 8, 8], [1, 2.3, 1.6, 10.2, 7.7], [0, 5, 5, 5, 5],
               [1, -3, -2, 30, 40], [0, 4, 3, 3, 2]], np.float32), (3, 4),
     0.5),
    ("empty_bins", _relu((1, 2, 6, 6), 3),
     np.array([[0, 5, 5, 40, 40], [0, -20, -20, -2, -2]], np.float32),
     (7, 7), 1.0),
    ("vgg_stride", _relu((1, 8, 12, 15), 4),
     np.array([[0, 10, 20, 150, 180], [0, 0, 0, 239, 191],
               [0, 100, 50, 120, 60]], np.float32), (7, 7), 1.0 / 16),
]


def _roi(reg, data, rois, ps, ss):
    return reg.get_op("ROIPooling").fn(data, rois, pooled_size=ps,
                                       spatial_scale=ss)


def _jax_roi(ps, ss, rois):
    """The JAX op as a function of the data, run op by op: under jit XLA
    takes x / n as x * (1 / n), which moves bin edges that fall on an
    integer (the op's own arithmetic is the eager one)."""
    return lambda d: _roi(jreg, d, jnp.asarray(rois), ps, ss)


@pytest.mark.parametrize("data,rois,ps,ss", [c[1:] for c in ROI_CASES],
                         ids=[c[0] for c in ROI_CASES])
def test_roi_pooling_matches_jax(data, rois, ps, ss):
    jo, vjp = jax.vjp(_jax_roi(ps, ss, rois), jnp.asarray(data))
    cot = np.random.RandomState(9).randn(*jo.shape).astype(np.float32)
    jg, = vjp(jnp.asarray(cot))
    x = torch.from_numpy(data.copy()).requires_grad_()
    to = _roi(treg, x, torch.from_numpy(rois), ps, ss)
    tg, = torch.autograd.grad(to, x, torch.from_numpy(cot))
    np.testing.assert_array_equal(to.detach().numpy(), np.asarray(jo))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD_TOL)


def test_roi_pooling_splits_a_tied_zero_bin():
    """A bin of relu zeros: every element ties at the maximum 0 and takes
    an even share of the bin's gradient, in both packages."""
    data = np.zeros((1, 1, 4, 4), np.float32)
    data[0, 0, 0, 0] = 3.0
    rois = np.array([[0, 0, 0, 3, 3]], np.float32)
    cot = np.array([[[[1.0, 2.0], [4.0, 8.0]]]], np.float32)
    x = torch.from_numpy(data).requires_grad_()
    tg, = torch.autograd.grad(_roi(treg, x, torch.from_numpy(rois), (2, 2),
                                   1.0), x, torch.from_numpy(cot))
    _, vjp = jax.vjp(_jax_roi((2, 2), 1.0, rois), jnp.asarray(data))
    jg, = vjp(jnp.asarray(cot))
    want = np.zeros((1, 1, 4, 4), np.float32)
    want[0, 0, 0, 0] = 1.0                  # bin (0, 0): 3 is its maximum
    want[0, 0, :2, 2:] = 2.0 / 4
    want[0, 0, 2:, :2] = 4.0 / 4
    want[0, 0, 2:, 2:] = 8.0 / 4
    np.testing.assert_allclose(tg.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jg), want, rtol=1e-6)


def test_roi_pooling_chunks_agree(monkeypatch):
    """The windows gathered a few rois at a time give the whole call's
    forward and gradient."""
    data, rois, ps, ss = ROI_CASES[2][1:]
    cot = torch.from_numpy(np.random.RandomState(5).randn(
        len(rois), data.shape[1], *ps).astype(np.float32))
    outs = []
    for chunk in (1 << 26, 50):
        monkeypatch.setattr(tdet, "_ROI_CHUNK_ELEMS", chunk)
        x = torch.from_numpy(data.copy()).requires_grad_()
        y = _roi(treg, x, torch.from_numpy(rois), ps, ss)
        outs.append((y.detach(), torch.autograd.grad(y, x, cot)[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# the SSD300 training graph, one Module step in each package
# ---------------------------------------------------------------------------

CLASSES, DIV, B = 4, 16, 2


def _module(mx, ctx_kw, params, X, Y, to_nd):
    sym = cs.ssd300_symbol(mx.sym, CLASSES, DIV, train=True)
    mod = mx.mod.Module(sym, data_names=("data",), label_names=("label",),
                        **ctx_kw)
    mod.bind(data_shapes=[("data", X.shape)],
             label_shapes=[("label", Y.shape)])
    mod.init_params(arg_params={k: to_nd(v) for k, v in params.items()},
                    aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.002, "momentum": 0.9, "wd": 5e-4})
    batch = mx.io.DataBatch([to_nd(X)], [to_nd(Y)])
    mod.forward(batch, is_train=True)
    outs = [np.asarray(o.asnumpy()) for o in mod.get_outputs()]
    mod.backward()
    mod.update()
    return outs, {k: np.asarray(v.asnumpy())
                  for k, v in mod.get_params()[0].items()}


def test_ssd300_training_step_matches_jax():
    heads = cs.ssd300_symbol(jmx.sym, CLASSES, DIV, heads=True)
    shapes, _, _ = heads.infer_shape(data=(1, 3, 300, 300))
    rng = np.random.RandomState(0)
    params = {}
    for name, shp in zip(heads.list_arguments(), shapes):
        if name == "data":
            continue
        if name.endswith("_scale"):
            params[name] = np.full(shp, 20.0, np.float32)
        else:
            std = np.sqrt(2.0 / max(1, int(np.prod(shp[1:])))) * (
                0.1 if "_pred_conv" in name else 1.0)
            params[name] = (rng.randn(*shp) * std).astype(np.float32)
    X, Y = cs.ssd_train_batch(B, 1, classes=CLASSES)
    jo, jp = _module(jmx, {}, params, X, Y, jmx.nd.array)

    def tnd(v):
        return tmx.nd.array(v, ctx=tmx.cpu())
    to, tp = _module(tmx, {"context": tmx.cpu()}, params, X, Y, tnd)
    for o in (jo, to):
        assert min(cs.target_margin_ulps(o[0][:, 0], o[2])) >= 8, \
            "pick another batch seed"
    np.testing.assert_array_equal(to[2], jo[2])        # the targets
    assert (to[2] > 0).any() and (to[2] == 0).any()
    for t, j in zip(to, jo):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
