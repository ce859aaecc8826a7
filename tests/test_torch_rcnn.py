"""The R-CNN family in the port against the JAX package, on the CPU:
Proposal / MultiProposal, PSROIPooling, DeformablePSROIPooling,
DeformableConvolution, and examples/rcnn_train.py's Faster R-CNN
(``chip_smoke.faster_rcnn_symbol``, its two Custom target ops) for one
Module step.

* Proposal: the rois within rtol 1e-5 / atol 1e-3 of JAX's (both decode
  with exp, which rounds differently in the last bit) and of the numpy
  oracle of ``tests/test_rcnn_contrib_ops.py``; the batch column and the
  scores equal. Tied scores take the lower index first in both.
* The fixed-point walk (``rcnn_ops._sweep_keep``) equals the sequential
  loop flag for flag, a chain that needs one sweep a row included.
* The pooling and deformable ops: forward within rtol 1e-5 / atol 1e-6,
  gradients (data, offsets, weights) within rtol 1e-4 / atol 1e-5 of
  ``jax.vjp``.
* The Faster R-CNN step: outputs within rtol 1e-4 / atol 1e-5 (the
  proposals and targets equal up to exp's last bit), parameters after
  the SGD step within rtol 1e-5 / atol 1e-6.
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
from mxnet_tpu_torch.ops import rcnn_ops
from mxnet_tpu_torch.ops import registry as treg

import chip_smoke as cs
from test_rcnn_contrib_ops import _np_proposal_oracle

ROI_TOL = dict(rtol=1e-5, atol=1e-3)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _run(reg, mod, name, inputs, attrs):
    op = reg.get_op(name)
    fn = functools.partial(op.fn, **reg.canon_attrs(op, attrs))
    if reg is jreg:
        fn = jax.jit(fn)        # one compile, not one an eager jnp op
    out = fn(*[mod(x) for x in inputs])
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list))
                                    else [out])]


def _prop_inputs(B, A, H, W, seed, tie_step=None, zero_deltas=False):
    rs = np.random.RandomState(seed)
    prob = rs.uniform(0, 1, (B, 2 * A, H, W)).astype(np.float32)
    if tie_step:
        prob = (np.round(prob / tie_step) * tie_step).astype(np.float32)
    deltas = np.zeros((B, 4 * A, H, W), np.float32) if zero_deltas else \
        (rs.randn(B, 4 * A, H, W) * 0.1).astype(np.float32)
    info = np.tile(np.array([[16 * H, 16 * W, 1.0]], np.float32), (B, 1))
    return [prob, deltas, info]


PROPOSAL_CASES = [
    ("oracle_multi", "_contrib_MultiProposal", _prop_inputs(2, 3, 4, 4, 4),
     {"rpn_pre_nms_top_n": 30, "rpn_post_nms_top_n": 8, "threshold": 0.7,
      "rpn_min_size": 4, "scales": (8.0,), "ratios": (0.5, 1.0, 2.0)}),
    ("post_exceeds_candidates", "_contrib_MultiProposal",
     _prop_inputs(1, 3, 4, 4, 9, zero_deltas=True),
     {"scales": (8.0,), "ratios": (0.5, 1.0, 2.0), "rpn_min_size": 2}),
    ("tied_scores", "_contrib_Proposal",
     _prop_inputs(1, 9, 6, 7, 6, tie_step=0.125),
     {"rpn_pre_nms_top_n": 200, "rpn_post_nms_top_n": 40,
      "scales": (8, 16, 32), "output_score": True}),
    ("min_size_and_alias", "Proposal", _prop_inputs(2, 6, 5, 5, 7),
     {"rpn_pre_nms_top_n": 60, "rpn_post_nms_top_n": 20,
      "rpn_min_size": 40, "scales": (2, 4), "threshold": 0.5}),
]


@pytest.mark.parametrize("name,inputs,attrs",
                         [c[1:] for c in PROPOSAL_CASES],
                         ids=[c[0] for c in PROPOSAL_CASES])
def test_proposal_matches_jax(name, inputs, attrs):
    want = _run(jreg, jnp.asarray, name, inputs, attrs)
    got = _run(treg, torch.from_numpy, name, inputs, attrs)
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    np.testing.assert_allclose(got[0], want[0], **ROI_TOL)
    if len(got) > 1:
        np.testing.assert_array_equal(got[1], want[1])


def test_proposal_matches_numpy_oracle():
    _n, name, inputs, attrs = PROPOSAL_CASES[0]
    got = _run(treg, torch.from_numpy, name, inputs, attrs)[0]
    ref = _np_proposal_oracle(*inputs, 16, (8.0,), (0.5, 1.0, 2.0), 30, 8,
                              0.7, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


def _chain(k):
    """Boxes each overlapping only the next: greedy keeps every other
    one, and the walk needs a sweep a row."""
    x = np.arange(k, dtype=np.float32) * 3.0
    return np.stack([x, np.zeros(k), x + 9.0, np.full(k, 9.0)],
                    1).astype(np.float32)[None]


def _scatter(k, seed):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 100, (1, k, 2))
    return np.concatenate([xy, xy + rs.uniform(5, 40, (1, k, 2))],
                          -1).astype(np.float32)


@pytest.mark.parametrize("boxes,valid_every", [
    (_chain(40), 1), (_scatter(300, 1), 1), (_scatter(200, 2), 3),
    (_scatter(50, 3), 0)], ids=["chain", "scatter", "sparse_valid",
                                "none_valid"])
def test_sweep_walk_equals_sequential_loop(boxes, valid_every):
    k = boxes.shape[1]
    valid = torch.zeros((1, k), dtype=torch.bool)
    if valid_every:
        valid[:, ::valid_every] = True
    sup = rcnn_ops._suppression(torch.from_numpy(boxes), 0.3)
    keep, sweeps = rcnn_ops._sweep_keep(sup, valid)
    assert torch.equal(keep, rcnn_ops._dense_keep(sup, valid))
    if k == 40:                         # the chain
        assert keep[0, ::2].all() and not keep[0, 1::2].any()
        assert sweeps >= k // 2


# ---------------------------------------------------------------------------
# PSROIPooling, DeformablePSROIPooling, DeformableConvolution
# ---------------------------------------------------------------------------

def _f32(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


_ROIS = np.array([[0, 1, 1, 6, 6], [0, 0, 0, 7, 7]], np.float32)
GATHER_CASES = [
    ("psroi_groups", "_contrib_PSROIPooling",
     [np.broadcast_to(np.arange(18, dtype=np.float32)[None, :, None, None],
                      (1, 18, 12, 12)).copy(),
      np.array([[0, 0, 0, 11, 11]], np.float32)],
     {"spatial_scale": 1.0, "output_dim": 2, "pooled_size": 3}, (0,)),
    ("deformable_psroi_zero_trans", "_contrib_DeformablePSROIPooling",
     [_f32(1, 8, 8, 8, seed=6), _ROIS, np.zeros((2, 2, 2, 2), np.float32)],
     {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 2,
      "trans_std": 0.1}, (0, 2)),
    ("deformable_psroi_per_roi", "DeformablePSROIPooling",
     [_f32(1, 4, 8, 8, seed=7), np.array([[0, 1, 1, 6, 6], [0, 1, 1, 6, 6]],
                                         np.float32),
      np.concatenate([np.zeros((1, 2, 2, 2)), np.full((1, 2, 2, 2), 0.5)]
                     ).astype(np.float32)],
     {"spatial_scale": 1.0, "output_dim": 1, "pooled_size": 2,
      "trans_std": 0.5}, (0, 2)),
    ("deformable_psroi_no_trans", "_contrib_DeformablePSROIPooling",
     [_f32(1, 8, 8, 8, seed=8), _ROIS],
     {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 2,
      "no_trans": True, "sample_per_part": 3}, (0,)),
    ("deformable_conv", "_contrib_DeformableConvolution",
     [_f32(1, 2, 5, 5, seed=8), _f32(1, 8, 4, 4, seed=9, scale=0.1),
      _f32(3, 2, 2, 2, seed=10)],
     {"kernel": (2, 2), "num_filter": 3, "no_bias": True}, (0, 1, 2)),
    ("deformable_conv_groups_stride", "DeformableConvolution",
     [_f32(1, 4, 5, 5, seed=11), _f32(1, 2 * 2 * 4, 3, 3, seed=12,
                                      scale=0.7),
      _f32(4, 2, 2, 2, seed=13), _f32(4, seed=14)],
     {"kernel": (2, 2), "stride": (2, 2), "pad": (1, 1), "num_filter": 4,
      "num_group": 2, "num_deformable_group": 2, "dilate": (1, 1)},
     (0, 1, 2, 3)),
]


@pytest.mark.parametrize("name,inputs,attrs,wrt",
                         [c[1:] for c in GATHER_CASES],
                         ids=[c[0] for c in GATHER_CASES])
def test_gather_op_matches_jax(name, inputs, attrs, wrt):
    jop, top = jreg.get_op(name), treg.get_op(name)
    ja, ta = jreg.canon_attrs(jop, attrs), treg.canon_attrs(top, attrs)
    jx = [jnp.asarray(x) for x in inputs]

    # jitted over every input: jit would fold constant inputs with XLA's
    # own arithmetic, not the op's
    op_jit = jax.jit(functools.partial(jop.fn, **ja))

    def jfn(*d):
        xs = list(jx)
        for i, v in zip(wrt, d):
            xs[i] = v
        return op_jit(*xs)
    jo, vjp = jax.vjp(jfn, *[jx[i] for i in wrt])
    cot = _f32(*jo.shape, seed=21)
    jg = vjp(jnp.asarray(cot))
    tx = [torch.from_numpy(x.copy()) for x in inputs]
    for i in wrt:
        tx[i].requires_grad_()
    to = top.fn(*tx, **ta)
    tg = torch.autograd.grad(to, [tx[i] for i in wrt], torch.from_numpy(cot))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               **FWD_TOL)
    for i, t, j in zip(wrt, tg, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=str(i),
                                   **GRAD_TOL)


def test_psroi_group_channel_selection():
    """Bin (i, j) of output channel c reads input channel c*G*G + i*G + j
    (tests/test_rcnn_contrib_ops.py)."""
    _n, name, inputs, attrs, _w = GATHER_CASES[0]
    out = _run(treg, torch.from_numpy, name, inputs, attrs)[0]
    want = np.arange(18, dtype=np.float32).reshape(1, 2, 3, 3)
    np.testing.assert_allclose(out, want, atol=1e-4)


def test_deformable_conv_zero_offset_is_convolution():
    data, weight, bias = _f32(2, 4, 7, 7, seed=7), _f32(6, 4, 3, 3, seed=8), \
        _f32(6, seed=9)
    attrs = {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6}
    out = _run(treg, torch.from_numpy, "_contrib_DeformableConvolution",
               [data, np.zeros((2, 18, 7, 7), np.float32), weight, bias],
               attrs)[0]
    ref = _run(treg, torch.from_numpy, "Convolution", [data, weight, bias],
               attrs)[0]
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_deformable_conv_integer_offset_shifts():
    data = np.zeros((1, 1, 5, 5), np.float32)
    data[0, 0, 2, 3] = 1.0
    offset = np.zeros((1, 2, 5, 5), np.float32)
    offset[0, 1] = 1.0                  # dx = +1: a 1x1 kernel reads x+1
    out = _run(treg, torch.from_numpy, "_contrib_DeformableConvolution",
               [data, offset, np.ones((1, 1, 1, 1), np.float32)],
               {"kernel": (1, 1), "num_filter": 1, "no_bias": True})[0]
    assert out[0, 0, 2, 2] == 1.0 and out[0, 0, 2, 3] == 0.0


def test_deformable_shape_hooks():
    """The deformable ops' arguments and inferred parameter shapes, as the
    JAX package's hooks give them."""
    for mx in (jmx, tmx):
        conv = mx.sym.contrib.DeformableConvolution(
            mx.sym.Variable("data"), mx.sym.Variable("offset"),
            kernel=(3, 3), num_filter=8, num_group=2, name="dc")
        args, _, _ = conv.infer_shape(data=(1, 4, 9, 9),
                                      offset=(1, 18, 7, 7))
        assert conv.list_arguments() == ["data", "offset", "dc_weight",
                                         "dc_bias"]
        assert args[2:] == [(8, 2, 3, 3), (8,)]
        pool = mx.sym.contrib.DeformablePSROIPooling(
            mx.sym.Variable("data"), mx.sym.Variable("rois"),
            no_trans=True, output_dim=2, pooled_size=2)
        assert pool.list_arguments() == ["data", "rois"]


# ---------------------------------------------------------------------------
# examples/rcnn_train.py's Faster R-CNN, one Module step in each package
# ---------------------------------------------------------------------------

def _rcnn_step(mx, kw, params, X, info, gt, to_nd):
    seen = cs.rcnn_register(mx)
    B, im = cs.RCNN["batch"], cs.RCNN["image"]
    mod = mx.mod.Module(cs.faster_rcnn_symbol(mx),
                        data_names=("data", "im_info"),
                        label_names=("gt_boxes",), **kw)
    mod.bind(data_shapes=[("data", (B, 3, im, im)), ("im_info", (B, 3))],
             label_shapes=[("gt_boxes", (B, 5))])
    mod.init_params(arg_params={k: to_nd(v) for k, v in params.items()},
                    aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": cs.RCNN["lr"], "momentum": 0.9,
        "rescale_grad": 1.0 / B})
    mod.forward(mx.io.DataBatch([to_nd(X), to_nd(info)], [to_nd(gt)]),
                is_train=True)
    outs = [np.asarray(o.asnumpy()) for o in mod.get_outputs()]
    mod.backward()
    mod.update()
    return outs, {k: np.asarray(v.asnumpy())
                  for k, v in mod.get_params()[0].items()}, seen


def test_faster_rcnn_step_matches_jax():
    B, im = cs.RCNN["batch"], cs.RCNN["image"]
    with tmx.cpu():
        cs.rcnn_register(tmx)
        params = cs.rcnn_params(tmx, cs.faster_rcnn_symbol(tmx), seed=0)
    X, gt = cs.rcnn_dataset(B, seed=0)
    info = np.tile(np.array([im, im, 1.0], np.float32), (B, 1))
    jo, jp, _ = _rcnn_step(jmx, {}, params, X, info, gt, jmx.nd.array)
    to, tp, seen = _rcnn_step(tmx, {"context": tmx.cpu()}, params, X, info,
                              gt, lambda v: tmx.nd.array(v, ctx=tmx.cpu()))
    assert set(seen) == {"cpu(0)"} and len(seen) == 2
    np.testing.assert_array_equal(to[5], jo[5])        # the head's labels
    assert (to[5] > 0).any()
    for i, (t, j) in enumerate(zip(to, jo)):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5,
                                   err_msg="output %d" % i)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
