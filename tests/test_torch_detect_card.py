"""The detection-training slice's ops on the card against the port's CPU,
without the JAX package: importable where only PyTorch is installed, as
on the card's machine, where

    python -m pytest --noconftest tests/test_torch_detect_card.py

runs every case. The tests are marked ``cuda`` and skip on machines
without a card (the CPU routes are held to the JAX package in
``tests/test_torch_multibox_target.py``, ``test_torch_rcnn.py``,
``test_torch_custom_op.py`` and ``test_torch_warp_linalg.py``).

* MultiBoxTarget at SSD300's 8732 anchors: the targets equal the CPU's
  exactly (the IoUs, the argmaxes and the stable sort are the same
  arithmetic on the same inputs), loc targets within 1e-6.
* ROIPooling: forward equal, gradient within rtol 1e-5 / atol 1e-6, and
  two card runs' gradients equal bit for bit (the shares are added by
  the fixed-order segment sum, ROADMAP Queue C 21).
* Proposal: scores equal to the CPU's, rois within rtol 1e-6 / atol 1e-4
  (exp rounds in the last bit on one device); the fixed-point walk's
  keep mask equal to the sequential loop's flag for flag.
* The R-CNN gathers, warp ops, linalg, fft, count_sketch and quantize
  within rtol 1e-5 / atol 1e-5 (cuBLAS, cuSOLVER, cuFFT and atomics sum
  in other orders); gelqf by L.Q = A and Q.Q^T = I within 1e-5.
* A Custom op's forward and backward run with NDArrays on the card.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import rcnn_ops
from mxnet_tpu_torch.ops.registry import canon_attrs, get_op

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CPU routes are tested "
                    "against the JAX package)")
    return torch.device("cuda", 0)


def _both(name, inputs, attrs, device):
    op = get_op(name)
    a = canon_attrs(op, attrs)
    outs = []
    for dev in (device, torch.device("cpu")):
        o = op.fn(*[torch.from_numpy(x).to(dev) for x in inputs], **a)
        outs.append([t.cpu() for t in (o if isinstance(o, (tuple, list))
                                       else [o])])
    return outs


def _f(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


@pytest.mark.cuda
def test_multibox_target_card_equals_cpu(cuda_device):
    rs = np.random.RandomState(0)
    A, B, L = 8732, 4, 12
    xy = rs.uniform(0, 0.9, (1, A, 2))
    anchors = np.concatenate([xy, xy + rs.uniform(0.02, 0.3, (1, A, 2))],
                             -1).astype(np.float32)
    labels = -np.ones((B, L, 6), np.float32)
    for b in range(B):
        for k in range(1 + b * 2):
            w, h = rs.uniform(0.1, 0.6, 2)
            x, y = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            labels[b, k] = (rs.randint(0, 20), x, y, x + w, y + h, 0)
    logits = _f(rs, B, 21, A)
    card, cpu = _both("_contrib_MultiBoxTarget", [anchors, labels, logits],
                      {"negative_mining_ratio": 3.0}, cuda_device)
    np.testing.assert_array_equal(card[2].numpy(), cpu[2].numpy())
    np.testing.assert_array_equal(card[1].numpy(), cpu[1].numpy())
    np.testing.assert_allclose(card[0].numpy(), cpu[0].numpy(), rtol=1e-6,
                               atol=1e-6)
    assert (card[2] > 0).sum() > 0 and (card[2] == 0).sum() > 0


@pytest.mark.cuda
def test_roi_pooling_card_equals_cpu(cuda_device):
    rs = np.random.RandomState(1)
    data = np.maximum(np.round(_f(rs, 2, 16, 19, 31) * 2), 0)
    R = 40
    xy = rs.uniform(0, [480, 300], (R, 2))
    rois = np.concatenate([rs.randint(0, 2, (R, 1)), xy, xy + rs.uniform(
        8, 200, (R, 2))], 1).astype(np.float32)
    dy = _f(rs, R, 16, 7, 7)
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        x = torch.from_numpy(data).to(dev).requires_grad_()
        y = get_op("ROIPooling").fn(x, torch.from_numpy(rois).to(dev),
                                    pooled_size=(7, 7),
                                    spatial_scale=1.0 / 16)
        g, = torch.autograd.grad(y, x, torch.from_numpy(dy).to(dev))
        res.append((y.detach().cpu().numpy(), g.cpu().numpy()))
    np.testing.assert_array_equal(res[0][0], res[1][0])
    np.testing.assert_allclose(res[0][1], res[1][1], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("rois_n", [40, 300])
def test_roi_pooling_card_gradient_is_deterministic(cuda_device, rois_n):
    """Overlapping rois add into the same map positions: two card runs
    give the same gradient bits (Queue C 21)."""
    rs = np.random.RandomState(2)
    data = np.maximum(_f(rs, 1, 64, 38, 63), 0)
    xy = rs.uniform(0, [1000, 600], (rois_n, 2))
    rois = np.concatenate([np.zeros((rois_n, 1)), xy, np.minimum(
        xy + rs.uniform(16, 400, (rois_n, 2)), [999, 599])], 1).astype(
        np.float32)
    dy = torch.from_numpy(_f(rs, rois_n, 64, 7, 7)).to(cuda_device)
    grads = []
    for _ in range(2):
        x = torch.from_numpy(data).to(cuda_device).requires_grad_()
        y = get_op("ROIPooling").fn(x, torch.from_numpy(rois).to(
            cuda_device), pooled_size=(7, 7), spatial_scale=1.0 / 16)
        grads.append(torch.autograd.grad(y, x, dy)[0])
    assert torch.equal(grads[0], grads[1])
    assert int((grads[0] != 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pre,post", [(600, 100), (2000, 300)])
def test_proposal_card_equals_cpu(cuda_device, pre, post):
    rs = np.random.RandomState(2)
    A, H, W = 9, 19, 31
    fg = rs.uniform(0, 1, (1, A, H, W)).astype(np.float32)
    prob = np.concatenate([1 - fg, fg], 1)
    deltas = (_f(rs, 1, 4 * A, H, W) * 0.1).astype(np.float32)
    info = np.array([[H * 16, W * 16, 1.0]], np.float32)
    attrs = {"rpn_pre_nms_top_n": pre, "rpn_post_nms_top_n": post,
             "scales": (8, 16, 32), "output_score": True}
    card, cpu = _both("_contrib_Proposal", [prob, deltas, info], attrs,
                      cuda_device)
    # torch.exp rounds in its last bit on one device and not the other
    np.testing.assert_allclose(card[0].numpy(), cpu[0].numpy(), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_array_equal(card[1].numpy(), cpu[1].numpy())
    boxes, score = rcnn_ops._candidates(
        *[torch.from_numpy(a).to(cuda_device) for a in (prob, deltas, info)],
        pre, 16, (8, 16, 32), (0.5, 1, 2), 16)
    sup = rcnn_ops._suppression(boxes, 0.7)
    valid = score > float("-inf")
    keep, _ = rcnn_ops._sweep_keep(sup, valid)
    assert torch.equal(keep, rcnn_ops._dense_keep(sup, valid))


def _cases():
    rs = np.random.RandomState(3)
    spd = _f(rs, 5, 5)
    spd = spd @ spd.T + 5 * np.eye(5, dtype=np.float32)
    tri = np.tril(_f(rs, 5, 5)) + 3 * np.eye(5, dtype=np.float32)
    lo, hi = np.array([-1.5], np.float32), np.array([2.0], np.float32)
    rois = np.array([[0, 1, 1, 20, 18], [1, 4, 2, 12, 30]], np.float32)
    return [
        ("psroi", "_contrib_PSROIPooling", [_f(rs, 2, 18, 8, 8), rois],
         {"spatial_scale": 0.25, "output_dim": 2, "pooled_size": 3}),
        ("deformable_psroi", "_contrib_DeformablePSROIPooling",
         [_f(rs, 2, 8, 8, 8), rois, _f(rs, 2, 2, 2, 2)],
         {"spatial_scale": 0.25, "output_dim": 2, "pooled_size": 2,
          "sample_per_part": 2, "trans_std": 0.1}),
        ("deformable_conv", "_contrib_DeformableConvolution",
         [_f(rs, 2, 4, 6, 6), _f(rs, 2, 36, 6, 6) * 0.7, _f(rs, 6, 2, 3, 3),
          _f(rs, 6)],
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6, "num_group": 2,
          "num_deformable_group": 2}),
        ("grid_affine", "GridGenerator", [_f(rs, 2, 6) * 0.3],
         {"transform_type": "affine", "target_shape": (6, 7)}),
        ("grid_warp", "GridGenerator", [_f(rs, 2, 2, 6, 7)],
         {"transform_type": "warp"}),
        ("bilinear", "BilinearSampler",
         [_f(rs, 2, 3, 8, 9), _f(rs, 2, 2, 6, 7) * 0.8], {}),
        ("spatial_transformer", "SpatialTransformer",
         [_f(rs, 2, 3, 8, 9), np.tile(np.array(
             [[0.9, 0.1, 0.05, -0.1, 0.8, 0.1]], np.float32), (2, 1))],
         {"target_shape": (6, 7)}),
        ("correlation", "Correlation", [_f(rs, 2, 4, 9, 10),
                                        _f(rs, 2, 4, 9, 10)],
         {"kernel_size": 3, "max_displacement": 2, "stride2": 2,
          "pad_size": 3}),
        ("gemm", "_linalg_gemm", [_f(rs, 2, 3, 4), _f(rs, 2, 4, 5),
                                  _f(rs, 2, 3, 5)], {"alpha": 0.5}),
        ("gemm2", "_linalg_gemm2", [_f(rs, 4, 3), _f(rs, 4, 5)],
         {"transpose_a": True}),
        ("potrf", "_linalg_potrf", [spd], {}),
        ("potri", "_linalg_potri", [tri], {}),
        ("trmm", "_linalg_trmm", [tri, _f(rs, 5, 3)], {"transpose": True}),
        ("trsm", "_linalg_trsm", [tri, _f(rs, 3, 5)], {"rightside": True}),
        ("syrk", "_linalg_syrk", [_f(rs, 3, 5)], {}),
        ("sumlogdiag", "_linalg_sumlogdiag", [tri], {}),
        ("khatri_rao", "khatri_rao", [_f(rs, 2, 3), _f(rs, 4, 3)], {}),
        ("fft", "_contrib_fft", [_f(rs, 4, 16)], {}),
        ("ifft", "_contrib_ifft", [_f(rs, 4, 32)], {}),
        ("count_sketch", "_contrib_count_sketch",
         [_f(rs, 6, 40), rs.randint(0, 12, (1, 40)).astype(np.float32),
          np.where(_f(rs, 1, 40) > 0, 1, -1).astype(np.float32)],
         {"out_dim": 12}),
        ("quantize", "_contrib_quantize", [_f(rs, 6, 7), lo, hi], {}),
        ("dequantize", "_contrib_dequantize",
         [rs.randint(0, 256, (6, 7)).astype(np.uint8), lo, hi], {}),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("name,inputs,attrs", [c[1:] for c in _cases()],
                         ids=[c[0] for c in _cases()])
def test_op_card_equals_cpu(cuda_device, name, inputs, attrs):
    card, cpu = _both(name, inputs, attrs, cuda_device)
    for c, h in zip(card, cpu):
        if c.dtype.is_floating_point:
            np.testing.assert_allclose(c.numpy(), h.numpy(), **TOL)
        else:
            np.testing.assert_array_equal(c.numpy(), h.numpy())


@pytest.mark.cuda
def test_gelqf_card_invariants(cuda_device):
    A = np.random.RandomState(4).standard_normal((3, 5)).astype(np.float32)
    q, l = (t.double().cpu() for t in get_op("_linalg_gelqf").fn(
        torch.from_numpy(A).to(cuda_device)))
    _q, cl = get_op("_linalg_gelqf").fn(torch.from_numpy(A))
    np.testing.assert_allclose((l @ q).numpy(), A, atol=1e-5)
    np.testing.assert_allclose((q @ q.T).numpy(), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(l.diagonal().abs().numpy(),
                               cl.diagonal().abs().double().numpy(),
                               atol=1e-5)


@pytest.mark.cuda
def test_custom_op_runs_on_the_card(cuda_device):
    seen = []

    class Scale(tmx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen.append(str(in_data[0].context))
            self.assign(out_data[0], req[0], in_data[0] * 3.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            seen.append(str(out_grad[0].context))
            self.assign(in_grad[0], req[0], out_grad[0] * 3.0)

    @tmx.operator.register("card_scale")
    class ScaleProp(tmx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Scale()

    with tmx.gpu(0):
        x = tmx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        x.attach_grad()
        with tmx.autograd.record():
            y = tmx.nd.Custom(x, op_type="card_scale")
            z = (y * y).sum()
        z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 18 * x.asnumpy())
    assert seen == ["gpu(0)", "gpu(0)"]
