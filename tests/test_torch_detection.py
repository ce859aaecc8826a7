"""The port's detection ops and NMS against the JAX package's, on the CPU.

* IoU: the port's ``_box_iou_corner`` equals JAX's run eagerly, bit for
  bit (eager jnp, numpy and torch round each f32 operation alike); under
  ``jax.jit`` XLA's own lowering differs in the last places (up to 4 ulps
  of a small value, 2e-7 at most), so there it is held within 2e-7
  (ROADMAP Queue C item 3).
* NMS: the kernel's plain version ``_nms_reference`` against the JAX
  ``nms_keep`` (its Pallas kernel in interpret mode, jitted) at A = 7,
  300 and 8732 with ``force_suppress`` both ways: keep masks equal. Each
  case first asserts, in numpy, that no pair's IoU lies within 8 ulps
  (2.4e-7 at 0.45) of the threshold, wider than the jit's deviation, so
  the jit's rounding cannot decide a pair.
* MultiBoxDetection: the port's ``auto``, ``pallas`` and ``xla`` routes
  against the JAX op's ``pallas`` and ``xla`` routes on identical
  ``cls_prob`` / ``loc_pred`` / anchors, within rtol = atol = 1e-6 (as
  ``tests/test_detection_ops.py`` holds the two JAX routes), across
  ``nms_topk``, ``background_id``, ``threshold``, ``nms_threshold = 0``
  and ``force_suppress``; bf16 heads against the JAX op run eagerly:
  boxes within 1e-2, class ids and the kept rows equal (under jit, XLA
  keeps bf16 intermediates of the box decode in f32, see Queue C 3).
* The routes' rules: meta tensors give (B, A, 6) without NMS,
  ``MXNET_NMS_IMPL`` picks the route of ``impl="auto"``, and an unknown
  route raises.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import detection_ops as jdet
from mxnet_tpu.ops import nms_pallas as jnms
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch  # noqa: F401  (populates the port's registry)
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.ops import detection_ops as tdet
from mxnet_tpu_torch.ops import nms_kernels as tnms
from mxnet_tpu_torch.ops import registry as treg

THR = 0.45


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these cases are many small eager ops, and the
    suite runs beside other workers on the same cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _boxes(n, rng, scale=0.3):
    xy = rng.rand(n, 2).astype(np.float32)
    return np.concatenate([xy, xy + rng.rand(n, 2).astype(np.float32)
                           * scale], 1)


def _iou_np(a, b):
    """The f32 IoU in numpy, rounded as the sources write it."""
    ax1, ay1, ax2, ay2 = (a[:, i, None] for i in range(4))
    bx1, by1, bx2, by2 = (b[None, :, i] for i in range(4))
    z = np.float32(0)
    iw = np.maximum(z, np.minimum(ax2, bx2) - np.maximum(ax1, bx1))
    ih = np.maximum(z, np.minimum(ay2, by2) - np.maximum(ay1, by1))
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union <= 0, z,
                        inter / np.maximum(union, np.float32(1e-12)))


def _assert_margin(boxes, thr, chunk=1024):
    """No pair of ``boxes`` (A, 4) has an IoU within 8 ulps of ``thr``."""
    t = np.float32(thr)
    margin = 8 * np.spacing(t)
    for s in range(0, len(boxes), chunk):
        iou = _iou_np(boxes[s:s + chunk], boxes)
        assert not (np.abs(iou - t) <= margin).any(), \
            "a pair's IoU lies within 8 ulps of the threshold: pick " \
            "another seed"


def test_iou_equals_eager_jax_and_is_close_to_jit():
    rng = np.random.RandomState(0)
    a, b = _boxes(600, rng), _boxes(500, rng)
    a[:5, 2:] = a[:5, :2]                    # zero-area boxes
    a[5:10] = a[5:10, [2, 3, 0, 1]]          # inverted boxes
    port = tnms._box_iou_corner(torch.from_numpy(a),
                                torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(port, np.asarray(
        jdet._box_iou_corner(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(port, _iou_np(a, b))
    jit = np.asarray(jax.jit(jdet._box_iou_corner)(a, b))
    assert np.abs(jit - port).max() <= 2e-7
    # batched: (B, Na, 4) x (B, Nb, 4) -> (B, Na, Nb)
    two = tnms._box_iou_corner(torch.from_numpy(np.stack([a, a])),
                               torch.from_numpy(np.stack([b, b])))
    assert two.shape == (2, 600, 500)
    np.testing.assert_array_equal(two[1].numpy(), port)


@functools.lru_cache(maxsize=None)
def _nms_case(A, seed):
    """Boxes, classes and valid flags whose IoUs all clear the threshold's
    margin (checked once for both force_suppress cases)."""
    rng = np.random.RandomState(seed)
    boxes = _boxes(A, rng, scale=0.2)
    cls = rng.randint(0, 3, A).astype(np.float32)
    valid = rng.rand(A) < 0.9
    _assert_margin(boxes, THR)
    return boxes, cls, valid


@pytest.mark.parametrize("force", [False, True], ids=["class", "force"])
@pytest.mark.parametrize("A,seed", [(7, 0), (300, 1), (8732, 2)])
def test_nms_reference_equals_jax_nms_keep(A, seed, force):
    boxes, cls, valid = _nms_case(A, seed)
    want = np.asarray(jnms.nms_keep(jnp.asarray(boxes), jnp.asarray(cls),
                                    jnp.asarray(valid), THR, force))
    got = tnms._nms_reference(torch.from_numpy(boxes)[None],
                              torch.from_numpy(cls)[None],
                              torch.from_numpy(valid)[None], THR, force)
    assert got.dtype == torch.bool and got.shape == (1, A)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert 0 < want.sum() <= valid.sum()
    if A > 7:
        assert want.sum() < valid.sum()       # something was suppressed
    # the dispatcher takes the plain version for CPU tensors
    np.testing.assert_array_equal(tnms.nms_keep(
        torch.from_numpy(boxes)[None], torch.from_numpy(cls)[None],
        torch.from_numpy(valid)[None], THR, force)[0].numpy(), want)


@functools.lru_cache(maxsize=None)
def _nms_sparse_case(kind):
    """``scattered``: A = 384, 3 classes, valid rows at random places in
    the first and last 128-row blocks and none in the middle one (a block
    with no live row between two live ones); ``one_class``: A = 300, every
    row of class 0, 80% of the rows valid at random places."""
    rng = np.random.RandomState(11 if kind == "scattered" else 12)
    if kind == "scattered":
        A = 384
        cls = rng.randint(0, 3, A).astype(np.float32)
        valid = rng.rand(A) < 0.5
        valid[128:256] = False
    else:
        A = 300
        cls = np.zeros(A, np.float32)
        valid = rng.rand(A) < 0.8
    boxes = _boxes(A, rng, scale=0.5)
    _assert_margin(boxes, THR)
    return boxes, cls, valid


@pytest.mark.parametrize("force", [False, True], ids=["class", "force"])
@pytest.mark.parametrize("kind", ["scattered", "one_class"])
def test_nms_reference_equals_jax_nms_keep_sparse_valid(kind, force):
    """Valid flags that are not a prefix (a dead row block between live
    ones), and a single class (every pair tested by IoU): the plain
    version equals the JAX kernel (interpret mode) in both
    force_suppress modes, and keeps only valid rows."""
    boxes, cls, valid = _nms_sparse_case(kind)
    want = np.asarray(jnms.nms_keep(jnp.asarray(boxes), jnp.asarray(cls),
                                    jnp.asarray(valid), THR, force))
    got = tnms._nms_reference(torch.from_numpy(boxes)[None],
                              torch.from_numpy(cls)[None],
                              torch.from_numpy(valid)[None], THR, force)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert not (want & ~valid).any()
    assert 0 < want.sum() < valid.sum()       # something was suppressed


def test_nms_reference_batch_equals_images_alone():
    rng = np.random.RandomState(5)
    boxes = np.stack([_boxes(200, rng) for _ in range(3)])
    cls = rng.randint(0, 2, (3, 200)).astype(np.float32)
    valid = rng.rand(3, 200) < 0.8
    batch = tnms._nms_reference(torch.from_numpy(boxes),
                                torch.from_numpy(cls),
                                torch.from_numpy(valid), THR)
    for b in range(3):
        alone = tnms._nms_reference(torch.from_numpy(boxes[b:b + 1]),
                                    torch.from_numpy(cls[b:b + 1]),
                                    torch.from_numpy(valid[b:b + 1]), THR)
        assert torch.equal(batch[b], alone[0])


def test_nms_edge_cases():
    """IoU exactly at the threshold suppresses; identical boxes keep the
    first of each class; no valid row keeps nothing; degenerate boxes
    (union <= 0) suppress nothing."""
    keep = tnms._nms_reference(
        torch.tensor([[[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 0.5]]]),
        torch.zeros((1, 2)), torch.ones((1, 2), dtype=torch.bool), 0.5)
    assert keep.tolist() == [[True, False]]
    same = torch.tensor([0.1, 0.2, 0.5, 0.6]).expand(1, 6, 4)
    cls = torch.tensor([[0.0, 1.0, 0.0, 1.0, 2.0, 0.0]])
    ones = torch.ones((1, 6), dtype=torch.bool)
    assert tnms._nms_reference(same, cls, ones, THR).tolist() == \
        [[True, True, False, False, True, False]]
    assert tnms._nms_reference(same, cls, ones, THR, True).tolist() == \
        [[True] + [False] * 5]
    assert not tnms._nms_reference(same, cls, ~ones, THR).any()
    flat = torch.zeros((1, 6, 4))
    assert tnms._nms_reference(flat, cls * 0, ones, THR).all()


def _heads(B, C, A, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    cls_prob = rng.rand(B, C, A).astype(np.float32)
    cls_prob /= cls_prob.sum(1, keepdims=True)
    loc = (rng.rand(B, A * 4).astype(np.float32) - 0.5) * 0.4
    xy = rng.rand(1, A, 2).astype(np.float32)
    anchor = np.concatenate(
        [xy, xy + rng.rand(1, A, 2).astype(np.float32) * 0.3], 2)
    return cls_prob.astype(dtype), loc.astype(dtype), anchor


def _margin_for(cls_prob, loc, anchor, attrs):
    """The IoU margin over every pair of the rows NMS sees in each image:
    the valid rows in score order, cut to nms_topk."""
    if not 0 < attrs["nms_threshold"] <= 1:
        return
    B, C, A = cls_prob.shape
    boxes = tdet._decode_boxes(torch.from_numpy(anchor[0]),
                               torch.from_numpy(loc).reshape(B, A, 4),
                               attrs["variances"], attrs["clip"]).numpy()
    fg = np.arange(C) != attrs["background_id"]
    scores = cls_prob[:, fg].max(axis=1)
    for b in range(B):
        valid = scores[b] >= np.float32(attrs["threshold"])
        order = np.argsort(-np.where(valid, scores[b], -1), kind="stable")
        n = int(valid.sum())
        if attrs["nms_topk"] > 0:
            n = min(n, attrs["nms_topk"])
        _assert_margin(boxes[b, order[:n]], attrs["nms_threshold"])


DETECTION_CASES = [
    ("topk", 2, 4, 300, dict(nms_threshold=0.45, threshold=0.05,
                             nms_topk=200)),
    ("ssd_anchors_topk400", 2, 5, 8732, dict(nms_threshold=0.45,
                                              nms_topk=400)),
    ("background_id", 2, 4, 300, dict(nms_threshold=0.5, background_id=2,
                                      threshold=0.2)),
    ("no_nms", 2, 4, 300, dict(nms_threshold=0.0)),
    ("force_suppress", 2, 4, 300, dict(nms_threshold=0.45,
                                       force_suppress=True)),
    ("no_clip_high_threshold", 3, 3, 129, dict(nms_threshold=0.3,
                                               threshold=0.4,
                                               clip=False)),
]


@pytest.mark.parametrize("B,C,A,attrs", [c[1:] for c in DETECTION_CASES],
                         ids=[c[0] for c in DETECTION_CASES])
def test_multibox_detection_matches_jax_on_every_route(B, C, A, attrs):
    jop = jreg.get_op("_contrib_MultiBoxDetection")
    top = treg.get_op("_contrib_MultiBoxDetection")
    cls_prob, loc, anchor = _heads(B, C, A, seed=A + B)
    jattrs = jreg.canon_attrs(jop, attrs)
    _margin_for(cls_prob, loc, anchor, jattrs)
    want = {impl: np.asarray(jop.fn(jnp.asarray(cls_prob), jnp.asarray(loc),
                                    jnp.asarray(anchor),
                                    **{**jattrs, "impl": impl}))
            for impl in ("pallas", "xla")}
    np.testing.assert_array_equal(want["pallas"], want["xla"])
    assert (want["xla"][..., 0] >= 0).any()
    for impl in ("auto", "pallas", "xla"):
        got = top.fn(torch.from_numpy(cls_prob), torch.from_numpy(loc),
                     torch.from_numpy(anchor),
                     **treg.canon_attrs(top, {**attrs, "impl": impl}))
        assert got.dtype == torch.float32 and got.shape == (B, A, 6)
        for ref in want.values():
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                       atol=1e-6, err_msg=impl)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_multibox_detection_bf16_matches_eager_jax(impl):
    jop = jreg.get_op("_contrib_MultiBoxDetection")
    top = treg.get_op("_contrib_MultiBoxDetection")
    cls_prob, loc, anchor = _heads(2, 5, 8732, seed=3)
    attrs = dict(nms_threshold=0.45, nms_topk=400, impl=impl)
    want = jop.fn(jnp.asarray(cls_prob, jnp.bfloat16),
                  jnp.asarray(loc, jnp.bfloat16), jnp.asarray(anchor),
                  **jreg.canon_attrs(jop, attrs))
    got = top.fn(torch.from_numpy(cls_prob).bfloat16(),
                 torch.from_numpy(loc).bfloat16(), torch.from_numpy(anchor),
                 **treg.canon_attrs(top, attrs))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                               atol=1e-2)
    assert (want[..., 0] >= 0).sum() > 0


def test_multibox_detection_meta_gives_shape_without_nms(monkeypatch):
    def no_nms(*a, **k):
        raise AssertionError("NMS ran on meta tensors")

    monkeypatch.setattr(tdet, "nms_keep", no_nms)
    monkeypatch.setattr(tdet, "_dense_keep", no_nms)
    top = treg.get_op("_contrib_MultiBoxDetection")
    out = top.fn(torch.empty((3, 4, 50), device="meta",
                             dtype=torch.bfloat16),
                 torch.empty((3, 200), device="meta", dtype=torch.bfloat16),
                 torch.empty((1, 50, 4), device="meta"),
                 **treg.canon_attrs(top, {"impl": "pallas"}))
    assert out.device.type == "meta" and out.shape == (3, 50, 6)
    assert out.dtype == torch.float32
    prior = treg.get_op("_contrib_MultiBoxPrior").fn(
        torch.empty((1, 8, 5, 5), device="meta"), sizes=(0.2,),
        ratios=(1.0, 2.0))
    assert prior.device.type == "meta" and prior.shape == (1, 50, 4)
    keep = tnms.nms_keep(torch.empty((2, 9, 4), device="meta"),
                         torch.empty((2, 9), device="meta"),
                         torch.empty((2, 9), device="meta",
                                     dtype=torch.bool), THR)
    assert keep.device.type == "meta" and keep.shape == (2, 9)


@pytest.mark.parametrize("knob,kernel_route", [
    (None, False), ("pallas", True), ("xla", False)])
def test_auto_route_reads_mxnet_nms_impl(monkeypatch, knob, kernel_route):
    """impl="auto" on CPU tensors: the dense path, unless MXNET_NMS_IMPL
    asks for the kernel route (its plain version here)."""
    calls = []

    def counting(*a):
        calls.append(1)
        return tnms.nms_keep(*a)

    monkeypatch.setattr(tdet, "nms_keep", counting)
    top = treg.get_op("_contrib_MultiBoxDetection")
    cls_prob, loc, anchor = _heads(1, 3, 60, seed=9)
    try:
        tconfig.set_override("MXNET_NMS_IMPL", knob)
        got = top.fn(torch.from_numpy(cls_prob), torch.from_numpy(loc),
                     torch.from_numpy(anchor),
                     **treg.canon_attrs(top, {"nms_threshold": 0.45}))
    finally:
        tconfig.set_override("MXNET_NMS_IMPL", None)
    assert bool(calls) == kernel_route
    want = top.fn(torch.from_numpy(cls_prob), torch.from_numpy(loc),
                  torch.from_numpy(anchor), **treg.canon_attrs(
                      top, {"nms_threshold": 0.45, "impl": "xla"}))
    assert torch.equal(got, want)


def test_unknown_route_raises():
    top = treg.get_op("_contrib_MultiBoxDetection")
    cls_prob, loc, anchor = _heads(1, 3, 20, seed=4)
    with pytest.raises(ValueError, match="impl must be"):
        top.fn(torch.from_numpy(cls_prob), torch.from_numpy(loc),
               torch.from_numpy(anchor),
               **treg.canon_attrs(top, {"impl": "cuda"}))
