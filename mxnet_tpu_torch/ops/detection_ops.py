"""SSD detection ops ported so far — ``MultiBoxPrior`` and
``MultiBoxDetection`` — with the semantics of
``mxnet_tpu/ops/detection_ops.py`` (reference:
src/operator/contrib/multibox_prior.cc:35-71,
src/operator/contrib/multibox_detection.cc:44-168). ``MultiBoxTarget``
and ``ROIPooling`` wait for the SSD training slice (ROADMAP Queue A
item 10).

Anchors are built with numpy on the host exactly as the JAX package
builds them. ``MultiBoxDetection`` writes the batch out where JAX vmaps
one image, and keeps that op's rules: the best non-background class with
``background_id`` renumbered, ``valid = score >= threshold``, a stable
sort by score (``jnp.argsort`` is stable), invalid rows set to -1, the
``nms_topk`` cut before NMS, NMS only when ``0 < nms_threshold <= 1``,
and class-aware suppression unless ``force_suppress``. A Python scalar
meets a tensor in the tensor's dtype, as a weakly typed scalar does in
jnp: bf16 scores compare with the bf16-rounded threshold, and bf16
location offsets scale by bf16 variances.

NMS routes (``impl``, the JAX op's attribute values, so symbol JSON
loads in either package): ``"pallas"`` is the kernel route
(``ops/nms_kernels.py``: the hand-written CUDA kernel on CUDA tensors,
its plain version on the CPU); ``"xla"`` the dense path in plain torch
(the IoU matrix and the sequential loop); ``"auto"`` (default) reads
``MXNET_NMS_IMPL`` at call time, else takes the kernel route on CUDA
tensors and the dense path on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config as _config
from .nms_kernels import _box_iou_corner, nms_keep
from .registry import register


def _weak(x, value):
    """A Python scalar as jnp takes it against ``x``: in x's dtype."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------

@register("_contrib_MultiBoxPrior", arg_names=("data",),
          differentiable=False,
          aliases=("MultiBoxPrior", "_contrib_multibox_prior"),
          defaults={"sizes": (1.0,), "ratios": (1.0,), "clip": False,
                    "steps": (-1.0, -1.0), "offsets": (0.5, 0.5)})
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5), **_):
    """Anchors from a feature map: (1, H*W*num_anchors, 4) corner boxes in
    [0,1] image coordinates; num_anchors = len(sizes)-1+len(ratios). On
    the data's device (a meta tensor for meta data)."""
    h, w = data.shape[2], data.shape[3]
    sizes = np.atleast_1d(np.asarray(sizes, np.float32))
    ratios = np.atleast_1d(np.asarray(ratios, np.float32))
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w

    cy = (np.arange(h, dtype=np.float32) + offsets[0]) * step_y
    cx = (np.arange(w, dtype=np.float32) + offsets[1]) * step_x

    # per-location half-extents, reference order: all sizes at ratio 1,
    # then ratios[1:] at sizes[0]
    ws, hs = [], []
    for s in sizes:
        ws.append(s * h / w / 2.0)
        hs.append(s / 2.0)
    for r in ratios[1:]:
        sr = np.sqrt(r)
        ws.append(sizes[0] * h / w * sr / 2.0)
        hs.append(sizes[0] / sr / 2.0)
    ws = np.asarray(ws, np.float32)     # (K,)
    hs = np.asarray(hs, np.float32)

    cyg, cxg = np.meshgrid(cy, cx, indexing="ij")     # (h, w)
    cxg = cxg[:, :, None]
    cyg = cyg[:, :, None]
    boxes = np.stack([cxg - ws, cyg - hs, cxg + ws, cyg + hs],
                     axis=-1)                         # (h, w, K, 4)
    boxes = boxes.reshape(1, -1, 4)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    return torch.from_numpy(np.ascontiguousarray(boxes)).to(data.device)


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------

def _decode_boxes(anchors, loc_pred, variances, clip):
    """TransformLocations (multibox_detection.cc:44-70). anchors (A,4),
    loc_pred (B,A,4) -> corner boxes (B,A,4)."""
    vx, vy, vw, vh = (_weak(loc_pred, v) for v in variances)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * _weak(anchors, 0.5)
    ay = (anchors[:, 1] + anchors[:, 3]) * _weak(anchors, 0.5)
    ox = loc_pred[..., 0] * vx * aw + ax
    oy = loc_pred[..., 1] * vy * ah + ay
    ow = torch.exp(loc_pred[..., 2] * vw) * aw
    ow = ow * _weak(ow, 0.5)
    oh = torch.exp(loc_pred[..., 3] * vh) * ah
    oh = oh * _weak(oh, 0.5)
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


def _dense_keep(boxes, cls_ids, valid, nms_threshold, force_suppress):
    """The dense path (detection_ops.py:300-311), one image at a time: the
    IoU of every row that can suppress (those up to the last valid row)
    against every row, then the sequential loop in row order, each live
    row clearing the later rows it suppresses."""
    B, A = valid.shape
    keep = valid.clone()
    idx = torch.arange(A, device=valid.device)
    for b in range(B):
        n = int(torch.where(valid[b], idx + 1, 0).max())
        if n == 0:
            continue
        iou = _box_iou_corner(boxes[b, :n], boxes[b])          # (n, A)
        sup = iou >= _weak(iou, nms_threshold)
        del iou
        if not force_suppress:
            sup &= cls_ids[b, :n, None] == cls_ids[b, None, :]
        kb = keep[b]
        for i in range(n):
            # no host sync: a dead or invalid row clears nothing
            kb[i + 1:] &= ~(sup[i, i + 1:] & (kb[i] & valid[b, i]))
    return keep


@register("_contrib_MultiBoxDetection",
          arg_names=("cls_prob", "loc_pred", "anchor"),
          differentiable=False,
          aliases=("MultiBoxDetection", "_contrib_multibox_detection"),
          defaults={"clip": True, "threshold": 0.01, "background_id": 0,
                    "nms_threshold": 0.5, "force_suppress": False,
                    "variances": (0.1, 0.1, 0.2, 0.2), "nms_topk": -1,
                    "impl": "auto"})
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0,
                        nms_threshold=0.5, force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1,
                        impl="auto", **_):
    """cls_prob (B,C,A), loc_pred (B,A*4), anchor (1,A,4) -> (B,A,6) rows
    [class_id, score, x1, y1, x2, y2], invalid rows -1. Output ids
    renumber foreground classes with background_id skipped."""
    B, C, A = cls_prob.shape
    out_dtype = torch.promote_types(
        cls_prob.dtype, torch.promote_types(loc_pred.dtype, anchor.dtype))
    if cls_prob.device.type == "meta":
        # shape inference: the (B, A, 6) rows, without running NMS
        return torch.empty((B, A, 6), dtype=out_dtype, device="meta")
    dev = cls_prob.device
    anchors = anchor.reshape(-1, 4)
    fg = (torch.arange(C, device=dev) != background_id)[None, :, None]
    masked = torch.where(fg, cls_prob, _weak(cls_prob, float("-inf")))
    scores = torch.amax(masked, dim=1)                      # best non-bg
    ids = torch.argmax(masked, dim=1)                       # first maximum
    out_ids = torch.where(ids > background_id, ids - 1, ids)
    valid = scores >= _weak(scores, threshold)

    boxes = _decode_boxes(anchors, loc_pred.reshape(B, A, 4), variances,
                          clip)
    # sort: valid-by-score first (stable, score descending)
    key = torch.where(valid, scores, _weak(scores, -1.0))
    order = torch.argsort(-key, dim=1, stable=True)
    s_valid = torch.gather(valid, 1, order)
    s_rows = torch.cat(
        [torch.gather(out_ids, 1, order).to(cls_prob.dtype)[..., None]
         .to(out_dtype),
         torch.gather(scores, 1, order)[..., None].to(out_dtype),
         torch.gather(boxes, 1, order[..., None].expand(B, A, 4))
         .to(out_dtype)], dim=2)
    fill = _weak(s_rows, -1.0)
    s_rows = torch.where(s_valid[..., None], s_rows, fill)

    if nms_topk > 0:
        s_valid = s_valid & (torch.arange(A, device=dev) < nms_topk)
        s_rows = torch.where(s_valid[..., None], s_rows, fill)

    if not (0 < nms_threshold <= 1):
        return s_rows

    if impl == "auto":
        impl = _config.get("MXNET_NMS_IMPL") or (
            "pallas" if dev.type == "cuda" else "xla")
    if impl == "pallas":
        # the kernel route (ops/nms_kernels.py): one launch for the batch
        keep = nms_keep(s_rows[..., 2:6].float(), s_rows[..., 0].float(),
                        s_valid, nms_threshold, force_suppress)
    elif impl == "xla":
        keep = _dense_keep(s_rows[..., 2:6], s_rows[..., 0], s_valid,
                           nms_threshold, force_suppress)
    else:
        raise ValueError("MultiBoxDetection: impl must be auto, pallas or "
                         "xla, got %r" % (impl,))
    return torch.where((keep & s_valid)[..., None], s_rows, fill)
