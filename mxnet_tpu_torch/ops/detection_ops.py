"""SSD detection ops — ``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection`` — and ``ROIPooling``, with the semantics of
``mxnet_tpu/ops/detection_ops.py`` (reference:
src/operator/contrib/multibox_prior.cc:35-71,
src/operator/contrib/multibox_target.cc:30-280,
src/operator/contrib/multibox_detection.cc:44-168,
src/operator/roi_pooling.cc:40-110).

Anchors are built with numpy on the host exactly as the JAX package
builds them. ``MultiBoxTarget`` and ``MultiBoxDetection`` write the batch
out where JAX vmaps one image. ``MultiBoxTarget`` keeps the JAX op's
rules and runs without a host sync: the bipartite loop of L steps, each
an argmax over the image's anchor-major flattened (A, L) IoUs (torch's
argmax, like jnp's, returns the first maximum); the per-anchor best gt
above ``overlap_threshold``; hard negatives ranked by a stable sort
(``jnp.argsort`` is stable, and background probabilities tie); the x
offset divided by the anchor's width and the y offset by its height (the
reference's quirk); loc 0, mask 0 and class ``ignore_label`` for an
image without a valid gt. ``ROIPooling`` is a custom autograd Function
over each bin's gathered window, not the JAX formulation's (R, C, ph,
pw, H, W) mask; its backward splits a bin's gradient evenly over every
element equal to the bin's maximum, as the JAX max does (ReLU features
tie at 0), and an empty bin gives 0; the shares reach the map through
``ops/_segment.py``'s fixed-order segment sum, so the card's gradient is
the same bits run after run (ROADMAP Queue C 21).

``MultiBoxDetection`` keeps that op's rules: the best non-background
class with ``background_id`` renumbered, ``valid = score >= threshold``,
a stable sort by score (``jnp.argsort`` is stable), invalid rows -1, the
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
from ._segment import segment_sum
from .registry import register


def _weak(x, value):
    """A Python scalar as jnp takes it against ``x``: in x's dtype, filled
    on x's device (no copy from the host, so a CUDA graph can capture
    it)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


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
    the data's device (a meta tensor for meta data), built there with no
    copy from the host, so a CUDA graph can capture it: the per-anchor
    half-extents are float32 host scalars (numpy's arithmetic) filled in
    on the device, the centres float32 device arithmetic in numpy's
    order."""
    h, w = data.shape[2], data.shape[3]
    sizes = np.atleast_1d(np.asarray(sizes, np.float32))
    ratios = np.atleast_1d(np.asarray(ratios, np.float32))
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    dev, f32 = data.device, torch.float32

    cy = (torch.arange(h, dtype=f32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=f32, device=dev) + offsets[1]) * step_x

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
    ws, hs = (torch.stack([torch.full((), float(np.float32(v)), dtype=f32,
                                      device=dev) for v in vals])
              for vals in (ws, hs))                     # (K,)

    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")  # (h, w)
    cxg = cxg[:, :, None]
    cyg = cyg[:, :, None]
    boxes = torch.stack([cxg - ws, cyg - hs, cxg + ws, cyg + hs],
                        dim=-1)                       # (h, w, K, 4)
    boxes = boxes.reshape(1, -1, 4)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------

def _encode_loc(anchors, gt_boxes, variances):
    """(gx-ax)/aw/vx ... per multibox_target.cc:30-54. anchors (A,4),
    gt_boxes (B,A,4) matched per anchor -> (B,A,4)."""
    vx, vy, vw, vh = (_weak(gt_boxes, v) for v in variances)
    half, tiny = _weak(anchors, 0.5), _weak(anchors, 1e-12)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * half
    ay = (anchors[:, 1] + anchors[:, 3]) * half
    gw = gt_boxes[..., 2] - gt_boxes[..., 0]
    gh = gt_boxes[..., 3] - gt_boxes[..., 1]
    gx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * half
    gy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * half
    aw, ah = torch.maximum(aw, tiny), torch.maximum(ah, tiny)
    # reference quirk kept: x offset divides by aw, y offset by ah
    tx = (gx - ax) / aw / vx
    ty = (gy - ay) / ah / vy
    tw = torch.log(torch.maximum(gw / aw, tiny)) / vw
    th = torch.log(torch.maximum(gh / ah, tiny)) / vh
    return torch.stack([tx, ty, tw, th], dim=-1)


@register("_contrib_MultiBoxTarget",
          arg_names=("anchor", "label", "cls_pred"),
          differentiable=False, num_visible=3,
          aliases=("MultiBoxTarget", "_contrib_multibox_target"),
          defaults={"overlap_threshold": 0.5, "ignore_label": -1.0,
                    "negative_mining_ratio": -1.0,
                    "negative_mining_thresh": 0.5,
                    "minimum_negative_samples": 0,
                    "variances": (0.1, 0.1, 0.2, 0.2)})
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5,
                     minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2), **_):
    """anchor (1,A,4), label (B,L,W>=5), cls_pred (B,C,A) ->
    loc_target (B,A*4), loc_mask (B,A*4), cls_target (B,A)."""
    B, L = label.shape[0], label.shape[1]
    A = anchor.numel() // 4
    dt = torch.promote_types(anchor.dtype, label.dtype)
    if label.device.type == "meta":
        return (torch.empty((B, A * 4), dtype=dt, device="meta"),
                torch.empty((B, A * 4), dtype=dt, device="meta"),
                torch.empty((B, A), dtype=label.dtype, device="meta"))
    anchors = anchor.detach().reshape(-1, 4)
    label, cls_pred = label.detach(), cls_pred.detach()
    dev = label.device
    with torch.no_grad():
        # valid gt prefix: the first row whose class is < 0 ends it
        invalid = label[:, :, 0] < 0
        num_valid = torch.argmax(torch.cat(
            [invalid, invalid.new_ones((B, 1))], 1).to(torch.int32), dim=1)
        gt_valid = torch.arange(L, device=dev)[None, :] < num_valid[:, None]

        ious = _box_iou_corner(anchors, label[:, :, 1:5])      # (B, A, L)
        neg1 = _weak(ious, -1.0)
        ious = torch.where(gt_valid[:, None, :], ious, neg1)

        # phase 1: greedy bipartite matching, one gt a step
        match_iou = torch.full((B, A), -1.0, dtype=ious.dtype, device=dev)
        match_gt = torch.full((B, A), -1, dtype=torch.int64, device=dev)
        a_flag = torch.full((B, A), -1, dtype=torch.int32, device=dev)
        g_flag = torch.zeros((B, L), dtype=torch.bool, device=dev)
        rows = torch.arange(B, device=dev)
        one, eps = a_flag.new_ones(()), _weak(ious, 1e-6)
        for _step in range(L):
            masked = torch.where((a_flag != 1)[:, :, None] &
                                 ~g_flag[:, None, :], ious, neg1)
            flat = masked.reshape(B, -1)
            pick = torch.argmax(flat, dim=1)       # anchor-major, first max
            bi, bk = pick // L, pick % L
            best = flat.gather(1, pick[:, None])[:, 0]
            ok = best > eps
            match_iou[rows, bi] = torch.where(ok, best, match_iou[rows, bi])
            match_gt[rows, bi] = torch.where(ok, bk, match_gt[rows, bi])
            a_flag[rows, bi] = torch.where(ok, one, a_flag[rows, bi])
            g_flag[rows, bk] = g_flag[rows, bk] | ok

        # phase 2: per-anchor best gt; positive where iou > threshold
        best_gt = torch.argmax(ious, dim=2)
        best_iou = torch.amax(ious, dim=2)
        un = a_flag != 1
        take = un & (best_iou > neg1)
        match_iou = torch.where(take, best_iou, match_iou)
        match_gt = torch.where(take, best_gt, match_gt)
        if overlap_threshold > 0:
            pos2 = un & (best_iou > _weak(best_iou, overlap_threshold))
            a_flag = torch.where(pos2, one, a_flag)

        positive = a_flag == 1
        num_positive = positive.sum(1, dtype=torch.int32)
        if negative_mining_ratio > 0:
            # hard negatives: a stable ascending sort of the candidates'
            # background probability (jnp.argsort(-score))
            prob_bg = torch.softmax(cls_pred, dim=1)[:, 0]         # (B, A)
            cand = ~positive & (match_iou < _weak(
                match_iou, negative_mining_thresh))
            score = torch.where(cand, -prob_bg,
                                _weak(prob_bg, float("-inf")))
            order = torch.argsort(-score, dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(A, device=dev).expand(B, A))
            num_neg = torch.minimum(
                (num_positive.to(torch.float32) *
                 float(negative_mining_ratio)).to(torch.int32),
                A - num_positive)
            num_neg = torch.clamp_min(num_neg, int(minimum_negative_samples))
            negative = cand & (rank < num_neg[:, None])
            a_flag = torch.where(negative, a_flag.new_zeros(()), a_flag)
        else:
            a_flag = positive.to(torch.int32)

        # targets
        gt_rows = torch.gather(label, 1, match_gt.clamp_min(0)[..., None]
                               .expand(B, A, label.shape[2]))   # (B, A, W)
        cls_target = torch.full((B, A), float(ignore_label),
                                dtype=label.dtype, device=dev)
        cls_target = torch.where(a_flag == 0, _weak(cls_target, 0.0),
                                 cls_target)
        cls_target = torch.where(a_flag == 1, gt_rows[..., 0] + 1.0,
                                 cls_target)
        loc = _encode_loc(anchors, gt_rows[..., 1:5], variances)
        loc_mask = (a_flag == 1).to(dt)[..., None].expand(B, A, 4)
        loc_target = loc * loc_mask

        # no valid gt: everything stays at init (loc 0, mask 0, cls ignore)
        none = (num_valid == 0)[:, None]
        cls_target = torch.where(none, _weak(cls_target, float(ignore_label)),
                                 cls_target)
        loc_target = torch.where(none[..., None], _weak(loc_target, 0.0),
                                 loc_target)
        loc_mask = torch.where(none[..., None], _weak(loc_mask, 0.0),
                               loc_mask)
    return loc_target.reshape(B, -1), loc_mask.reshape(B, -1), cls_target


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
    # not differentiable: the inputs enter detached
    cls_prob, loc_pred = cls_prob.detach(), loc_pred.detach()
    dev = cls_prob.device
    anchors = anchor.detach().reshape(-1, 4)
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


# ---------------------------------------------------------------------------
# ROIPooling
# ---------------------------------------------------------------------------

# elements of one chunk's gathered windows (rois x bins x window x channels)
_ROI_CHUNK_ELEMS = 1 << 26


def _roi_bins(rois, pooled_size, spatial_scale, H, W):
    """Each roi's image and its bins' integer edges, in f32 as the JAX op
    computes them (round-to-int corners, floor/ceil bin edges clipped to
    the map): bidx (R,), hstart/hend (R, ph), wstart/wend (R, pw)."""
    ph, pw = pooled_size
    f32, dev = torch.float32, rois.device
    ss, one = _weak(rois, spatial_scale), _weak(rois, 1.0)
    bidx = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (torch.round(rois[:, k] * ss) for k in range(1, 5))
    rw = torch.maximum(x2 - x1 + one, one)
    rh = torch.maximum(y2 - y1 + one, one)
    bin_h = rh / _weak(rh, ph)
    bin_w = rw / _weak(rw, pw)
    py = torch.arange(ph, dtype=f32, device=dev)[None, :]
    px = torch.arange(pw, dtype=f32, device=dev)[None, :]

    def edges(p, size, start, n):
        lo = torch.clamp(torch.floor(p * size[:, None]) + start[:, None],
                         0, n)
        hi = torch.clamp(torch.ceil((p + 1) * size[:, None]) +
                         start[:, None], 0, n)
        return lo.to(torch.int64), hi.to(torch.int64)

    return (bidx,) + edges(py, bin_h, y1, H) + edges(px, bin_w, x1, W)


class _ROIPool(torch.autograd.Function):
    """Max over each bin's window. The windows are gathered channels-last
    a chunk of rois at a time, (r, ph, KH, pw, KW, C) with KH, KW the
    largest bin's extent; the backward gathers them again and splits each
    bin's gradient evenly over the elements equal to its maximum."""

    @staticmethod
    def _windows(xt, bidx, hs, he, ws, we, kh, kw):
        dev = xt.device
        r = hs[:, :, None] + torch.arange(kh, device=dev)       # (R, ph, KH)
        c = ws[:, :, None] + torch.arange(kw, device=dev)       # (R, pw, KW)
        valid = ((r < he[:, :, None])[:, :, :, None, None] &
                 (c < we[:, :, None])[:, None, None, :, :])
        r = r.clamp_max(xt.shape[1] - 1)[:, :, :, None, None]
        c = c.clamp_max(xt.shape[2] - 1)[:, None, None, :, :]
        vals = xt[bidx[:, None, None, None, None], r, c]     # (..., C)
        return vals, valid, (bidx[:, None, None, None, None], r, c)

    @staticmethod
    def _chunks(bins, C):
        bidx, hs, he, ws, we = bins
        R = bidx.shape[0]
        kh = int((he - hs).max()) if R else 0
        kw = int((we - ws).max()) if R else 0
        per_roi = max(1, hs.shape[1] * ws.shape[1] * max(kh, 1) *
                      max(kw, 1) * C)
        step = max(1, _ROI_CHUNK_ELEMS // per_roi)
        for s in range(0, R, step):
            yield (slice(s, s + step), kh, kw)

    @staticmethod
    def forward(ctx, data, bins):
        B, C, H, W = data.shape
        bidx, hs, he, ws, we = bins
        R, ph, pw = bidx.shape[0], hs.shape[1], ws.shape[1]
        xt = data.permute(0, 2, 3, 1)                           # (B, H, W, C)
        raw = data.new_full((R, ph, pw, C), float("-inf"))
        for sl, kh, kw in _ROIPool._chunks(bins, C):
            if kh == 0 or kw == 0:
                break
            vals, valid, _ = _ROIPool._windows(
                xt, bidx[sl], hs[sl], he[sl], ws[sl], we[sl], kh, kw)
            vals = torch.where(valid[..., None], vals,
                               _weak(vals, float("-inf")))
            raw[sl] = torch.amax(vals, dim=(2, 4))
        ctx.save_for_backward(data, raw, *bins)
        out = torch.where(torch.isfinite(raw), raw, _weak(raw, 0.0))
        return out.permute(0, 3, 1, 2).contiguous()            # (R, C, ph, pw)

    @staticmethod
    def backward(ctx, dy):
        data, raw, *bins = ctx.saved_tensors
        bidx, hs, he, ws, we = bins
        xt = data.permute(0, 2, 3, 1)
        # empty bins pass nothing (the forward's isfinite select)
        g = torch.where(torch.isfinite(raw), dy.permute(0, 2, 3, 1),
                        _weak(raw, 0.0))
        B, H, W, C = xt.shape
        P = B * H * W
        dxt = torch.zeros((P, C), dtype=xt.dtype, device=xt.device)
        at = torch.arange(P, device=xt.device)
        for sl, kh, kw in _ROIPool._chunks(bins, C):
            if kh == 0 or kw == 0:
                break
            vals, valid, (b, r, c) = _ROIPool._windows(
                xt, bidx[sl], hs[sl], he[sl], ws[sl], we[sl], kh, kw)
            top = raw[sl][:, :, None, :, None, :]
            hit = (vals == top) & valid[..., None]
            count = hit.sum(dim=(2, 4), keepdim=True).to(g.dtype)
            share = g[sl][:, :, None, :, None, :] / torch.clamp_min(count, 1)
            # the shares summed by map position in a fixed order (Queue C
            # 21): each position's running sum first, then the chunk's
            # window elements in order, so chunking changes no bit
            pos = ((b * H + r) * W + c).expand(hit.shape[:-1])
            dxt = segment_sum(torch.cat([dxt, torch.where(
                hit, share, _weak(share, 0.0)).reshape(-1, C)]),
                torch.cat([at, pos.reshape(-1)]), P)
        return dxt.reshape(B, H, W, C).permute(0, 3, 1, 2), None


@register("ROIPooling", arg_names=("data", "rois"), nondiff_inputs=(1,),
          aliases=("_contrib_ROIPooling",),
          defaults={"pooled_size": (1, 1), "spatial_scale": 1.0})
def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0, **_):
    """data (B,C,H,W), rois (R,5) [batch_idx, x1, y1, x2, y2] in image
    coords -> (R, C, ph, pw) max-pooled (reference roi_pooling.cc:40-110:
    round-to-int bin edges, empty bins give 0). The gradient reaches
    ``data`` only."""
    B, C, H, W = data.shape
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    R = rois.shape[0]
    if data.device.type == "meta" or rois.device.type == "meta":
        return torch.empty((R, C, ph, pw), dtype=data.dtype, device="meta")
    bins = _roi_bins(rois.detach(), (ph, pw), spatial_scale, H, W)
    return _ROIPool.apply(data, bins)
