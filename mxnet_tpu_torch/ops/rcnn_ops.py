"""RCNN / R-FCN operator family: Proposal, MultiProposal, PSROIPooling,
DeformableConvolution, DeformablePSROIPooling — the PyTorch twin of
``mxnet_tpu/ops/rcnn_ops.py`` (reference:
src/operator/contrib/{proposal,multi_proposal,psroi_pooling,
deformable_convolution,deformable_psroi_pooling}-inl.h).

- Proposal keeps the reference's anchor arithmetic (numpy on the host,
  the JAX package's ``_base_anchors``/``_shifted_anchors`` copied here)
  and the JAX op's fixed ``rpn_post_nms_top_n`` rois an image, padded
  with the best box. The top ``rpn_pre_nms_top_n`` candidates are the
  head of a stable descending sort (``lax.top_k`` puts the lower index
  first among ties; ``torch.topk`` on CUDA leaves their order open). The
  suppression matrix (IoU with +1 widths > threshold) is built on the
  device as the JAX op builds it, and greedy NMS over it runs as a
  fixed-point sweep (``_sweep_keep``): keep <- valid and no earlier kept
  row suppresses it, one (1 x k) . (k x k) product a sweep, repeated
  until the mask stops changing. After sweep t the first t flags are
  final, so it ends within k sweeps with the sequential loop's mask flag
  for flag; each sweep reads one host flag.
- PSROIPooling samples each bin on a sub-grid with bilinear taps (the
  deformable formulation with zero offsets); DeformablePSROIPooling adds
  the learned per-part offsets.
- DeformableConvolution gathers one bilinear-sampled image a kernel tap
  and contracts with the weights in one ``torch.einsum``, as the JAX op
  computes it outside any Pallas kernel.

All of these are plain torch; ``floor`` passes no gradient, as in jnp.
"""
from __future__ import annotations

import numpy as np
import torch

from .detection_ops import _weak as _c
from .registry import register


# ---------------------------------------------------------------------------
# anchors (host-side, static attrs only)
# ---------------------------------------------------------------------------

def _base_anchors(feature_stride, scales, ratios):
    """(A, 4) corner anchors at cell (0, 0) — proposal-inl.h:213."""
    base = np.array([0, 0, feature_stride - 1.0, feature_stride - 1.0])
    w = base[2] - base[0] + 1.0
    h = base[3] - base[1] + 1.0
    x_ctr = base[0] + 0.5 * (w - 1.0)
    y_ctr = base[1] + 0.5 * (h - 1.0)
    size = w * h
    out = []
    for ratio in ratios:
        size_ratio = np.floor(size / ratio)
        new_w = np.floor(np.sqrt(size_ratio) + 0.5)
        new_h = np.floor(new_w * ratio + 0.5)
        for scale in scales:
            ws, hs = new_w * scale, new_h * scale
            out.append([x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                        x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)])
    return np.asarray(out, np.float32)


def _shifted_anchors(H, W, feature_stride, scales, ratios):
    """(H*W*A, 4) anchors in the reference's h-major, w, a order."""
    base = _base_anchors(feature_stride, scales, ratios)      # (A, 4)
    sx = np.arange(W) * feature_stride
    sy = np.arange(H) * feature_stride
    shift = np.stack(np.meshgrid(sy, sx, indexing="ij"), -1)  # (H, W, 2)
    shift4 = np.concatenate([shift[..., 1:2], shift[..., 0:1]] * 2, -1)
    all_anchors = shift4[:, :, None, :] + base[None, None, :, :]
    return all_anchors.reshape(-1, 4).astype(np.float32)


# ---------------------------------------------------------------------------
# Proposal
# ---------------------------------------------------------------------------

def _decode_rpn(anchors, deltas, im_h, im_w):
    """BBoxTransformInv (proposal.cc:40-90): deltas (B, N, 4) on corner
    anchors (N, 4), clipped to each image's (B, 1) height and width."""
    one, half = _c(anchors, 1.0), _c(anchors, 0.5)
    widths = anchors[:, 2] - anchors[:, 0] + one
    heights = anchors[:, 3] - anchors[:, 1] + one
    ctr_x = anchors[:, 0] + half * (widths - one)
    ctr_y = anchors[:, 1] + half * (heights - one)
    pred_ctr_x = deltas[..., 0] * widths + ctr_x
    pred_ctr_y = deltas[..., 1] * heights + ctr_y
    pred_w = torch.exp(deltas[..., 2]) * widths
    pred_h = torch.exp(deltas[..., 3]) * heights
    zero = _c(anchors, 0.0)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi - one)

    x1 = clip(pred_ctr_x - half * (pred_w - one), im_w)
    y1 = clip(pred_ctr_y - half * (pred_h - one), im_h)
    x2 = clip(pred_ctr_x + half * (pred_w - one), im_w)
    y2 = clip(pred_ctr_y + half * (pred_h - one), im_h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def _suppression(boxes, threshold):
    """(B, k, k) bool: row i suppresses later row j (IoU with +1 widths >
    threshold), in the JAX op's f32 order of operations."""
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    one, zero = _c(boxes, 1.0), _c(boxes, 0.0)
    area = (torch.maximum(x2 - x1 + one, zero) *
            torch.maximum(y2 - y1 + one, zero))
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    iw = torch.maximum(ix2 - ix1 + one, zero)
    ih = torch.maximum(iy2 - iy1 + one, zero)
    inter = iw * ih
    del ix1, iy1, ix2, iy2, iw, ih
    iou = inter / torch.maximum(area[..., :, None] + area[..., None, :] -
                                inter, _c(boxes, 1e-12))
    k = boxes.shape[-2]
    later = torch.ones((k, k), dtype=torch.bool,
                       device=boxes.device).triu_(1)
    return (iou > _c(iou, threshold)) & later


def _sweep_keep(sup, valid):
    """Greedy NMS's keep mask over score-sorted rows by fixed-point
    sweeps: keep = valid & ~(keep . sup), repeated until unchanged. sup
    (B, k, k) holds only row-before-column pairs, so sweep t fixes flag
    t; returns (keep, sweeps)."""
    supf = sup.to(torch.float32)
    keep = valid
    sweeps = 0
    while True:
        hit = torch.bmm(keep.to(torch.float32)[:, None, :], supf)[:, 0] > 0
        new = valid & ~hit
        sweeps += 1
        if torch.equal(new, keep):
            return keep, sweeps
        keep = new


def _dense_keep(sup, valid):
    """The JAX op's sequential loop over the same matrix (one step a
    row), for the tests: the route ``_sweep_keep`` must equal."""
    keep = valid.clone()
    for i in range(sup.shape[-1]):
        alive = keep[:, i] & valid[:, i]
        keep &= ~(sup[:, i] & alive[:, None])
    return keep


def _candidates(cls_prob, bbox_pred, im_info, pre_n, min_size, scales,
                ratios, feature_stride):
    """Each image's top ``pre_n`` proposals before NMS: decoded boxes (B,
    k, 4) and scores (B, k), -inf for boxes under the minimum size, in a
    stable descending order (the lower index first among ties, as
    ``lax.top_k``)."""
    B, twoA, H, W = cls_prob.shape
    A = twoA // 2
    anchors = torch.from_numpy(_shifted_anchors(
        H, W, feature_stride, tuple(scales), tuple(ratios))).to(
            cls_prob.device)
    # reference ordering: index = h*(W*A) + w*A + a
    scores = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(B, -1)
    deltas = bbox_pred.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(B, -1, 4)
    im_h, im_w, im_scale = (im_info[:, i:i + 1] for i in range(3))
    boxes = _decode_rpn(anchors, deltas, im_h, im_w)              # (B, N, 4)
    one = _c(boxes, 1.0)
    ws = boxes[..., 2] - boxes[..., 0] + one
    hs = boxes[..., 3] - boxes[..., 1] + one
    ms = float(min_size) * im_scale
    valid = (ws >= ms) & (hs >= ms)
    score = torch.where(valid, scores, _c(scores, float("-inf")))
    k = min(int(pre_n), score.shape[1])
    top_idx = torch.argsort(score, dim=1, descending=True,
                            stable=True)[:, :k]
    return (torch.gather(boxes, 1, top_idx[..., None].expand(B, k, 4)),
            torch.gather(score, 1, top_idx))


def _multi_proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                    rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                    scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                    feature_stride=16, output_score=False,
                    iou_loss=False, **_):
    """cls_prob (B, 2A, H, W), bbox_pred (B, 4A, H, W), im_info (B, 3) ->
    rois (B*post, 5) [batch_idx, x1, y1, x2, y2] (and, with
    ``output_score``, their scores (B*post, 1))."""
    B = cls_prob.shape[0]
    post_n = int(rpn_post_nms_top_n)
    dt = cls_prob.dtype
    if cls_prob.device.type == "meta":
        rois = torch.empty((B * post_n, 5), dtype=dt, device="meta")
        if output_score:
            return rois, torch.empty((B * post_n, 1), dtype=dt,
                                     device="meta")
        return rois
    dev = cls_prob.device
    with torch.no_grad():
        top_boxes, top_score = _candidates(
            cls_prob.detach(), bbox_pred.detach(), im_info.detach(),
            rpn_pre_nms_top_n, rpn_min_size, scales, ratios, feature_stride)
        k = top_score.shape[1]
        sup = _suppression(top_boxes, threshold)
        keep, _ = _sweep_keep(sup, top_score > _c(
            top_score, float("-inf")))
        del sup

        # stable-select the first post_n kept rows; pad with the best box
        # (also when post_n exceeds the candidate count k)
        ar = torch.arange(k, device=dev)
        sel_key = torch.where(keep, ar, k + ar)
        pick = torch.clamp(torch.arange(post_n, device=dev), 0, k - 1)
        order = torch.argsort(sel_key, dim=1)[:, pick]
        n_keep = torch.clamp_max(keep.sum(1), k)
        pad = torch.arange(post_n, device=dev)[None, :] >= n_keep[:, None]
        rows = torch.where(pad[..., None], top_boxes[:, :1],
                           torch.gather(top_boxes, 1, order[..., None]
                                        .expand(B, post_n, 4)))
        row_scores = torch.where(pad, top_score[:, :1],
                                 torch.gather(top_score, 1, order))
        batch_idx = torch.arange(B, dtype=rows.dtype, device=dev)[
            :, None, None].expand(B, post_n, 1)
        rois = torch.cat([batch_idx, rows], dim=2).reshape(B * post_n, 5)
    if output_score:
        return rois, row_scores.reshape(-1, 1)
    return rois


register("_contrib_MultiProposal",
         arg_names=("cls_prob", "bbox_pred", "im_info"),
         differentiable=False,
         aliases=("MultiProposal", "_contrib_multi_proposal"),
         defaults={"rpn_pre_nms_top_n": 6000, "rpn_post_nms_top_n": 300,
                   "threshold": 0.7, "rpn_min_size": 16,
                   "scales": (4, 8, 16, 32), "ratios": (0.5, 1, 2),
                   "feature_stride": 16, "output_score": False,
                   "iou_loss": False})(_multi_proposal)

register("_contrib_Proposal",
         arg_names=("cls_prob", "bbox_pred", "im_info"),
         differentiable=False,
         aliases=("Proposal", "_contrib_proposal"),
         defaults={"rpn_pre_nms_top_n": 6000, "rpn_post_nms_top_n": 300,
                   "threshold": 0.7, "rpn_min_size": 16,
                   "scales": (4, 8, 16, 32), "ratios": (0.5, 1, 2),
                   "feature_stride": 16, "output_score": False,
                   "iou_loss": False})(_multi_proposal)


# ---------------------------------------------------------------------------
# position-sensitive ROI pooling (R-FCN)
# ---------------------------------------------------------------------------

def _bilinear_tap(img, y, x):
    """img (N, C, H, W) sampled at grids y, x (N, ...) -> (N, C, ...),
    zero padded outside the map."""
    N, C, H, W = img.shape
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    dy = y - y0
    dx = x - x0
    one = _c(y, 1.0)
    flat = img.reshape(N, C, H * W)

    def corner(yc, xc, w):
        inside = (xc >= 0) & (xc <= W - 1) & (yc >= 0) & (yc <= H - 1)
        yi = torch.clamp(yc, 0, H - 1).to(torch.int64)
        xi = torch.clamp(xc, 0, W - 1).to(torch.int64)
        idx = (yi * W + xi).reshape(N, 1, -1).expand(N, C, -1)
        val = torch.gather(flat, 2, idx).reshape((N, C) + y.shape[1:])
        return val * (w * inside)[:, None]

    return (corner(y0, x0, (one - dy) * (one - dx)) +
            corner(y0, x0 + one, (one - dy) * dx) +
            corner(y0 + one, x0, dy * (one - dx)) +
            corner(y0 + one, x0 + one, dy * dx))


def _psroi(data, rois, trans, spatial_scale, output_dim, pooled,
           group_size, sample_per_part, trans_std, part_size):
    """Every roi over the batch's data (B, C, H, W); roi[0] picks the
    image, trans (R, 2, part, part) this roi's learned offsets (None: 0).
    Returns (R, output_dim, pooled, pooled)."""
    R = rois.shape[0]
    dev = data.device
    img = data[rois[:, 0].to(torch.int64)]                  # (R, C, H, W)
    ss = _c(rois, spatial_scale)
    half = _c(rois, 0.5)
    x1 = rois[:, 1] * ss - half
    y1 = rois[:, 2] * ss - half
    x2 = (rois[:, 3] + 1.0) * ss - half
    y2 = (rois[:, 4] + 1.0) * ss - half
    rw = torch.maximum(x2 - x1, _c(rois, 0.1))
    rh = torch.maximum(y2 - y1, _c(rois, 0.1))
    bin_w = rw / _c(rw, pooled)
    bin_h = rh / _c(rh, pooled)
    sub_w = bin_w / _c(rw, sample_per_part)
    sub_h = bin_h / _c(rh, sample_per_part)

    ph = torch.arange(pooled, device=dev)
    gh = torch.clamp_max((ph * group_size) // pooled, group_size - 1)
    if trans is not None:
        part = torch.clamp_max((ph * part_size) // pooled, part_size - 1)
        t = trans[:, :, part[:, None], part[None, :]]       # (R, 2, P, P)
        off_y = t[:, 0] * trans_std * rh[:, None, None]
        off_x = t[:, 1] * trans_std * rw[:, None, None]
    else:
        off_y = off_x = torch.zeros((R, pooled, pooled), dtype=rois.dtype,
                                    device=dev)

    f = rois.dtype
    s = torch.arange(sample_per_part, dtype=f, device=dev) + 0.5
    phf = ph.to(f)
    # (R, P, P, s, s) sample grids
    yy = (y1[:, None, None, None, None] +
          phf[None, :, None, None, None] * bin_h[:, None, None, None, None] +
          s[None, None, None, :, None] * sub_h[:, None, None, None, None] +
          off_y[:, :, :, None, None])
    xx = (x1[:, None, None, None, None] +
          phf[None, None, :, None, None] * bin_w[:, None, None, None, None] +
          s[None, None, None, None, :] * sub_w[:, None, None, None, None] +
          off_x[:, :, :, None, None])
    shape = (R, pooled, pooled, sample_per_part, sample_per_part)
    sampled = _bilinear_tap(img, yy.expand(shape), xx.expand(shape))
    avg = sampled.mean(dim=(4, 5))                          # (R, C, P, P)

    # position-sensitive channel select: out[c, i, j] uses input channel
    # c*G*G + gh[i]*G + gw[j]
    chan = (torch.arange(output_dim, device=dev)[:, None, None] *
            group_size * group_size + gh[None, :, None] * group_size +
            gh[None, None, :])                              # (O, P, P)
    idx = chan.reshape(1, output_dim, pooled * pooled)
    flat = avg.reshape(R, -1, pooled * pooled)
    pos = torch.arange(pooled * pooled, device=dev)
    return flat[:, idx[0], pos[None, :].expand(output_dim, -1)].reshape(
        R, output_dim, pooled, pooled)


@register("_contrib_PSROIPooling", arg_names=("data", "rois"),
          nondiff_inputs=(1,),
          aliases=("PSROIPooling", "_contrib_psroipooling"),
          defaults={"spatial_scale": 1.0, "output_dim": 0,
                    "pooled_size": 0, "group_size": 0})
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=0,
                   pooled_size=0, group_size=0, **_):
    """data (B, output_dim*group², H, W), rois (R, 5) -> (R, output_dim,
    pooled, pooled): psroi_pooling-inl.h via the sampled-bin formulation
    (a 4 x 4 sample grid a bin)."""
    group_size = int(group_size) or int(pooled_size)
    return _psroi(data, rois.detach(), None, spatial_scale, int(output_dim),
                  int(pooled_size), group_size, 4, 0.0, group_size)


@register("_contrib_DeformablePSROIPooling",
          arg_names=("data", "rois", "trans"), nondiff_inputs=(1,),
          aliases=("DeformablePSROIPooling",),
          defaults={"spatial_scale": 1.0, "output_dim": 0,
                    "pooled_size": 0, "group_size": 0, "part_size": 0,
                    "sample_per_part": 4, "trans_std": 0.0,
                    "no_trans": False})
def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                              output_dim=0, pooled_size=0, group_size=0,
                              part_size=0, sample_per_part=4,
                              trans_std=0.0, no_trans=False, **_):
    group_size = int(group_size) or int(pooled_size)
    part_size = int(part_size) or int(pooled_size)
    tr = None
    if trans is not None and not no_trans:
        # trans (R, 2·k, part, part): one offset grid a roi
        tr = trans.reshape(rois.shape[0], -1, part_size, part_size)[:, :2]
    return _psroi(data, rois.detach(), tr, spatial_scale, int(output_dim),
                  int(pooled_size), group_size, int(sample_per_part),
                  float(trans_std), part_size)


# ---------------------------------------------------------------------------
# deformable convolution (v1)
# ---------------------------------------------------------------------------

@register("_contrib_DeformableConvolution",
          arg_names=("data", "offset", "weight", "bias"),
          aliases=("DeformableConvolution",),
          defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                    "num_filter": 0, "num_group": 1,
                    "num_deformable_group": 1, "no_bias": False,
                    "workspace": 1024})
def _deformable_convolution(data, offset, weight, bias=None, kernel=(),
                            stride=(), dilate=(), pad=(), num_filter=0,
                            num_group=1, num_deformable_group=1,
                            no_bias=False, **_):
    """deformable_im2col semantics (contrib/nn/deformable_im2col.h):
    each kernel tap samples the input at its position + learned offset
    (bilinear); offset channels [dg][2*(ki*kw+kj)] = dy, +1 = dx."""
    B, C, H, W = data.shape
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = (int(stride[0]), int(stride[1])) if stride else (1, 1)
    dh, dw = (int(dilate[0]), int(dilate[1])) if dilate else (1, 1)
    ph, pw = (int(pad[0]), int(pad[1])) if pad else (0, 0)
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = int(num_deformable_group)
    cpg = C // dg
    O, g = int(num_filter), int(num_group)
    if data.device.type == "meta":
        return torch.empty((B, O, Ho, Wo), dtype=data.dtype, device="meta")

    f, dev = data.dtype, data.device
    oy = (torch.arange(Ho, device=dev) * sh - ph).to(f)
    ox = (torch.arange(Wo, device=dev) * sw - pw).to(f)
    taps = []
    for t in range(kh * kw):
        ki, kj = divmod(t, kw)
        per_g = []
        for gi in range(dg):
            dy = offset[:, gi * 2 * kh * kw + 2 * t]            # (B, Ho, Wo)
            dx = offset[:, gi * 2 * kh * kw + 2 * t + 1]
            yy = oy[None, :, None] + ki * dh + dy
            xx = ox[None, None, :] + kj * dw + dx
            per_g.append(_bilinear_tap(data[:, gi * cpg:(gi + 1) * cpg],
                                       yy, xx))
        taps.append(torch.cat(per_g, dim=1))
    patches = torch.stack(taps, dim=2)                  # (B, C, K², Ho, Wo)
    wg = weight.reshape(g, O // g, C // g, kh * kw)
    pg = patches.reshape(B, g, C // g, kh * kw, Ho, Wo)
    out = torch.einsum("bgckhw,gock->bgohw", pg, wg).reshape(B, O, Ho, Wo)
    if not no_bias and bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out
