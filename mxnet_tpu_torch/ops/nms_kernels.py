"""Greedy NMS over the hand-written Hopper kernel — the PyTorch twin of
``mxnet_tpu/ops/nms_pallas.py``.

``nms_keep(boxes, cls_ids, valid, nms_threshold, force_suppress)`` takes
a batch of score-sorted corner boxes (B, A, 4) f32, their class ids
(B, A) f32 and valid flags (B, A) bool, and returns the keep mask (B, A)
bool of greedy NMS: rows go in score order, and a row still alive (and
valid) suppresses every later row whose IoU with it is >= the threshold
and, unless ``force_suppress``, whose class is equal.

On CUDA tensors it launches the kernel of ``csrc/nms.cu``
(``nms_keep_cuda``, with a ``.launches`` counter: one launch for the
whole batch, one thread-block cluster an image; ``launch_shape`` reports
the cluster's size and shared memory) or raises; on CPU (and meta)
tensors it runs the kernel's plain version ``_nms_reference``, the TPU
kernel's blocked algorithm step by step in eager torch. Nothing falls back from one to the other.
All three give the dense path's result bit for bit: the IoU is
``_box_iou_corner``'s f32 formula, each operation rounded on its own in
the jnp source's order, and the threshold is rounded to f32.
"""
from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["nms_keep", "nms_keep_cuda", "launch_shape", "MAX_ANCHORS"]

_BLOCK = 128             # rows per row block, as the TPU kernel's _BLOCK
MAX_ANCHORS = 200000     # rows an image (csrc/nms.cu kMaxAnchors)


def _box_iou_corner(a, b):
    """IoU between two sets of corner boxes: a (..., Na, 4), b (..., Nb, 4)
    -> (..., Na, Nb), in f32 with each operation rounded on its own in
    the order of the JAX package's ``detection_ops._box_iou_corner``
    (eager torch equals eager jnp and numpy bit for bit)."""
    ax1, ay1, ax2, ay2 = (a[..., :, i, None] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    zero = a.new_zeros(())
    iw = torch.maximum(zero,
                       torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1))
    ih = torch.maximum(zero,
                       torch.minimum(ay2, by2) - torch.maximum(ay1, by1))
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    tiny = torch.tensor(1e-12, dtype=a.dtype, device=a.device)
    return torch.where(union <= 0, zero, inter / torch.maximum(union, tiny))


def _threshold(nms_threshold, device):
    # a Python float compared with f32 values: rounded to f32 first
    return torch.tensor(nms_threshold, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the plain version (the kernel's algorithm, for CPU and meta tensors)
# ---------------------------------------------------------------------------

def _nms_reference(boxes, cls_ids, valid, nms_threshold,
                   force_suppress=False):
    """The TPU kernel's blocked greedy NMS in eager torch, over a batch:
    for each 128-row block in order, greedy suppression inside the block
    (a row loop over the block), then the block's survivors suppress
    every later row in one tile. A block with no live row is skipped, as
    the CUDA kernel skips it; that changes nothing."""
    B, A = valid.shape
    if boxes.device.type == "meta":
        return torch.empty((B, A), dtype=torch.bool, device="meta")
    thr = _threshold(nms_threshold, boxes.device)
    keep = valid.clone()
    for offs in range(0, A, _BLOCK):
        end = min(offs + _BLOCK, A)
        k = keep[:, offs:end].clone()                         # (B, n)
        if not k.any():
            continue
        blk_boxes, blk_cls = boxes[:, offs:end], cls_ids[:, offs:end]
        sup = _box_iou_corner(blk_boxes, blk_boxes) >= thr    # (B, n, n)
        if not force_suppress:
            sup &= blk_cls[:, :, None] == blk_cls[:, None, :]
        idx = torch.arange(end - offs, device=boxes.device)
        sup &= idx[None, :] > idx[:, None]                    # later rows
        for i in range(end - offs):
            k &= ~(k[:, i, None] & sup[:, i])
        keep[:, offs:end] = k
        if end < A:
            sup_ba = _box_iou_corner(blk_boxes, boxes[:, end:]) >= thr
            if not force_suppress:
                sup_ba &= blk_cls[:, :, None] == cls_ids[:, None, end:]
            keep[:, end:] &= ~(k[:, :, None] & sup_ba).any(dim=1)
    return keep


# ---------------------------------------------------------------------------
# the CUDA launcher
# ---------------------------------------------------------------------------

def _check_operands(boxes, cls_ids, valid):
    """Raise on what the kernel does not take."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError("nms_keep_cuda: boxes must be (B, A, 4), got shape "
                         "%r" % (tuple(boxes.shape),))
    B, A = boxes.shape[:2]
    if boxes.dtype != torch.float32:
        raise TypeError("nms_keep_cuda: boxes must be float32, got %s"
                        % boxes.dtype)
    if B == 0 or A == 0:
        raise ValueError("nms_keep_cuda: empty input of shape %r"
                         % (tuple(boxes.shape),))
    if A > MAX_ANCHORS:
        raise ValueError("nms_keep_cuda: %d boxes an image, more than the "
                         "kernel's %d (its keep flags live in shared memory)"
                         % (A, MAX_ANCHORS))
    for name, t, dtype in (("cls_ids", cls_ids, torch.float32),
                           ("valid", valid, torch.bool)):
        if (tuple(t.shape) != (B, A) or t.dtype != dtype
                or t.device != boxes.device):
            raise ValueError("nms_keep_cuda: %s must be %s of shape (%d, %d) "
                             "on %s, got %r, %s, %s" % (
                                 name, dtype, B, A, boxes.device,
                                 tuple(t.shape), t.dtype, t.device))
    if boxes.device.type != "cuda":
        raise ValueError("nms_keep_cuda: boxes must be on a CUDA device, got "
                         "%s" % boxes.device)


def nms_keep_cuda(boxes, cls_ids, valid, nms_threshold,
                  force_suppress=False):
    """Launch the NMS kernel once for the batch: the (B, A) bool keep
    mask. ``nms_keep_cuda.launches`` counts the launches."""
    _check_operands(boxes, cls_ids, valid)
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:          # the kernel reads a box as a float4
        boxes = boxes.clone()
    cls_ids, valid = cls_ids.contiguous(), valid.contiguous()
    B, A = valid.shape
    keep = torch.empty((B, A), dtype=torch.bool, device=boxes.device)
    lib = _kernels.load("nms")
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = lib.nms_keep(boxes.data_ptr(), cls_ids.data_ptr(),
                          valid.data_ptr(), keep.data_ptr(), B, A,
                          float(nms_threshold), int(bool(force_suppress)),
                          stream)
    _kernels.check(lib, rc, "nms_keep")
    nms_keep_cuda.launches += 1
    return keep


nms_keep_cuda.launches = 0


def launch_shape(num_anchors):
    """How ``nms_keep_cuda`` launches for images of ``num_anchors`` rows
    on the current CUDA device: ``{"cluster": CTAs an image,
    "smem_bytes": dynamic shared memory a CTA, "cached_rows": rows a CTA
    keeps in shared memory, "max_active_clusters": clusters of that shape
    the device runs at once}``. Needs the card (it builds the kernel)."""
    import ctypes
    lib = _kernels.load("nms")
    out = (ctypes.c_int * 4)()
    _kernels.check(lib, lib.nms_launch_shape(int(num_anchors), out),
                   "nms_launch_shape")
    return dict(zip(("cluster", "smem_bytes", "cached_rows",
                     "max_active_clusters"), out))


def nms_keep(boxes, cls_ids, valid, nms_threshold, force_suppress=False):
    """Greedy NMS keep mask: the kernel on CUDA tensors, the plain version
    on CPU and meta tensors."""
    dev = boxes.device
    if dev.type == "cuda":
        return nms_keep_cuda(boxes, cls_ids, valid, nms_threshold,
                             force_suppress)
    if dev.type in ("cpu", "meta"):
        return _nms_reference(boxes, cls_ids, valid, nms_threshold,
                              force_suppress)
    raise ValueError("the NMS kernel has no implementation for device %s"
                     % (dev,))
