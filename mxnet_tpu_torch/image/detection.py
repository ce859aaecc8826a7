"""Detection image pipeline — the PyTorch package's copy of
``mxnet_tpu/image/detection.py`` (reference:
python/mxnet/image/detection.py; C++ analogue iter_image_det_recordio.cc
+ image_det_aug_default.cc). Host code, as in ``image``: the draws come
from Python's ``random`` in the JAX package's order, per-image arrays
stay on the host and each batch is copied once to the iterator's
context. ``CreateDetAugmenter`` takes ``rand_pad`` and makes no pad
augmenter, as the JAX package's does.

Labels are [header_width, obj_width, id, xmin, ymin, xmax, ymax, ...] per
object with normalized coords — the SSD workload format (BASELINE config
#5)."""
from __future__ import annotations

import random

import numpy as np

from .. import io
from .. import ndarray as nd
from ..context import cpu
from ..ndarray import NDArray
from .image import (Augmenter, ImageIter, ForceResizeAug,
                    ColorNormalizeAug, CastAug, imresize)

__all__ = ["DetAugmenter", "DetBorderAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetForceResizeAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Detection augmenter: __call__(src, label) -> (src, label)
    (reference detection.py:DetAugmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorderAug(DetAugmenter):
    """Apply an image-only augmenter, label unchanged (reference
    detection.py:DetBorderAug)."""

    def __init__(self, augmenter):
        super().__init__()
        assert isinstance(augmenter, Augmenter)
        self.augmenter = augmenter

    def __call__(self, src, label):
        src = self.augmenter(src)[0]
        return (src, label)


class DetRandomSelectAug(DetAugmenter):
    """Randomly select one augmenter to apply (reference
    detection.py:DetRandomSelectAug)."""

    def __init__(self, aug_list, skip_prob=0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if random.random() < self.skip_prob or not self.aug_list:
            return (src, label)
        return random.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image + boxes (reference
    detection.py:DetHorizontalFlipAug)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if random.random() < self.p:
            arr = src.asnumpy()[:, ::-1]
            src = nd.array(arr.copy(), dtype=arr.dtype)
            label = label.copy()
            valid = label[:, 0] >= 0
            tmp = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - label[valid, 1]
            label[valid, 1] = tmp
        return (src, label)


class DetRandomCropAug(DetAugmenter):
    """Random crop with min-IOU object constraint (reference
    detection.py:DetRandomCropAug; the SSD sampling strategy)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75,
                 1.33), area_range=(0.05, 1.0), max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _check_satisfy(self, rect, boxes):
        """Fraction of each box covered by rect >= min_object_covered."""
        l, t, r, b = rect
        valid = boxes[:, 0] >= 0
        if not valid.any():
            return True
        bx = boxes[valid]
        ix1 = np.maximum(bx[:, 1], l)
        iy1 = np.maximum(bx[:, 2], t)
        ix2 = np.minimum(bx[:, 3], r)
        iy2 = np.minimum(bx[:, 4], b)
        inter = np.maximum(0, ix2 - ix1) * np.maximum(0, iy2 - iy1)
        area = (bx[:, 3] - bx[:, 1]) * (bx[:, 4] - bx[:, 2])
        cov = inter / np.maximum(area, 1e-12)
        return (cov >= self.min_object_covered).all()

    def __call__(self, src, label):
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            ratio = random.uniform(*self.aspect_ratio_range)
            area = random.uniform(*self.area_range) * h * w
            cw = int(np.sqrt(area * ratio))
            ch = int(np.sqrt(area / ratio))
            if cw > w or ch > h:
                continue
            x0 = random.randint(0, w - cw)
            y0 = random.randint(0, h - ch)
            rect = (x0 / w, y0 / h, (x0 + cw) / w, (y0 + ch) / h)
            if not self._check_satisfy(rect, label):
                continue
            arr = src.asnumpy()[y0:y0 + ch, x0:x0 + cw]
            new_label = label.copy()
            valid = new_label[:, 0] >= 0
            # transform boxes into crop coords, clip, drop empty
            for i in np.where(valid)[0]:
                bx = new_label[i]
                x1 = (bx[1] - rect[0]) / (rect[2] - rect[0])
                y1 = (bx[2] - rect[1]) / (rect[3] - rect[1])
                x2 = (bx[3] - rect[0]) / (rect[2] - rect[0])
                y2 = (bx[4] - rect[1]) / (rect[3] - rect[1])
                x1, y1 = max(0.0, x1), max(0.0, y1)
                x2, y2 = min(1.0, x2), min(1.0, y2)
                if x2 <= x1 or y2 <= y1:
                    new_label[i, 0] = -1  # dropped
                else:
                    new_label[i, 1:5] = (x1, y1, x2, y2)
            return (nd.array(arr.copy(), dtype=arr.dtype), new_label)
        return (src, label)


class DetForceResizeAug(DetAugmenter):
    """Force resize; normalized boxes unchanged."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src, label):
        return (imresize(src, self.size[0], self.size[1], self.interp),
                label)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None,
                       std=None, brightness=0, contrast=0, saturation=0,
                       pca_noise=0, hue=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50,
                       pad_val=(127, 127, 127)):
    """Standard detection augmenter list (reference
    detection.py:CreateDetAugmenter)."""
    auglist = []
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (min(area_range[0], 1.0),
                                 min(area_range[1], 1.0)), max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetForceResizeAug((data_shape[2], data_shape[1]),
                                     inter_method))
    auglist.append(DetBorderAug(CastAug()))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = np.asarray(mean)
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = np.asarray(std)
    if mean is not None or std is not None:
        auglist.append(DetBorderAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: object-list labels padded to fixed width
    (reference detection.py:ImageDetIter)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_mirror", "mean",
                         "std", "min_object_covered", "max_attempts",
                         "aspect_ratio_range", "area_range")})
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         path_imgidx=path_imgidx, shuffle=shuffle,
                         part_index=part_index, num_parts=num_parts,
                         aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name)
        self.det_auglist = aug_list
        # detection label: (batch, max_objects, 5) [id x1 y1 x2 y2]
        self._max_objects = int(kwargs.get("max_objects", 16))
        self.provide_label = [io.DataDesc(
            label_name, (batch_size, self._max_objects, 5))]

    @staticmethod
    def _parse_label(raw):
        """[hw, ow, (extras...), id,x1,y1,x2,y2, ...] -> (N,5) array
        (reference detection.py:_parse_label)."""
        raw = np.asarray(raw, np.float32).ravel()
        header_width = int(raw[0])
        obj_width = int(raw[1])
        body = raw[header_width:]
        n = body.size // obj_width
        out = body[:n * obj_width].reshape(n, obj_width)[:, :5]
        return out

    def _decode_augment_det(self, label, raw):
        from .image import imdecode
        with cpu():     # per-image arrays stay on the host
            data = imdecode(raw)
            label = self._parse_label(label)
            for aug in self.det_auglist:
                data, label = aug(data, label)
        return label, data

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        samples = []
        pad = 0
        for _ in range(batch_size):
            try:
                samples.append(self.next_sample())
            except StopIteration:
                if not samples:
                    raise
                pad = batch_size - len(samples)
                self.reset()
                while len(samples) < batch_size:
                    samples.append(self.next_sample())
                break
        decoded = list(self._pool.map(
            lambda s: self._decode_augment_det(*s), samples))

        batch_data = np.empty((batch_size, c, h, w), np.float32)
        batch_label = np.full((batch_size, self._max_objects, 5), -1.0,
                              np.float32)
        for i, (label, img) in enumerate(decoded):
            arr = img.asnumpy() if isinstance(img, NDArray) else \
                np.asarray(img)
            batch_data[i] = arr.transpose(2, 0, 1)
            n = min(label.shape[0], self._max_objects)
            batch_label[i, :n] = label[:n]
        self.batches_by_route["pil"] += 1
        return io.DataBatch([nd.array(batch_data, ctx=self._ctx)],
                            [nd.array(batch_label, ctx=self._ctx)], pad=pad)
