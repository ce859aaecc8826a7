"""Image loading + augmenters + ImageIter — the PyTorch package's copy of
``mxnet_tpu/image/image.py`` (reference: python/mxnet/image/image.py;
native pipeline src/io/iter_image_recordio_2.cc + image_aug_default.cc).

Decode and augmentation run on the host: PIL and numpy in a thread pool,
or, for the standard resize/crop/mirror/normalize list, the native C++
decoder (``native_decode``) in one call a batch. Random draws come from
Python's ``random`` and numpy's global state, in the JAX package's
order, so a seeded epoch is the same in both packages. The functions
return NDArrays on the current context; inside ``ImageIter`` every
per-image array is a host array and the batch is copied once to the
context the iterator was made in (the card unless a ``with mx.cpu():``
scope says otherwise). The ``ImageRecordIter`` factory keeps the
reference's C++-iterator kwargs and wraps the iterator in a
``PrefetchingIter``, so that copy happens on its worker thread.
"""
from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import random

import numpy as np

from .. import io
from .. import ndarray as nd
from .. import recordio
from ..base import numeric_types
from ..context import cpu, current_context
from ..ndarray import NDArray

__all__ = ["imdecode", "imread", "imresize", "scale_down", "resize_short",
           "fixed_crop", "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "Augmenter", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
           "RandomOrderAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "ColorJitterAug", "LightingAug",
           "ColorNormalizeAug", "HorizontalFlipAug", "CastAug",
           "CreateAugmenter", "ImageIter", "ImageRecordIter"]

# ITU-R BT.601 luma weights, shared by the contrast/saturation jitters
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def _pil():
    from PIL import Image
    return Image


def _to_np(img, dtype=None):
    arr = img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)
    return arr.astype(dtype) if dtype is not None else arr


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an image byte buffer to HWC NDArray (reference
    image.py:imdecode — OpenCV there, PIL here; to_rgb matches the
    reference's BGR→RGB flip semantics)."""
    from io import BytesIO
    img = _pil().open(BytesIO(buf if isinstance(buf, (bytes, bytearray))
                              else bytes(buf)))
    if flag == 0:
        arr = np.asarray(img.convert("L"))[:, :, None]
    else:
        arr = np.asarray(img.convert("RGB"))
        if not to_rgb:
            arr = arr[:, :, ::-1]
    return nd.array(arr.astype(np.uint8), dtype=np.uint8)


def imread(filename, flag=1, to_rgb=True):
    """Read an image file (reference image.py: via cv2.imread)."""
    with open(filename, "rb") as fin:
        return imdecode(fin.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=2):
    """Resize to (w, h) (reference: mx.nd.imresize / cv2.resize)."""
    Image = _pil()
    arr = _to_np(src)
    squeeze = arr.ndim == 3 and arr.shape[2] == 1
    img = Image.fromarray(arr[:, :, 0] if squeeze else arr.astype(np.uint8))
    resample = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                3: Image.NEAREST, 4: Image.LANCZOS}.get(interp,
                                                        Image.BILINEAR)
    out = np.asarray(img.resize((w, h), resample))
    if squeeze:
        out = out[:, :, None]
    return nd.array(out.astype(arr.dtype), dtype=arr.dtype)


def scale_down(src_size, size):
    """Shrink the requested crop so it fits inside the source, keeping
    its aspect ratio (reference image.py:scale_down). Shrinks one axis
    at a time so the binding dimension lands exactly on the source
    edge (float-factor rounding would fall one pixel short)."""
    sw, sh = src_size
    w, h = size
    if sh < h:
        w, h = w * sh / h, sh
    if sw < w:
        w, h = sw, h * sw / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so the shorter edge == size (reference
    image.py:resize_short). Integer arithmetic keeps the short edge
    exactly `size`."""
    h, w = src.shape[:2]
    if h > w:
        return imresize(src, size, size * h // w, interp)
    return imresize(src, size * w // h, size, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop + optional resize (reference image.py:fixed_crop)."""
    out = _to_np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(nd.array(out, dtype=out.dtype), size[0], size[1],
                        interp)
    return nd.array(out, dtype=out.dtype)


def _cropped(src, size, interp, place):
    """Shared crop helper: `place(max_x, max_y)` picks the corner."""
    h, w = src.shape[:2]
    cw, ch = scale_down((w, h), size)
    x0, y0 = place(w - cw, h - ch)
    return fixed_crop(src, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)


def random_crop(src, size, interp=2):
    """Random crop to size (reference image.py:random_crop)."""
    return _cropped(src, size, interp,
                    lambda mx_, my: (random.randint(0, mx_),
                                     random.randint(0, my)))


def center_crop(src, size, interp=2):
    """Center crop (reference image.py:center_crop)."""
    return _cropped(src, size, interp,
                    lambda mx_, my: (mx_ // 2, my // 2))


def color_normalize(src, mean, std=None):
    """(src - mean) / std (reference image.py:color_normalize)."""
    arr = _to_np(src, np.float32)
    if mean is not None:
        arr = arr - _to_np(mean, np.float32)
    if std is not None:
        arr = arr / _to_np(std, np.float32)
    return nd.array(arr)


def random_size_crop(src, size, min_area, ratio, interp=2):
    """Random area+aspect crop, center-crop fallback after 10 attempts
    (reference image.py:random_size_crop)."""
    h, w = src.shape[:2]
    for _ in range(10):
        a = h * w * random.uniform(min_area, 1.0)
        r = random.uniform(*ratio)
        cw, ch = int(round((a * r) ** 0.5)), int(round((a / r) ** 0.5))
        if random.random() < 0.5:
            cw, ch = ch, cw
        if cw <= w and ch <= h:
            x0 = random.randint(0, w - cw)
            y0 = random.randint(0, h - ch)
            return fixed_crop(src, x0, y0, cw, ch, size, interp), \
                (x0, y0, cw, ch)
    return center_crop(src, size, interp)


class Augmenter:
    """Image augmenter base (reference image.py:Augmenter). Subclass
    kwargs are recorded for `dumps()` and auto-assigned as attributes."""

    def __init__(self, **kwargs):
        self._kwargs = {
            k: (v.asnumpy().tolist() if isinstance(v, NDArray) else v)
            for k, v in kwargs.items()}
        self.__dict__.update(kwargs)

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    """Resize shorter edge (reference image.py:ResizeAug)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)

    def __call__(self, src):
        return [resize_short(src, self.size, self.interp)]


class ForceResizeAug(Augmenter):
    """Force resize to exact size (reference image.py:ForceResizeAug)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)

    def __call__(self, src):
        return [imresize(src, self.size[0], self.size[1], self.interp)]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)

    def __call__(self, src):
        return [random_crop(src, self.size, self.interp)[0]]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, min_area, ratio, interp=2):
        super().__init__(size=size, min_area=min_area, ratio=ratio,
                         interp=interp)

    def __call__(self, src):
        return [random_size_crop(src, self.size, self.min_area,
                                 self.ratio, self.interp)[0]]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)

    def __call__(self, src):
        return [center_crop(src, self.size, self.interp)[0]]


class RandomOrderAug(Augmenter):
    """Apply child augmenters in a fresh random order each call
    (reference image.py:RandomOrderAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        outs = [src]
        for t in random.sample(self.ts, len(self.ts)):
            outs = [o for item in outs for o in t(item)]
        return outs


def _blend(arr, other, alpha):
    """alpha * arr + (1-alpha) * other — the common jitter formula."""
    return arr * alpha + other * (1.0 - alpha)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.brightness, self.brightness)
        return [nd.array(_to_np(src, np.float32) * alpha)]


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.contrast, self.contrast)
        arr = _to_np(src, np.float32)
        gray = arr @ _LUMA if arr.shape[-1] == 3 else arr[..., 0]
        return [nd.array(_blend(arr, float(gray.mean()), alpha))]


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)

    def __call__(self, src):
        arr = _to_np(src, np.float32)
        if arr.shape[-1] != 3:
            return [nd.array(arr)]    # saturation is a no-op in grayscale
        alpha = 1.0 + random.uniform(-self.saturation, self.saturation)
        luma = (arr @ _LUMA)[:, :, None]
        return [nd.array(_blend(arr, luma, alpha))]


class ColorJitterAug(RandomOrderAug):
    """Brightness+contrast+saturation jitter in random order (reference
    image.py:ColorJitterAug)."""

    def __init__(self, brightness, contrast, saturation):
        kinds = [(brightness, BrightnessJitterAug),
                 (contrast, ContrastJitterAug),
                 (saturation, SaturationJitterAug)]
        super().__init__([cls(mag) for mag, cls in kinds if mag > 0])


class LightingAug(Augmenter):
    """PCA lighting noise (reference image.py:LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd, eigval=eigval, eigvec=eigvec)
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha) @ self.eigval
        return [nd.array(_to_np(src, np.float32) + rgb)]


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def __call__(self, src):
        return [color_normalize(src, self.mean, self.std)]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)

    def __call__(self, src):
        if random.random() >= self.p:
            return [src]
        arr = _to_np(src)
        return [nd.array(arr[:, ::-1].copy(), dtype=arr.dtype)]


class CastAug(Augmenter):
    def __init__(self):
        super().__init__(type="float32")

    def __call__(self, src):
        return [src.astype(np.float32)]


# ImageNet PCA statistics (uint8 scale) used when pca_noise > 0, and the
# conventional mean/std picked up by `mean=True` / `std=True`
_PCA_EIGVAL = [55.46, 4.794, 1.148]
_PCA_EIGVEC = [[-0.5675, 0.7192, 0.4009],
               [-0.5808, -0.0045, -0.8140],
               [-0.5836, -0.6948, 0.4203]]
_IMAGENET_MEAN = [123.68, 116.28, 103.53]
_IMAGENET_STD = [58.395, 57.12, 57.375]


def _default_stat(value, default):
    """Resolve a mean/std kwarg: True -> ImageNet default, array-likes
    validated to 1 or 3 channels, None passed through."""
    if value is True:
        return np.asarray(default)
    if value is None:
        return None
    value = np.asarray(value)
    if value.shape[0] not in (1, 3):
        raise ValueError("mean/std must have 1 or 3 channels")
    return value


def CreateAugmenter(data_shape, resize=0, rand_crop=False,
                    rand_resize=False, rand_mirror=False, mean=None,
                    std=None, brightness=0, contrast=0, saturation=0,
                    pca_noise=0, inter_method=2):
    """Standard augmenter list (reference image.py:CreateAugmenter)."""
    crop = (data_shape[2], data_shape[1])
    if rand_resize and not rand_crop:
        raise ValueError("rand_resize requires rand_crop")

    augs = [ResizeAug(resize, inter_method)] if resize > 0 else []
    if rand_resize:
        augs.append(RandomSizedCropAug(crop, 0.3, (3 / 4, 4 / 3),
                                       inter_method))
    elif rand_crop:
        augs.append(RandomCropAug(crop, inter_method))
    else:
        augs.append(CenterCropAug(crop, inter_method))
    if rand_mirror:
        augs.append(HorizontalFlipAug(0.5))
    augs.append(CastAug())
    if brightness or contrast or saturation:
        augs.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        augs.append(LightingAug(pca_noise, _PCA_EIGVAL, _PCA_EIGVEC))
    mean = _default_stat(mean, _IMAGENET_MEAN)
    std = _default_stat(std, _IMAGENET_STD)
    if mean is not None or std is not None:
        augs.append(ColorNormalizeAug(mean, std))
    return augs


def _parse_imglist_file(path):
    """Parse a .lst file (tab-separated: index, labels..., path) into
    {key: (label_array, path)} plus the key order."""
    table, order = {}, []
    with open(path) as fin:
        for line in fin:
            cells = line.strip().split("\t")
            if not cells or not cells[0]:
                continue
            key = int(cells[0])
            table[key] = (np.array(cells[1:-1], np.float32), cells[-1])
            order.append(key)
    return table, order


def _parse_imglist_arg(entries):
    """Normalize an in-memory [(label(s)..., path), ...] list into the
    same {key: (label_array, path)} shape, keys are 1-based strings."""
    table, order = {}, []
    for i, entry in enumerate(entries, start=1):
        *labels, path = entry
        if len(labels) == 1 and not isinstance(labels[0], numeric_types):
            lab = np.array(labels[0], np.float32)   # nested label list
        else:
            lab = np.array(labels, np.float32)
        table[str(i)] = (lab, path)
        order.append(str(i))
    return table, order


class ImageIter(io.DataIter):
    """Image iterator over .rec files or image lists with augmentation +
    threaded decode (reference image.py:ImageIter:482; C++ analogue
    ImageRecordIOParser2, iter_image_recordio_2.cc:121-319 — the OMP
    decode pool maps to a python ThreadPoolExecutor since PIL/numpy
    release the GIL).

    Batches are made on the context current when the iterator was made.
    ``batches_by_route`` counts the batches the native decoder and the
    PIL path made."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0,
                 num_parts=1, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label",
                 num_threads=4, **kwargs):
        super().__init__()
        if not (path_imgrec or path_imglist or isinstance(imglist, list)):
            raise ValueError("one of path_imgrec / path_imglist / imglist "
                             "is required")
        num_threads = max(1, int(num_threads))
        logging.info("decode pool: %d threads", num_threads)
        self._pool = concurrent.futures.ThreadPoolExecutor(num_threads)

        self.imgrec, self.imgidx = None, None
        if path_imgrec:
            idx_path = path_imgidx or \
                path_imgrec.rsplit(".", 1)[0] + ".idx"
            if os.path.exists(idx_path):
                self.imgrec = recordio.MXIndexedRecordIO(
                    idx_path, path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")

        if path_imglist:
            self.imglist, self.seq = _parse_imglist_file(path_imglist)
        elif isinstance(imglist, list):
            self.imglist, self.seq = _parse_imglist_arg(imglist)
        else:
            self.imglist, self.seq = None, self.imgidx

        self.path_root = path_root

        if len(data_shape) != 3 or data_shape[0] not in (1, 3):
            raise ValueError("data_shape must be (1|3, H, W)")
        self.provide_data = [io.DataDesc(data_name,
                                         (batch_size,) + tuple(data_shape))]
        label_shape = (batch_size, label_width) if label_width > 1 \
            else (batch_size,)
        self.provide_label = [io.DataDesc(label_name, label_shape)]
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        if num_parts > 1 and self.seq is not None:
            # even shard per worker, remainder dropped (reference
            # semantics for num_parts/part_index)
            if part_index >= num_parts:
                raise ValueError("part_index must be < num_parts")
            per = len(self.seq) // num_parts
            self.seq = self.seq[part_index * per:(part_index + 1) * per]
        self.auglist = CreateAugmenter(data_shape, **kwargs) \
            if aug_list is None else aug_list
        self._native = self._native_plan(aug_list, kwargs) \
            if data_shape[0] == 3 else None
        self._nthreads = num_threads
        self._ctx = current_context()
        self.batches_by_route = {"native": 0, "pil": 0}
        self.cur = 0
        self.reset()

    def _native_plan(self, aug_list, kwargs):
        """When the augment pipeline is the standard resize/crop/mirror/
        normalize set, batches can decode through the native C++ pipeline
        (_native/imgdecode.cc) — crop rects computed host-side, decode+
        crop+resize+mirror in one FFI call (the reference's
        ImageRecordIOParser2 path). Returns the plan dict or None."""
        from .. import config as _config
        from . import native_decode
        simple = {"resize", "rand_crop", "rand_mirror", "mean", "std",
                  "inter_method"}
        if (aug_list is not None or not set(kwargs) <= simple or
                not _config.get("MXNET_NATIVE_IMAGE") or
                not native_decode.available()):
            return None
        # the native kernel interpolates bilinearly (like the reference's
        # C++ augmenter); engage only for bilinear/bicubic requests and
        # honour nearest/lanczos via the PIL path
        if kwargs.get("inter_method", 2) not in (1, 2):
            return None
        return {"resize": int(kwargs.get("resize", 0) or 0),
                "rand_crop": bool(kwargs.get("rand_crop", False)),
                "rand_mirror": bool(kwargs.get("rand_mirror", False)),
                "mean": _default_stat(kwargs.get("mean"), _IMAGENET_MEAN),
                "std": _default_stat(kwargs.get("std"), _IMAGENET_STD)}

    def _native_batch(self, samples):
        """Decode a whole batch natively; None if any record's format is
        unsupported (caller falls back to the PIL path)."""
        from . import native_decode
        plan = self._native
        c, oh, ow = self.data_shape
        rects = np.empty((len(samples), 4), np.float32)
        flips = np.zeros(len(samples), np.uint8)
        for i, (_, raw) in enumerate(samples):
            dims = native_decode.probe(raw)
            if dims is None:
                return None
            h, w = dims
            if plan["resize"]:
                # integer resized dims exactly as resize_short computes
                size = plan["resize"]
                rw, rh = (size, size * h // w) if h > w \
                    else (size * w // h, size)
            else:
                rw, rh = w, h
            cw, ch = scale_down((rw, rh), (ow, oh))
            if plan["rand_crop"]:
                x0 = random.randint(0, rw - cw)
                y0 = random.randint(0, rh - ch)
            else:
                x0, y0 = (rw - cw) // 2, (rh - ch) // 2
            # map the resized-coords rect back onto the source image:
            # one bilinear pass composes resize-short + crop + resize
            sx, sy = w / rw, h / rh
            rects[i] = (x0 * sx, y0 * sy, cw * sx, ch * sy)
            if plan["rand_mirror"]:
                flips[i] = random.random() < 0.5
        try:
            out = native_decode.decode_batch(
                [raw for _, raw in samples], rects, flips, (oh, ow),
                n_threads=self._nthreads)
        except RuntimeError:
            # e.g. CMYK JPEG: header probes fine but the RGB decode
            # fails — the PIL path handles these
            return None
        batch = out.astype(np.float32)
        if plan["mean"] is not None:
            batch -= plan["mean"]
        if plan["std"] is not None:
            batch /= plan["std"]
        return batch.transpose(0, 3, 1, 2)   # NHWC -> NCHW

    def reset(self):
        if self.shuffle and self.seq is not None:
            random.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        """Next (label, raw bytes) (reference image.py:next_sample)."""
        if self.seq is None:
            # sequential .rec without index
            rec = self.imgrec.read()
            if rec is None:
                raise StopIteration
            header, img = recordio.unpack(rec)
            return header.label, img
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            header, img = recordio.unpack(self.imgrec.read_idx(idx))
            label = header.label if self.imglist is None \
                else self.imglist[idx][0]
            return label, img
        label, fname = self.imglist[idx]
        return label, self.read_image(fname)

    def _decode_augment(self, label, raw):
        with cpu():     # per-image arrays stay on the host
            data = imdecode(raw, flag=0 if self.data_shape[0] == 1 else 1)
            for aug in self.auglist:
                data = aug(data)[0]
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
                # wrap around (pad semantics like NDArrayIter)
                self.reset()
                while len(samples) < batch_size:
                    samples.append(self.next_sample())
                break

        batch_label = np.empty((batch_size, self.label_width), np.float32) \
            if self.label_width > 1 else np.empty((batch_size,),
                                                  np.float32)
        for i, (label, _) in enumerate(samples):
            batch_label[i] = label

        batch_data = self._native_batch(samples) if self._native else None
        if batch_data is None:
            if self._native and \
                    not getattr(self, "_pil_fallback_logged", False):
                # PIL resize-short-then-crop is two bilinear passes vs
                # the native composed single pass, so augmentation
                # numerics can differ batch-to-batch — make
                # mixed-numerics epochs visible
                logging.debug(
                    "image batch contained a record the native decoder "
                    "can't handle; falling back to PIL for such batches "
                    "(slightly different resample numerics)")
                self._pil_fallback_logged = True
            decoded = list(self._pool.map(
                lambda s: self._decode_augment(*s), samples))
            batch_data = np.empty((batch_size, c, h, w), np.float32)
            for i, (_, img) in enumerate(decoded):
                batch_data[i] = _to_np(img).transpose(2, 0, 1)
            self.batches_by_route["pil"] += 1
        else:
            self.batches_by_route["native"] += 1
        return io.DataBatch([nd.array(batch_data, ctx=self._ctx)],
                            [nd.array(batch_label, ctx=self._ctx)], pad=pad)

    def read_image(self, fname):
        with open(os.path.join(self.path_root or "", fname), "rb") as fin:
            return fin.read()


def ImageRecordIter(path_imgrec=None, data_shape=None, batch_size=None,
                    shuffle=False, rand_crop=False, rand_mirror=False,
                    mean_r=0, mean_g=0, mean_b=0, std_r=0, std_g=0,
                    std_b=0, resize=0, label_width=1,
                    preprocess_threads=4, num_parts=1, part_index=0,
                    prefetch_buffer=4, **kwargs):
    """C++-iterator-compatible factory (reference: registered
    'ImageRecordIter', src/io/iter_image_recordio_2.cc:567). Returns a
    prefetched ImageIter honoring the same kwargs surface."""
    mean = [mean_r, mean_g, mean_b] \
        if any([mean_r, mean_g, mean_b]) else None
    std = [std_r, std_g, std_b] if any([std_r, std_g, std_b]) else None
    kwargs.pop("path_imgidx", None)
    it = ImageIter(batch_size=batch_size, data_shape=tuple(data_shape),
                   label_width=label_width, path_imgrec=path_imgrec,
                   shuffle=shuffle, rand_crop=rand_crop,
                   rand_mirror=rand_mirror, mean=mean, std=std,
                   resize=resize, num_threads=preprocess_threads,
                   num_parts=num_parts, part_index=part_index)
    return io.PrefetchingIter(it)
