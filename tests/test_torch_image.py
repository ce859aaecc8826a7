"""The port's image data plane against the JAX package, on the CPU: the
functions and every augmenter of ``image/image.py`` and
``image/detection.py``, the augmenter lists, ``ImageIter`` on the PIL and
the native routes, ``ImageDetIter``, the two ``mx.io`` factories, and the
native RecordIO reader under ``recordio``.

Every comparison is bit-equal (``assert_array_equal``, dtypes equal):
both packages run the same host code (numpy, PIL, the same C++ source
built with the same g++ flags) on the same inputs, with Python's
``random`` and numpy's global state seeded alike before each side. The
images are small (40-64 px), made from numpy seeds and packed into
``tmp_path``. Random augmenters go through ``ImageIter`` with one decode
thread (the pool's threads take the draws in their own order, Queue C
26); deterministic ones with four. The native cases skip where g++ or
libjpeg/libpng cannot build the decoder, and say so.
"""
import io as _io
import os
import pickle
import random
import struct
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu.image import detection as jdet
from mxnet_tpu.image import image as jimg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _native
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.image import detection as tdet
from mxnet_tpu_torch.image import image as timg
from mxnet_tpu_torch.image import native_decode as tnative

PKGS = {"jax": (jmx, jimg, jdet, jrec), "port": (tmx, timg, tdet, trec)}
MAGIC = struct.pack("<I", 0xced7230a)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(t, j):
    """Bit-equal arrays of one dtype (an NDArray, numpy array or a list /
    tuple of them)."""
    if isinstance(t, (list, tuple)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b)
        return
    if isinstance(t, (int, float, str)) or t is None:
        assert t == j
        return
    a, b = _np(t), _np(j)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _both(fn, seed=0):
    """fn(mx, image, detection, recordio) in each package, with both
    random streams seeded by ``seed`` before each."""
    out = {}
    for name, mods in PKGS.items():
        _seed(seed)
        out[name] = fn(*mods)
    return out["port"], out["jax"]


def _image(h, w, seed):
    """Smooth content (photo-like, so JPEG compresses as it does photos)
    with a little noise, uint8 HWC."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(0.05, 0.3, 3)
    base = np.stack([128 + 100 * np.sin(xx * f[0] + yy * 0.07),
                     128 + 100 * np.cos(yy * f[1]),
                     (xx + yy) * 255.0 / (h + w) + 30 * np.sin(xx * f[2])],
                    axis=2)
    return np.clip(base + rng.randint(0, 12, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _encode(arr, fmt="JPEG", mode=None):
    from PIL import Image
    pil = Image.fromarray(arr)
    if mode is not None:
        pil = pil.convert(mode)
    buf = _io.BytesIO()
    pil.save(buf, format=fmt, **({"quality": 95} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _dumps(aug):
    """aug.dumps(), or the error's type where its kwargs hold a numpy
    array (JSON cannot write one, in either package)."""
    try:
        return aug.dumps()
    except TypeError as e:
        return type(e).__name__


def _native_ok():
    from mxnet_tpu.image import native_decode as jnative
    return tnative.available() and jnative.available()


native = pytest.mark.skipif(
    not _native_ok(), reason="the native image decoder cannot be built "
    "here (g++, jpeglib.h/png.h or libjpeg/libpng missing)")

# -- the functions --------------------------------------------------------

FUNCS = {
    "imdecode_jpeg": lambda mx, im, img: im.imdecode(_encode(img)),
    "imdecode_png": lambda mx, im, img: im.imdecode(_encode(img, "PNG")),
    "imdecode_gray": lambda mx, im, img: im.imdecode(_encode(img), flag=0),
    "imdecode_bgr": lambda mx, im, img: im.imdecode(_encode(img),
                                                    to_rgb=False),
    "imdecode_cmyk": lambda mx, im, img: im.imdecode(
        _encode(img, mode="CMYK")),
    "imresize": lambda mx, im, img: [
        im.imresize(mx.nd.array(img, dtype=np.uint8), 37, 29, interp=k)
        for k in range(5)],
    "imresize_gray": lambda mx, im, img: im.imresize(
        mx.nd.array(img[:, :, :1], dtype=np.uint8), 20, 30),
    "resize_short": lambda mx, im, img: [
        im.resize_short(mx.nd.array(img, dtype=np.uint8), 33),
        im.resize_short(mx.nd.array(img.transpose(1, 0, 2).copy(),
                                    dtype=np.uint8), 33, interp=1)],
    "scale_down": lambda mx, im, img: [
        im.scale_down((48, 40), (64, 30)), im.scale_down((30, 50), (40, 60)),
        im.scale_down((50, 50), (20, 20))],
    "fixed_crop": lambda mx, im, img: [
        im.fixed_crop(mx.nd.array(img, dtype=np.uint8), 3, 5, 20, 17),
        im.fixed_crop(mx.nd.array(img, dtype=np.uint8), 3, 5, 20, 17,
                      size=(24, 24), interp=1)],
    "random_crop": lambda mx, im, img: [
        (lambda o: [o[0], list(o[1])])(
            im.random_crop(mx.nd.array(img, dtype=np.uint8), (24, 20)))
        for _ in range(3)],
    "center_crop": lambda mx, im, img: (lambda o: [o[0], list(o[1])])(
        im.center_crop(mx.nd.array(img, dtype=np.uint8), (70, 30))),
    "color_normalize": lambda mx, im, img: [
        im.color_normalize(mx.nd.array(img, dtype=np.uint8),
                           mx.nd.array([123.68, 116.28, 103.53]),
                           mx.nd.array([58.395, 57.12, 57.375])),
        im.color_normalize(mx.nd.array(img.astype(np.float32)),
                           np.float32(3.5))],
    "random_size_crop": lambda mx, im, img: [
        (lambda o: [o[0], list(o[1])])(im.random_size_crop(
            mx.nd.array(img, dtype=np.uint8), (24, 24), 0.3, (0.75, 1.33)))
        for _ in range(4)] + [
        # an area no crop fits: ten draws, then the center crop
        (lambda o: [o[0], list(o[1])])(im.random_size_crop(
            mx.nd.array(img, dtype=np.uint8), (24, 24), 5.0, (4.0, 5.0)))],
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_functions_bit_equal(name):
    img = _image(44, 58, 1)
    t, j = _both(lambda mx, im, det, rec: FUNCS[name](mx, im, img), seed=7)
    _same(t, j)


def test_imdecode_keeps_uint8_and_the_current_context():
    buf = _encode(_image(40, 48, 2))
    out = timg.imdecode(buf)
    assert out.dtype == np.uint8 and str(out.context) == "cpu(0)"
    assert out._data.dtype.is_floating_point is False
    assert tmx.nd.array(np.zeros(3, np.uint8), dtype=np.uint8).dtype == \
        np.uint8

# -- the augmenters -------------------------------------------------------


def _augs(mx, im, det):
    eig = (im._PCA_EIGVAL, im._PCA_EIGVEC)
    return {
        "ResizeAug": im.ResizeAug(30, 1),
        "ForceResizeAug": im.ForceResizeAug((26, 34)),
        "RandomCropAug": im.RandomCropAug((24, 24)),
        "RandomSizedCropAug": im.RandomSizedCropAug((24, 24), 0.3,
                                                    (3 / 4, 4 / 3)),
        "CenterCropAug": im.CenterCropAug((24, 30)),
        "RandomOrderAug": im.RandomOrderAug(
            [im.BrightnessJitterAug(0.3), im.HorizontalFlipAug(0.5),
             im.CastAug()]),
        "BrightnessJitterAug": im.BrightnessJitterAug(0.4),
        "ContrastJitterAug": im.ContrastJitterAug(0.4),
        "SaturationJitterAug": im.SaturationJitterAug(0.4),
        "ColorJitterAug": im.ColorJitterAug(0.3, 0.3, 0.3),
        "LightingAug": im.LightingAug(0.1, *eig),
        "ColorNormalizeAug": im.ColorNormalizeAug(
            np.array([123.68, 116.28, 103.53]), np.array([58.4, 57.1, 57.4])),
        "HorizontalFlipAug": im.HorizontalFlipAug(0.5),
        "CastAug": im.CastAug(),
    }


@pytest.mark.parametrize("name", sorted(_augs(tmx, timg, tdet)))
def test_augmenters_bit_equal(name):
    img = _image(40, 52, 3)

    def run(mx, im, det, rec):
        aug = _augs(mx, im, det)[name]
        src = mx.nd.array(img, dtype=np.uint8)
        outs = [aug(src)[0] for _ in range(4)]
        gray = aug(mx.nd.array(img[:, :, :1].astype(np.float32)))[0] \
            if name in ("ContrastJitterAug", "SaturationJitterAug") else None
        return outs + ([gray] if gray is not None else []), _dumps(aug)
    (t, td), (j, jd) = _both(run, seed=11)
    _same(t, j)
    assert td == jd


def _det_label(n, seed):
    """(n, 5) [id, x1, y1, x2, y2] in [0, 1], some rows padding (-1)."""
    rng = np.random.RandomState(seed)
    out = -np.ones((n, 5), np.float32)
    for i in range(n - 1):
        w, h = rng.uniform(0.2, 0.6, 2)
        x, y = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
        out[i] = (rng.randint(0, 20), x, y, x + w, y + h)
    return out


def _det_augs(mx, im, det):
    crop = det.DetRandomCropAug(0.5, (0.75, 1.33), (0.3, 1.0), 20)
    return {
        "DetBorderAug": det.DetBorderAug(im.BrightnessJitterAug(0.3)),
        "DetRandomSelectAug": det.DetRandomSelectAug(
            [det.DetHorizontalFlipAug(1.0), crop], skip_prob=0.3),
        "DetHorizontalFlipAug": det.DetHorizontalFlipAug(0.5),
        "DetRandomCropAug": crop,
        "DetRandomCropAug_strict": det.DetRandomCropAug(
            0.95, (0.5, 2.0), (0.05, 0.4), 50),
        "DetForceResizeAug": det.DetForceResizeAug((30, 26), 1),
    }


@pytest.mark.parametrize("name", sorted(_det_augs(tmx, timg, tdet)))
def test_det_augmenters_bit_equal(name):
    """DetRandomCropAug draws a varying number of times an image (its
    attempts); six images in a row keep both streams in step."""
    img = _image(48, 60, 4)

    def run(mx, im, det, rec):
        aug = _det_augs(mx, im, det)[name]
        outs = []
        for k in range(6):
            src, lab = aug(mx.nd.array(img, dtype=np.uint8),
                           _det_label(4, k))
            outs += [src, lab]
        return outs, _dumps(aug), random.random(), np.random.rand()
    t, j = _both(run, seed=5)
    _same(t[0], j[0])
    assert t[1:] == j[1:]


AUG_LISTS = [
    dict(),
    dict(resize=40, rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(rand_crop=True, rand_resize=True, brightness=0.1, contrast=0.2,
         saturation=0.3, pca_noise=0.05, inter_method=1),
    dict(mean=[1.0, 2.0, 3.0], std=np.array([2.0])),
]


@pytest.mark.parametrize("kw", range(len(AUG_LISTS)))
def test_create_augmenter_lists_item_by_item(kw):
    t, j = _both(lambda mx, im, det, rec: im.CreateAugmenter(
        (3, 24, 28), **AUG_LISTS[kw]))
    assert [type(a).__name__ for a in t] == [type(a).__name__ for a in j]
    assert [_dumps(a) for a in t] == [_dumps(a) for a in j]
    img = _image(42, 50, 6)
    outs = []
    for augs, mx in ((t, tmx), (j, jmx)):
        _seed(3)
        data = mx.nd.array(img, dtype=np.uint8)
        for a in augs:
            data = a(data)[0]
        outs.append(data)
    _same(*outs)
    with pytest.raises(ValueError):
        timg.CreateAugmenter((3, 24, 24), rand_resize=True)
    with pytest.raises(ValueError):
        timg.CreateAugmenter((3, 24, 24), mean=[1.0, 2.0])


DET_LISTS = [
    dict(),
    dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True, std=True),
    dict(rand_crop=1, mean=np.array([123, 117, 104]), area_range=(0.1, 2.0),
         min_object_covered=0.3, max_attempts=10),
]


@pytest.mark.parametrize("kw", range(len(DET_LISTS)))
def test_create_det_augmenter_lists_item_by_item(kw):
    t, j = _both(lambda mx, im, det, rec: det.CreateDetAugmenter(
        (3, 30, 26), **DET_LISTS[kw]))

    def desc(augs):
        return [(type(a).__name__, _dumps(a),
                 _dumps(getattr(a, "augmenter", a)),
                 [_dumps(b) for b in getattr(a, "aug_list", [])])
                for a in augs]
    assert desc(t) == desc(j)

# -- record files ---------------------------------------------------------


def _pack(path, n, seed, rec=trec, labels=None, fmts=("JPEG",), sizes=None,
          cmyk=()):
    """n seeded images (40..64 px) into path.rec / path.idx; labels[i]
    (a float or an array) or i % 5."""
    w = rec.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, wd = sizes[i] if sizes else rng.randint(40, 65, 2)
        img = _image(int(h), int(wd), seed * 1000 + i)
        buf = _encode(img, fmts[i % len(fmts)],
                      mode="CMYK" if i in cmyk else None)
        lab = float(i % 5) if labels is None else labels[i]
        w.write_idx(i, rec.pack(rec.IRHeader(0, lab, i, 0), buf))
    w.close()
    return path + ".rec"


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        it.reset()
        out.append([(b.data[0], b.label[0], b.pad) for b in it])
    if getattr(it, "_inflight", False):
        # a prefetcher keeps one batch in flight: let its draws finish
        # before the other package seeds the streams
        it._collect()
    return out


def _iter_pair(make, seed=0, epochs=2):
    t, j = _both(lambda mx, im, det, rec: _epochs(make(mx, im, det), epochs),
                 seed=seed)
    assert len(t) == len(j) and all(len(a) == len(b) for a, b in zip(t, j))
    for et, ej in zip(t, j):
        for (td, tl, tp), (jd, jl, jp) in zip(et, ej):
            _same(td, jd)
            _same(tl, jl)
            assert tp == jp
    return t


def test_pil_route_random_augmenters_one_thread(tmp_path):
    rec = _pack(str(tmp_path / "a"), 11, 1, fmts=("JPEG", "PNG"))
    got = _iter_pair(lambda mx, im, det: im.ImageIter(
        4, (3, 24, 24), path_imgrec=rec, shuffle=True, rand_crop=True,
        rand_mirror=True, brightness=0.2, contrast=0.2, saturation=0.2,
        pca_noise=0.1, mean=True, std=True, num_threads=1), seed=3)
    # the padded batch wraps into the next pass (reset inside next), so
    # the epoch ends where a pass ends on a batch boundary
    assert [b[2] for b in got[0]][:3] == [0, 0, 1]


def test_pil_route_deterministic_four_threads(tmp_path):
    rec = _pack(str(tmp_path / "a"), 10, 2)
    _iter_pair(lambda mx, im, det: im.ImageIter(
        3, (3, 20, 28), path_imgrec=rec, resize=30, inter_method=3,
        num_threads=4))
    _iter_pair(lambda mx, im, det: im.ImageIter(
        3, (1, 24, 24), path_imgrec=rec, num_threads=4))


def test_pil_route_parts_and_sequential_reader(tmp_path):
    rec = _pack(str(tmp_path / "a"), 13, 3)
    for part in (0, 2):
        _iter_pair(lambda mx, im, det: im.ImageIter(
            2, (3, 24, 24), path_imgrec=rec, num_parts=3, part_index=part,
            shuffle=True, rand_crop=True, aug_list=None, num_threads=1,
            inter_method=4))
    os.remove(str(tmp_path / "a.idx"))        # no index: sequential reads
    _iter_pair(lambda mx, im, det: im.ImageIter(
        5, (3, 24, 24), path_imgrec=rec, num_threads=2, inter_method=0))


def test_pil_route_imglist(tmp_path):
    root = tmp_path / "imgs"
    root.mkdir()
    entries = []
    for i in range(5):
        name = "im%d.jpg" % i
        (root / name).write_bytes(_encode(_image(40 + i, 50, 40 + i)))
        entries.append([float(i), float(-i), name])
    with open(tmp_path / "list.lst", "w") as f:
        for i, e in enumerate(entries):
            f.write("%d\t%g\t%g\t%s\n" % (i, e[0], e[1], e[2]))
    for kw in (dict(imglist=entries), dict(path_imglist=str(
            tmp_path / "list.lst"))):
        _iter_pair(lambda mx, im, det: im.ImageIter(
            2, (3, 24, 24), label_width=2, path_root=str(root),
            num_threads=1, rand_crop=True, shuffle=True, **kw), seed=4)


@native
@pytest.mark.parametrize("kw", [
    dict(),
    dict(rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(resize=36, rand_crop=True, rand_mirror=True, inter_method=1,
         mean=[123.68, 116.779, 103.939], std=[58.395, 57.12, 57.375]),
    dict(resize=50, shuffle=True),
])
def test_native_route_bit_equal(tmp_path, kw):
    rec = _pack(str(tmp_path / "a"), 9, 5, fmts=("JPEG", "JPEG", "PNG"))
    kw = dict(kw)
    shuffle = kw.pop("shuffle", False)

    def make(mx, im, det):
        it = im.ImageIter(4, (3, 24, 28), path_imgrec=rec, shuffle=shuffle,
                          num_threads=3, **kw)
        assert it._native is not None
        return it
    _iter_pair(make, seed=8)
    it = make(tmx, timg, tdet)
    n = len(list(it))
    assert it.batches_by_route == {"native": n, "pil": 0}


@native
def test_native_route_cmyk_batch_falls_back_to_pil(tmp_path):
    rec = _pack(str(tmp_path / "a"), 8, 6, cmyk=(5,))
    its = {}

    def make(mx, im, det):
        its[mx.__name__] = it = im.ImageIter(
            4, (3, 24, 24), path_imgrec=rec, rand_crop=True, rand_mirror=True,
            mean=True, num_threads=1)
        return it
    _iter_pair(make, seed=2, epochs=1)
    for it in its.values():
        assert it._pil_fallback_logged
    assert its["mxnet_tpu_torch"].batches_by_route == {"native": 1, "pil": 1}


def _det_rec(path, n, seed, rec=trec):
    rng = np.random.RandomState(seed)
    labels = []
    for i in range(n):
        boxes = _det_label(int(rng.randint(2, 5)), seed * 100 + i)[:-1]
        labels.append(np.concatenate([[2, 5], boxes.ravel()]).astype(
            np.float32))
    return _pack(path, n, seed, rec=rec, labels=labels)


def test_image_det_iter_bit_equal(tmp_path):
    rec = _det_rec(str(tmp_path / "d"), 7, 7)

    def random_augs(mx, im, det):
        it = det.ImageDetIter(3, (3, 30, 30), path_imgrec=rec, shuffle=True,
                              rand_crop=1, rand_mirror=True, mean=True,
                              std=True, min_object_covered=0.3,
                              max_objects=4)
        it._pool.shutdown()
        it._pool = ThreadPoolExecutor(1)      # one thread: the draws' order
        return it
    got = _iter_pair(random_augs, seed=6)
    assert tuple(got[0][0][1].shape) == (3, 4, 5)
    assert [b[2] for b in got[0]][:3] == [0, 0, 2]
    _iter_pair(lambda mx, im, det: det.ImageDetIter(
        4, (3, 28, 24), path_imgrec=rec, mean=True))


@native
def test_io_factories_bit_equal(tmp_path):
    rec = _pack(str(tmp_path / "a"), 10, 9)
    kw = dict(path_imgrec=rec, data_shape=(3, 24, 24), batch_size=4,
              shuffle=True, rand_crop=True, rand_mirror=True,
              mean_r=123.68, mean_g=116.779, mean_b=103.939, std_r=58.395,
              std_g=57.12, std_b=57.375, preprocess_threads=2,
              data_name="data", label_name="softmax_label", pad=0)
    its = {}

    def make(mx, im, det):
        its[mx.__name__] = it = mx.io.ImageRecordIter(**kw)
        return it
    _iter_pair(make, seed=1)
    inner = its["mxnet_tpu_torch"].iters[0]
    assert inner._native is not None and inner.imgrec._native is not None
    assert inner.batches_by_route["pil"] == 0
    # ImageDetIter decodes on four threads whatever it is given, so its
    # factory is held on deterministic augmenters (Queue C 26)
    drec = _det_rec(str(tmp_path / "d"), 6, 3)
    _iter_pair(lambda mx, im, det: mx.io.ImageDetRecordIter(
        path_imgrec=drec, data_shape=(3, 30, 30), batch_size=4,
        mean=np.array([123, 117, 104]), std=True, preprocess_threads=4,
        prefetch_buffer=2), seed=4)


def test_batches_on_the_iterators_context(tmp_path):
    rec = _pack(str(tmp_path / "a"), 4, 10)
    it = tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 24, 24),
                                batch_size=4)
    b = next(iter(it))
    assert b.data[0].context == tmx.cpu() and b.label[0].dtype == np.float32

# -- the native RecordIO reader --------------------------------------------


def _payloads(n=23, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if i % 5 == 2:      # the aligned magic word: split into parts
            out.append(b"abcd" + MAGIC + rng.bytes(8) + MAGIC + MAGIC +
                       b"tail")
        elif i % 7 == 6:
            out.append(b"")
        else:
            out.append(rng.bytes(int(rng.randint(1, 90))))
    return out


@pytest.fixture
def corpus(tmp_path):
    idx, path = str(tmp_path / "c.idx"), str(tmp_path / "c.rec")
    w = trec.MXIndexedRecordIO(idx, path, "w")
    for i, p in enumerate(_payloads()):
        w.write_idx(i * 2 + 1, p)
    w.close()
    return idx, path


def _native_reader_ok():
    return _native.load("recordio") is not None


native_reader = pytest.mark.skipif(
    not _native_reader_ok(), reason="g++ cannot build the native reader")


@native_reader
def test_native_record_file_matches_jax(corpus):
    from mxnet_tpu._native import NativeRecordFile as JFile
    idx, path = corpus
    t, j = _native.NativeRecordFile(path), JFile(path)
    assert len(t) == len(j) == len(_payloads()) and t.size == j.size
    offsets = [t.offset(i) for i in range(len(t))]
    assert offsets == [j.offset(i) for i in range(len(j))]
    assert t.offset(len(t)) == j.offset(len(t)) == -1
    for i, want in enumerate(_payloads()):
        assert t.read(i) == j.read(i) == want
    for off in offsets + [0, 1, 4, offsets[-1] + 1, t.size]:
        assert t.find_offset(off) == j.find_offset(off)
    with pytest.raises(IndexError):
        t.read(len(t))
    t.close()
    j.close()


@native_reader
@pytest.mark.parametrize("knob", [True, False])
def test_tell_and_seek_with_the_native_knob(corpus, knob):
    idx, path = corpus
    tconfig.set_override("MXNET_NATIVE_RECORDIO", knob)
    try:
        t = trec.MXIndexedRecordIO(idx, path, "r")
        j = jrec.MXIndexedRecordIO(idx, path, "r")
        j._native = j._native if knob else None
        assert (t._native is not None) == knob
        tells = []
        for r in (t, j):
            seq = [r.tell()]
            for _ in range(5):
                r.read()
                seq.append(r.tell())
            r.seek(9)
            seq += [r.tell(), r.read(), r.tell()]
            r.reset()
            seq += [r.tell(), r.read()]
            tells.append(seq)
        assert tells[0] == tells[1]
        for k in reversed(t.keys):
            assert t.read_idx(k) == _payloads()[(k - 1) // 2]
        assert (t._native is not None) == knob
        t.close()
        j.close()
    finally:
        tconfig.clear_override("MXNET_NATIVE_RECORDIO")


@native_reader
def test_native_reader_pickles_without_the_mmap(corpus):
    idx, path = corpus
    r = trec.MXIndexedRecordIO(idx, path, "r")
    r.read()
    blob = pickle.dumps(r)
    back = pickle.loads(blob)
    assert back._native is not None and back.read_idx(5) == _payloads()[2]
    assert [back.read() for _ in range(2)] == _payloads()[3:5]
    back.close()


@native_reader
def test_torn_file_takes_the_strict_python_reader(corpus):
    idx, path = corpus
    with open(path, "ab") as f:
        f.write(b"JUNKJUNK")                   # no record's magic
    for rec in (trec, jrec):
        r = rec.MXRecordIO(path, "r")
        assert r._native is None
        got = [r.read() for _ in _payloads()]
        assert got == _payloads()
        with pytest.raises(AssertionError, match="magic"):
            r.read()
        r.close()


@native_reader
def test_bad_index_sidecar_drops_the_native_index(corpus):
    idx, path = corpus
    with open(idx, "a") as f:
        f.write("99\t6\n")                     # not a record's offset
    r = trec.MXIndexedRecordIO(idx, path, "r")
    j = jrec.MXIndexedRecordIO(idx, path, "r")
    assert r._native is not None
    r.seek(99)
    j.seek(99)
    assert r._native is None and j._native is None
    assert r.read_idx(3) == j.read_idx(3) == _payloads()[1]

# -- the build ------------------------------------------------------------


# sizeof/offsetof of what imgdecode.cc touches in jpeglib.h and png.h
_LAYOUT_SRC = r"""
#include <cstddef>
#include <cstdio>
#include <jpeglib.h>
#include <png.h>
int main() {
  png_image p; p.format = PNG_FORMAT_RGB; p.width = 7; p.height = 5;
  p.colormap_entries = 0;
  std::printf("%d %zu %zu %zu %zu %zu %zu %zu %zu %zu %zu %d %d %d\n",
    JPEG_LIB_VERSION, sizeof(jpeg_decompress_struct),
    sizeof(jpeg_error_mgr), offsetof(jpeg_decompress_struct, err),
    offsetof(jpeg_decompress_struct, image_width),
    offsetof(jpeg_decompress_struct, out_color_space),
    offsetof(jpeg_decompress_struct, output_width),
    offsetof(jpeg_decompress_struct, output_scanline),
    sizeof(png_image), offsetof(png_image, format),
    (size_t)PNG_IMAGE_SIZE(p), (int)JCS_RGB, PNG_IMAGE_VERSION, TRUE);
}
"""


def test_compat_headers_match_the_system_abi(tmp_path):
    """The card's build declares libjpeg (ABI 62) and libpng's simplified
    API from ``_native/compat``: the layouts imgdecode.cc relies on equal
    the system headers' where the machine has them."""
    import shutil
    if shutil.which("g++") is None or not os.path.exists(
            "/usr/include/jpeglib.h") or not os.path.exists(
            "/usr/include/png.h"):
        pytest.skip("no g++ or no system jpeglib.h/png.h to compare with")
    (tmp_path / "layout.cc").write_text(_LAYOUT_SRC)
    outs = []
    for extra in ([], ["-I", str(_native._DIR / "compat")]):
        exe = str(tmp_path / ("layout%d" % len(extra)))
        subprocess.run(["g++", "-std=c++17", *extra,
                        str(tmp_path / "layout.cc"), "-o", exe], check=True,
                       capture_output=True, timeout=120)
        outs.append(subprocess.run([exe], check=True, capture_output=True,
                                   text=True).stdout)
    if not outs[0].startswith("62 "):
        pytest.skip("the system's libjpeg is not ABI 62: %s" % outs[0])
    assert outs[0] == outs[1]


@native
def test_build_links_the_wheel_libraries_where_the_system_has_none(
        tmp_path, monkeypatch):
    """Where ``-ljpeg -lpng`` cannot link (the card's machine), the build
    links Pillow's bundled copies with the compat headers, and that
    library decodes as the system one does. A library already built that
    does not load here (one copied from another machine) is passed over,
    not rebuilt."""
    if _native._wheel_libs(["-ljpeg", "-lpng"]) is None:
        pytest.skip("this Pillow ships no libjpeg/libpng copies")
    sys_lib = _native.load("imgdecode")
    real = subprocess.run
    cmds = []

    def run(cmd, **kw):
        cmds.append(cmd)
        if not any("pillow.libs" in c for c in cmd):
            raise subprocess.CalledProcessError(1, cmd)
        return real(cmd, **kw)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_LIBS", {})
    monkeypatch.setattr(_native.subprocess, "run", run)
    (system, _), (wheel, _) = _native._candidates("imgdecode")
    system.write_bytes(b"not a library")
    lib = _native.load("imgdecode")
    assert lib is not None and wheel.exists() and len(cmds) == 1
    assert "-idirafter" in cmds[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [system.name, wheel.name])
    import ctypes
    bufs = [_encode(_image(45, 61, 12)), _encode(_image(50, 40, 13), "PNG")]
    rects = np.array([[2.5, 1.0, 40.0, 30.0], [0, 0, 0, 0]], np.float32)
    outs = []
    for handle in (lib, sys_lib):
        handle.imgd_batch.argtypes = sys_lib.imgd_batch.argtypes
        arr = (ctypes.c_char_p * 2)(*bufs)
        out = np.empty((2, 20, 22, 3), np.uint8)
        assert handle.imgd_batch(arr, np.array([len(b) for b in bufs],
                                               np.int64), 2, rects,
                                 np.array([1, 0], np.uint8), 20, 22, out,
                                 1) == 0
        outs.append(out)
    np.testing.assert_array_equal(*outs)


@native
def test_native_decode_batch_and_probe_match_jax():
    from mxnet_tpu.image import native_decode as jnative
    bufs = [_encode(_image(41 + k, 57, 20 + k), ("JPEG", "PNG")[k % 2])
            for k in range(5)]
    rects = np.array([[0, 0, 0, 0], [3.25, 2.0, 30.0, 20.5],
                      [1, 1, 50, 30], [0, 0, 57, 41], [10, 5, 5, 5]],
                     np.float32)
    flips = np.array([0, 1, 0, 1, 1], np.uint8)
    for buf in bufs + [b"\xff\xd8garbage", b"nope"]:
        assert tnative.probe(buf) == jnative.probe(buf)
    _same(tnative.decode_batch(bufs, rects, flips, (17, 23), n_threads=3),
          jnative.decode_batch(bufs, rects, flips, (17, 23), n_threads=3))
    with pytest.raises(RuntimeError, match="record 1"):
        tnative.decode_batch([bufs[0], _encode(_image(40, 40, 1),
                                               mode="CMYK")],
                             rects[:2], flips[:2], (8, 8))
