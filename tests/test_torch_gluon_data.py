"""The port's ``gluon.data`` against the JAX package's, on the CPU:
samplers, ``ArrayDataset``/``SimpleDataset`` and their transforms,
``DataLoader`` batches (every ``last_batch`` mode, thread workers), the
MNIST / FashionMNIST / CIFAR10 / CIFAR100 readers on tiny files written
here in the upstream formats, ``RecordFileDataset``,
``ImageRecordDataset`` and ``SyntheticImageDataset``. Every array is
compared exactly (no arithmetic happens on the way)."""
import gzip
import os
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _batches(mx, make_loader):
    with mx.cpu():
        out = []
        for b in make_loader(mx):
            parts = b if isinstance(b, (list, tuple)) else [b]
            out.append([p.asnumpy() for p in parts])
        return out


def _assert_same_batches(make_loader):
    j = _batches(jmx, make_loader)
    t = _batches(tmx, make_loader)
    assert len(t) == len(j)
    for bt, bj in zip(t, j):
        assert len(bt) == len(bj)
        for a, b in zip(bt, bj):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    return t


X = np.arange(70, dtype=np.float32).reshape(10, 7)
Y = np.arange(10, dtype=np.int32) % 3


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_batch_sampler_modes(last_batch):
    for mx in (jmx, tmx):
        s = mx.gluon.data.BatchSampler(
            mx.gluon.data.SequentialSampler(10), 4, last_batch)
        got = [list(s), len(s), list(s), len(s)]
        if mx is jmx:
            want = got
        else:
            assert got == want
    with pytest.raises(ValueError, match="last_batch"):
        tmx.gluon.data.BatchSampler(tmx.gluon.data.SequentialSampler(3), 2,
                                    "pad")


def test_random_sampler_draws_numpy_global_stream():
    orders = []
    for mx in (jmx, tmx):
        np.random.seed(3)
        orders.append(list(mx.gluon.data.RandomSampler(12)))
    assert orders[0] == orders[1]
    assert sorted(orders[1]) == list(range(12))


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_batches_match_jax(last_batch, workers):
    """An ArrayDataset of (features, labels) through a DataLoader: the
    same batches in the same dtypes, two epochs (rollover carries the
    tail into the second)."""
    def make(mx):
        loader = mx.gluon.data.DataLoader(
            mx.gluon.data.ArrayDataset(X, Y), batch_size=4,
            last_batch=last_batch, num_workers=workers)
        return list(loader) + list(loader)
    got = _assert_same_batches(make)
    assert got[0][0].shape == (4, 7) and got[0][1].dtype == np.int32


def test_dataloader_lands_on_the_current_context():
    with tmx.cpu():
        x, y = next(iter(tmx.gluon.data.DataLoader(
            tmx.gluon.data.ArrayDataset(X, Y), batch_size=5)))
    assert isinstance(x, tmx.nd.NDArray) and x.handle.device.type == "cpu"
    with pytest.raises(ValueError, match="batch_sampler"):
        tmx.gluon.data.DataLoader(tmx.gluon.data.ArrayDataset(X),
                                  batch_size=2, batch_sampler=[[0, 1]])


def test_shuffled_loader_and_nd_dataset_match_jax():
    def make(mx):
        np.random.seed(5)
        ds = mx.gluon.data.ArrayDataset(mx.nd.array(X), Y)
        return list(mx.gluon.data.DataLoader(ds, batch_size=3,
                                             shuffle=True))
    _assert_same_batches(make)


def test_simple_dataset_and_transforms_match_jax():
    def make(mx):
        ds = mx.gluon.data.dataset.SimpleDataset(
            [(X[i], int(Y[i])) for i in range(10)])
        lazy = ds.transform(lambda x, y: (x * 2, y + 1))
        eager = ds.transform_first(lambda x: x - 1, lazy=False)
        assert len(lazy) == len(eager) == 10
        return [[mx.nd.array(lazy[i][0]), mx.nd.array(eager[i][0])]
                for i in range(10)]
    _assert_same_batches(make)


def _write_mnist(root, n, gz):
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lbls = rng.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    os.makedirs(root, exist_ok=True)
    for name, header, body in (
            ("train-images-idx3-ubyte", struct.pack(">IIII", 2051, n, 28,
                                                    28), imgs),
            ("train-labels-idx1-ubyte", struct.pack(">II", 2049, n), lbls)):
        with opener(os.path.join(root, name + suffix), "wb") as f:
            f.write(header + body.tobytes())
    return imgs, lbls


@pytest.mark.parametrize("kind", ["MNIST", "FashionMNIST"])
def test_mnist_readers_match_jax(tmp_path, kind):
    root = str(tmp_path / kind)
    imgs, lbls = _write_mnist(root, 6, gz=kind == "MNIST")

    def make(mx):
        ds = getattr(mx.gluon.data.vision, kind)(root=root, train=True)
        return list(mx.gluon.data.DataLoader(ds, batch_size=4))
    got = _assert_same_batches(make)
    np.testing.assert_array_equal(got[0][0][..., 0], imgs[:4])
    np.testing.assert_array_equal(got[1][1], lbls[4:])
    with pytest.raises(IOError, match="not found"):
        tmx.gluon.data.vision.MNIST(root=root, train=False)


@pytest.mark.parametrize("kind", ["CIFAR10", "CIFAR100"])
def test_cifar_readers_match_jax(tmp_path, kind):
    rng = np.random.RandomState(2)
    root = str(tmp_path / kind)
    os.makedirs(root)
    nlab = 1 if kind == "CIFAR10" else 2
    rows = rng.randint(0, 256, (5, nlab + 3072)).astype(np.uint8)
    rows[:, :nlab] %= 10
    files = ["test_batch.bin"] if kind == "CIFAR10" else ["test.bin"]
    for f in files:
        rows.tofile(os.path.join(root, f))

    def make(mx):
        kw = {"fine_label": True} if kind == "CIFAR100" else {}
        ds = getattr(mx.gluon.data.vision, kind)(root=root, train=False,
                                                 **kw)
        return list(mx.gluon.data.DataLoader(
            ds.transform_first(lambda x: x.astype(np.float32) / 255),
            batch_size=5))
    got = _assert_same_batches(make)
    assert got[0][0].shape == (5, 32, 32, 3)
    np.testing.assert_array_equal(got[0][1], rows[:, nlab - 1])


def test_record_datasets_match_jax(tmp_path):
    """A .rec/.idx pair written by the port's recordio: the raw records
    through RecordFileDataset and PNG images through
    ImageRecordDataset (recordio.unpack_img), in both packages."""
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    rng = np.random.RandomState(4)
    imgs = rng.randint(0, 256, (3, 8, 6, 3)).astype(np.uint8)
    w = tmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i, img in enumerate(imgs):
        w.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, float(i), i, 0), img, img_fmt=".png"))
    w.close()
    raw = []
    for mx in (jmx, tmx):
        ds = mx.gluon.data.RecordFileDataset(rec)
        raw.append([ds[i] for i in range(len(ds))])
    assert raw[0] == raw[1] and len(raw[1]) == 3

    def make(mx):
        ds = mx.gluon.data.vision.ImageRecordDataset(rec)
        return [[mx.nd.array(ds[i][0]), mx.nd.array([ds[i][1]])]
                for i in range(len(ds))]
    got = _assert_same_batches(make)
    np.testing.assert_array_equal(got[2][0], imgs[2])


def test_synthetic_image_dataset_matches_jax():
    def make(mx):
        ds = mx.gluon.data.vision.SyntheticImageDataset(
            length=6, shape=(4, 4, 3), num_classes=5, seed=9)
        return list(mx.gluon.data.DataLoader(ds, batch_size=3))
    _assert_same_batches(make)
