"""Vision datasets (reference: python/mxnet/gluon/data/vision.py —
MNIST/FashionMNIST/CIFAR10/CIFAR100 + ImageRecordDataset).

Zero-egress environment: download=False paths only; datasets read local
files in the reference's formats (MNIST idx ubyte, CIFAR binary). A
SyntheticDataset stands in for smoke tests without data on disk.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from .dataset import Dataset
from ...recordio import MXIndexedRecordIO, unpack_img

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "SyntheticImageDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from local idx-ubyte files (reference vision.py:MNIST;
    format: same files the reference's MNISTIter reads,
    src/io/iter_mnist.cc)."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _read_pair(self, img_path, lbl_path):
        def _open(p):
            if os.path.exists(p + ".gz"):
                return gzip.open(p + ".gz", "rb")
            return open(p, "rb")
        with _open(lbl_path) as fin:
            magic, n = struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(), dtype=np.uint8)
        with _open(img_path) as fin:
            magic, n, rows, cols = struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(), dtype=np.uint8)
            data = data.reshape(n, rows, cols, 1)
        return data, label.astype(np.int32)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        img = os.path.join(self._root, files[0])
        lbl = os.path.join(self._root, files[1])
        if not (os.path.exists(img) or os.path.exists(img + ".gz")):
            raise IOError(
                "MNIST files not found under %s (zero-egress environment: "
                "place %s there, or use SyntheticImageDataset for smoke "
                "tests)" % (self._root, files[0]))
        self._data, self._label = self._read_pair(img, lbl)


class FashionMNIST(MNIST):
    """FashionMNIST — same file format as MNIST (reference
    vision.py:FashionMNIST)."""

    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from local binary batches (reference
    vision.py:CIFAR10)."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        self._file_hashes = None
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(
                -1, 3072 + 1)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(np.int32)

    def _get_data(self):
        if self._train:
            files = ["data_batch_%d.bin" % i for i in range(1, 6)]
        else:
            files = ["test_batch.bin"]
        paths = [os.path.join(self._root, f) for f in files]
        if not all(os.path.exists(p) for p in paths):
            raise IOError(
                "CIFAR10 binary batches not found under %s (zero-egress "
                "environment)" % self._root)
        data, label = zip(*[self._read_batch(p) for p in paths])
        self._data = np.concatenate(data)
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    """CIFAR100 binary format (reference vision.py:CIFAR100)."""

    def __init__(self, root="~/.mxnet/datasets/cifar100",
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(
                -1, 3072 + 2)
        return data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0 + self._fine_label].astype(np.int32)

    def _get_data(self):
        files = ["train.bin"] if self._train else ["test.bin"]
        paths = [os.path.join(self._root, f) for f in files]
        if not all(os.path.exists(p) for p in paths):
            raise IOError(
                "CIFAR100 binary batches not found under %s" % self._root)
        data, label = zip(*[self._read_batch(p) for p in paths])
        self._data = np.concatenate(data)
        self._label = np.concatenate(label)


class ImageRecordDataset(Dataset):
    """Dataset over a .rec of packed images (reference
    vision.py:ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        idx_file = filename.rsplit(".", 1)[0] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        record = self._record.read_idx(self._record.keys[idx])
        header, img = unpack_img(record, self._flag)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label

    def __len__(self):
        return len(self._record.keys)


class SyntheticImageDataset(Dataset):
    """Random images+labels for zero-egress smoke tests (stands in for
    the reference's --benchmark 1 synthetic mode,
    example/image-classification/README.md:253-260)."""

    def __init__(self, length=256, shape=(32, 32, 3), num_classes=10,
                 seed=0, transform=None):
        rng = np.random.RandomState(seed)
        self._data = (rng.rand(length, *shape) * 255).astype(np.uint8)
        self._label = rng.randint(0, num_classes, length).astype(np.int32)
        self._transform = transform

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)
