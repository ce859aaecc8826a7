"""Data iterators — the PyTorch twin of ``mxnet_tpu/io.py`` (reference:
python/mxnet/io.py): the DataIter/DataBatch/DataDesc protocol,
NDArrayIter, ResizeIter and PrefetchingIter.

NDArrayIter holds its arrays on the current context (the card unless a
``with mx.cpu():`` scope says otherwise) and slices batches there;
shuffle draws numpy's global ``np.random.permutation``, the JAX
package's draw. PrefetchingIter overlaps batch assembly with the step on
a worker thread (the reference's dmlc::ThreadedIter double-buffering,
src/io/iter_prefetcher.h:141); its ``place_fn`` runs there on the
consumer's CUDA stream, so a placed batch is ordered with the steps that
read it.

MNISTIter and CSVIter read their files on the host into an NDArrayIter.
LibSVMIter parses its text once on the host and gives CSR batches
(``ndarray.sparse.CSRNDArray``) on the current context. ImageRecordIter
and ImageDetRecordIter are the factories of ``image``: they read .rec
files, decode and augment on the host and give batches on the context
current where they were made.
"""
from __future__ import annotations

import os
import queue
import threading
from collections import namedtuple

import contextlib

import numpy as np
import torch

from . import ndarray
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MNISTIter", "CSVIter", "LibSVMIter",
           "ImageRecordIter", "ImageDetRecordIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name + shape (+dtype/layout) of a data source (reference
    io.py:DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        """Index of the 'N' axis in a layout string (reference
        io.py:DataDesc.get_batch_axis)."""
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch (reference io.py:DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        for field, v in (("data", data), ("label", label)):
            if v is not None and not isinstance(v, (list, tuple)):
                raise TypeError("%s must be a list/tuple of NDArrays"
                                % field)
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        return "%s: data %s label %s" % (
            self.__class__.__name__, [d.shape for d in self.data],
            [l.shape for l in self.label] if self.label else None)


class DataIter:
    """Base iterator (reference io.py:DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        """Next DataBatch (default implementation drives iter_next +
        getdata/getlabel/getindex/getpad)."""
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


class _BatchDelegate:
    """Mixin for wrapper iterators whose getdata/getlabel/... just expose
    fields of the wrapped iterator's last batch."""

    current_batch = None

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class ResizeIter(_BatchDelegate, DataIter):
    """Resize an iterator to `size` batches per epoch, optionally resetting
    the inner iterator on underflow (reference io.py:ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            # epoch underflow: restart the inner iterator mid-"epoch"
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True


class _WorkerError:
    """Carrier for a non-StopIteration worker failure: re-raised in the
    consumer thread instead of starving its queue forever."""

    def __init__(self, exc):
        self.exc = exc


class _PrefetchWorker(threading.Thread):
    """One background thread per wrapped iterator: serves 'next'/'reset'
    commands so batch assembly overlaps device compute. With a
    place_fn, the worker also DISPATCHES the batch's device placement
    (an async H2D) before handing it over — the double-buffer stage:
    batch t+1's transfer is in flight while the consumer's step t
    computes."""

    def __init__(self, it, place_fn=None, stream=None):
        super().__init__(daemon=True)
        self.it = it
        self.place_fn = place_fn
        self.stream = stream
        self.cmds = queue.Queue()
        self.outs = queue.Queue()
        self.start()

    def run(self):
        while True:
            cmd = self.cmds.get()
            if cmd == "stop":
                return
            if cmd == "reset":
                self.it.reset()
                self.outs.put(None)
            else:  # "next"
                try:
                    item = self.it.next()
                except StopIteration:
                    item = StopIteration
                except Exception as e:  # noqa: BLE001 — surface it
                    item = _WorkerError(e)
                else:
                    # outside the StopIteration guard: a StopIteration
                    # escaping place_fn is a BUG to surface, not an
                    # epoch end (only it.next() may signal that)
                    if self.place_fn is not None:
                        try:
                            with (torch.cuda.stream(self.stream)
                                  if self.stream is not None
                                  else contextlib.nullcontext()):
                                item.placed = self.place_fn(item)
                        except Exception as e:  # noqa: BLE001
                            item = _WorkerError(e)
                self.outs.put(item)


class PrefetchingIter(_BatchDelegate, DataIter):
    """Thread-backed prefetcher over one or more iterators (reference
    io.py:PrefetchingIter; C++ analogue iter_prefetcher.h). One worker
    thread per inner iterator; a 'next' command is always in flight so
    the next batch is being assembled while the device computes.

    place_fn (the device-prefetch stage): a callable applied to each
    assembled DataBatch whose result lands on ``batch.placed`` — use
    ``TrainStep.make_placer()`` to place the feed on the step's device.
    With a single inner iterator it runs on the worker thread, on the
    CUDA stream that was current where the iterator was made (the
    consumer's), so the copy is off the step loop and ordered with the
    steps; with multiple inner iterators it runs at merge time (the
    merged batch is what needs placing)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 place_fn=None):
        super().__init__()
        self.iters = iters if isinstance(iters, list) else [iters]
        if not self.iters:
            raise ValueError("need at least one iterator")
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._place_fn = place_fn
        self.batch_size = self.provide_data[0][1][0]
        worker_place = place_fn if len(self.iters) == 1 else None
        stream = torch.cuda.current_stream() \
            if worker_place is not None and torch.cuda.is_available() \
            else None
        self._workers = [_PrefetchWorker(it, worker_place, stream)
                         for it in self.iters]
        self._inflight = False
        self._request()

    def _request(self):
        for w in self._workers:
            w.cmds.put("next")
        self._inflight = True

    def _collect(self):
        self._inflight = False
        return [w.outs.get() for w in self._workers]

    def __del__(self):
        for w in getattr(self, "_workers", []):
            w.cmds.put("stop")

    def _renamed(self, which, renames):
        descs_per_iter = [getattr(it, which) for it in self.iters]
        if renames is None:
            return [d for descs in descs_per_iter for d in descs]
        out = []
        for mapping, descs in zip(renames, descs_per_iter):
            for d in descs:
                d = d if isinstance(d, DataDesc) else DataDesc(*d)
                out.append(DataDesc(mapping[d.name], d.shape, d.dtype))
        return out

    @property
    def provide_data(self):
        return self._renamed("provide_data", self.rename_data)

    @property
    def provide_label(self):
        return self._renamed("provide_label", self.rename_label)

    def reset(self):
        if self._inflight:
            self._collect()     # drain the outstanding 'next'
        for w in self._workers:
            w.cmds.put("reset")
        for w in self._workers:
            w.outs.get()
        self._request()

    def iter_next(self):
        if not self._inflight:
            self._request()
        batches = self._collect()
        for b in batches:
            if isinstance(b, _WorkerError):
                raise b.exc
        ended = [b is StopIteration for b in batches]
        if any(ended):
            if not all(ended):
                raise RuntimeError("inner iterators ended at different "
                                   "batch counts")
            return False
        if len({b.pad for b in batches}) != 1:
            raise RuntimeError("inner iterators disagree on pad")
        self.current_batch = DataBatch(
            [d for b in batches for d in b.data],
            [l for b in batches for l in b.label]
            if batches[0].label is not None else None,
            batches[0].pad, batches[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        if self._place_fn is not None:
            placed = getattr(batches[0], "placed", None) \
                if len(batches) == 1 else None
            self.current_batch.placed = placed if placed is not None \
                else self._place_fn(self.current_batch)
        self._request()          # keep the pipeline primed
        return True


def _init_data(data, allow_empty, default_name):
    """Normalize data input (array | list | dict | None) into a sorted
    [(name, NDArray)] list (reference io.py:_init_data)."""
    if data is None:
        data = {}
    elif isinstance(data, (np.ndarray, NDArray)):
        data = {default_name: data}
    elif isinstance(data, list):
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("data must be an array, a list of arrays, or a "
                        "dict of name->array, got %s" % type(data))
    if not data and not allow_empty:
        raise ValueError("empty %s input" % default_name)

    def as_nd(name, v):
        if isinstance(v, NDArray):
            return v
        try:
            return array(np.asarray(v))
        except Exception:
            raise TypeError("cannot convert %s (%s) to NDArray"
                            % (name, type(v)))
    return sorted((k, as_nd(k, v)) for k, v in data.items())


class NDArrayIter(DataIter):
    """Iterator over in-memory arrays with shuffle + pad/discard/roll-over
    last-batch handling (reference io.py:NDArrayIter, :516)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)

        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        n = self.data[0][1].shape[0]

        def remap(pairs, idx):
            return [(k, array(v.asnumpy()[idx])) for k, v in pairs]

        if shuffle:
            # host-side: one permutation per construction, shared by
            # every data/label source
            perm = np.random.permutation(n)
            self.data, self.label = remap(self.data, perm), \
                remap(self.label, perm)
        if last_batch_handle == "discard":
            # a slice on the device; no host round trip
            keep = n - n % batch_size
            self.data = [(k, v[:keep]) for k, v in self.data]
            self.label = [(k, v[:keep]) for k, v in self.label]

        self.data_list = [v for _, v in self.data + self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.data_list[0].shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size %d exceeds data size %d"
                             % (batch_size, self.num_data))
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [
            DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                     v.dtype)
            for k, v in self.data]

    @property
    def provide_label(self):
        return [
            DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                     v.dtype)
            for k, v in self.label]

    def hard_reset(self):
        """Ignore roll-over; fully reset (reference
        NDArrayIter.hard_reset)."""
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        if self.cursor >= self.num_data:
            raise RuntimeError("iterator exhausted; call reset()")
        if self.cursor + self.batch_size <= self.num_data:
            window = slice(self.cursor, self.cursor + self.batch_size)
            return [v[window] for _, v in data_source]
        # padded last batch wraps to the epoch start: stitch the epoch
        # tail to a head slice (on the device; no host gather)
        pad = self.cursor + self.batch_size - self.num_data
        return [ndarray.concatenate([v[self.cursor:], v[:pad]])
                for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class MNISTIter(NDArrayIter):
    """MNIST idx-ubyte iterator (reference: the registered C++
    'MNISTIter', src/io/iter_mnist.cc:259; the same file format and
    kwargs). Files may be gzipped (``path.gz``)."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 data_name="data", label_name="softmax_label", **kwargs):
        import gzip
        import struct

        def _open(p):
            if os.path.exists(p):
                return open(p, "rb")
            if os.path.exists(p + ".gz"):
                return gzip.open(p + ".gz", "rb")
            raise IOError("MNIST file %s not found" % p)

        with _open(label) as fin:
            _magic, _n = struct.unpack(">II", fin.read(8))
            y = np.frombuffer(fin.read(), dtype=np.uint8).astype(
                np.float32)
        with _open(image) as fin:
            _magic, n, rows, cols = struct.unpack(">IIII", fin.read(16))
            x = np.frombuffer(fin.read(), dtype=np.uint8).astype(
                np.float32) / 255.0
            x = x.reshape(n, rows * cols) if flat else \
                x.reshape(n, 1, rows, cols)
        if shuffle:
            idx = np.random.RandomState(seed).permutation(n)
            x, y = x[idx], y[idx]
        super().__init__(data={data_name: x}, label={label_name: y},
                         batch_size=batch_size,
                         last_batch_handle="discard")


class CSVIter(NDArrayIter):
    """CSV iterator (reference: the registered C++ 'CSVIter',
    src/io/iter_csv.cc:150)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=128, round_batch=True,
                 **kwargs):
        data = np.loadtxt(data_csv, delimiter=",",
                          dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",",
                               dtype=np.float32, ndmin=1)
            if tuple(label_shape) != (1,):
                label = label.reshape((-1,) + tuple(label_shape))
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard")


def ImageRecordIter(*args, **kwargs):
    """The reference's C++ ImageRecordIter (src/io/iter_image_recordio_2.cc)
    as ``image.ImageRecordIter``: a prefetched ImageIter."""
    from .image import ImageRecordIter as _impl
    return _impl(*args, **kwargs)


def ImageDetRecordIter(*args, **kwargs):
    """The reference's C++ ImageDetRecordIter as ``image.ImageDetIter``
    (the prefetch and thread-count kwargs are dropped)."""
    from .image.detection import ImageDetIter as _impl
    kwargs.pop("prefetch_buffer", None)
    kwargs.pop("preprocess_threads", None)
    return _impl(*args, **kwargs)


class LibSVMIter(DataIter):
    """Batches of LibSVM-format text (``label idx:val ...``) as CSR
    arrays (reference src/io/iter_libsvm.cc:200): each batch is a
    ``CSRNDArray`` of the parsed corpus's rows, never a dense (batch,
    num_features) buffer unless the consumer casts. The last batch wraps
    around to the first rows with ``round_batch`` (its ``pad`` counts
    them), else it is dropped. ``label_libsvm`` names a LibSVM file of
    labels, each row densified to ``label_shape``."""

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_libsvm=None, label_shape=(1,), round_batch=True,
                 **_kwargs):
        super().__init__(batch_size)
        self._data_shape = (int(data_shape[0]) if not
                            isinstance(data_shape, int) else
                            int(data_shape),)
        self._label_shape = ((int(label_shape),) if
                             isinstance(label_shape, int)
                             else tuple(int(d) for d in label_shape))
        vals, cols, indptr, labels = self._parse(data_libsvm)
        self._vals, self._cols, self._indptr = vals, cols, indptr
        self._num = len(indptr) - 1
        if label_libsvm is not None:
            lv, lc, lptr, _ = self._parse(label_libsvm)
            width = int(np.prod(self._label_shape))
            dense = np.zeros((len(lptr) - 1, width), np.float32)
            rows = np.repeat(np.arange(len(lptr) - 1), np.diff(lptr))
            dense[rows, lc] = lv
            if self._label_shape in ((), (1,)):
                labels = dense.reshape(-1)   # as provide_label's (N,)
            else:
                labels = dense.reshape((-1,) + self._label_shape)
        elif self._label_shape not in ((), (1,)):
            raise ValueError("label_shape %r needs a label_libsvm file "
                             "(the data file's leading token is a single "
                             "scalar label)" % (self._label_shape,))
        self._labels = labels
        self._round_batch = round_batch
        self.data_name, self.label_name = "data", "label"
        self.reset()

    @staticmethod
    def _parse(path):
        """(values f32, columns int64, indptr int64, labels f32) of a
        LibSVM file; blank lines are skipped."""
        labels, toks, indptr = [], [], [0]
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(parts[0])
                toks.extend(parts[1:])
                indptr.append(len(toks))
        pairs = np.array(" ".join(toks).replace(":", " ").split(),
                         np.float64).reshape(-1, 2)
        return (pairs[:, 1].astype(np.float32), pairs[:, 0].astype(np.int64),
                np.asarray(indptr, np.int64),
                np.asarray(labels, np.float64).astype(np.float32))

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,)
        if self._label_shape not in ((), (1,)):
            shape += self._label_shape
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        self._cursor = 0

    def _rows(self, ids):
        """The CSR batch of the corpus rows ``ids`` (sliced on the host,
        one copy to the current context)."""
        from .ndarray import sparse
        starts = self._indptr[ids]
        counts = self._indptr[ids + 1] - starts
        indptr = np.concatenate([[0], np.cumsum(counts)])
        take = np.repeat(starts - indptr[:-1], counts) + np.arange(
            indptr[-1])
        return sparse.CSRNDArray(self._vals[take], self._cols[take], indptr,
                                 (len(ids), self._data_shape[0]))

    def next(self):
        if self._cursor >= self._num:
            raise StopIteration
        end = self._cursor + self.batch_size
        ids = np.arange(self._cursor, min(end, self._num))
        pad = 0
        if end > self._num:
            if not self._round_batch:
                raise StopIteration
            pad = end - self._num
            ids = np.concatenate([ids, np.arange(pad) % self._num])
        self._cursor = end
        return DataBatch(data=[self._rows(ids)],
                         label=[array(self._labels[ids])], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
