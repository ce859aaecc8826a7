"""DataLoader — the PyTorch twin of ``mxnet_tpu/gluon/data/dataloader.py``
(reference: python/mxnet/gluon/data/dataloader.py).

Batches are assembled on the host in numpy, in worker threads when
``num_workers`` > 0 (not the reference's processes: the decode cost sits
in PIL/numpy, which release the GIL), and land as one NDArray a field on
the current context (``gpu(0)`` by default): one host-to-device copy a
batch.
"""
from __future__ import annotations

import concurrent.futures

import numpy as np

from ... import ndarray as nd
from ...context import current_context
from ...ndarray import NDArray
from . import sampler as _sampler

__all__ = ["DataLoader"]


def default_batchify_fn(data):
    """Collate samples into a batch (reference
    dataloader.py:default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        return nd.stack(*data)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = np.asarray(data)
    return nd.array(data, dtype=data.dtype)


class DataLoader:
    """Mini-batch loader over a Dataset (reference
    dataloader.py:DataLoader)."""

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0):
        self._dataset = dataset

        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                if shuffle:
                    sampler = _sampler.RandomSampler(len(dataset))
                else:
                    sampler = _sampler.SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is "
                    "specified")
            batch_sampler = _sampler.BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")

        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn if batchify_fn is not None \
            else default_batchify_fn
        self._num_workers = num_workers

    def __iter__(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._batchify_fn(
                    [self._dataset[int(idx)] for idx in batch])
            return

        # thread-pool pipelined fetch: keeps ~2x workers batches in flight;
        # the workers place batches on the caller's context (a context
        # scope is thread-local)
        ctx = current_context()
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self._num_workers) as pool:
            def fetch(batch):
                with ctx:
                    return self._batchify_fn(
                        [self._dataset[int(idx)] for idx in batch])

            batches = list(self._batch_sampler)
            depth = max(2 * self._num_workers, 2)
            futures = []
            for b in batches[:depth]:
                futures.append(pool.submit(fetch, b))
            pos = depth
            for i in range(len(batches)):
                yield futures[i].result()
                if pos < len(batches):
                    futures.append(pool.submit(fetch, batches[pos]))
                    pos += 1

    def __len__(self):
        return len(self._batch_sampler)
