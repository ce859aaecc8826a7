"""Samplers — index streams feeding DataLoader (reference surface:
python/mxnet/gluon/data/sampler.py; bodies re-derived around a single
chunking helper)."""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]

_LAST_BATCH_MODES = ("keep", "discard", "rollover")


class Sampler:
    """Iterable of sample indices with a known length."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class _RangeSampler(Sampler):
    """Shared base: yields a permutation of [0, length)."""

    def __init__(self, length):
        self._length = int(length)

    def __len__(self):
        return self._length

    def __iter__(self):
        return iter(self._order())


class SequentialSampler(_RangeSampler):
    """Identity order."""

    def _order(self):
        return range(self._length)


class RandomSampler(_RangeSampler):
    """Fresh uniform shuffle each epoch (global numpy RNG, so
    mx.random.seed-style seeding makes epochs reproducible)."""

    def _order(self):
        return np.random.permutation(self._length)


class BatchSampler(Sampler):
    """Chunk an index sampler into lists of ``batch_size``.

    last_batch: 'keep' yields the short tail, 'discard' drops it,
    'rollover' saves it as the head of the next epoch."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in _LAST_BATCH_MODES:
            raise ValueError(
                "last_batch must be one of %s, but got %s"
                % (", ".join(repr(m) for m in _LAST_BATCH_MODES),
                   last_batch))
        self._sampler = sampler
        self._batch_size = int(batch_size)
        self._last_batch = last_batch
        self._carry = []

    def __iter__(self):
        pending = list(self._carry)
        self._carry = []
        for idx in self._sampler:
            pending.append(idx)
            if len(pending) == self._batch_size:
                yield pending
                pending = []
        if not pending:
            return
        if self._last_batch == "keep":
            yield pending
        elif self._last_batch == "rollover":
            self._carry = pending
        # 'discard': tail dropped

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return -(-n // self._batch_size)
        if self._last_batch == "rollover":
            n += len(self._carry)
        return n // self._batch_size
