"""Bucketed sentence iterator for variable-length sequence training —
the PyTorch twin of ``mxnet_tpu/rnn/io.py``.

Reference: python/mxnet/rnn/io.py (encode_sentences, BucketSentenceIter).
Every bucket is one fixed shape, so the BucketingModule binds one
executor per bucket, all sharing one parameter set. Batches land on the
context current where the iterator was made (the card unless a
``with mx.cpu():`` scope says otherwise), as NDArrayIter's do; shuffles
draw Python's ``random`` and numpy's global stream, the JAX package's
draws.
"""
from __future__ import annotations

import random

import numpy as np

from .. import ndarray as nd
from ..context import current_context
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Map token sequences to integer-id sequences, building (or
    extending) ``vocab``. Returns (encoded_sentences, vocab)."""
    new_vocab = vocab is None
    if new_vocab:
        vocab = {invalid_key: invalid_label}
    encoded = []
    for sent in sentences:
        ids = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    raise ValueError("word %r not in provided vocab" % word)
                next_id = start_label + len(vocab) - 1  # invalid_key excluded
                vocab[word] = next_id
            ids.append(vocab[word])
        encoded.append(ids)
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """Pads each sentence to its bucket length and yields one
    fixed-shape batch per call, tagged with ``bucket_key``.

    Labels are the input shifted one step left (next-token LM target),
    padded with ``invalid_label``.
    """

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super(BucketSentenceIter, self).__init__(batch_size)
        if buckets is None:
            counts = np.bincount([len(s) for s in sentences])
            buckets = [length for length, count in enumerate(counts)
                       if count >= batch_size]
        buckets = sorted(buckets)
        if not buckets:
            raise ValueError("no buckets: provide them explicitly or use a "
                             "larger corpus / smaller batch_size")

        self.data = [[] for _ in buckets]
        skipped = 0
        for sent in sentences:
            bkt = np.searchsorted(buckets, len(sent))
            if bkt == len(buckets) or len(sent) == 0:
                skipped += 1
                continue
            padded = np.full(buckets[bkt], invalid_label, dtype=dtype)
            padded[:len(sent)] = sent
            self.data[bkt].append(padded)
        if skipped:
            import logging
            logging.warning("BucketSentenceIter: discarded %d sentences "
                            "longer than the largest bucket", skipped)
        self.data = [np.asarray(x, dtype=dtype) for x in self.data]

        self.batch_size = batch_size
        self.buckets = buckets
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)
        self._ctx = current_context()
        self.reset()

    def _batch_shape(self, bucket_len):
        if self.major_axis == 0:
            return (self.batch_size, bucket_len)
        return (bucket_len, self.batch_size)

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         self._batch_shape(self.default_bucket_key))]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         self._batch_shape(self.default_bucket_key))]

    def reset(self):
        """Reshuffle sentences within buckets and the batch order."""
        self.curr_idx = 0
        # (bucket, start-row) pairs, one per full batch, shuffled
        self.idx = []
        for b, data in enumerate(self.data):
            np.random.shuffle(data)
            self.idx.extend(
                (b, start) for start in
                range(0, len(data) - self.batch_size + 1, self.batch_size))
        random.shuffle(self.idx)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        b, start = self.idx[self.curr_idx]
        self.curr_idx += 1

        batch = self.data[b][start:start + self.batch_size]
        label = np.full_like(batch, self.invalid_label)
        label[:, :-1] = batch[:, 1:]
        if self.major_axis != 0:   # TN layout
            batch = batch.T
            label = label.T
        shape = self._batch_shape(self.buckets[b])
        return DataBatch(
            data=[nd.array(batch, ctx=self._ctx)],
            label=[nd.array(label, ctx=self._ctx)], pad=0,
            bucket_key=self.buckets[b],
            provide_data=[DataDesc(self.data_name, shape)],
            provide_label=[DataDesc(self.label_name, shape)])
