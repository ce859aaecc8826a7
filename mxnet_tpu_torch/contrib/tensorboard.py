"""TensorBoard bridge — log training metrics as TensorBoard event files;
the PyTorch port's own copy of ``mxnet_tpu/contrib/tensorboard.py``.

Reference: python/mxnet/contrib/tensorboard.py (LogMetricsCallback over
the dmlc/tensorboard SummaryWriter). Pure Python with no dependency:
scalar Event protos are wire-encoded by hand and framed in the TFRecord
format (varint/length-delimited protobuf fields + masked crc32c), byte
for byte as the JAX package writes them (tests/test_torch_tensorboard.py).

Usage (identical shape to the reference):

    from mxnet_tpu_torch.contrib.tensorboard import LogMetricsCallback
    mod.fit(train_iter,
            batch_end_callback=LogMetricsCallback('logs/train'),
            eval_end_callback=LogMetricsCallback('logs/eval'))
    # then: tensorboard --logdir=logs
"""
from __future__ import annotations

import os
import socket
import struct
import time

__all__ = ["SummaryWriter", "LogMetricsCallback"]


# -- crc32c (Castagnoli), table-driven — needed for TFRecord framing --------

def _make_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


def _crc32c(data):
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data):
    c = _crc32c(data)
    return ((((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# -- protobuf wire encoding (only what scalar Events need) -------------------

def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_double(num, v):
    return _varint(num << 3 | 1) + struct.pack("<d", v)


def _field_float(num, v):
    return _varint(num << 3 | 5) + struct.pack("<f", v)


def _field_varint(num, v):
    return _varint(num << 3) + _varint(v)


def _field_bytes(num, payload):
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _scalar_event(tag, value, step, wall_time):
    # Summary.Value { tag = 1; simple_value = 2 }
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, val)           # Summary.value (repeated)
    # Event { wall_time = 1; step = 2; summary = 5 }
    return (_field_double(1, wall_time) + _field_varint(2, int(step))
            + _field_bytes(5, summary))


def _version_event(wall_time):
    # Event.file_version = 3 — the header record every reader expects
    return (_field_double(1, wall_time)
            + _field_bytes(3, b"brain.Event:2"))


class SummaryWriter:
    """Minimal scalar-only event-file writer (the subset the reference
    bridge used; histograms/images are out of its scope too)."""

    def __init__(self, logdir, filename_suffix=""):
        os.makedirs(logdir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s.%d%s" % (
            time.time(), socket.gethostname(), os.getpid(),
            filename_suffix)
        self._path = os.path.join(logdir, name)
        self._f = open(self._path, "ab")
        self._write_record(_version_event(time.time()))
        self.flush()

    def _write_record(self, payload):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag, value, global_step=0):
        self._write_record(
            _scalar_event(tag, value, global_step, time.time()))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self.flush()
            self._f.close()

    @property
    def path(self):
        return self._path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LogMetricsCallback:
    """Batch-end (or eval-end) callback writing each metric as a scalar
    series — reference contrib/tensorboard.py:25 with the same
    constructor shape.

    Parameters
    ----------
    logging_dir : str
        Event-file directory (point ``tensorboard --logdir`` here).
    prefix : str, optional
        Prepended as ``<prefix>/<metric>`` so train/eval curves with
        the same suffix overlay in one TensorBoard chart.
    """

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        self.summary_writer = SummaryWriter(logging_dir)

    def __call__(self, param):
        """param: BatchEndParam-like with .eval_metric."""
        self.step += 1
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = "%s/%s" % (self.prefix, name)
            self.summary_writer.add_scalar(name, value, self.step)
        self.summary_writer.flush()

    def close(self):
        self.summary_writer.close()
