"""RecordIO — the binary record pack format, read/write compatible with
the reference's ``.rec`` files; the PyTorch package's copy of
``mxnet_tpu/recordio.py``, which holds no JAX.

Each record (dmlc-core recordio.h):

  [magic: uint32 LE = 0xced7230a]
  [lrec: uint32 — upper 3 bits continuation flag, lower 29 bits length]
  [payload][zero pad to a 4-byte boundary]

flag 0 is a whole record; 1/2/3 are the first/middle/last part of a
record whose payload held the aligned magic word (split on write,
rejoined with the magic on read), which keeps byte scans unambiguous.

IRHeader (the image record header, struct 'IfQQ'): flag, label (f32),
id, id2; flag > 0 means ``flag`` float32 labels follow the header.

Reading goes through the native mmap'd scanner (``_native``'s
``NativeRecordFile``, one memcpy a record) when ``MXNET_NATIVE_RECORDIO``
is set, its default; where the library cannot be built, or its scan
refuses the file (torn or not RecordIO), the strict Python reader reads
it and raises at the first bad record. Writing is Python only.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as np

from . import config as _config

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_K_MAGIC = 0xced7230a
_MAGIC_BYTES = struct.pack("<I", _K_MAGIC)


def _enc_lrec(cflag, length):
    return (cflag << 29) | length


def _dec_lrec(lrec):
    return lrec >> 29, lrec & ((1 << 29) - 1)


class MXRecordIO:
    """Sequential .rec reader/writer (reference recordio.py:MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.fp = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.fp = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fp = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True
        # the native reader: a record index scanned once, reads slice an
        # mmap; MXNET_NATIVE_RECORDIO=0 forces the Python reader
        self._native = None
        self._cursor = 0
        if self.flag == "r" and _config.get("MXNET_NATIVE_RECORDIO"):
            try:
                from ._native import NativeRecordFile
                self._native = NativeRecordFile(self.uri)
            except Exception:  # noqa: BLE001 — no library, or refused
                self._native = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        """Pickle the uri and flags; the file reopens on unpickling."""
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("fp", None)
        d.pop("_native", None)
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        self.fp = None
        is_open = d.get("is_open", False)
        self.is_open = False
        if is_open:
            self.open()

    def close(self):
        if self.is_open and self.fp is not None:
            self.fp.close()
            self.is_open = False
            if getattr(self, "_native", None) is not None:
                self._native.close()
                self._native = None

    def reset(self):
        if not self.writable and getattr(self, "_native", None) is not None:
            # the scanned index stays across epochs: a reset rewinds
            self._cursor = 0
            self.fp.seek(0)
            return
        self.close()
        self.open()

    def write(self, buf):
        """Write one record (split where the payload holds the aligned
        magic word)."""
        assert self.writable
        parts = []
        start = 0
        for i in range(0, len(buf) - 3, 4):
            if buf[i:i + 4] == _MAGIC_BYTES:
                parts.append(buf[start:i])
                start = i + 4
        parts.append(buf[start:])
        if len(parts) == 1:
            self._write_chunk(0, parts[0])
        else:
            for k, p in enumerate(parts):
                cflag = 1 if k == 0 else (3 if k == len(parts) - 1 else 2)
                self._write_chunk(cflag, p)

    def _write_chunk(self, cflag, data):
        self.fp.write(_MAGIC_BYTES)
        self.fp.write(struct.pack("<I", _enc_lrec(cflag, len(data))))
        self.fp.write(data)
        pad = (-len(data)) % 4
        if pad:
            self.fp.write(b"\x00" * pad)

    def read(self):
        """Read one (logical) record; None at EOF."""
        assert not self.writable
        if self._native is not None:
            if self._cursor >= len(self._native):
                return None
            rec = self._native.read(self._cursor)
            self._cursor += 1
            return rec
        out = None
        while True:
            head = self.fp.read(8)
            if len(head) < 8:
                return out  # EOF (out is None unless the file is torn)
            magic, lrec = struct.unpack("<II", head)
            assert magic == _K_MAGIC, "invalid record magic"
            cflag, length = _dec_lrec(lrec)
            data = self.fp.read(length)
            pad = (-length) % 4
            if pad:
                self.fp.read(pad)
            if cflag == 0:
                return data
            if cflag == 1:
                out = data
            elif cflag == 2:
                out = out + _MAGIC_BYTES + data
            else:  # 3: the last part
                return out + _MAGIC_BYTES + data

    def tell(self):
        if getattr(self, "_native", None) is not None and \
                not self.writable:
            # the next record's header offset (the native reads move no
            # file position)
            if self._cursor < len(self._native):
                return self._native.offset(self._cursor)
            return self._native.size
        return self.fp.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec through a .idx sidecar of ``key\\tpos`` lines
    (reference recordio.py:MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)
        if self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        fidx = getattr(self, "fidx", None)     # an unpickled reader has none
        if fidx is not None and not fidx.closed:
            fidx.close()
        super().close()

    def __getstate__(self):
        d = super().__getstate__()
        d.pop("fidx", None)
        return d

    def seek(self, idx):
        assert not self.writable
        pos = self.idx[idx]
        self.fp.seek(pos)
        if self._native is not None:
            ordinal = self._native.find_offset(pos)
            if ordinal >= 0:
                self._cursor = ordinal
            else:
                # the sidecar disagrees with the scan: read this file in
                # Python from here on
                self._native.close()
                self._native = None

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """A payload with its IRHeader in front (reference recordio.py:pack);
    an array label goes after the header, its size in ``flag``."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        header = header._replace(label=float(header.label))
        return struct.pack(_IR_FORMAT, *header) + s
    label = np.asarray(header.label, dtype=np.float32)
    header = header._replace(flag=label.size, label=0)
    return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s


def unpack(s):
    """(IRHeader, payload) of a packed record (reference
    recordio.py:unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4],
                              dtype=np.float32).copy()
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array as JPEG or PNG (reference
    recordio.py:pack_img), through PIL as the JAX package does."""
    from io import BytesIO
    from PIL import Image
    pil = Image.fromarray(np.asarray(img).astype(np.uint8))
    buf = BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    kwargs = {"quality": quality} if fmt == "JPEG" else {}
    pil.save(buf, format=fmt, **kwargs)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    """(IRHeader, image array) of a packed image record (reference
    recordio.py:unpack_img)."""
    from io import BytesIO
    from PIL import Image
    header, s = unpack(s)
    pil = Image.open(BytesIO(s))
    if iscolor == 0:
        pil = pil.convert("L")
    elif iscolor == 1:
        pil = pil.convert("RGB")
    return header, np.asarray(pil)
