"""KVStore — the data-parallel parameter store; the PyTorch twin of
``mxnet_tpu/kvstore.py`` for the in-process types (reference:
python/mxnet/kvstore.py, src/kvstore/kvstore_local.h, comm.h).

``local`` and ``device`` (and the ``local_allreduce_*`` spellings) are one
store in one process: ``push`` sums the list of values pushed for a key
(one ``add_n``), then runs the updater on the stored weight when one is
set (``set_optimizer`` / ``set_updater``: the update on the store), else
stores the sum; ``pull`` copies the stored value into every out array.
The type string only named where the reduce ran; it changes nothing
here, as it changes nothing in the JAX package.

Not ported yet: the ``dist_*`` types (a process group; ROADMAP Queue A
item 9b.4) and sparse values with ``row_sparse_pull`` (item 10); each
raises ``NotImplementedError``.
"""
from __future__ import annotations

from . import ndarray
from . import optimizer as opt
from .base import string_types
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

_TYPES = ("local", "device", "local_allreduce_cpu", "local_allreduce_device",
          "dist_sync", "dist_device_sync", "dist_async", "dist")


def _key_list(keys):
    if isinstance(keys, (int, str)):
        return [keys], True
    assert isinstance(keys, (list, tuple))
    return list(keys), False


def _value_list(vals, n):
    """Group values per key: an NDArray, a list of NDArrays (one key), or
    a list of (NDArray | list) aligned with the keys."""
    if isinstance(vals, NDArray):
        return [[vals]]
    assert isinstance(vals, (list, tuple))
    if n == 1 and (not vals or isinstance(vals[0], NDArray)):
        return [list(vals)]
    out = []
    for v in vals:
        out.append([v] if isinstance(v, NDArray) else list(v))
    assert len(out) == n
    return out


class KVStore:
    """In-process key-value store with the reference's semantics
    (include/mxnet/kvstore.h:45-372, kvstore_local.h)."""

    def __init__(self, kv_type="local"):
        if kv_type.startswith("dist"):
            raise NotImplementedError(
                "kvstore %r spans processes, which is not ported to the "
                "PyTorch package yet (ROADMAP Queue A item 9b.4)" % kv_type)
        self.type = kv_type
        self._store = {}          # key -> the stored NDArray
        self._updater = None
        self._optimizer = None

    # -- identity ----------------------------------------------------------
    @property
    def rank(self):
        """Worker rank: 0 in one process."""
        return 0

    @property
    def num_workers(self):
        return 1

    # -- init/push/pull ----------------------------------------------------
    def init(self, key, value):
        """Initialize key(s) once with their first value (reference
        kvstore.py:init)."""
        keys, _ = _key_list(key)
        for k, vlist in zip(keys, _value_list(value, len(keys))):
            if k in self._store:
                raise ValueError("duplicate init of key %r" % (k,))
            self._store[k] = vlist[0].copy()

    def push(self, key, value, priority=0):
        """Sum the values pushed for each key, then apply the updater to
        the stored weight (or store the sum without one) — reference
        kvstore.py:push, comm.h Reduce."""
        keys, _ = _key_list(key)
        for k, vlist in zip(keys, _value_list(value, len(keys))):
            if k not in self._store:
                raise KeyError("key %r has not been initialized" % (k,))
            merged = vlist[0] if len(vlist) == 1 else ndarray.add_n(*vlist)
            if self._updater is not None:
                # the updater writes the stored weight in place
                self._updater(k, merged, self._store[k])
            else:
                self._store[k] = merged.copy()

    def pull(self, key, out=None, priority=0):
        """Copy each key's stored value into its out array(s) (reference
        kvstore.py:pull, comm.h Broadcast)."""
        assert out is not None
        keys, _ = _key_list(key)
        for k, olist in zip(keys, _value_list(out, len(keys))):
            if k not in self._store:
                raise KeyError("key %r has not been initialized" % (k,))
            src = self._store[k]._data
            for o in olist:
                o._set_data(src.to(device=o._data.device,
                                   dtype=o._data.dtype, copy=True))

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise NotImplementedError(
            "KVStore.row_sparse_pull pulls row-sparse storage, which is not "
            "ported to the PyTorch package yet (ROADMAP Queue A item 10)")

    # -- updater/optimizer -------------------------------------------------
    def set_updater(self, updater):
        """Set the push-time updater (reference kvstore.py:_set_updater)."""
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """Run this optimizer on the store at each push (reference
        kvstore.py:set_optimizer)."""
        self._optimizer = optimizer
        self.set_updater(opt.get_updater(optimizer))

    def set_gradient_compression(self, compression_params):
        raise NotImplementedError(
            "gradient compression is not part of the 0.11 reference surface")

    # -- optimizer state IO (reference kvstore.py:save/load_optimizer_states)
    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None, "no updater is set"
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None, "no updater is set"
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    def barrier(self):
        """Global barrier across workers: nothing to wait for in one
        process."""


def create(name="local"):
    """Factory (reference kvstore.py:create, kvstore.cc:34-61): local |
    device | local_allreduce_cpu | local_allreduce_device; the dist types
    raise NotImplementedError (ROADMAP Queue A item 9b.4)."""
    if not isinstance(name, string_types):
        raise TypeError("name must be a string")
    if name not in _TYPES:
        raise ValueError("Unknown KVStore type %r. Valid: %r"
                         % (name, _TYPES))
    return KVStore(name)
