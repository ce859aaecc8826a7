"""KVStore — the data-parallel parameter store; the PyTorch twin of
``mxnet_tpu/kvstore.py`` (reference: python/mxnet/kvstore.py,
src/kvstore/kvstore_local.h, comm.h, kvstore_dist.h).

``local`` and ``device`` (and the ``local_allreduce_*`` spellings) are one
store in one process: ``push`` sums the list of values pushed for a key
(one ``add_n``), then runs the updater on the stored weight when one is
set (``set_optimizer`` / ``set_updater``: the update on the store), else
stores the sum; ``pull`` copies the stored value into every out array.
The type string only named where the reduce ran; it changes nothing
here, as it changes nothing in the JAX package.

``dist_sync``, ``dist_device_sync`` and ``dist`` span the worker
processes of a ``torch.distributed`` group (``parallel.dist.init``; rank
and worker count come from it): ``init`` takes rank 0's value, ``push``
merges a key's device copies, gathers every worker's merged value and
sums them in rank order (so the sum does not depend on the backend's
reduction order), then runs the updater, and every worker applies the
same update to its copy (the reference's server-side apply, collapsed
onto the workers); ``barrier`` is the group's. Every collective goes
through ``parallel._comm``, so on gloo a CUDA tensor crosses through
pinned host memory and ``parallel.comm.staged_bytes`` counts it. Without
a group a dist store has one worker and behaves as ``local``.

``dist_async`` with DMLC_PS_ROOT_URI set is a client of the parameter
server(s) of ``parallel/ps_async.py``: pushes are applied on arrival on
the server, on the host, with no aggregation among workers; rank and
worker count come from the DMLC_* environment; ``set_optimizer`` ships
the optimizer to the server(s).

Row-sparse values stay sparse in an in-process store: a list pushed for
a key reduces over the union of its rows (``sparse.add``, never
densified), a plain ``pull`` of a sparse store densifies it once for
every dense out array, and ``row_sparse_pull`` copies only the requested
rows (a row-sparse out gets exactly those ids; a dense out the gathered
rows). A dist store carries dense values only and refuses sparse ones,
as in the JAX package.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import ndarray
from . import optimizer as opt
from . import telemetry as _telemetry
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
    """Key-value store with the reference's semantics
    (include/mxnet/kvstore.h:45-372, kvstore_local.h, kvstore_dist.h)."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}          # key -> the stored NDArray
        self._updater = None
        self._optimizer = None
        self._async_client = None
        if kv_type == "dist_async" and os.environ.get("DMLC_PS_ROOT_URI"):
            # the parameter server(s) apply each push on arrival; the
            # workers form no collective (a key-sharded fan-out client
            # when DMLC_NUM_SERVER > 1)
            from .parallel.ps_async import create_client
            self._async_client = create_client()

    def _world(self):
        """Worker processes a dist store spans (1 for the in-process
        types and outside a process group)."""
        if not self.type.startswith("dist"):
            return 1
        return self.num_workers

    @staticmethod
    def _cross_process_sum(arr_nd):
        """Sum an array over the worker processes in rank order: gather
        every rank's value, then add them rank by rank (the reference's
        server-side aggregation, kvstore_dist_server.h:247-390)."""
        from .parallel import _comm
        stacked = _comm.world_gather(arr_nd._data)
        total = stacked[0].clone()
        for r in range(1, stacked.shape[0]):
            total += stacked[r]
        return NDArray(total)

    @staticmethod
    def _broadcast_from_root(arr_nd):
        """Rank 0's array on every worker (reference
        KVStoreDist::InitImpl: only rank 0 pushes the init value)."""
        from .parallel import _comm
        return NDArray(_comm.world_broadcast(arr_nd._data, src=0))

    def _reject_sparse_dist(self, val, what):
        """A dist store carries dense values only: a sparse NDArray (or an
        array over a torch sparse layout) raises, as in the JAX
        package."""
        if not isinstance(val, NDArray) or val.stype != "default" or \
                val._data.layout != torch.strided:
            raise NotImplementedError(
                "sparse %s through a %s kvstore is not supported: the dist "
                "types (%s) carry dense values only, since variable-nnz "
                "buffers have no fixed-shape collective; use a local "
                "kvstore (its reduce keeps sparsity) or dense arrays"
                % (what, self.type, ", ".join(
                    t for t in _TYPES if t.startswith("dist"))))

    # -- identity ----------------------------------------------------------
    @property
    def rank(self):
        """Worker rank (reference kvstore.py:rank): the process group's
        rank for a dist store (0 outside a group), DMLC_WORKER_ID for the
        parameter-server client, 0 in one process."""
        if self._async_client is not None:
            return int(os.environ.get("DMLC_WORKER_ID", "0"))
        if not self.type.startswith("dist"):
            return 0
        from .parallel import dist
        return dist.rank()

    @property
    def num_workers(self):
        if self._async_client is not None:
            return int(os.environ.get("DMLC_NUM_WORKER", "1"))
        if not self.type.startswith("dist"):
            return 1
        from .parallel import dist
        return dist.size()

    # -- init/push/pull ----------------------------------------------------
    def init(self, key, value):
        """Initialize key(s) once with their first value (reference
        kvstore.py:init); across workers rank 0's value wins."""
        keys, _ = _key_list(key)
        vals = _value_list(value, len(keys))
        if self._async_client is not None:
            # rank 0's value becomes the server's; the barrier makes
            # "initialized" visible to every worker before anyone pulls
            for k, vlist in zip(keys, vals):
                self._reject_sparse_dist(vlist[0], "init")
                if self.rank == 0:
                    self._async_client.init(k, vlist[0].asnumpy())
            self._async_client.barrier()
            return
        for k, vlist in zip(keys, vals):
            if k in self._store:
                raise ValueError("duplicate init of key %r" % (k,))
            first = vlist[0].copy()
            if self._world() > 1:
                self._reject_sparse_dist(first, "init")
                first = self._broadcast_from_root(first)
            self._store[k] = first

    def push(self, key, value, priority=0):
        """Sum the values pushed for each key (and, across workers, each
        worker's sum in rank order), then apply the updater to the
        stored weight, or store the sum without one — reference
        kvstore.py:push, comm.h Reduce. The parameter-server client
        ships each key's merged value to the server instead."""
        keys, _ = _key_list(key)
        vals = _value_list(value, len(keys))
        pushed = _telemetry.counter("kvstore.push_bytes")
        _telemetry.counter("kvstore.pushes").inc(len(keys))
        for k, vlist in zip(keys, vals):
            if self._async_client is None and k not in self._store:
                raise KeyError("key %r has not been initialized" % (k,))
            if len(vlist) == 1:
                merged = vlist[0]
            elif isinstance(vlist[0], ndarray.RowSparseNDArray):
                # the union of the pushed rows, never densified
                # (reference CommCPU::ReduceRowSparse)
                merged = vlist[0]
                for v in vlist[1:]:
                    merged = ndarray.sparse.add(merged, v)
            else:
                merged = ndarray.add_n(*vlist)
            pushed.inc(merged._data.numel() * merged._data.element_size())
            if self._async_client is not None:
                # applied on the server at once: no aggregation among
                # workers (kvstore_dist_server.h sync_mode_=false)
                self._reject_sparse_dist(merged, "push")
                self._async_client.push(k, merged.asnumpy())
                continue
            if self._world() > 1:
                # every worker then applies the same update to its copy
                self._reject_sparse_dist(merged, "push")
                merged = self._cross_process_sum(merged)
            if self._updater is not None:
                # the updater writes the stored weight in place
                self._updater(k, merged, self._store[k])
            else:
                self._store[k] = merged.copy()

    def pull(self, key, out=None, priority=0):
        """Copy each key's stored value into its out array(s) (reference
        kvstore.py:pull, comm.h Broadcast); from the server, possibly
        stale, for the parameter-server client."""
        assert out is not None
        keys, _ = _key_list(key)
        pulled = _telemetry.counter("kvstore.pull_bytes")
        _telemetry.counter("kvstore.pulls").inc(len(keys))
        for k, olist in zip(keys, _value_list(out, len(keys))):
            if self._async_client is not None:
                # shape/dtype let a sharded client derive the stripe
                # plan of a key this worker never pushed
                cur = self._async_client.pull(
                    k, shape=tuple(olist[0].shape), dtype=olist[0].dtype)
                src = torch.from_numpy(np.ascontiguousarray(cur))
            else:
                if k not in self._store:
                    raise KeyError("key %r has not been initialized"
                                   % (k,))
                stored = self._store[k]
                if isinstance(stored, ndarray.sparse.BaseSparseNDArray):
                    # a sparse store: a sparse out gets a copy, the dense
                    # outs one densified value
                    for o in olist:
                        if isinstance(o, ndarray.sparse.BaseSparseNDArray):
                            stored.copyto(o)
                    olist = [o for o in olist if o.stype == "default"]
                    if not olist:
                        continue
                    stored = stored.todense()
                src = stored._data
            pulled.inc(src.numel() * src.element_size())
            for o in olist:
                o._set_data(src.to(device=o._data.device,
                                   dtype=o._data.dtype, copy=True))

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows in ``row_ids`` (reference
        kvstore.py:row_sparse_pull): a row-sparse ``out`` receives the
        values and indices of exactly those rows (sorted), the weight
        itself never copied; a dense ``out`` gets the gathered rows in
        ``row_ids`` order."""
        assert out is not None and row_ids is not None
        keys, _ = _key_list(key)
        outs = _value_list(out, len(keys))
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        if len(rids) == 1 and len(outs) > 1:
            rids = rids * len(outs)
        sparse = ndarray.sparse
        pulled = _telemetry.counter("kvstore.pull_bytes")
        _telemetry.counter("kvstore.pulls").inc(len(keys))
        for k, olist, rid in zip(keys, outs, rids):
            if k not in self._store:
                raise KeyError("key %r has not been initialized" % (k,))
            src = self._store[k]
            ids = sparse._as_tensor(rid, torch.int32,
                                    src._data.device).reshape(-1)
            if isinstance(src, sparse.RowSparseNDArray):
                rows = sparse._gather_rows(src, ids)
            else:
                rows = src._data.detach().index_select(0, ids)
            for o in olist:
                if isinstance(o, sparse.RowSparseNDArray):
                    sparse.RowSparseNDArray(rows, ids, src.shape).copyto(o)
                else:
                    o._set_data(rows.to(o._data.device))
                pulled.inc(rows.numel() * rows.element_size())

    # -- updater/optimizer -------------------------------------------------
    def set_updater(self, updater):
        """Set the push-time updater (reference kvstore.py:_set_updater)."""
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """Run this optimizer on the store at each push (reference
        kvstore.py:set_optimizer); the parameter-server client ships it
        to the server(s), which apply it on the host (the reference's
        controller command channel)."""
        self._optimizer = optimizer
        if self._async_client is not None:
            self._async_client.set_optimizer(optimizer)
            return
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
        """Global barrier across workers (reference ps::Postoffice
        Barrier): the server's counted barrier for the parameter-server
        client, the process group's for a dist store, nothing to wait
        for in one process."""
        if self._async_client is not None:
            self._async_client.barrier()
        elif self._world() > 1:
            torch.distributed.barrier()

    def close(self):
        """Say bye to the parameter server(s) (a no-op for the other
        types); the store is unusable afterwards."""
        if self._async_client is not None:
            client, self._async_client = self._async_client, None
            client.close()

    def __del__(self):
        if getattr(self, "_async_client", None) is not None:
            try:
                self.close()
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass


def create(name="local"):
    """Factory (reference kvstore.py:create, kvstore.cc:34-61): local |
    device | local_allreduce_cpu | local_allreduce_device | dist_sync |
    dist_device_sync | dist | dist_async. A dist type outside a process
    group (and dist_async without DMLC_PS_ROOT_URI) has one worker and
    behaves as local, as the reference's tests run it."""
    if not isinstance(name, string_types):
        raise TypeError("name must be a string")
    if name not in _TYPES:
        raise ValueError("Unknown KVStore type %r. Valid: %r"
                         % (name, _TYPES))
    return KVStore(name)
