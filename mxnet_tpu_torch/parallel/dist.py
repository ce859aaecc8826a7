"""Multi-process init — the PyTorch twin of ``mxnet_tpu/parallel/dist.py``
(the replacement for the reference's ps-lite scheduler/tracker).

Every process runs the same program; ``init`` joins the process group
from arguments or from the reference's launch variables, so reference
launch scripts keep working:

  DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT   the coordinator (a TCP store)
  DMLC_NUM_WORKER                        the world size
  DMLC_WORKER_ID                         this process's rank

or torch's own ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK``. The backend is the caller's: ``init(backend=...)`` or
``MXNET_DIST_BACKEND``; the default is ``nccl`` where CUDA is available
and ``gloo`` otherwise. Two ranks that share one GPU must name ``gloo``:
with ``nccl`` ``init`` raises before NCCL's own duplicate-GPU error can
occur. ``timeout`` bounds every collective, so a hung rank fails instead
of hanging its peers.

``default_mesh()`` without sizes is the JAX package's GSPMD ``data ×
fsdp`` mesh: ``fsdp`` over the ranks of one host, ``data`` over hosts;
with sizes it is ``sharding.make_mesh(axis_sizes)``.
"""
from __future__ import annotations

import datetime
import os
import socket

__all__ = ["init", "rank", "size", "is_initialized", "default_mesh",
           "shutdown"]

_DEFAULT_TIMEOUT_S = 300.0


def _env_int(*names):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def init(coordinator_address=None, num_processes=None, process_id=None,
         backend=None, timeout=None):
    """Join the process group (a no-op when it is already initialized).

    coordinator_address: "host:port" of the TCP store rank 0 serves;
    num_processes / process_id: world size and rank. Each defaults to
    the DMLC_* variables, then MASTER_ADDR/MASTER_PORT, WORLD_SIZE,
    RANK. A world of one process needs no coordinator and starts no
    group. backend: 'nccl' | 'gloo' (default MXNET_DIST_BACKEND, else
    nccl with CUDA, gloo without). timeout: seconds a collective may
    wait (default 300)."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return
    if coordinator_address is None:
        uri = os.environ.get("DMLC_PS_ROOT_URI") or \
            os.environ.get("MASTER_ADDR")
        port = os.environ.get("DMLC_PS_ROOT_PORT") or \
            os.environ.get("MASTER_PORT") or "9000"
        if uri:
            coordinator_address = "%s:%s" % (uri, port)
    if num_processes is None:
        num_processes = _env_int("DMLC_NUM_WORKER", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("DMLC_WORKER_ID", "RANK")
    if num_processes is None or int(num_processes) <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError(
            "dist.init for %d processes needs a coordinator address and "
            "this process's rank: pass coordinator_address= and "
            "process_id=, or set DMLC_PS_ROOT_URI/DMLC_PS_ROOT_PORT and "
            "DMLC_WORKER_ID (or MASTER_ADDR/MASTER_PORT and RANK)"
            % int(num_processes))
    world, rank_ = int(num_processes), int(process_id)
    if backend is None:
        backend = os.environ.get("MXNET_DIST_BACKEND") or (
            "nccl" if torch.cuda.is_available() else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError("backend must be 'nccl' or 'gloo', got %r"
                         % (backend,))
    if backend == "nccl" and not torch.cuda.is_available():
        raise ValueError("backend 'nccl' needs a CUDA device; this rank "
                         "sees none (name backend='gloo' for CPU ranks)")
    host, _, port = coordinator_address.rpartition(":")
    limit = datetime.timedelta(seconds=float(
        timeout if timeout is not None else _DEFAULT_TIMEOUT_S))
    store = dist.TCPStore(host, int(port), world, rank_ == 0,
                          timeout=limit)
    if backend == "nccl":
        _check_one_gpu_a_rank(store, rank_, world)
    dist.init_process_group(backend, store=store, rank=rank_,
                            world_size=world, timeout=limit)


def _check_one_gpu_a_rank(store, rank_, world):
    """NCCL takes one rank a GPU: publish this rank's (host, device)
    through the store and raise, naming gloo, if two ranks share one."""
    import torch
    local = _env_int("LOCAL_RANK")
    dev = local if local is not None else \
        rank_ % torch.cuda.device_count()
    torch.cuda.set_device(dev)
    me = "%s:%d" % (socket.gethostname(), dev)
    store.set("mxnet_dev/%d" % rank_, me)
    seen = {}
    for r in range(world):
        where = store.get("mxnet_dev/%d" % r).decode()
        if where in seen:
            raise ValueError(
                "ranks %d and %d share GPU %s, which NCCL refuses; run "
                "ranks that share a GPU with backend='gloo' (or "
                "MXNET_DIST_BACKEND=gloo)" % (seen[where], r, where))
        seen[where] = r


def is_initialized():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def rank():
    import torch.distributed as dist
    return dist.get_rank() if is_initialized() else 0


def size():
    import torch.distributed as dist
    return dist.get_world_size() if is_initialized() else 1


def shutdown():
    """Leave the process group (a no-op when none was joined)."""
    import torch.distributed as dist
    if is_initialized():
        dist.destroy_process_group()


def default_mesh(axis_sizes=None):
    """The ``data × fsdp`` mesh of the GSPMD path (docs/parallelism.md):
    ``fsdp`` spans the ranks of one host (parameter all-gathers stay on
    the host's fabric), ``data`` spans hosts (only gradient reductions
    cross between them). A host's ranks must hold consecutive ranks and
    every host as many, else the mesh is ``fsdp`` over every rank, as
    the JAX package falls back. A process without a group gets ``data=1,
    fsdp=1``.

    axis_sizes: an override forwarded to ``sharding.make_mesh`` (e.g.
    ``{"data": 2, "fsdp": 2, "tp": 2}``)."""
    from .sharding import make_mesh
    if axis_sizes is not None:
        return make_mesh(axis_sizes)
    n = size()
    if n == 1:
        return make_mesh({"data": 1, "fsdp": 1})
    import torch.distributed as dist
    hosts = [None] * n
    dist.all_gather_object(hosts, socket.gethostname())
    order = []
    for h in hosts:
        if not order or order[-1] != h:
            order.append(h)
    per = n // len(order)
    if len(order) != len(set(order)) or per * len(order) != n or any(
            hosts[i * per:(i + 1) * per] != [h] * per
            for i, h in enumerate(order)):
        return make_mesh({"data": 1, "fsdp": n})
    return make_mesh({"data": len(order), "fsdp": per})
