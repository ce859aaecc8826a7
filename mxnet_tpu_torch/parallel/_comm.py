"""The mesh and its collectives over ``torch.distributed`` ranks — the
PyTorch twin of what each ``shard_map`` body of the JAX package does by
hand (``mxnet_tpu/parallel/_compat.py`` and the ``lax`` collectives it
wraps).

A ``Mesh`` names its axes over a ``torch.distributed.device_mesh
.DeviceMesh`` that spans the world of the initialized process group; one
rank owns one device, and each named axis yields its own process group. A
mesh whose axes multiply to 1 needs no process group: every collective is
then the identity, which is how the one-rank runs work.

Tensors under a mesh are plain local tensors. The collectives are
``torch.autograd.Function``s with the JAX package's transpose rules:

  ppermute(x, perm)          send to the permuted rank; backward: the
                             inverse permutation
  all_to_all(x, split, cat)  exchange chunks; backward: an all_to_all back
  psum(x)                    sum over the axis; backward: the identity
                             (JAX's rule for a sum whose result is the
                             same on every rank)
  all_gather(x, dim)         gather; backward: a reduce-scatter
                             (JAX's ``psum_scatter`` transpose)
  axis_index                 this rank's index on the axis

and three region helpers stand in for ``shard_map``'s in_specs/out_specs
around a mesh-aware op whose input every rank holds whole:

  scatter_to_axis   keep this rank's slice; backward: all_gather of the
                    slice cotangents
  copy_to_axis      the identity (a replicated input such as a router
                    weight); backward: psum, since the cotangent from the
                    local tokens is partial
  gather_from_axis  all_gather of a sharded output; backward: keep this
                    rank's slice, since the cotangent is replicated

and ``take_from_axis`` keeps this rank's slice of a result every rank
computed whole from an all-gathered input (backward: the zero-padded
cotangent, so the gradients behind it stay this rank's part).
``global_sum`` is the sum of a statistic over the ranks of an axis whose
every rank's loss covers its own rows (BatchNorm's sums, a graph's
reduction over the batch): a psum forward and a psum of the partial
cotangents backward. The ``*_axes`` forms apply one of these over
several axes in turn (the replica axes ``data`` and ``fsdp``).

The param gather (``param_gather``) hands the graph a whole parameter
from this rank's shard under its spec: forward, an all-gather over the
spec's axes (the minor axis of a merged entry first); backward, the sum
of the cotangents over the spec's batch axes (``data``, ``fsdp``: each
rank's cotangent covers its own rows) and this rank's slice over its
model axes (``tp``, ``model``: the cotangent is the same on every rank
of them), a reduce-scatter and a slice.

With these rules a parameter replicated over ``sp``, ``expert`` or
``pipe`` gets the same, complete gradient on every rank, and a training
step reduces gradients over ``data`` alone.

A collective's backward is itself a collective, so every rank must reach
it: a rank whose schedule leaves a collective's output unused (a causal
ring block it skips, a pipeline stage that never reads its carry) ties
that output to its result (``tie``), whose backward hands it a zero
cotangent. Autograd then runs the same backward collectives on every
rank, in the order their forwards were created.

Transport follows the group's backend, never a caught error: NCCL takes
CUDA tensors as they are; on a gloo group a CUDA tensor goes through a
pinned host buffer for every collective (two ranks that share one GPU
must use gloo, since NCCL refuses them), and the bytes so staged are
counted in the telemetry counter ``parallel.comm.staged_bytes``. It is a
transport, not a fallback: every kernel still runs on the card.
bfloat16 crosses as its bytes (sums are taken in float32 and rounded
back once).
"""
from __future__ import annotations

import math

import torch

from .. import telemetry as _telemetry
from ..ops._mesh_ctx import REPLICA_AXES

__all__ = ["Mesh", "ppermute", "all_to_all", "psum", "all_gather",
           "axis_index", "scatter_to_axis", "copy_to_axis",
           "gather_from_axis", "take_from_axis", "global_sum", "tie",
           "all_reduce_", "param_gather", "world_gather",
           "world_broadcast", "STAGED_BYTES"]

STAGED_BYTES = "parallel.comm.staged_bytes"


def _dist():
    import torch.distributed as dist
    return dist


class Mesh:
    """Named axes over the ranks of the process group.

    axis_sizes: an ordered {name: size}; the sizes multiply to the world
    size (``sharding.make_mesh`` checks and infers a -1). Ranks are laid
    out row-major: the last axis varies fastest, as ``np.reshape`` lays
    out the JAX package's device array.

    ``shape`` ({name: size}) and ``axis_names`` read as on a
    ``jax.sharding.Mesh``; ``axis_index(name)`` is this rank's coordinate
    and ``group(name)`` the process group of its axis (None on a
    one-rank axis)."""

    def __init__(self, axis_sizes):
        self.axis_names = tuple(axis_sizes)
        self.shape = {k: int(v) for k, v in axis_sizes.items()}
        self.size = math.prod(self.shape.values())
        dist = _dist()
        if self.size > 1:
            if not (dist.is_available() and dist.is_initialized()):
                raise ValueError(
                    "a mesh of %d ranks %r needs an initialized process "
                    "group: call mxnet_tpu_torch.parallel.dist.init() in "
                    "every rank first" % (self.size, self.shape))
            self.rank = dist.get_rank()
            self.backend = dist.get_backend()
            from torch.distributed.device_mesh import DeviceMesh
            dtype = "cpu" if self.backend == "gloo" else "cuda"
            self.device_mesh = DeviceMesh(
                dtype, torch.arange(self.size).reshape(
                    tuple(self.shape.values())),
                mesh_dim_names=self.axis_names)
        else:
            self.rank = 0
            self.backend = None
            self.device_mesh = None
        # this rank's coordinate on each axis, row-major
        coords, rem = {}, self.rank
        for name in reversed(self.axis_names):
            coords[name] = rem % self.shape[name]
            rem //= self.shape[name]
        self._coords = {n: coords[n] for n in self.axis_names}
        self._groups = {}
        self._ranks = {}
        strides, s = {}, 1
        for name in reversed(self.axis_names):
            strides[name] = s
            s *= self.shape[name]
        for name in self.axis_names:
            base = self.rank - self._coords[name] * strides[name]
            self._ranks[name] = [base + i * strides[name]
                                 for i in range(self.shape[name])]
            self._groups[name] = self.device_mesh.get_group(name) \
                if self.device_mesh is not None and \
                self.shape[name] > 1 else None

    def axis_index(self, name):
        return self._coords[name]

    def group(self, name):
        return self._groups[name]

    def axis_ranks(self, name):
        """Global ranks of this rank's group on ``name``, by index."""
        return list(self._ranks[name])

    def __repr__(self):
        return "Mesh(%r, rank=%d)" % (self.shape, self.rank)


def axis_index(mesh, axis):
    """``lax.axis_index``: this rank's index on ``axis`` (0 off-mesh)."""
    return 0 if mesh is None else mesh.axis_index(axis)


# ---------------------------------------------------------------------------
# transport: one place that knows NCCL from gloo
# ---------------------------------------------------------------------------

def _staged(group, t):
    return t.device.type == "cuda" and \
        _dist().get_backend(group) == "gloo"


def _wire(t):
    """A contiguous view the backend can carry: bfloat16 as its bytes
    (gloo has no bfloat16 nor int16; a copy, not arithmetic)."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


def _unwire(t, dtype):
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _to_host(t):
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    _telemetry.counter(STAGED_BYTES).inc(t.numel() * t.element_size())
    return host


def _to_device(host, device):
    _telemetry.counter(STAGED_BYTES).inc(host.numel() * host.element_size())
    return host.to(device)


def _through(group, fn, *tensors):
    """Run ``fn(*tensors) -> tensor`` on the group's transport: on a gloo
    group, CUDA tensors go through pinned host buffers both ways."""
    dev = tensors[0].device
    if not _staged(group, tensors[0]):
        return fn(*tensors)
    torch.cuda.current_stream(dev).synchronize()
    out = fn(*(_to_host(t) for t in tensors))
    return _to_device(out, dev)


def _raw_all_reduce(x, group):
    dist = _dist()
    wide = x.dtype in (torch.bfloat16, torch.float16)

    def run(t):
        t = t.float() if wide else t.contiguous().clone()
        dist.all_reduce(t, group=group)
        return t

    out = _through(group, run, x)
    return out.to(x.dtype) if wide else out


def all_reduce_(tensors, mesh, axis, op="sum"):
    """In-place all-reduce of a list of tensors over ``axis``, or over
    each axis of a tuple in turn (no autograd: gradients, metric sums,
    flags). op: 'sum', 'max' or 'min'. The tensors of one dtype go as one
    flat buffer."""
    if isinstance(axis, tuple):
        for a in axis:
            all_reduce_(tensors, mesh, a, op)
        return tensors
    if mesh is None or mesh.shape.get(axis, 1) == 1 or not tensors:
        return tensors
    dist = _dist()
    group = mesh.group(axis)
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        flat = torch.cat([t.reshape(-1) for t in ts])
        wide = dtype in (torch.bfloat16, torch.float16, torch.bool)
        if dtype == torch.bool:
            flat = flat.to(torch.int32)
        elif wide:
            flat = flat.float()

        def run(b):
            b = b.contiguous().clone()
            dist.all_reduce(b, op=rop, group=group)
            return b

        flat = _through(group, run, flat)
        i = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[i:i + n].reshape(t.shape).to(dtype))
            i += n
    return tensors


def _raw_all_gather(x, group, n, dim):
    """Concatenate every rank's ``x`` along ``dim``, in axis order."""
    dist = _dist()
    dtype = x.dtype
    xm = x.movedim(dim, 0)

    def run(t):
        t = _wire(t)
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return out

    out = _unwire(_through(group, run, xm), dtype)
    return out.movedim(0, dim)


def world_gather(x):
    """Every rank's ``x`` stacked on a new leading axis in rank order,
    over the whole process group (the distributed KVStore's push: the
    caller sums the stacked axis in that order, so the sum does not
    depend on the backend's reduction order)."""
    n = _dist().get_world_size()
    return _raw_all_gather(x.reshape((1,) + tuple(x.shape)), None, n, 0)


def world_broadcast(x, src=0):
    """Rank ``src``'s ``x`` on every rank of the process group (a new
    tensor; the distributed KVStore's init)."""
    dist = _dist()
    dtype = x.dtype

    def run(t):
        t = _wire(t).clone()
        dist.broadcast(t, src=src)
        return t

    return _unwire(_through(None, run, x.contiguous()), dtype)


def _raw_all_to_all(x, group, n):
    """Chunk i of dim 0 goes to rank i; chunk j of the result came from
    rank j (``lax.all_to_all`` untiled, split = concat = 0)."""
    dist = _dist()
    dtype = x.dtype

    def run(t):
        t = _wire(t)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    return _unwire(_through(group, run, x), dtype)


def _raw_ppermute(x, mesh, axis, perm):
    """Send ``x`` along ``perm`` ((src, dst) axis indices); a rank that
    receives nothing gets zeros, as ``lax.ppermute`` gives."""
    dist = _dist()
    group = mesh.group(axis)
    ranks = mesh.axis_ranks(axis)
    me = mesh.axis_index(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    dtype = x.dtype

    def run(t):
        t = _wire(t)
        out = torch.zeros_like(t)
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, t, ranks[dst[0]],
                                  group=group))
        if src:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src[0]],
                                  group=group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    return _unwire(_through(group, run, x), dtype)


def _one_rank(mesh, axis):
    return mesh is None or mesh.shape.get(axis, 1) == 1


def entry_axes(entry):
    """A spec entry as a tuple of axis names, major first (None: ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def place_local(value, spec, mesh):
    """This rank's slice of a whole ``value`` under ``spec`` (no
    autograd); a merged entry splits by its first axis, then each piece by
    the next, as a JAX ``NamedSharding`` lays out a tuple entry."""
    if mesh is None:
        return value
    for d, entry in enumerate(spec):
        for axis in entry_axes(entry):
            n = mesh.shape[axis]
            if n == 1:
                continue
            if value.shape[d] % n:
                raise ValueError(
                    "dim %d of shape %r does not split over the %d ranks "
                    "of mesh axis %r" % (d, tuple(value.shape), n, axis))
            step = value.shape[d] // n
            value = value.narrow(d, mesh.axis_index(axis) * step, step)
    return value.contiguous()


def gather_local(value, spec, mesh):
    """The whole array from every rank's slice under ``spec`` (no
    autograd; the minor axis of a merged entry is gathered first)."""
    if mesh is None:
        return value
    for d, entry in reversed(list(enumerate(spec))):
        for axis in reversed(entry_axes(entry)):
            if mesh.shape[axis] == 1:
                continue
            value = _raw_all_gather(value.contiguous(), mesh.group(axis),
                                    mesh.shape[axis], d)
    return value


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, perm)
        return _raw_ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        inv = [(d, s) for s, d in perm]
        return _raw_ppermute(g, mesh, axis, inv), None, None, None


def ppermute(x, mesh, axis, perm):
    """``lax.ppermute``: perm is a list of (source, destination) axis
    indices; ranks that receive nothing get zeros."""
    perm = [(int(s), int(d)) for s, d in perm]
    if _one_rank(mesh, axis):
        moved = dict(perm)
        return x if moved.get(0) == 0 else torch.zeros_like(x)
    return _PPermute.apply(x, mesh, axis, perm)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (_all_to_all(g, mesh, axis, concat_axis, split_axis),
                None, None, None, None)


def _all_to_all(x, mesh, axis, split_axis, concat_axis):
    n = mesh.shape[axis]
    if x.shape[split_axis] != n:
        raise ValueError("all_to_all over %r: split dim %d has size %d, "
                         "the axis has %d ranks" % (axis, split_axis,
                                                    x.shape[split_axis], n))
    y = _raw_all_to_all(x.movedim(split_axis, 0).contiguous(),
                        mesh.group(axis), n)
    # y[j] came from rank j: that index lands on concat_axis
    return y.movedim(0, concat_axis)


def all_to_all(x, mesh, axis, split_axis=0, concat_axis=0):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=False)``:
    ``x.shape[split_axis]`` equals the axis size; chunk i goes to rank i,
    and the chunk from rank j sits at index j of ``concat_axis``."""
    if _one_rank(mesh, axis):
        return x.movedim(split_axis, concat_axis)
    return _AllToAll.apply(x, mesh, axis, int(split_axis),
                           int(concat_axis))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _raw_all_reduce(x, mesh.group(axis))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x, mesh, axis):
    """``lax.psum`` over ``axis``; its cotangent passes through unchanged
    (every rank holds the same sum, so its cotangent is replicated)."""
    if _one_rank(mesh, axis):
        return x
    return _PSum.apply(x, mesh, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _raw_all_gather(x, mesh.group(axis), mesh.shape[axis], dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        total = _raw_all_reduce(g, mesh.group(axis))
        return _my_slice(total, mesh, axis, dim), None, None, None


def all_gather(x, mesh, axis, dim=0):
    """``lax.all_gather(..., tiled=True)`` along ``dim``; backward: the
    reduce-scatter of the cotangents (JAX's ``psum_scatter``)."""
    if _one_rank(mesh, axis):
        return x
    return _AllGather.apply(x, mesh, axis, int(dim))


def _my_slice(x, mesh, axis, dim):
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError("dim %d of size %d does not split over the %d "
                         "ranks of mesh axis %r" % (dim, x.shape[dim], n,
                                                    axis))
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * step, step).contiguous()


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _my_slice(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return (_raw_all_gather(g.contiguous(), mesh.group(axis),
                                mesh.shape[axis], dim), None, None, None)


def scatter_to_axis(x, mesh, axis, dim):
    """Keep this rank's slice of a replicated ``x`` along ``dim``;
    backward: all_gather of the slice cotangents."""
    if _one_rank(mesh, axis):
        return x
    return _Scatter.apply(x, mesh, axis, int(dim))


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return _raw_all_reduce(g, mesh.group(axis)), None, None


def copy_to_axis(x, mesh, axis):
    """The identity on a replicated input that meets local work (a router
    weight, a stage's shared input); backward: psum of the partial
    cotangents."""
    if _one_rank(mesh, axis):
        return x
    return _Copy.apply(x, mesh, axis)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _raw_all_gather(x.contiguous(), mesh.group(axis),
                               mesh.shape[axis], dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return _my_slice(g, mesh, axis, dim), None, None, None


def gather_from_axis(x, mesh, axis, dim):
    """all_gather a sharded output along ``dim`` into the whole tensor on
    every rank; backward: keep this rank's slice of the (replicated)
    cotangent."""
    if _one_rank(mesh, axis):
        return x
    return _Gather.apply(x, mesh, axis, int(dim))


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim, x.shape)
        return _my_slice(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, shape = ctx.args
        full = g.new_zeros(shape)
        step = shape[dim] // mesh.shape[axis]
        full.narrow(dim, mesh.axis_index(axis) * step, step).copy_(g)
        return full, None, None, None


def take_from_axis(x, mesh, axis, dim):
    """Keep this rank's slice of ``x`` along ``dim``, a value every rank
    computed whole from an ``all_gather``-ed input; backward: the
    cotangent zero-padded to the whole (a slice's transpose), so the
    gradients behind it are this rank's part, which sum over the axis as
    the step's gradients over ``data`` do."""
    if _one_rank(mesh, axis):
        return x
    return _Take.apply(x, mesh, axis, int(dim))


def global_sum(x, mesh, axes):
    """The sum of ``x`` over the ranks of each of ``axes`` (an axis or a
    tuple), with the partial cotangents summed back (``copy_to_axis`` of
    a ``psum``): the rule for a statistic of the whole batch that meets
    this rank's rows again."""
    for a in ((axes,) if isinstance(axes, str) else axes):
        x = copy_to_axis(psum(x, mesh, a), mesh, a)
    return x


def all_gather_axes(x, mesh, axes, dim=0):
    """``all_gather`` over several axes, the minor (last) one first: the
    rows of a batch split over merged axes, whole on every rank."""
    for a in reversed(tuple(axes)):
        x = all_gather(x, mesh, a, dim)
    return x


def take_from_axes(x, mesh, axes, dim=0):
    """``take_from_axis`` over several axes, major first: this rank's rows
    of a value every rank computed whole."""
    for a in axes:
        x = take_from_axis(x, mesh, a, dim)
    return x



class _ParamGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.args = (mesh, spec)
        return gather_local(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh, spec = ctx.args
        for entry in spec:
            for a in entry_axes(entry):
                # ranks of a batch axis hold different rows: their
                # cotangents are partial and sum; over tp and model the
                # cotangent is the same on every rank
                if a in REPLICA_AXES and mesh.shape[a] > 1:
                    g = _raw_all_reduce(g.contiguous(), mesh.group(a))
        return place_local(g, spec, mesh), None, None


def param_gather(x, mesh, spec):
    """The whole parameter from this rank's shard under ``spec``;
    backward: the reduce-scatter over the spec's batch axes and this
    rank's slice over its model axes (see the module doc)."""
    if mesh is None or not any(mesh.shape[a] > 1 for e in spec
                               for a in entry_axes(e)):
        return x
    return _ParamGather.apply(x, mesh, tuple(spec))


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *deps):
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=t, device=d)
                     for s, t, d in ctx.deps))


def tie(out, *deps):
    """``out`` unchanged, with ``deps`` (collective outputs this rank may
    leave unused) tied into its autograd graph: their cotangent is zero,
    but their backward collectives run on every rank."""
    deps = [d for d in deps if d is not None and d.requires_grad]
    if not deps or not torch.is_grad_enabled():
        return out
    return _Tie.apply(out, *deps)
