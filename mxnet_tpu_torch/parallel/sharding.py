"""Mesh construction and the placement rules — the PyTorch twin of the
parts of ``mxnet_tpu/parallel/sharding.py`` for the axes on which the JAX
package writes its collectives by hand:

  data    data parallelism: the batch splits over it, gradients sum over
          it, parameters replicate along it; ``optimizer_sharding=
          'zero1'`` folds the optimizer state over it
  sp      sequence parallelism (ring attention, ``seq_axis=``)
  expert  expert parallelism (the MoE FFN's all_to_all, ``expert_axis=``);
          per-expert stacked weights hold E/n experts a rank
  pipe    pipeline stages (``pipeline.pipeline_apply``)

A sharding here is a spec: a tuple with an axis name or None per
dimension, trailing Nones stripped (``("expert",)``, ``("expert",
"data")``, ``()`` for replicated), the JAX package's ``PartitionSpec``
entries. Tensors are plain local tensors: ``place`` keeps this rank's
slice of a whole array and ``gather`` (no autograd) puts the whole array
back together on every rank, as a checkpoint needs.

Not in this slice (ROADMAP Queue A item 9b): the GSPMD axes ``model``,
``tp`` and ``fsdp`` and ``SpecLayout``, the partition-spec registry over
them; both raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from ._comm import Mesh, _raw_all_gather

__all__ = ["Mesh", "make_mesh", "data_parallel_mesh", "param_sharding",
           "batch_sharding", "replicated", "zero1_sharding", "SpecLayout",
           "place", "gather", "as_layout", "REPLICA_AXES"]

# axes the batch dimension shards over and optimizer state folds across
# (in this order); the port's mesh has no fsdp axis yet (item 9b)
REPLICA_AXES = ("data", "fsdp")

_GSPMD_AXES = ("model", "tp", "fsdp")


def _not_ported_9b(what):
    raise NotImplementedError(
        "%s is GSPMD tensor/parameter sharding, not ported to the PyTorch "
        "package yet (ROADMAP Queue A item 9b); this slice takes the "
        "data, sp, expert and pipe axes" % what)


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(axis_sizes, devices=None):
    """A Mesh from {'data': N, 'sp': M, ...} over the ranks of the
    process group. Sizes must multiply to the world size; pass -1 for (at
    most) one axis to infer it. Raises ValueError with the sizes and the
    world size on any mismatch."""
    if devices is not None:
        raise ValueError("make_mesh spans the ranks of the process group; "
                         "one rank owns one device, so devices= is not "
                         "taken (start the ranks you want instead)")
    names = tuple(axis_sizes.keys())
    for name in names:
        if name in _GSPMD_AXES:
            _not_ported_9b("mesh axis %r" % name)
    sizes = list(axis_sizes.values())
    n = _world()
    bad = [(k, v) for k, v in axis_sizes.items()
           if not isinstance(v, int) or (v < 1 and v != -1)]
    if bad:
        raise ValueError(
            "mesh axis sizes must be positive ints (or one -1 to "
            "infer), got %r in %r" % (bad, axis_sizes))
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1 (inferred), "
                         "got %r" % (axis_sizes,))
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known != 0:
            raise ValueError(
                "cannot infer the -1 axis of %r: the known sizes "
                "multiply to %d, which does not divide the %d ranks of "
                "the process group" % (axis_sizes, known, n))
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            "mesh axes %r (sizes %r, product %d) don't multiply to the %d "
            "ranks of the process group — fix the sizes, use -1 for one "
            "axis, or start %d ranks (dist.init)"
            % (names, sizes, math.prod(sizes), n, math.prod(sizes)))
    return Mesh(dict(zip(names, sizes)))


def data_parallel_mesh(devices=None):
    """1-D data mesh over every rank."""
    return make_mesh({"data": -1}, devices=devices)


def _strip(parts):
    parts = list(parts)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def replicated(mesh):
    return ()


def batch_sharding(mesh, ndim, batch_axis=0):
    """Batch arrays: split the batch axis over 'data'."""
    spec = [None] * ndim
    spec[batch_axis] = "data"
    return _strip(spec)


def param_sharding(mesh, name, shape):
    """The parameter rule for these axes: on a mesh with an 'expert'
    axis, per-expert stacked weights (names carrying 'expert', leading
    dim divisible by the axis) split their leading dim over it; every
    other parameter is replicated."""
    if "expert" in mesh.axis_names and "expert" in name and \
            len(shape) >= 1 and shape[0] % mesh.shape["expert"] == 0:
        return ("expert",)
    return ()


def zero1_sharding(mesh, name, shape):
    """ZeRO-1 sharding of a parameter's optimizer state (and update):
    its parameter spec, plus the first still-undivided dim divisible by
    the 'data' axis size split over 'data'. Tensors with no such dim stay
    on the parameter spec (small; not worth a collective)."""
    base = param_sharding(mesh, name, shape)
    if "data" not in mesh.axis_names:
        return base
    dsize = mesh.shape["data"]
    spec = list(base) + [None] * (len(shape) - len(base))
    for d in range(len(shape)):
        if spec[d] is None and shape[d] % dsize == 0 and \
                shape[d] >= dsize:
            spec[d] = "data"
            return _strip(spec)
    return base


def place(value, spec, mesh):
    """This rank's slice of a whole ``value`` under ``spec``."""
    if mesh is None:
        return value
    for d, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n = mesh.shape[axis]
        if value.shape[d] % n:
            raise ValueError("dim %d of shape %r does not split over the "
                             "%d ranks of mesh axis %r"
                             % (d, tuple(value.shape), n, axis))
        step = value.shape[d] // n
        value = value.narrow(d, mesh.axis_index(axis) * step, step)
    return value.contiguous()


def gather(value, spec, mesh):
    """The whole array from every rank's slice under ``spec`` (a
    collective: every rank of each named axis calls it)."""
    if mesh is None:
        return value
    for d, axis in reversed(list(enumerate(spec))):
        if axis is None or mesh.shape[axis] == 1:
            continue
        with torch.no_grad():
            value = _raw_all_gather(value.contiguous(), mesh.group(axis),
                                    mesh.shape[axis], d)
    return value


def local_shape(shape, spec, mesh):
    """The shape of this rank's slice of a ``shape`` array."""
    out = list(shape)
    for d, axis in enumerate(spec):
        if axis is not None:
            out[d] //= mesh.shape[axis]
    return tuple(out)


class _HeuristicLayout:
    """The name rules behind a bare ``mesh=`` argument (param_sharding /
    zero1_sharding / batch_sharding), as a layout so TrainStep has one
    placement path."""

    def __init__(self, mesh):
        self.mesh = mesh

    @property
    def batch_axes(self):
        return ("data",) if "data" in self.mesh.axis_names else ()

    # optimizer state folds over the same axes the batch shards over
    zero_axes = batch_axes

    def param_nsharding(self, name, shape):
        return param_sharding(self.mesh, name, shape)

    def opt_nsharding(self, name, shape, zero=False):
        if zero:
            return zero1_sharding(self.mesh, name, shape)
        return param_sharding(self.mesh, name, shape)

    def batch_nsharding(self, ndim, batch_axis=0):
        if not self.batch_axes:
            # sp/pipe/expert-only meshes: the batch enters replicated and
            # the mesh-aware ops shard what they need
            return replicated(self.mesh)
        return batch_sharding(self.mesh, ndim, batch_axis)



class SpecLayout:
    """The GSPMD partition-spec registry over a data × fsdp × tp mesh;
    not ported yet (ROADMAP Queue A item 9b)."""

    def __init__(self, *args, **kwargs):
        _not_ported_9b("SpecLayout")


def as_layout(mesh_or_layout):
    """A mesh-or-layout argument as a layout (None stays None)."""
    if mesh_or_layout is None:
        return None
    if isinstance(mesh_or_layout, Mesh):
        return _HeuristicLayout(mesh_or_layout)
    return mesh_or_layout
