"""Mesh construction and the placement rules — the PyTorch twin of
``mxnet_tpu/parallel/sharding.py``.

Axes (scaling-book style):

  data    data parallelism: the batch splits over it, gradients sum over
          it, parameters replicate along it; ``optimizer_sharding=
          'zero1'`` folds the optimizer state over it
  fsdp    data parallelism with parameter sharding: the batch ALSO splits
          over it, but parameters and optimizer state live 1/|fsdp| a
          rank, and the param gather (``_comm.param_gather``) hands the
          graph each whole parameter where it is used
  tp      tensor parallelism (the hidden dimension): a FullyConnected
          whose weight splits on dim 0 over it runs column-parallel
  model   the heuristic layout's name for the tensor-parallel axis
  sp      sequence parallelism (ring attention, ``seq_axis=``)
  expert  expert parallelism (the MoE FFN's all_to_all, ``expert_axis=``);
          per-expert stacked weights hold E/n experts a rank
  pipe    pipeline stages (``pipeline.pipeline_apply``)

A sharding here is a spec: a tuple with an entry per dimension, trailing
Nones stripped, each entry None, an axis name, or a tuple of axes that
share the dimension (the first the major one), the JAX package's
``PartitionSpec`` entries; ``P`` builds one as JAX's ``PartitionSpec``
does. Tensors are plain local tensors: ``place`` keeps this rank's slice
of a whole array and ``gather`` (no autograd) puts the whole array back
together on every rank, as a checkpoint needs.

Two layouts decide every parameter, optimizer-state and batch spec
through one interface: ``_HeuristicLayout`` (the name rules behind a bare
``mesh=``: ``param_sharding``, ``zero1_sharding``, ``batch_sharding``) and
``SpecLayout`` (the partition-spec registry over a ``data × fsdp × tp``
mesh: ordered first-match rules, an auto rule sharding the largest
``fsdp``-divisible dim, the optimizer state folded over ``data × fsdp``,
``describe()``).
"""
from __future__ import annotations

import fnmatch
import math

from ..ops._mesh_ctx import REPLICA_AXES
from ._comm import Mesh, entry_axes as _entry_axes, gather_local, place_local

__all__ = ["Mesh", "P", "make_mesh", "data_parallel_mesh", "param_sharding",
           "batch_sharding", "replicated", "zero1_sharding", "SpecLayout",
           "place", "gather", "local_shape", "as_layout", "parse_spec",
           "REPLICA_AXES", "MODEL_AXES", "GATHERED_AXES"]

# REPLICA_AXES (data, fsdp): the axes the batch dimension shards over and
# optimizer state folds across, in this order. Everything else
# (tp/model/sp/expert/pipe) partitions the model itself, never the batch.

# the tensor-parallel axes: a weight split on dim 0 over one of them runs
# its FullyConnected column-parallel
MODEL_AXES = ("tp", "model")

# the axes a parameter's shard is gathered over before use (an expert
# stack split over 'expert' is read split by its op)
GATHERED_AXES = REPLICA_AXES + MODEL_AXES


class P(tuple):
    """A partition spec, ``P("fsdp", None)`` or ``P(("fsdp", "tp"),
    None)``, as JAX's ``PartitionSpec`` reads: one entry a dimension."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(axis_sizes, devices=None):
    """A Mesh from {'data': N, 'fsdp': M, ...} over the ranks of the
    process group. Sizes must multiply to the world size; pass -1 for (at
    most) one axis to infer it. Raises ValueError with the sizes and the
    world size on any mismatch. Ranks fill the axes row-major, as the
    JAX package reshapes its device list."""
    if devices is not None:
        raise ValueError("make_mesh spans the ranks of the process group; "
                         "one rank owns one device, so devices= is not "
                         "taken (start the ranks you want instead)")
    names = tuple(axis_sizes.keys())
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
    """The heuristic parameter rule: per-expert stacked weights (names
    carrying 'expert', leading dim divisible by the axis) split their
    leading dim over 'expert'; on a mesh with a 'model' axis a weight of
    two or more dims splits dim 0 over it (a FullyConnected weight
    (num_hidden, in) then runs column-parallel) and a bias vector its one
    dim, where the size divides; every other parameter is replicated."""
    if "expert" in mesh.axis_names and "expert" in name and \
            len(shape) >= 1 and shape[0] % mesh.shape["expert"] == 0:
        return ("expert",)
    if "model" not in mesh.axis_names:
        return ()
    msize = mesh.shape["model"]
    if len(shape) >= 2 and shape[0] % msize == 0 and (
            name.endswith("_weight") or name.endswith("weight")):
        return ("model",)
    if len(shape) == 1 and shape[0] % msize == 0 and \
            name.endswith("_bias"):
        return ("model",)
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
    return place_local(value, spec, mesh)


def gather(value, spec, mesh):
    """The whole array from every rank's slice under ``spec`` (a
    collective: every rank of each named axis calls it)."""
    import torch
    with torch.no_grad():
        return gather_local(value, spec, mesh)


def local_shape(shape, spec, mesh):
    """The shape of this rank's slice of a ``shape`` array."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for axis in _entry_axes(entry):
            out[d] //= mesh.shape[axis]
    return tuple(out)


# ---------------------------------------------------------------------------
# the layout interface
# ---------------------------------------------------------------------------

def parse_spec(spec):
    """Rule grammar -> tuple of per-dim entries (None | axis | tuple).

    Accepts a ``P``, a tuple/list (entries: None, 'axis', or a tuple of
    axes sharing one dim), or a string: comma-separated dims, '+'-joined
    axes within one dim, None/'' for replicated dims — ``"fsdp,None"``,
    ``"data+fsdp"``, ``"fsdp,tp"``.
    """
    if isinstance(spec, (tuple, list)):
        parts = list(spec)
    else:
        parts = [p.strip() for p in
                 str(spec).strip().strip("()").split(",")]
        parts = [tuple(a.strip() for a in p.split("+")) if "+" in p
                 else p for p in parts]
    out = []
    for p in parts:
        if p is None or p in ("", "None", "none"):
            out.append(None)
        elif isinstance(p, (tuple, list)):
            sub = tuple(str(a) for a in p
                        if a not in (None, "", "None", "none"))
            out.append(sub if len(sub) > 1 else
                       (sub[0] if sub else None))
        else:
            out.append(str(p))
    return tuple(out)


def _batch_spec(axes, ndim, batch_axis):
    """The batch arrays' spec: the batch dim over the replica axes
    (merged, data major)."""
    parts = [None] * ndim
    if axes and ndim > 0:
        parts[batch_axis] = axes if len(axes) > 1 else axes[0]
    return _strip(parts)


class _HeuristicLayout:
    """The name rules behind a bare ``mesh=`` argument (param_sharding /
    zero1_sharding / batch_sharding), as a layout so TrainStep has one
    placement path."""

    def __init__(self, mesh):
        self.mesh = mesh

    @property
    def batch_axes(self):
        # every replica axis of the mesh splits the batch, as under a
        # SpecLayout (the JAX heuristic replicates the batch over an
        # 'fsdp' axis instead: the same global numbers)
        return tuple(a for a in REPLICA_AXES if a in self.mesh.axis_names)

    # optimizer state folds over the same axes the batch shards over
    zero_axes = batch_axes

    def param_nsharding(self, name, shape):
        return param_sharding(self.mesh, name, shape)

    def opt_nsharding(self, name, shape, zero=False):
        if zero:
            return zero1_sharding(self.mesh, name, shape)
        return param_sharding(self.mesh, name, shape)

    def batch_nsharding(self, ndim, batch_axis=0):
        # sp/pipe/expert/model-only meshes: the batch enters replicated
        # and the mesh-aware ops shard what they need
        return _batch_spec(self.batch_axes, ndim, batch_axis)

    def replicated_nsharding(self):
        return replicated(self.mesh)

    def act_parts(self, ndim):
        """No boundary constraints on the heuristic path (``__shard__``
        and ``__shard_hint__`` attributes still apply)."""
        return None

    def describe(self):
        return "heuristic layout over mesh %r (param_sharding " \
            "name-suffix rules; __shard__ attrs override)" \
            % dict(self.mesh.shape)


class SpecLayout:
    """Ordered partition-spec registry over a named mesh.

    rules: sequence of ``(pattern, spec)`` — pattern matches parameter
    names exactly or as a glob (``fnmatch``: ``*``, ``?``, ``[...]``),
    FIRST match wins; spec is a ``P`` / tuple / grammar string (see
    ``parse_spec``). Parameters no rule claims fall to the auto rule:
    shard the largest dim divisible by the ``fsdp`` axis over it,
    replicate the rest; tensors under ``min_shard_size`` elements
    (default MXNET_FSDP_MIN_SIZE) replicate — a per-layer all-gather
    costs more than the memory it saves on tiny tensors.

    Validation raises ValueError (never an assert): unknown axes at
    construction, rank/divisibility violations at first placement —
    each message names the rule, the parameter and the offending sizes.

    ``describe()`` (after placement, e.g. ``TrainStep.init_state``)
    reports which rule claimed each parameter and the per-rank shard.
    ``constrain_activations`` (default MXNET_GSPMD_CONSTRAIN_ACTS) is the
    JAX package's boundary pinning of activations to the batch axes:
    here every activation already holds this rank's batch rows, so
    ``act_parts`` is read and changes no number.
    """

    def __init__(self, mesh, rules=(), min_shard_size=None,
                 constrain_activations=None):
        from .. import config as _config
        self.mesh = mesh
        self.min_shard_size = int(
            _config.get("MXNET_FSDP_MIN_SIZE")
            if min_shard_size is None else min_shard_size)
        self.constrain_activations = bool(
            _config.get("MXNET_GSPMD_CONSTRAIN_ACTS")
            if constrain_activations is None else constrain_activations)
        self.rules = []
        for i, rule in enumerate(rules):
            try:
                pat, spec = rule
            except (TypeError, ValueError):
                raise ValueError(
                    "SpecLayout rule %d must be a (pattern, spec) "
                    "pair, got %r" % (i, rule))
            parts = parse_spec(spec)
            seen = set()
            for entry in parts:
                for ax in _entry_axes(entry):
                    if ax not in mesh.axis_names:
                        raise ValueError(
                            "SpecLayout rule %d (%r -> %r): axis %r is "
                            "not a mesh axis %r"
                            % (i, pat, spec, ax, mesh.axis_names))
                    if ax in seen:
                        raise ValueError(
                            "SpecLayout rule %d (%r -> %r): axis %r "
                            "appears on more than one dim"
                            % (i, pat, spec, ax))
                    seen.add(ax)
            self.rules.append((str(pat), parts))
        self._claims = {}   # name -> (label, parts, shape)

    @property
    def batch_axes(self):
        return tuple(a for a in REPLICA_AXES
                     if a in self.mesh.axis_names)

    # the replica axes optimizer state folds over under zero1 — the
    # data×fsdp product is the ZeRO shard count N
    zero_axes = batch_axes

    # -- rule resolution ---------------------------------------------------
    def spec_for(self, name, shape):
        """(per-dim parts, rule label) for a parameter. Explicit rules
        that cannot apply (rank/divisibility) fail loudly — first-match-
        wins means a bad glob silently falling through would mask a
        layout bug."""
        shape = tuple(shape)
        for i, (pat, parts) in enumerate(self.rules):
            if not fnmatch.fnmatchcase(name, pat):
                continue
            label = "rule[%d] %r" % (i, pat)
            if len(parts) > len(shape):
                raise ValueError(
                    "SpecLayout %s claims %r (shape %r) but its spec "
                    "%r has more dims than the parameter — narrow the "
                    "pattern or shorten the spec"
                    % (label, name, shape, parts))
            for d, entry in enumerate(parts):
                axes = _entry_axes(entry)
                if not axes:
                    continue
                n = math.prod(self.mesh.shape[a] for a in axes)
                if shape[d] % n != 0:
                    raise ValueError(
                        "SpecLayout %s claims %r but dim %d (size %d) "
                        "is not divisible by %r (total shards %d) — "
                        "put a more specific rule first or replicate "
                        "this parameter"
                        % (label, name, d, shape[d], entry, n))
            return parts + (None,) * (len(shape) - len(parts)), label
        return self._auto(shape)

    def _auto(self, shape):
        """Auto rule: shard the LARGEST divisible dim over 'fsdp',
        replicate the rest; tiny tensors replicate outright."""
        shape = tuple(shape)
        rep = (None,) * len(shape)
        if "fsdp" not in self.mesh.axis_names or not shape:
            return rep, "auto:replicated (no fsdp axis)"
        if math.prod(shape) < self.min_shard_size:
            return rep, "auto:replicated (< %d elements)" \
                % self.min_shard_size
        f = self.mesh.shape["fsdp"]
        best = None
        for d, s in enumerate(shape):
            if s % f == 0 and s >= f and (best is None
                                          or s > shape[best]):
                best = d
        if best is None:
            return rep, "auto:replicated (no dim divisible by fsdp=%d)" \
                % f
        parts = list(rep)
        parts[best] = "fsdp"
        return tuple(parts), "auto:fsdp@dim%d" % best

    # -- the layout interface ---------------------------------------------
    def param_nsharding(self, name, shape):
        parts, label = self.spec_for(name, shape)
        self._claims[name] = (label, parts, tuple(shape))
        return _strip(parts)

    def opt_nsharding(self, name, shape, zero=False):
        """Optimizer-state sharding. ``zero=True`` (the sharded-
        optimizer path) starts from the parameter's own spec and folds
        every still-unused replica axis (data, fsdp) into the first dim
        it divides — the weight update then runs on a 1/(data·fsdp)
        slice a rank (arXiv 2004.13336). A folded axis is the minor one
        of its entry, so the state is a slice of the rank's parameter
        shard."""
        parts, _ = self.spec_for(name, shape)
        if not zero:
            return _strip(parts)
        parts = list(parts)
        used = {a for e in parts for a in _entry_axes(e)}
        for ax in self.zero_axes:
            if ax in used:
                continue
            axn = self.mesh.shape[ax]
            for d in range(len(parts)):
                cur = _entry_axes(parts[d])
                have = math.prod(self.mesh.shape[a] for a in cur)
                if shape[d] % (have * axn) == 0 and \
                        shape[d] >= have * axn:
                    merged = cur + (ax,)
                    parts[d] = merged if len(merged) > 1 else merged[0]
                    used.add(ax)
                    break
        return _strip(parts)

    def batch_nsharding(self, ndim, batch_axis=0):
        return _batch_spec(self.batch_axes, ndim, batch_axis)

    def replicated_nsharding(self):
        return replicated(self.mesh)

    def act_parts(self, ndim):
        """Lenient per-dim parts pinning an activation's batch dim to
        the data axes at module boundaries, or None when constraints
        are off / there is nothing to pin."""
        if not self.constrain_activations or ndim == 0:
            return None
        axes = self.batch_axes
        if not axes:
            return None
        head = axes if len(axes) > 1 else axes[0]
        return (head,) + (None,) * (ndim - 1)

    def describe(self):
        """Human-readable placement report: one line per parameter the
        layout has claimed (global shape → per-rank shard, claiming
        rule), plus any rule that matched nothing."""
        lines = ["SpecLayout over mesh %r (%d devices)"
                 % (dict(self.mesh.shape), self.mesh.size)]
        matched = set()
        for name in sorted(self._claims):
            label, parts, shape = self._claims[name]
            if label.startswith("rule["):
                matched.add(label.split()[0])
            shard = local_shape(shape, parts, self.mesh)
            lines.append("  %-32s %s -> %s  spec=%r  [%s]"
                         % (name, "x".join(map(str, shape)) or "()",
                            "x".join(map(str, shard)) or "()",
                            tuple(parts), label))
        for i, (pat, _parts) in enumerate(self.rules):
            if "rule[%d]" % i not in matched:
                lines.append("  rule[%d] %r matched no parameter"
                             % (i, pat))
        if not self._claims:
            lines.append("  (no parameters placed yet — call "
                         "init_state/bind first)")
        return "\n".join(lines)


def as_layout(mesh_or_layout):
    """A mesh-or-layout argument as a layout (None stays None): the one
    seam through which TrainStep and the Module bind placement."""
    if mesh_or_layout is None:
        return None
    if isinstance(mesh_or_layout, Mesh):
        return _HeuristicLayout(mesh_or_layout)
    return mesh_or_layout
