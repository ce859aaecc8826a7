"""Ambient mesh for mesh-aware operators — a copy of the JAX package's
``ops/_mesh_ctx.py`` (pure Python).

The executor announces the mesh it evaluates a graph over; ops that can
exploit a mesh axis (``_contrib_FlashAttention(seq_axis='sp')`` switching
to ring attention, ``_contrib_MoEFFN(expert_axis=...)`` to the all_to_all
form, and the batch-global reductions over ``data``) read it when they
run. A contextvar — not a threaded argument — so the registry keeps its
pure ``fn(*tensors, **attrs)`` signature and only the ops that care opt
in.

The batch splits over the replica axes (``REPLICA_AXES``: ``data`` and
``fsdp``), and every batch-global route (the loss heads' divisors,
BatchNorm's statistics, Dropout's counters, the MoE route, the graph's
batch reductions) reads them through ``replica()``: the axes with more
than one rank, their rank count and this rank's place in the merged
batch order (``data`` major, as a JAX ``NamedSharding`` of
``("data", "fsdp")`` lays out dim 0).

The executor also announces the column-parallel form of a
FullyConnected whose weight the bound layout splits on dim 0 over a model
axis (``use_tp``; the op reads ``tp_form()``).

Eager calls run with no ambient mesh and take the single-device path.
"""
from __future__ import annotations

import contextlib
import contextvars

_AMBIENT_MESH = contextvars.ContextVar("mxnet_tpu_torch_ambient_mesh",
                                       default=None)

__all__ = ["ambient_mesh", "active_mesh_axis", "use_mesh", "REPLICA_AXES",
           "Replica", "replica", "replica_of", "use_tp", "tp_form"]

# the axes the batch dimension splits over, major first
REPLICA_AXES = ("data", "fsdp")

_TP_FORM = contextvars.ContextVar("mxnet_tpu_torch_tp_form", default=None)


def ambient_mesh():
    """The mesh the surrounding graph is evaluated over, or None."""
    return _AMBIENT_MESH.get()


def active_mesh_axis(axis_name):
    """The ambient mesh if it carries ``axis_name`` with >1 ranks,
    else None — the single predicate every mesh-aware op's attr
    (seq_axis, expert_axis, ...) gates on."""
    mesh = _AMBIENT_MESH.get()
    if mesh is not None and axis_name in mesh.axis_names and \
            mesh.shape[axis_name] > 1:
        return mesh
    return None


@contextlib.contextmanager
def use_mesh(mesh):
    tok = _AMBIENT_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT_MESH.reset(tok)


class Replica:
    """The active replica axes of a mesh: ``axes`` (those of
    REPLICA_AXES with more than one rank, major first), ``n`` (their rank
    count) and ``index`` (this rank's place in the merged batch order)."""

    def __init__(self, mesh, axes):
        self.mesh = mesh
        self.axes = axes
        self.n = 1
        self.index = 0
        for a in axes:
            self.n *= mesh.shape[a]
            self.index = self.index * mesh.shape[a] + mesh.axis_index(a)


def replica_of(mesh):
    """``Replica`` of ``mesh``'s active replica axes, or None when the
    batch is not split (no mesh, or no replica axis with >1 ranks)."""
    if mesh is None:
        return None
    axes = tuple(a for a in REPLICA_AXES
                 if a in mesh.axis_names and mesh.shape[a] > 1)
    return Replica(mesh, axes) if axes else None


def replica():
    """``replica_of`` the ambient mesh: the one helper every batch-global
    route reads."""
    return replica_of(_AMBIENT_MESH.get())


@contextlib.contextmanager
def use_tp(form):
    """Announce a FullyConnected's column-parallel form to the op:
    ``(mesh, axis, bias_split)``: its weight (and, when ``bias_split``,
    its bias) is this rank's dim-0 slice over ``axis``."""
    tok = _TP_FORM.set(form)
    try:
        yield form
    finally:
        _TP_FORM.reset(tok)


def tp_form():
    """The column-parallel form the executor announced, or None."""
    return _TP_FORM.get()
