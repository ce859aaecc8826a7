"""Ambient mesh for mesh-aware operators — a copy of the JAX package's
``ops/_mesh_ctx.py`` (pure Python).

The executor announces the mesh it evaluates a graph over; ops that can
exploit a mesh axis (``_contrib_FlashAttention(seq_axis='sp')`` switching
to ring attention, ``_contrib_MoEFFN(expert_axis=...)`` to the all_to_all
form, and the batch-global reductions over ``data``) read it when they
run. A contextvar — not a threaded argument — so the registry keeps its
pure ``fn(*tensors, **attrs)`` signature and only the ops that care opt
in.

Eager calls run with no ambient mesh and take the single-device path.
"""
from __future__ import annotations

import contextlib
import contextvars

_AMBIENT_MESH = contextvars.ContextVar("mxnet_tpu_torch_ambient_mesh",
                                       default=None)

__all__ = ["ambient_mesh", "active_mesh_axis", "use_mesh"]


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
