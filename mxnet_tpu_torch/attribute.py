"""Attribute scoping for symbols.

Reference: python/mxnet/attribute.py — `AttrScope` attaches attributes (most
importantly ``ctx_group`` / ``__ctx_group__`` for model parallelism, SURVEY.md
§2.3) to every symbol created inside the scope. A copy of
``mxnet_tpu/attribute.py``; the attributes ride the symbol JSON unchanged.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]

_local = threading.local()


def current():
    cur = getattr(_local, "scope", None)
    if cur is None:
        cur = AttrScope()
        _local.scope = cur
    return cur


class AttrScope:
    """Attribute manager for scoping; user-facing as `with mx.AttrScope(...)`."""

    def __init__(self, **kwargs):
        self._old = None
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("Attributes need to be string")
        self._attr = {("__%s__" % k if not k.startswith("__") else k): v
                      for k, v in kwargs.items()}

    def get(self, attr):
        """Merge user attrs with the scope attrs."""
        ret = self._attr.copy()
        if attr:
            ret.update(attr)
        return ret

    def __enter__(self):
        self._old = getattr(_local, "scope", None)
        merged = AttrScope()
        merged._attr = dict(getattr(self._old, "_attr", {}) or {})
        merged._attr.update(self._attr)
        _local.scope = merged
        return self

    def __exit__(self, *args):
        _local.scope = self._old
