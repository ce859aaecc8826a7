"""Automatic naming of symbols.

Reference: python/mxnet/name.py — NameManager assigns `hint0`, `hint1`, ...
to anonymous symbols; Prefix prepends a scope prefix (a Gluon Block's
name scope). Used as a `with` scope.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]

_local = threading.local()


def current():
    cur = getattr(_local, "manager", None)
    if cur is None:
        cur = NameManager()
        _local.manager = cur
    return cur


class NameManager:
    """Assigns unique names to operators created without an explicit name."""

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name is not None:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old = getattr(_local, "manager", None)
        _local.manager = self
        return self

    def __exit__(self, *args):
        _local.manager = self._old


class Prefix(NameManager):
    """NameManager that prepends a prefix to every name."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name
