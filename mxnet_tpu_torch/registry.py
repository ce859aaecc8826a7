"""Generic class registry with name/alias lookup and JSON round-trip —
the port's copy of ``mxnet_tpu/registry.py`` (it holds no array code).

Provides the register/alias/create factory surface that backs the
Initializer registry now, and the Optimizer and EvalMetric registries in
later slices (capability parity with python/mxnet/registry.py in the
reference — one Registry object per base class rather than closure
triples).
"""
from __future__ import annotations

import json
import warnings

from .base import string_types


class Registry:
    """A case-insensitive name -> class table for one base class."""

    def __init__(self, base_class, nickname):
        self.base_class = base_class
        self.nickname = nickname
        self._table = {}

    def entries(self):
        return dict(self._table)

    def add(self, klass, name=None):
        if not (self.base_class is object or
                issubclass(klass, self.base_class)):
            raise AssertionError(
                "Can only register subclass of %s"
                % self.base_class.__name__)
        key = (name or klass.__name__).lower()
        prev = self._table.get(key)
        if prev is not None and prev is not klass:
            warnings.warn(
                "\033[91mNew %s %s.%s registered with name %s is overriding "
                "existing %s %s.%s\033[0m"
                % (self.nickname, klass.__module__, klass.__name__, key,
                   self.nickname, prev.__module__, prev.__name__),
                UserWarning)
        self._table[key] = klass
        return klass

    def make(self, spec, *args, **kwargs):
        """Instantiate from a name, an instance (passed through), a config
        dict, or a JSON-encoded ["name", {kwargs}] / {kwargs} string."""
        if isinstance(spec, self.base_class):
            if args or kwargs:
                raise AssertionError(
                    "%s is already an instance. Additional arguments are "
                    "invalid" % self.nickname)
            return spec
        if isinstance(spec, dict):
            cfg = dict(spec)
            return self.make(cfg.pop(self.nickname), **cfg)
        if not isinstance(spec, string_types):
            raise AssertionError("%s must be of string type" % self.nickname)
        head = spec[:1]
        if head == "[":
            assert not args and not kwargs
            inner_name, inner_kwargs = json.loads(spec)
            return self.make(inner_name, **inner_kwargs)
        if head == "{":
            assert not args and not kwargs
            cfg = json.loads(spec)
            return self.make(cfg.pop(self.nickname), **cfg)
        klass = self._table.get(spec.lower())
        if klass is None:
            raise AssertionError(
                "%s is not registered. Please register with %s.register "
                "first" % (spec, self.nickname))
        return klass(*args, **kwargs)


_REGISTRIES = {}


def _registry_for(base_class, nickname=None):
    reg = _REGISTRIES.get(base_class)
    if reg is None:
        reg = _REGISTRIES[base_class] = Registry(base_class,
                                                 nickname or "object")
    elif nickname and reg.nickname == "object":
        # a get_registry() peek may have created the entry before the real
        # nickname arrived; adopt it so dict/JSON config keys resolve
        reg.nickname = nickname
    return reg


def get_registry(base_class):
    """name -> class mapping registered under ``base_class``."""
    return _registry_for(base_class).entries()


def get_register_func(base_class, nickname):
    """Build the @register decorator for a base class."""
    reg = _registry_for(base_class, nickname)

    def register(klass, name=None):
        return reg.add(klass, name)

    register.__doc__ = "Register %s to the %s factory" % (nickname, nickname)
    return register


def get_alias_func(base_class, nickname):
    """Build the @alias(*names) decorator."""
    reg = _registry_for(base_class, nickname)

    def alias(*aliases):
        def wrap(klass):
            for name in aliases:
                reg.add(klass, name)
            return klass
        return wrap
    return alias


def get_create_func(base_class, nickname):
    """Build a create(name_or_instance_or_json, **kwargs) factory."""
    reg = _registry_for(base_class, nickname)

    def create(*args, **kwargs):
        if args:
            spec, rest = args[0], args[1:]
        else:
            spec, rest = kwargs.pop(nickname), ()
        return reg.make(spec, *rest, **kwargs)

    create.__doc__ = "Create a %s instance from config" % nickname
    return create
