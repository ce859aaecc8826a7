"""Deterministic fault injection for the fit loop — the part of
``mxnet_tpu/parallel/resilience.py`` that ``TrainStep.fit`` needs.

:class:`FaultInjector` parses the ``MXNET_FAULT_SPEC`` grammar, the
whole of it (a spec written for the JAX package parses the same here),
and serves its step-indexed rules: ``nan@N`` poisons the N-th training
step's gradients and ``sigterm@N`` raises a real SIGTERM at the N-th
step boundary (``guardrail.FitGuard.poll_faults``). The wire points'
hooks (the parameter server's and the serving front end's socket
plumbing), ``RetryPolicy`` and ``DeadWorkerError`` come with the
distributed KVStore (ROADMAP Queue A item 9).
"""
from __future__ import annotations

import os
import re
import threading

__all__ = ["FaultInjector", "active_injector", "install_fault_injector"]

_RULE_RE = re.compile(
    r"^(?P<point>\w+):(?P<action>drop|disconnect|delay)"
    r"@(?P<nth>\d+)(?:x(?P<count>\d+|\*))?(?::(?P<arg>[0-9.]+))?$")

# step-indexed rules: the "call" counted is one training step of a fit
# loop, and the point name IS the action. The `kill<I>` family counts
# completed fleet requests (the chaos harness's schedule).
_STEP_RULE_RE = re.compile(
    r"^(?P<point>nan|sigterm|kill\d*)@(?P<nth>\d+)(?:x(?P<count>\d+|\*))?$")

# every wire point name the documented hooks can fire: a typo'd point
# would never fire and the fault test it belongs to would pass vacuously
_WIRE_POINTS = frozenset((
    "send", "recv", "ping", "srv_send", "srv_recv",
    "serve_send", "serve_recv", "serve_srv_send", "serve_srv_recv",
    "prefill_send", "prefill_recv",
))
_WIRE_POINT_PATTERNS = (
    re.compile(r"^router\d+_(?:ctl_)?(?:send|recv)$"),
)


def _check_wire_point(point, raw):
    if point in _WIRE_POINTS or \
            any(p.match(point) for p in _WIRE_POINT_PATTERNS):
        return
    raise ValueError(
        "MXNET_FAULT_SPEC rule %r names unknown injection point %r — "
        "documented wire points are %s, plus the per-replica router "
        "family router<I>_send / router<I>_recv / router<I>_ctl_send / "
        "router<I>_ctl_recv; step-indexed rules are nan@N / sigterm@N "
        "/ kill<I>@N. A mistyped point never fires, so the fault test it "
        "belongs to passes vacuously."
        % (raw, point, ", ".join(sorted(_WIRE_POINTS))))


class _Rule:
    __slots__ = ("point", "action", "nth", "count", "arg")

    def __init__(self, point, action, nth, count, arg):
        self.point = point
        self.action = action
        self.nth = nth          # first matching call (1-based)
        self.count = count      # how many consecutive calls (None = ∞)
        self.arg = arg          # delay seconds

    def matches(self, n):
        if n < self.nth:
            return False
        if self.count is None:
            return True
        return n < self.nth + self.count


class FaultInjector:
    """Deterministic fault injection.

    Spec grammar (``MXNET_FAULT_SPEC``, rules joined by ``;``)::

        point:action@nth[xcount][:arg]      (wire rules)
        nan@nth[xcount] | sigterm@nth[xcount] | kill<I>@nth[xcount]

    ``@nth`` fires on the nth call of that point (1-based), counted per
    point from installation; ``xcount`` fires for that many consecutive
    calls (``x*``: every call from nth on). ``nan@5`` poisons the 5th
    training step's gradients; ``sigterm@3`` raises a real SIGTERM at
    the 3rd step boundary. Counting is process-wide per point, under a
    lock. ``fired`` records every injection as ``(point, n, action)``."""

    def __init__(self, spec):
        self.spec = spec or ""
        self._rules = []

        def add_rule(m, action, arg):
            count = m.group("count")
            self._rules.append(_Rule(
                m.group("point"), action, int(m.group("nth")),
                None if count == "*" else int(count or 1), arg))

        for raw in filter(None,
                          (s.strip() for s in self.spec.split(";"))):
            m = _RULE_RE.match(raw)
            if m is not None:
                _check_wire_point(m.group("point"), raw)
                add_rule(m, m.group("action"),
                         float(m.group("arg") or 0.0))
                continue
            m = _STEP_RULE_RE.match(raw)
            if m is None:
                raise ValueError(
                    "bad MXNET_FAULT_SPEC rule %r (want "
                    "point:action@nth[xcount][:seconds] or "
                    "nan@nth[xcount] / sigterm@nth[xcount] / "
                    "kill<I>@nth[xcount])" % raw)
            add_rule(m, m.group("point"), 0.0)
        self._counts = {}
        self._lock = threading.Lock()
        self.fired = []

    def _step(self, point):
        """Advance the point's call counter; return the rule to apply
        (or None)."""
        with self._lock:
            n = self._counts.get(point, 0) + 1
            self._counts[point] = n
            for rule in self._rules:
                if rule.point == point and rule.matches(n):
                    self.fired.append((point, n, rule.action))
                    return rule
        return None

    def on_train_step(self, point):
        """Step-indexed guardrail points (``nan`` / ``sigterm``):
        advance the per-point counter by one training step; True when a
        rule fires this step. The caller performs the fault."""
        return self._step(point) is not None

    def on_chaos_tick(self, point):
        """Chaos-schedule points (the ``kill<I>`` family): advance the
        named point's counter by one completed fleet request; True when
        a rule fires this tick."""
        return self._step(point) is not None


_installed = None          # explicitly installed injector (tests)
_env_injector = None       # injector built from MXNET_FAULT_SPEC
_env_spec = None           # the spec string _env_injector was built from
_env_lock = threading.Lock()


def install_fault_injector(injector):
    """Install (or, with None, remove) the process-wide injector.
    Explicit installation overrides ``MXNET_FAULT_SPEC``."""
    global _installed
    _installed = injector
    return injector


def active_injector():
    """The injector in effect: the explicitly installed one, else one
    lazily built from ``MXNET_FAULT_SPEC`` (rebuilt if the env value
    changes), else None."""
    global _env_injector, _env_spec
    if _installed is not None:
        return _installed
    spec = os.environ.get("MXNET_FAULT_SPEC") or None
    if spec != _env_spec:
        with _env_lock:
            if spec != _env_spec:
                _env_injector = FaultInjector(spec) if spec else None
                _env_spec = spec
    return _env_injector
