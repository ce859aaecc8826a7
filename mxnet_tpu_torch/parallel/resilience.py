"""Fault tolerance: retry policy and deterministic fault injection — the
PyTorch twin of ``mxnet_tpu/parallel/resilience.py`` (which imports no
jax; this is its copy).

* :class:`RetryPolicy` — exponential backoff with deterministic jitter,
  per-op deadlines, and transient-vs-fatal error classification
  (transport faults retry; replies the server sent are fatal).
* :class:`FaultInjector` parses the ``MXNET_FAULT_SPEC`` grammar and
  serves its rules: the wire points (``on_send`` / ``on_recv``, called
  by the serving front end's framing, ``serve/_wire.py``), the
  step-indexed rules (``nan@N`` poisons the N-th training step's
  gradients and ``sigterm@N`` raises a real SIGTERM at the N-th step
  boundary, ``guardrail.FitGuard.poll_faults``) and the chaos schedule's
  ``kill<I>@N`` (``on_chaos_tick``).
* :class:`DeadWorkerError` — a cohort member was declared dead (the
  distributed KVStore's barrier, ROADMAP Queue A item 9, raises it;
  ``RetryPolicy`` classifies it fatal).
"""
from __future__ import annotations

import errno
import os
import re
import socket
import threading
import time
import zlib

__all__ = ["DeadWorkerError", "FaultInjected", "FaultInjector",
           "RetryPolicy", "active_injector", "install_fault_injector"]

class DeadWorkerError(RuntimeError):
    """A worker in the cohort was declared dead (heartbeat lapse).

    Raised server-side to every barrier waiter — the cohort can never
    complete, so surviving workers fail loudly instead of hanging.
    Under ``MXNET_PS_ELASTIC=1`` the server shrinks the cohort instead
    and this error is not raised."""


class FaultInjected(ConnectionError):
    """The error a :class:`FaultInjector` rule raises — a subclass of
    ConnectionError so retry classification treats it exactly like the
    real transport fault it simulates."""


# errno values that indicate a transport-level (retryable) failure
_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name) for name in
    ("ECONNREFUSED", "ECONNRESET", "ECONNABORTED", "EPIPE", "ETIMEDOUT",
     "EHOSTUNREACH", "ENETUNREACH", "ENETRESET", "EAGAIN")
    if hasattr(errno, name))


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return float(default)


class RetryPolicy:
    """Exponential backoff with deterministic jitter and a per-op
    deadline.

    delay(attempt) = min(base * multiplier^(attempt-1), max_delay)
                     * (0.5 + 0.5 * jitter_frac(seed, attempt))

    The jitter fraction is a crc32 of ``(seed, attempt)`` — spread
    across workers (each seeds with its worker id) yet bit-reproducible
    run to run, so a fault-injection test replays the exact schedule.

    Env defaults: ``MXNET_PS_RETRY_MAX`` (8 retries),
    ``MXNET_PS_RETRY_BASE`` (0.05s), ``MXNET_PS_RETRY_MAX_DELAY`` (2s),
    ``MXNET_PS_OP_DEADLINE`` (120s; 0 = unlimited) — the total budget
    for one op *including* its retries and backoff sleeps."""

    def __init__(self, max_retries=None, base_delay=None, max_delay=None,
                 multiplier=2.0, deadline=None, seed=0):
        self.max_retries = int(max_retries if max_retries is not None
                               else _env_float("MXNET_PS_RETRY_MAX", 8))
        self.base_delay = float(base_delay if base_delay is not None
                                else _env_float("MXNET_PS_RETRY_BASE",
                                                0.05))
        self.max_delay = float(max_delay if max_delay is not None
                               else _env_float("MXNET_PS_RETRY_MAX_DELAY",
                                               2.0))
        self.multiplier = float(multiplier)
        self.deadline = float(deadline if deadline is not None
                              else _env_float("MXNET_PS_OP_DEADLINE",
                                              120.0))
        self.seed = seed

    # -- classification -----------------------------------------------------
    @staticmethod
    def is_transient(exc):
        """True when retrying can plausibly succeed: the TRANSPORT
        failed. False when the server answered (application error) or
        the cohort is dead — a retry would re-fail identically or,
        worse, re-apply a non-idempotent op."""
        if isinstance(exc, DeadWorkerError):
            return False
        if isinstance(exc, (ConnectionError, BrokenPipeError,
                            socket.timeout, TimeoutError, EOFError)):
            return True
        if isinstance(exc, OSError):
            return exc.errno in _TRANSIENT_ERRNOS
        return False

    # -- schedule -----------------------------------------------------------
    def delay(self, attempt):
        """Backoff before retry #attempt (1-based). Deterministic."""
        d = self.base_delay * (self.multiplier ** (max(1, attempt) - 1))
        d = min(d, self.max_delay)
        frac = (zlib.crc32(("%s:%d" % (self.seed, attempt))
                           .encode("utf-8")) % 1024) / 1024.0
        return d * (0.5 + 0.5 * frac)

    def run(self, fn, describe="op", on_retry=None, on_fatal=None):
        """Call ``fn()`` until it succeeds, a fatal error occurs, the
        retry count is exhausted, or the deadline would be overrun by
        the next backoff sleep. ``on_retry(exc, attempt, delay)`` fires
        before each sleep (the client uses it to drop the broken
        connection and to log).

        ``on_fatal(exc)`` is the per-call reroute hook: consulted for
        errors :meth:`is_transient` classifies FATAL, and only for
        those — and only when a retry is actually available (budget
        and deadline permitting), so the hook's bookkeeping never
        records a retry that cannot happen. Returning True retries
        anyway (same budget, same backoff schedule); False/None
        preserves the fast-fail raise. The fatal classification
        itself never changes — the hook exists for callers whose
        ``fn`` re-targets each attempt, e.g. the serve router
        retrying an ``Overloaded`` on the next-least-loaded replica
        (a single-replica client keeps its fast-fail contract by
        simply not passing one: retrying an Overloaded against the
        same full queue is a retry storm)."""
        start = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as exc:  # noqa: BLE001 — classified below
                fatal = not self.is_transient(exc)
                if fatal and on_fatal is None:
                    raise
                if attempt + 1 > self.max_retries:
                    raise
                d = self.delay(attempt + 1)
                if self.deadline > 0 and \
                        time.monotonic() - start + d > self.deadline:
                    raise
                if fatal and not on_fatal(exc):
                    raise
                attempt += 1
                if on_retry is not None:
                    on_retry(exc, attempt, d)
                # the backoff sleep as a trace span (no-op when tracing
                # is off): in a trace of a retried op the wait between
                # attempts is visible, not an unexplained gap
                from .. import trace as _trace
                bsp = _trace.start_span("retry.backoff", op=describe,
                                        attempt=attempt)
                time.sleep(d)
                _trace.end_span(bsp)


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

    @staticmethod
    def _sever(sock):
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # already dead — severing twice is the point, not a bug
        sock.close()

    # -- hooks (called from serve/_wire.py _send_msg/_recv_msg) ---------
    def on_send(self, point, sock, frame):
        """Before a frame is written. May sleep, or sever the
        connection (optionally after leaking half the frame) and raise
        FaultInjected — the caller must not then write."""
        rule = self._step(point)
        if rule is None:
            return
        if rule.action == "delay":
            time.sleep(rule.arg)
            return
        if rule.action == "disconnect":
            # mid-message disconnect: the peer receives a torn frame
            try:
                sock.sendall(frame[:max(1, len(frame) // 2)])
            except OSError:
                pass  # peer already gone; the sever below still holds
        self._sever(sock)
        raise FaultInjected("injected %s at %s #%d"
                            % (rule.action, point,
                               self._counts.get(point, 0)))

    def on_recv(self, point, sock):
        """Before a frame is read. drop/disconnect sever the socket and
        raise; delay sleeps."""
        rule = self._step(point)
        if rule is None:
            return
        if rule.action == "delay":
            time.sleep(rule.arg)
            return
        self._sever(sock)
        raise FaultInjected("injected %s at %s #%d"
                            % (rule.action, point,
                               self._counts.get(point, 0)))

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
