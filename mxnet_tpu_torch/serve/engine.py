"""In-process inference serving engine — dynamic batching over the
deploy artifacts. A near-copy of ``mxnet_tpu/serve/engine.py`` (which
imports no jax): the same queue, bucketing, deadlines, drain and
telemetry.

* **Bounded request queue** — admission beyond ``MXNET_SERVE_QUEUE_CAP``
  fails fast with the typed :class:`Overloaded` (load shedding; never a
  silent drop, never an unbounded queue).
* **Batcher thread** — coalesces queued requests for up to
  ``MXNET_SERVE_MAX_WAIT_MS``, pads the group to the smallest
  configured bucket (``MXNET_SERVE_BUCKETS``), runs ONE forward, and
  slices the outputs back per request.
* **Per-request deadlines** — a request still queued past its deadline
  fails with the typed :class:`RequestTimeout` instead of occupying a
  batch slot.
* **Graceful drain** — ``close()`` (and SIGTERM, through
  ``guardrail.GracefulShutdown``'s chaining handler) finishes every
  admitted request and rejects new ones with :class:`EngineClosed`.
* **Telemetry** — ``serve.queue_depth`` gauge; ``serve.batch_fill`` /
  ``serve.queue_wait_ms`` / ``serve.request_ms`` histograms;
  ``serve.admitted`` / ``serve.shed`` / ``serve.timeouts`` counters, and
  the ``serve.batch`` / ``serve.shed`` / ``serve.timeout`` /
  ``serve.drain`` journal events.

The model is anything with ``forward(*arrays) -> [outputs]``: an
in-process :class:`~mxnet_tpu_torch.predictor.Predictor`, or any user
callable wrapper. Outputs must be row-aligned with inputs (axis 0 is the
batch). Outputs come back to the host as numpy arrays; a bfloat16 output
becomes float32 there, because numpy has no bfloat16. The AOT deploy
chain (``from_export``) waits for the port's export path (ROADMAP Queue
A item 8).
"""
from __future__ import annotations

import logging
import signal
import threading
from collections import deque

import numpy as np
import torch

from .. import config as _config
from .. import telemetry as _telemetry
from .. import trace as _trace

__all__ = ["ServeEngine", "ServeFuture", "ServeError", "Overloaded",
           "RequestTimeout", "EngineClosed", "SessionEvacuated",
           "typed_error"]


class ServeError(RuntimeError):
    """Base of the typed serving errors — the wire protocol
    (serve/net.py) round-trips the concrete class by name, so a remote
    client raises exactly what the engine raised."""


class Overloaded(ServeError):
    """The request was shed at admission: the bounded queue is full (or
    the engine is past its deadline budget). Fast-fail backpressure —
    the client learns immediately and can retry elsewhere; nothing is
    ever silently dropped."""


class RequestTimeout(ServeError):
    """The request's deadline expired while it was still queued; it
    never reached a batch. The deadline is the caller's, so the caller
    gets a typed error rather than a stale answer."""


class EngineClosed(ServeError):
    """The engine is draining (close() or SIGTERM): admitted requests
    finish, new ones are rejected with this."""


class SessionEvacuated(ServeError):
    """An in-flight decode session was exported off its replica
    (migrating recycle or SIGTERM — ``ContinuousDecoder.evacuate``):
    ``.state`` carries the portable session dict from
    ``export_session`` instead of a finished row. This never crosses
    the wire as a typed error — the generate handler catches it and
    answers an ``evacuated`` reply, which the fleet router resumes on
    a survivor token-exactly (docs/robustness.md, fleet failure
    semantics)."""

    def __init__(self, state):
        super().__init__(
            "session evacuated after %d emitted token(s) — resume it "
            "on a survivor" % len(state.get("emitted") or ()))
        self.state = state


_TYPED = {c.__name__: c for c in (Overloaded, RequestTimeout,
                                  EngineClosed, ServeError)}


def typed_error(kind, msg):
    """Reconstruct a typed serving error from its class name (the wire
    representation serve/net.py ships)."""
    return _TYPED.get(kind, ServeError)(msg)


class ServeFuture:
    """One request's pending response: exactly one of a payload (list
    of per-request output arrays) or a typed error, set by the batcher
    thread."""

    __slots__ = ("inputs", "rows", "t_enq", "deadline", "tc", "_ev",
                 "_value", "_exc")

    def __init__(self, inputs, rows, t_enq, deadline, tc=None):
        self.inputs = inputs
        self.rows = rows
        self.t_enq = t_enq
        self.deadline = deadline           # now_ms scale; None = none
        self.tc = tc                       # TraceContext of the caller
        self._ev = threading.Event()
        self._value = None
        self._exc = None

    def _finish(self, value):
        self._value = value
        self._ev.set()

    def _fail(self, exc):
        self._exc = exc
        self._ev.set()

    def done(self):
        return self._ev.is_set()

    def result(self, timeout=None):
        """Block for the response. Raises the engine's typed error if
        the request failed, or RequestTimeout if ``timeout`` seconds
        pass locally."""
        if not self._ev.wait(timeout):
            raise RequestTimeout(
                "no response within %.3fs (request still in flight)"
                % timeout)
        if self._exc is not None:
            raise self._exc
        return self._value


def _parse_buckets(raw):
    try:
        buckets = sorted({int(b) for b in
                          str(raw).replace(",", " ").split()})
    except ValueError:
        raise ValueError("bad bucket list %r (want comma-separated "
                         "ints, e.g. '1,2,4,8')" % (raw,))
    if not buckets or buckets[0] < 1:
        raise ValueError("buckets must be positive ints, got %r"
                         % (raw,))
    return tuple(buckets)


class ServeEngine:
    """Dynamic-batching inference engine over a forward-capable model.

    Parameters
    ----------
    model : forward-capable or dict {bucket: forward-capable}
        Called as ``model.forward(*arrays)`` with every array padded to
        the chosen bucket's batch; must return a list of row-aligned
        outputs. A dict routes each bucket to its own (typically AOT
        compiled) model — the :meth:`from_export` deploy chain.
    buckets : iterable of int, optional
        Padded batch sizes, ascending. Defaults to the dict's keys, or
        ``MXNET_SERVE_BUCKETS``.
    max_wait_ms / queue_cap / deadline_ms : optional
        Override ``MXNET_SERVE_MAX_WAIT_MS`` / ``MXNET_SERVE_QUEUE_CAP``
        / ``MXNET_SERVE_DEADLINE_MS``.
    feature_shapes : list of tuple, optional
        Per-input feature shape WITHOUT the batch axis, for
        :meth:`warmup` and submit-time validation. Learned from the
        first request when omitted.
    dtype : str
        Input dtype for warmup zeros (default float32).
    install_sigterm : bool
        Install the chaining ``guardrail.GracefulShutdown`` handler so
        SIGTERM drains the engine (default True; degrades to a no-op
        off the main thread).
    """

    # the hello frame's identity: a batch-inference replica (the fleet
    # router's role-aware dispatch keys off declared roles — "prefill"
    # and "decode" replicas split the generation phases; everything
    # else, this engine included, serves the colocated paths)
    role = "batch"

    # generation stamp of the served artifact: set by from_export from
    # the export_buckets manifest, None for in-process models. Rides
    # the hello frame so a fleet controller (and `describe()`) can tell
    # a half-promoted fleet from a uniform one.
    model_id = None

    def __init__(self, model, buckets=None, max_wait_ms=None,
                 queue_cap=None, deadline_ms=None, feature_shapes=None,
                 dtype="float32", install_sigterm=True, logger=None):
        self._log = logger or logging.getLogger(__name__)
        if isinstance(model, dict):
            if not model:
                raise ValueError("empty model dict")
            self._by_bucket = {int(k): v for k, v in model.items()}
            derived = tuple(sorted(self._by_bucket))
            if buckets is not None and \
                    tuple(sorted(int(b) for b in buckets)) != derived:
                raise ValueError(
                    "buckets %r disagree with the model dict keys %r"
                    % (tuple(buckets), derived))
            self._buckets = derived
            self._model = None
        else:
            self._by_bucket = None
            self._model = model
            self._buckets = (
                tuple(sorted(int(b) for b in buckets)) if buckets
                else _parse_buckets(_config.get("MXNET_SERVE_BUCKETS")))
        if self._buckets[0] < 1:
            raise ValueError("buckets must be >= 1")
        self._max_bucket = self._buckets[-1]
        self._max_wait_ms = float(
            max_wait_ms if max_wait_ms is not None
            else _config.get("MXNET_SERVE_MAX_WAIT_MS"))
        self._cap = int(queue_cap if queue_cap is not None
                        else _config.get("MXNET_SERVE_QUEUE_CAP"))
        self._default_deadline = float(
            deadline_ms if deadline_ms is not None
            else _config.get("MXNET_SERVE_DEADLINE_MS"))
        self._feature_shapes = ([tuple(s) for s in feature_shapes]
                                if feature_shapes else None)
        self._dtype = np.dtype(dtype)

        self._queue = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._draining = False            # flipped by close()/SIGTERM
        self._closed = False
        # per-engine counts for callers/tests (the registry aggregates
        # across engines; these don't)
        self._admitted = 0
        self._shed = 0
        self._timeouts = 0
        self._forwards = 0
        self._completed = 0
        self._failed = 0
        self._fill_sum = 0
        self._warmed = []                 # buckets pre-compiled by warmup()

        # telemetry handles hoisted once (name-is-identity registry)
        self._g_depth = _telemetry.gauge("serve.queue_depth")
        self._h_fill = _telemetry.histogram(
            "serve.batch_fill", buckets=_telemetry.COUNT_BUCKETS)
        self._h_qwait = _telemetry.histogram("serve.queue_wait_ms")
        self._h_req = _telemetry.histogram("serve.request_ms")
        self._c_admitted = _telemetry.counter("serve.admitted")
        self._c_shed = _telemetry.counter("serve.shed")
        self._c_timeouts = _telemetry.counter("serve.timeouts")

        self._shutdown = None
        if install_sigterm:
            from .. import guardrail as _guardrail
            self._shutdown = _guardrail.GracefulShutdown(
                signals=(signal.SIGTERM,), logger=self._log,
                on_request=self._request_drain,
                action="serving engine draining (in-flight requests "
                       "finish, new ones are rejected)").install()

        _telemetry.journal_event(
            "serve.start", buckets=list(self._buckets),
            queue_cap=self._cap, max_wait_ms=self._max_wait_ms)
        self._thread = threading.Thread(
            target=self._batcher_loop, name="mxnet-serve-batcher",
            daemon=True)
        self._thread.start()

    # -- admission ----------------------------------------------------------
    def submit(self, *inputs, deadline_ms=None, tc=None, session=None):
        """Enqueue one request; returns a :class:`ServeFuture`.

        ``inputs``: one array per model input, each with a leading
        batch axis (a single sample is shape ``(1, ...)``); a request
        may carry several rows, up to the largest bucket. Raises
        :class:`Overloaded` when the queue is full and
        :class:`EngineClosed` while draining — both BEFORE any work is
        queued, so backpressure is immediate.

        ``tc``: an explicit :class:`~mxnet_tpu.trace.TraceContext` the
        batcher's lifecycle spans should parent to (the TCP front end
        hands in the remote caller's); defaults to the submitting
        thread's current span.

        ``session``: accepted and ignored — session ids are a ROUTING
        concern (the fleet router pins a session to the replica
        holding its decode state, serve/router.py); a single engine
        has nothing to route, but must accept fleet traffic
        unchanged."""
        del session                       # routing concern, see above
        arrays = [np.asarray(a) for a in inputs]
        if not arrays:
            raise ValueError("submit needs at least one input array")
        rows = int(arrays[0].shape[0]) if arrays[0].ndim else 0
        if rows < 1:
            raise ValueError(
                "inputs need a leading batch axis (a single sample is "
                "shape (1, ...)), got %r" % (arrays[0].shape,))
        if rows > self._max_bucket:
            raise ValueError(
                "request rows (%d) exceed the largest bucket (%d); "
                "split the request or configure a larger bucket"
                % (rows, self._max_bucket))
        if any(int(a.shape[0]) != rows for a in arrays):
            raise ValueError(
                "rows must agree across inputs, got %r"
                % ([a.shape for a in arrays],))
        feats = [a.shape[1:] for a in arrays]
        if self._feature_shapes is None:
            self._feature_shapes = feats
        elif feats != self._feature_shapes:
            raise ValueError(
                "inputs %r do not match the engine's feature shapes "
                "%r" % ([a.shape for a in arrays],
                        self._feature_shapes))
        t_enq = _telemetry.now_ms()
        if deadline_ms is None:
            deadline_ms = self._default_deadline
        deadline = t_enq + float(deadline_ms) if deadline_ms else None
        if tc is None:
            tc = _trace.current_context()
        req = ServeFuture(arrays, rows, t_enq, deadline, tc=tc)
        with self._cond:
            if self._draining or self._closed:
                raise EngineClosed(
                    "serving engine is draining — request rejected")
            if len(self._queue) >= self._cap:
                self._shed += 1
                self._c_shed.inc()
                _telemetry.journal_event("serve.shed",
                                         depth=len(self._queue))
                raise Overloaded(
                    "serving queue full (%d requests) — shed"
                    % len(self._queue))
            self._queue.append(req)
            self._admitted += 1
            self._c_admitted.inc()
            self._g_depth.set(len(self._queue))
            self._cond.notify_all()
        return req

    def infer(self, *inputs, deadline_ms=None, timeout=None):
        """submit + result in one blocking call."""
        return self.submit(*inputs,
                           deadline_ms=deadline_ms).result(timeout)

    # -- batcher ------------------------------------------------------------
    def _rows_queued(self):
        return sum(r.rows for r in self._queue)

    def _pop_group(self):
        """(live FIFO group that fits the largest bucket, expired
        requests). Deadline-expired requests pop out of the way here so
        they never consume group row budget — a live request that fits
        is never displaced by a doomed one."""
        group, expired = [], []
        rows = 0
        now = _telemetry.now_ms()
        while self._queue:
            nxt = self._queue[0]
            if nxt.deadline is not None and now > nxt.deadline:
                expired.append(self._queue.popleft())
                continue
            if group and rows + nxt.rows > self._max_bucket:
                break
            group.append(self._queue.popleft())
            rows += nxt.rows
        return group, expired

    def _batcher_loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._draining:
                    # bounded waits: the SIGTERM handler only sets the
                    # drain flag (it must not touch this lock), so the
                    # loop has to notice it by polling
                    self._cond.wait(0.05)
                if not self._queue:
                    break                    # draining and drained
                first_t = self._queue[0].t_enq
                while (self._rows_queued() < self._max_bucket
                       and not self._draining):
                    remain = self._max_wait_ms - \
                        (_telemetry.now_ms() - first_t)
                    if remain <= 0:
                        break
                    self._cond.wait(min(remain / 1000.0, 0.05))
                group, expired = self._pop_group()
                self._g_depth.set(len(self._queue))
            for r in expired:
                self._fail_timeout(r)
            if group:
                self._run_group(group)
        _telemetry.journal_event("serve.stop")

    def _bucket_for(self, rows):
        for b in self._buckets:
            if b >= rows:
                return b
        return self._max_bucket            # unreachable: submit caps

    def _forward(self, bucket, feed):
        model = self._by_bucket[bucket] if self._by_bucket is not None \
            else self._model
        return model.forward(*feed)

    @staticmethod
    def _to_np(out):
        # bf16 has no numpy dtype: it reaches the host as float32
        if isinstance(out, torch.Tensor):
            out = out.detach()
            if out.dtype == torch.bfloat16:
                out = out.float()
            return out.cpu().numpy()
        return out.asnumpy() if hasattr(out, "asnumpy") \
            else np.asarray(out)

    def _fail_timeout(self, r):
        now = _telemetry.now_ms()
        self._timeouts += 1
        self._c_timeouts.inc()
        _telemetry.journal_event("serve.timeout",
                                 wait_ms=round(now - r.t_enq, 3))
        _trace.add_span("serve.queue", r.t_enq, now, parent=r.tc,
                        timeout=True)
        r._fail(RequestTimeout(
            "deadline exceeded after %.1f ms in queue"
            % (now - r.t_enq)))

    def _run_group(self, group):
        now = _telemetry.now_ms()
        live = []
        for r in group:
            # re-checked here: a deadline can lapse between the pop
            # and this dispatch
            if r.deadline is not None and now > r.deadline:
                self._fail_timeout(r)
            else:
                self._h_qwait.observe(now - r.t_enq)
                live.append(r)
        if not live:
            return
        rows = sum(r.rows for r in live)
        bucket = self._bucket_for(rows)
        t0 = _telemetry.now_ms()
        try:
            feed = [np.concatenate([r.inputs[i] for r in live], axis=0)
                    for i in range(len(live[0].inputs))]
            if rows < bucket:
                feed = [np.concatenate(
                    [a, np.zeros((bucket - rows,) + a.shape[1:],
                                 a.dtype)], axis=0) for a in feed]
            t_fwd = _telemetry.now_ms()   # pad/concat vs forward split
            outs = [self._to_np(o)
                    for o in self._forward(bucket, feed)]
        except Exception as exc:           # noqa: BLE001 — every
            # request gets exactly one response; an engine-side error
            # IS that response, typed as itself
            self._failed += len(live)
            for r in live:
                r._fail(exc)
            _telemetry.journal_event("serve.error",
                                     error=type(exc).__name__)
            self._log.exception("serve: batch forward failed "
                                "(%d requests)", len(live))
            return
        fwd_ms = _telemetry.now_ms() - t0
        self._forwards += 1
        self._fill_sum += rows
        self._h_fill.observe(rows)
        end = _telemetry.now_ms()
        t_done = t0 + fwd_ms
        off = 0
        for r in live:
            r._finish([o[off:off + r.rows] for o in outs])
            self._h_req.observe(end - r.t_enq)
            off += r.rows
        self._completed += len(live)
        if _trace.enabled():
            # request lifecycle, reconstructed from the timestamps
            # already taken and parented to each request's own caller
            # span (across threads — the report draws the arrows):
            # queue -> batch(pad) -> forward -> respond. respond ends
            # AFTER the finish loop — it covers the output slicing and
            # the future wakeups, not just bookkeeping.
            t_resp = _telemetry.now_ms()
            for r in live:
                _trace.add_span("serve.queue", r.t_enq, now,
                                parent=r.tc)
                _trace.add_span("serve.pad", t0, t_fwd, parent=r.tc,
                                bucket=bucket, fill=rows)
                _trace.add_span("serve.forward", t_fwd, t_done,
                                parent=r.tc, bucket=bucket, fill=rows,
                                requests=len(live))
                _trace.add_span("serve.respond", t_done, t_resp,
                                parent=r.tc)
            # one spill write per batch, not one per record (the
            # batcher thread has no open span to trigger a flush)
            _trace.flush()
        _telemetry.journal_event(
            "serve.batch", bucket=bucket, fill=rows,
            requests=len(live), forward_ms=round(fwd_ms, 3),
            wait_ms=round(t0 - min(r.t_enq for r in live), 3))

    # -- lifecycle ----------------------------------------------------------
    def warmup(self):
        """Run one zero batch through every bucket so each bucket's
        first-forward costs (kernel builds, allocator growth) are paid
        BEFORE traffic arrives (needs ``feature_shapes``, given or
        learned)."""
        if self._feature_shapes is None:
            raise ValueError(
                "warmup needs feature_shapes (pass them to the engine "
                "or serve one request first)")
        for b in self._buckets:
            feed = [np.zeros((b,) + s, self._dtype)
                    for s in self._feature_shapes]
            self._forward(b, feed)
            if b not in self._warmed:
                self._warmed.append(b)
        _telemetry.journal_event("serve.warmup",
                                 buckets=list(self._buckets))
        # device-memory watermark after every bucket ran once — the
        # serving steady-state footprint (boundary-only sample)
        from .. import profiler as _profiler
        _profiler.sample_device_memory("serve.warmup")

    def _request_drain(self):
        # called from the signal handler: set-a-flag only (the batcher
        # polls with bounded waits; no lock may be touched here)
        self._draining = True

    @property
    def draining(self):
        return self._draining or self._closed

    def close(self, timeout=30.0):
        """Graceful drain: admitted requests finish, new submissions
        raise EngineClosed, then the batcher thread exits."""
        with self._cond:
            already = self._closed
            self._draining = True
            pending = len(self._queue)
            self._cond.notify_all()
        if not already:
            _telemetry.journal_event("serve.drain", pending=pending)
        self._thread.join(timeout)
        if self._shutdown is not None:
            self._shutdown.uninstall()
            self._shutdown = None
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def in_flight(self):
        """Admitted requests not yet resolved (queued or mid-batch) —
        the figure a drain-aware router watches reach zero before it
        recycles this replica (serve/router.py)."""
        return (self._admitted - self._completed - self._timeouts
                - self._failed)

    def stats(self):
        """This engine's own counters (the registry aggregates across
        engines; these don't)."""
        return {"admitted": self._admitted, "shed": self._shed,
                "timeouts": self._timeouts, "forwards": self._forwards,
                "completed": self._completed,
                "mean_fill": (self._fill_sum / self._forwards
                              if self._forwards else None),
                "queued": len(self._queue)}

    @property
    def warmed_buckets(self):
        """Buckets that warmup() has run."""
        return list(self._warmed)

    def introspect(self):
        """Live engine state for the ``stats`` introspection frame
        (serve/net.py): queue depth, drain state, bucket config and
        which buckets are warmed, on top of :meth:`stats`."""
        out = self.stats()
        out["queue_depth"] = out.pop("queued")
        out["in_flight"] = self.in_flight
        out["draining"] = self.draining
        out["buckets"] = list(self._buckets)
        out["warmed"] = self.warmed_buckets
        out["model_id"] = self.model_id
        return out

    # -- AOT deploy chain ---------------------------------------------------
    @classmethod
    def from_export(cls, prefix, **kwargs):
        """Serve a bucketed AOT export; the port has no export path yet."""
        raise NotImplementedError(
            "ServeEngine.from_export needs Predictor.export_buckets, not "
            "ported yet (ROADMAP Queue A item 8)")
