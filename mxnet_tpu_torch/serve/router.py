"""Fleet router: one serving endpoint over N ServeServer replicas
(docs/serving.md §fleet).

A single :class:`~mxnet_tpu_torch.serve.ServeEngine` is one process — one
batcher, one queue, one chip's worth of decode slots. Millions of
users need N replicas behind one endpoint, which is exactly the
paper's KVStore identity replayed on the inference side: many workers,
one logical service, load balanced and failure-masked. The
:class:`ServeRouter` supplies the missing layer:

* **Least-loaded dispatch** — every request goes to the replica with
  the lowest load score. The score is
  ``router-tracked in-flight + last-polled queue depth``: the
  in-flight count is exact and instantaneous (the router increments it
  at dispatch, decrements at response), the polled queue depth folds
  in load from OTHER frontends sharing the replica. Requests whose row
  count fits a bucket some subset has WARMED prefer that subset — a
  cold replica never costs a live request a first-call compile when a warm
  one is free.
* **Decode session affinity** — a request carrying ``session=`` pins
  to the replica holding that session's KV slot; the first request of
  a session places it on the replica with the most free decode slots
  (falling back to least-loaded when no replica reports
  ``decode_free_slots``). A pinned session never reroutes on
  ``Overloaded`` (its decode state is ON that replica — shedding is a
  backpressure signal to the caller, not a reason to orphan a KV
  slot); a pin to a draining/removed replica is dropped and the
  session re-places like a new one (state loss, the caller re-prefills).
* **Shed-and-retry** — an ``Overloaded`` (or drain-window
  ``EngineClosed``) from one replica retries on the
  next-least-loaded, via :meth:`RetryPolicy.run`'s ``on_fatal``
  reroute hook; ``Overloaded`` reaches the caller only when EVERY
  live replica shed this request. Transport faults mark the replica
  *suspect* (deprioritized, revived by the next successful stats
  poll or dispatch) and reroute — every failure path is
  deterministically injectable because all bytes still move through
  ``serve/net.py``'s FaultInjector'd plumbing, under per-replica
  point families (``router<I>_send``/``router<I>_recv`` data,
  ``router<I>_ctl_*`` control).
* **Zero-drop rolling restarts** — :meth:`recycle` stops routing to
  the replica, waits for its drain (the router's own in-flight
  condition PLUS the stats-observed engine in-flight, so work from
  other frontends counts too), runs the caller's ``restart`` hook
  (typically SIGTERM → the GracefulShutdown drain → fresh
  process), re-warms the declared buckets over the wire, and
  readmits. A client sweep running throughout observes exactly one
  response per request.
* **Replica death survival** (docs/robustness.md, fleet failure
  semantics) — the router is the durable owner of every generate's
  recovery state. When the replica pinned to an in-flight generate
  dies mid-call (transport fault + failed control probe), the
  request REPLAYS on a survivor from its retained recovery record
  (prompt, sampling opts, seed, handoff blob) — token-for-token
  identical, because prefill is pure and per-request PRNG streams
  split once per emitted token; every generate carries an admit id,
  so a replay onto a replica that actually survived rides the
  original admission (decode-side dedup — exactly-once admit). A
  recycle of a decode-role replica EVACUATES instead of draining:
  active sessions export mid-decode (``evacuate`` frame) and resume
  on survivors bit-exactly, so the restart is bounded by
  export+import cost, not the longest sequence in flight.
  ``MXNET_ROUTER_FAILOVER`` / ``MXNET_ROUTER_MIGRATION_LIMIT``
  govern both paths.

The router IS an engine to the front end: ``ServeServer(router)``
serves the same wire (infer/ping/stats/hello/warm frames) — clients
cannot tell a router from a replica. All router transport rides
:class:`~mxnet_tpu_torch.serve.ServeClient`; this module never touches a
socket (lint-enforced, tools/perf_gate.sh).
"""
from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import OrderedDict, deque

import numpy as np

from .. import config as _config
from .. import telemetry as _telemetry
from .. import trace as _trace
from ..generation import kv_blob_nbytes
from ..parallel.resilience import RetryPolicy
from .decode import drain_timeout as _decode_drain_timeout
from .engine import EngineClosed, Overloaded, ServeError
from .net import ServeClient

__all__ = ["ServeRouter", "ReplicaState"]


class ReplicaState:
    """The three dispatchability states of a fleet member."""
    LIVE = "live"            # routable
    SUSPECT = "suspect"      # transport fault seen; last-resort only
    DRAINING = "draining"    # recycling / externally draining; never
    #                          routed, readmitted by recycle()


class _DoneFuture:
    """An already-resolved response with the ServeFuture surface —
    router dispatch is synchronous in the calling thread (concurrency
    comes from concurrent front-end connections, exactly like the
    engine's contract), so the future the front end waits on is
    always complete."""

    __slots__ = ("_value", "_exc")

    def __init__(self, value=None, exc=None):
        self._value = value
        self._exc = exc

    def done(self):
        return True

    def result(self, timeout=None):
        del timeout
        if self._exc is not None:
            raise self._exc
        return self._value


class _Replica:
    """Router-side record of one fleet member: its control client,
    pooled data clients, dispatch accounting, and the last-polled
    load signals."""

    __slots__ = ("name", "host", "port", "index", "state", "control",
                 "idle", "inflight", "dispatched", "rerouted_from",
                 "faults", "stats", "declared", "role", "recycles",
                 "model_id", "window")

    def __init__(self, name, host, port, index):
        self.name = name
        self.host = host
        self.port = int(port)
        self.index = index               # fault-point family id; stable
        self.state = ReplicaState.LIVE
        self.control = None              # ServeClient (stats/warm/hello)
        self.idle = deque()              # pooled data ServeClients
        self.inflight = 0                # router-dispatched, unresolved
        self.dispatched = 0
        self.rerouted_from = 0           # sheds/faults that left here
        self.faults = 0
        self.stats = {}                  # last successful poll extract
        self.declared = {}               # hello() engine state
        self.role = None                 # hello-declared replica role
        self.recycles = 0
        self.model_id = None             # hello-declared artifact stamp
        self.window = {}                 # prev cumulative counters, for
        #                                  the per-poll-window rates

    def describe(self):
        return {"host": self.host, "port": self.port,
                "state": self.state, "role": self.role,
                "model_id": self.model_id,
                "in_flight": self.inflight,
                "dispatched": self.dispatched,
                "rerouted_from": self.rerouted_from,
                "faults": self.faults, "recycles": self.recycles,
                "stats": dict(self.stats)}


def _not_prefill(rep):
    """The default dispatchability predicate: every role but dedicated
    prefill (legacy fleets declare no role at all and stay fully
    dispatchable — today's colocated behavior, bit for bit)."""
    return rep.role != "prefill"


def _parse_addr(addr):
    if isinstance(addr, (tuple, list)):
        host, port = addr
        return str(host), int(port)
    host, _, port = str(addr).rpartition(":")
    if not host:
        raise ValueError("replica address wants HOST:PORT or "
                         "(host, port), got %r" % (addr,))
    return host, int(port)


class ServeRouter:
    """Least-loaded fan-out over a pool of serving replicas.

    Parameters
    ----------
    replicas : iterable, optional
        Initial fleet: ``"host:port"`` strings or ``(host, port)``
        tuples (more via :meth:`add_replica`).
    retry : RetryPolicy, optional
        The DISPATCH policy (reroutes + transport retries share its
        budget/backoff). Default: fleet-sized — ``max(8, replicas+2)``
        retries at 5 ms base backoff, so every live replica gets its
        chance to shed before Overloaded reaches the caller.
    poll_ms / conns_per_replica / session_cap / drain_timeout
        Override ``MXNET_ROUTER_POLL_MS`` / ``MXNET_ROUTER_CONNS`` /
        ``MXNET_ROUTER_SESSION_CAP`` / ``MXNET_ROUTER_DRAIN_TIMEOUT``.
        ``poll_ms=0`` disables the background poller (tests drive
        :meth:`poll_now` explicitly — every router code path is then
        deterministic).
    io_timeout : float, optional
        Socket timeout for the per-replica clients (default
        ``MXNET_ROUTER_IO_TIMEOUT``, 30 s; 0 = unbounded — a hung
        replica then wedges its dispatch thread instead of failing
        over).
    """

    role = "router"                      # the hello frame's identity

    def __init__(self, replicas=None, retry=None, poll_ms=None,
                 conns_per_replica=None, session_cap=None,
                 drain_timeout=None, io_timeout=None, logger=None):
        self._log = logger or logging.getLogger(__name__)
        self._user_retry = retry          # None = fleet-sized default
        #                                   built per dispatch
        self._poll_ms = float(poll_ms if poll_ms is not None
                              else _config.get("MXNET_ROUTER_POLL_MS"))
        self._conns = int(conns_per_replica
                          if conns_per_replica is not None
                          else _config.get("MXNET_ROUTER_CONNS"))
        self._session_cap = int(session_cap if session_cap is not None
                                else _config.get(
                                    "MXNET_ROUTER_SESSION_CAP"))
        self._drain_timeout = float(
            drain_timeout if drain_timeout is not None
            else _config.get("MXNET_ROUTER_DRAIN_TIMEOUT"))
        if io_timeout is None:
            io_timeout = float(_config.get("MXNET_ROUTER_IO_TIMEOUT"))
        # bounded by default: a replica that accepts but never answers
        # must surface as a transport fault (suspect + reroute), not
        # wedge the dispatching thread and the poller forever
        self._io_timeout = io_timeout or None

        self._replicas = OrderedDict()   # name -> _Replica
        self._sessions = OrderedDict()   # session id -> replica name
        self._next_index = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False

        self._g_replicas = _telemetry.gauge("serve.router.replicas")
        self._g_live = _telemetry.gauge("serve.router.replicas_live")
        self._g_inflight = _telemetry.gauge("serve.router.inflight")
        self._g_sessions = _telemetry.gauge("serve.router.sessions")
        self._c_dispatched = _telemetry.counter(
            "serve.router.dispatched")
        self._c_rerouted = _telemetry.counter("serve.router.rerouted")
        self._c_shed = _telemetry.counter("serve.router.shed")
        self._c_suspected = _telemetry.counter("serve.router.suspected")
        self._c_revived = _telemetry.counter("serve.router.revived")
        self._c_recycles = _telemetry.counter("serve.router.recycles")
        self._c_sessions_placed = _telemetry.counter(
            "serve.router.sessions_placed")
        self._c_sessions_replaced = _telemetry.counter(
            "serve.router.sessions_replaced")
        self._h_dispatch = _telemetry.histogram(
            "serve.router.dispatch_ms")
        # disaggregation accounting (docs/serving.md §disaggregated
        # prefill): prefills this router fanned to prefill replicas,
        # generate requests it completed, and the handoff blob bytes
        # it shipped decode-ward (byte-scale buckets, 1 KiB..64 MiB)
        self._c_generates = _telemetry.counter("serve.router.generates")
        self._c_streams = _telemetry.counter("serve.router.streams")
        self._c_prefills = _telemetry.counter("serve.prefill.dispatched")
        self._h_handoff = _telemetry.histogram(
            "serve.router.handoff_bytes",
            buckets=tuple(float(1 << s) for s in range(10, 27, 2)))
        # replica-death survival accounting (docs/robustness.md):
        # replays = generate attempts re-sent after a transport fault
        # (same replica when the probe says it lives, a survivor when
        # it is dead); failovers = the dead-replica subset of those;
        # migrations = evacuated sessions resumed on a survivor;
        # evacuations = evacuate frames a migrating recycle sent
        self._c_failovers = _telemetry.counter("serve.router.failovers")
        self._c_replays = _telemetry.counter("serve.router.replays")
        self._c_migrations = _telemetry.counter(
            "serve.router.migrations")
        self._c_evacuations = _telemetry.counter(
            "serve.router.evacuations")
        self._failover = bool(_config.get("MXNET_ROUTER_FAILOVER"))
        self._migration_limit = int(
            _config.get("MXNET_ROUTER_MIGRATION_LIMIT"))
        # admit-id source (the PS client's (cid, seq) pattern on the serving
        # side): unique per router instance ACROSS processes, so two
        # routers sharing a fleet can never collide in a replica's
        # dedup table
        self._admit_cid = "g%d.%x" % (os.getpid(), id(self) & 0xFFFFFF)
        self._admit_seq = itertools.count(1)

        _telemetry.journal_event("serve.router.start",
                                 poll_ms=self._poll_ms)
        try:
            for addr in (replicas or ()):
                host, port = _parse_addr(addr)
                self.add_replica(host, port)
        except BaseException:
            # a later replica failing registration must not leak the
            # already-connected control clients — the caller gets an
            # exception, never a router object to close()
            self.close()
            raise

        self._poll_thread = None
        self._poll_stop = threading.Event()
        if self._poll_ms > 0:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="mxnet-router-poll",
                daemon=True)
            self._poll_thread.start()

    # -- fleet membership ---------------------------------------------------
    def add_replica(self, host, port, name=None, warm=False):
        """Register a replica, hello it (learning its declared buckets
        and engine identity), take a first stats poll, and admit it to
        dispatch. ``warm=True`` pre-compiles the declared buckets over
        the wire BEFORE the replica becomes routable (it registers
        draining, warms, then flips live) — a freshly spawned replica
        never pays a cold first-call compile on a live request (the fleet
        controller's scale-out path). Returns the replica's name."""
        with self._lock:
            if self._closed:
                raise EngineClosed("router is closed")
            index = self._next_index
            self._next_index += 1
            name = name or ("replica%d" % index)
            if name in self._replicas:
                raise ValueError("duplicate replica name %r" % name)
            rep = _Replica(name, host, port, index)
            if warm:
                # warm-before-admit: not routable until the buckets
                # are compiled (dispatch skips DRAINING)
                rep.state = ReplicaState.DRAINING
            rep.control = self._make_client(rep, control=True)
            self._replicas[name] = rep

        def unwind():
            with self._lock:
                self._replicas.pop(name, None)
            rep.control.close()
        try:
            rep.declared = rep.control.hello()
        except ServeError:
            # a replica that answers but errors is misconfigured —
            # surface it, and do NOT leave the half-registered entry
            # routable (or its control socket open)
            unwind()
            raise
        except Exception as exc:         # noqa: BLE001 — classified:
            # transport-unreachable at registration is the operator's
            # problem to know about NOW, not at first dispatch
            unwind()
            raise ConnectionError(
                "replica %s at %s:%d unreachable at registration: %s"
                % (name, host, port, exc)) from exc
        rep.role = (rep.declared or {}).get("role")
        rep.model_id = (rep.declared or {}).get("model_id")
        if warm:
            try:
                self._warm_replica(rep)   # ServeError declines logged
            except Exception as exc:      # noqa: BLE001 — transport
                # mid-warm: same contract as an unreachable hello —
                # the caller never gets a half-admitted replica
                unwind()
                raise ConnectionError(
                    "replica %s at %s:%d died during pre-admission "
                    "warm: %s" % (name, host, int(port), exc)) from exc
            with self._lock:
                rep.state = ReplicaState.LIVE
        self._poll_replica(rep)
        self._update_gauges()
        _telemetry.journal_event(
            "serve.router.add_replica", name=name,
            addr="%s:%d" % (host, int(port)), role=rep.role,
            warmed=bool(warm))
        return name

    def remove_replica(self, name):
        """Drop a replica from dispatch immediately and close its
        clients (in-flight requests to it fail over through the normal
        fault path). Pinned sessions re-place on next use."""
        with self._lock:
            rep = self._replicas.pop(name, None)
            if rep is None:
                raise KeyError("no replica %r" % name)
            for sid in [s for s, n in self._sessions.items()
                        if n == name]:
                self._sessions.pop(sid, None)
            idle = list(rep.idle)
            rep.idle.clear()
        for cl in idle + [rep.control]:
            if cl is not None:
                cl.close()
        self._update_gauges()
        _telemetry.journal_event("serve.router.remove_replica",
                                 name=name)

    def replicas(self):
        """{name: replica description} — live router-side accounting
        plus the last-polled load signals per replica."""
        with self._lock:
            return {n: r.describe() for n, r in self._replicas.items()}

    # -- clients ------------------------------------------------------------
    def _make_client(self, rep, control=False):
        pts = "router%d_ctl" % rep.index if control \
            else "router%d" % rep.index
        # data clients carry NO transport retry budget of their own:
        # a fault must surface to the dispatch loop immediately so the
        # request reroutes to another replica instead of hammering a
        # dead one. The control client keeps a small budget (polls and
        # warms tolerate a blip; nothing reroutes them).
        retry = RetryPolicy(max_retries=2, base_delay=0.01,
                            seed="router:%s:ctl" % rep.name) if control \
            else RetryPolicy(max_retries=0, seed="router:%s" % rep.name)
        return ServeClient(rep.host, rep.port, retry=retry,
                           timeout=self._io_timeout, fault_points=pts,
                           logger=self._log)

    def _acquire(self, rep):
        with self._lock:
            if rep.idle:
                return rep.idle.popleft()
        return self._make_client(rep)

    def _release(self, rep, client):
        with self._lock:
            if self._replicas.get(rep.name) is rep and \
                    rep.state != ReplicaState.DRAINING and \
                    len(rep.idle) < self._conns and not self._closed:
                # (the identity check matters: a replica removed while
                # this request was in flight must not collect live
                # sockets into its orphaned pool — nothing would ever
                # close them)
                rep.idle.append(client)
                return
        client.close()

    # -- load signals -------------------------------------------------------
    @staticmethod
    def _extract(stats_reply):
        eng = (stats_reply or {}).get("engine") or {}
        out = {"queue_depth": int(eng.get("queue_depth") or 0),
               "in_flight": int(eng.get("in_flight") or 0),
               "warmed": list(eng.get("warmed") or []),
               "buckets": list(eng.get("buckets") or []),
               "draining": bool(eng.get("draining"))}
        if eng.get("decode_free_slots") is not None:
            out["decode_free_slots"] = int(eng["decode_free_slots"])
        if eng.get("shed") is not None:
            out["shed"] = int(eng["shed"])
        if eng.get("admitted") is not None:
            out["admitted"] = int(eng["admitted"])
        return out

    # the windowed-rate signals: which cumulative counter feeds which
    # per-poll-window rate (delta since the previous successful poll —
    # the fleet controller's scale signals, rendered by
    # tools/telemetry_report.py --stats for humans)
    _RATES = (("shed", "shed_rate"), ("admitted", "req_rate"))

    def _poll_replica(self, rep):
        """One stats round trip; success refreshes the cached load
        signals and revives a suspect, failure marks suspect. Besides
        the raw extract, each poll derives the per-window rates
        (``shed_rate``/``req_rate``): the delta of the replica's
        cumulative counter since the previous successful poll. A
        counter that went BACKWARDS means the replica restarted — the
        window restarts with it (rate = counts since the restart),
        never a negative rate. The first poll of a replica's life
        reports 0 (no window exists yet)."""
        try:
            reply = rep.control.stats()
        except Exception as exc:          # noqa: BLE001 — any failure
            # to observe the replica is a health signal, not a crash
            self._mark_suspect(rep, exc)
            return False
        with self._lock:
            st = self._extract(reply)
            for cum, rate in self._RATES:
                new = st.get(cum)
                if new is None:
                    continue
                prev = rep.window.get(cum)
                if prev is None:
                    st[rate] = 0
                else:
                    st[rate] = new - prev if new >= prev else new
                rep.window[cum] = new
            rep.stats = st
        if rep.state == ReplicaState.SUSPECT:
            self._revive(rep)
        return True

    def poll_now(self):
        """Synchronously refresh every replica's cached stats (the
        background poller's body; deterministic tests call this
        instead of running the poller)."""
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            self._poll_replica(rep)
        self._update_gauges()

    def _poll_loop(self):
        # dedicated event, NOT self._cond: dispatch completions
        # notify_all() that condition constantly, which would wake the
        # poller after nearly every request and turn the configured
        # poll period into a continuous stats hammer under load
        failing = False
        while not self._poll_stop.wait(self._poll_ms / 1000.0):
            try:
                self.poll_now()
                failing = False
            except Exception:  # noqa: BLE001 — the poller must outlive
                # any one bad stats frame: an uncaught error here used
                # to kill the thread silently, freezing load scores
                # and suspect revival for the router's lifetime. Log
                # the FIRST failure of a streak loudly, the rest at
                # debug (a flapping replica must not flood the log).
                if not failing:
                    self._log.exception(
                        "router: poll_now failed — poller keeps "
                        "running (repeats logged at debug)")
                else:
                    self._log.debug("router: poll_now failed again",
                                    exc_info=True)
                failing = True

    def _probe(self, rep):
        """Is the replica's process demonstrably alive? One control
        ping — the failover discriminator between a transport blip on
        a surviving replica (replay to the SAME replica; its admit-id
        dedup makes that exactly-once) and a dead one (replay on a
        survivor). Any failure to answer means dead for failover
        purposes; the poller keeps probing afterwards and revives it
        when it answers stats again."""
        try:
            return bool(rep.control.ping())
        except Exception:  # noqa: BLE001 — unreachable = not alive
            return False

    def probe_replica(self, name):
        """The liveness probe by name — the failover discriminator
        (:meth:`_probe`), exposed for the fleet controller's heal
        decision: True iff the replica's process answers a control
        ping right now."""
        with self._lock:
            rep = self._replicas.get(name)
        if rep is None:
            raise KeyError("no replica %r" % name)
        return self._probe(rep)

    def canary(self, name, inputs, timeout=None):
        """One infer pinned to the NAMED replica — no load balancing,
        no reroute, no retry: the fleet controller's rollout health
        gate (a freshly promoted replica must answer this within its
        deadline or the rollout rolls back). Uses a dedicated one-shot
        client so ``timeout`` bounds the whole round trip; typed
        replica errors and transport faults both propagate to the
        caller — every failure mode IS the gate's signal. Not counted
        as a dispatch (it is control-plane traffic, like warm)."""
        with self._lock:
            rep = self._replicas.get(name)
        if rep is None:
            raise KeyError("no replica %r" % name)
        arrays = [np.asarray(a) for a in inputs]
        client = ServeClient(
            rep.host, rep.port,
            retry=RetryPolicy(max_retries=0,
                              seed="router:%s:canary" % rep.name),
            timeout=float(timeout) if timeout else self._io_timeout,
            fault_points="router%d_ctl" % rep.index, logger=self._log)
        try:
            return client.request(arrays)
        finally:
            client.close()

    def _mark_suspect(self, rep, exc):
        with self._lock:
            rep.faults += 1
            was = rep.state
            if rep.state == ReplicaState.LIVE:
                rep.state = ReplicaState.SUSPECT
        if was == ReplicaState.LIVE:
            self._c_suspected.inc()
            _telemetry.journal_event("serve.router.suspect",
                                     name=rep.name,
                                     error=type(exc).__name__)
            self._log.warning("router: replica %s suspect after %s",
                              rep.name, exc)
            self._update_gauges()

    def _revive(self, rep):
        with self._lock:
            was = rep.state
            if rep.state == ReplicaState.SUSPECT:
                rep.state = ReplicaState.LIVE
        if was == ReplicaState.SUSPECT:
            self._c_revived.inc()
            _telemetry.journal_event("serve.router.revive",
                                     name=rep.name)
            self._update_gauges()

    def _update_gauges(self):
        with self._lock:
            reps = list(self._replicas.values())
            self._g_replicas.set(len(reps))
            self._g_live.set(sum(r.state == ReplicaState.LIVE
                                 for r in reps))
            self._g_inflight.set(sum(r.inflight for r in reps))
            self._g_sessions.set(len(self._sessions))

    # -- dispatch -----------------------------------------------------------
    @staticmethod
    def _score(rep):
        """Lower routes first. Router-tracked in-flight is exact and
        current; the polled queue depth folds in other frontends'
        load; the index breaks ties deterministically (registration
        order)."""
        return (rep.inflight + rep.stats.get("queue_depth", 0),
                rep.index)

    @staticmethod
    def _warm_for(rep, rows):
        """Is this replica compiled for a rows-sized request? Batch
        replicas warm PADDED buckets (any bucket >= rows serves);
        a prefill replica's 'warmed' entries are EXACT prompt lengths
        (the prefill graph specializes per (B, P)) — only an exact
        match avoids the cold compile the ranking exists to dodge."""
        warmed = rep.stats.get("warmed") or ()
        if rep.role == "prefill":
            return rows in warmed
        return any(b >= rows for b in warmed)

    def _candidates(self, rows, exclude, want=None):
        """Dispatchable replicas, best first: live before suspect
        (suspects are last-resort, so a one-replica fleet still rides
        out a transport blip), warmed-for-this-size before cold,
        least-loaded within each class. ``want``: optional role
        predicate — the disaggregated paths restrict a leg to its
        phase's replicas (prefill leg → role 'prefill', decode leg →
        role 'decode'); ``None`` = the infer/colocated default, every
        role except dedicated prefill (a prefill replica cannot
        answer anything but the prefill frame)."""
        if want is None:
            want = _not_prefill
        live, suspect = [], []
        for rep in self._replicas.values():
            if not want(rep) or rep.name in exclude or \
                    rep.state == ReplicaState.DRAINING or \
                    rep.stats.get("draining"):
                # the polled flag catches an EXTERNALLY draining
                # replica (its own SIGTERM) at poll time — no need to
                # pay a doomed round trip per request to notice; the
                # next poll clears it if the replica comes back
                continue
            (live if rep.state == ReplicaState.LIVE
             else suspect).append(rep)
        for pool in (live, suspect):
            pool.sort(key=lambda r: (not self._warm_for(r, rows),)
                      + self._score(r))
        return live + suspect

    def _pick(self, rows, session, exclude, fresh_pins, want=None):
        """Choose and charge the target replica (inflight++ under the
        lock, so concurrent dispatches see each other's load).
        Returns ``(replica, established)`` — established means the
        session pin predates this dispatch (KV state exists on that
        replica, so a shed there must NOT reroute); a pin placed by
        this very dispatch (``fresh_pins``) is speculative and free to
        move. ``want`` restricts the leg to a role (see
        :meth:`_candidates`); a pin to a replica outside the wanted
        role re-places like a pin to a drained one (the fleet's
        topology changed under the session)."""
        if want is None:
            want = _not_prefill
        with self._lock:
            if self._closed:
                raise EngineClosed("router is closed")
            if session is not None:
                pinned = self._replicas.get(self._sessions.get(session))
                if pinned is not None and want(pinned) and \
                        pinned.state != ReplicaState.DRAINING and \
                        not pinned.stats.get("draining") and \
                        pinned.name not in exclude:
                    self._sessions.move_to_end(session)   # LRU touch
                    pinned.inflight += 1
                    pinned.dispatched += 1
                    return pinned, pinned.name not in fresh_pins
                if self._sessions.pop(session, None) is not None:
                    # the pin's replica is draining/gone (or this
                    # dispatch's own speculative pin failed): the
                    # session re-places fresh
                    self._c_sessions_replaced.inc()
            cands = self._candidates(rows, exclude, want)
            if not cands:
                self._c_shed.inc()
                _telemetry.journal_event("serve.router.all_shed",
                                         tried=len(exclude))
                raise Overloaded(
                    "every live replica shed or is unavailable "
                    "(%d tried, %d draining/suspect-excluded)"
                    % (len(exclude),
                       len(self._replicas) - len(exclude)))
            if session is not None:
                # new session: most free decode slots wins (that's
                # where its KV slot will live); least-loaded when no
                # replica reports slot counts. Only among LIVE
                # replicas while any exist — a suspect's stale stats
                # must not win it a long-lived pin (_candidates
                # already sorts live first, so cands[0] is live iff
                # any live candidate exists)
                pool = [r for r in cands
                        if r.state == ReplicaState.LIVE] or cands
                rep = min(pool, key=lambda r: (
                    -r.stats.get("decode_free_slots", 0),)
                    + self._score(r))
                self._sessions[session] = rep.name
                fresh_pins.add(rep.name)
                self._c_sessions_placed.inc()
                while len(self._sessions) > self._session_cap:
                    self._sessions.popitem(last=False)
            else:
                rep = cands[0]
            rep.inflight += 1
            rep.dispatched += 1
            return rep, False

    def _has_other_candidate(self, rep, exclude, want=None):
        """Is any OTHER replica dispatchable right now? (the honesty
        test for the reroute counter)"""
        if want is None:
            want = _not_prefill
        with self._lock:
            return any(r is not rep and want(r)
                       and r.name not in exclude
                       and r.state != ReplicaState.DRAINING
                       and not r.stats.get("draining")
                       for r in self._replicas.values())

    def _finish_dispatch(self, rep):
        with self._cond:
            rep.inflight -= 1
            self._cond.notify_all()       # recycle() waits on this

    def submit(self, *inputs, deadline_ms=None, tc=None, session=None):
        """The engine-surface entry (ServeServer calls this): dispatch
        synchronously, return an already-resolved future. Typed errors
        raise here exactly like ServeEngine.submit's admission errors
        (Overloaded only when every live replica shed)."""
        return _DoneFuture(self._dispatch(
            [np.asarray(a) for a in inputs], deadline_ms, session, tc))

    def request(self, inputs, deadline_ms=None, session=None):
        """Blocking convenience twin of ServeClient.request for
        in-process callers (the fleet bench drives this)."""
        return self._dispatch([np.asarray(a) for a in inputs],
                              deadline_ms, session, None)

    def infer(self, *inputs, deadline_ms=None, session=None,
              timeout=None):
        """submit + result in one call (engine-surface parity;
        ``timeout`` is accepted for signature parity — dispatch is
        synchronous, so the response is already here)."""
        return self.submit(*inputs, deadline_ms=deadline_ms,
                           session=session).result(timeout)

    # -- disaggregated generation -------------------------------------------
    def _disagg_active(self):
        """Disaggregation engages only when the fleet holds BOTH
        phases: at least one routable prefill-role replica AND one
        decode-role replica. Any other fleet — legacy no-role, decode
        replicas alone, prefill replicas mid-deploy — keeps the
        colocated path bit-for-bit (the replica that admits also
        prefills)."""
        with self._lock:
            have = {None: False, "prefill": False, "decode": False}
            for r in self._replicas.values():
                if r.state == ReplicaState.DRAINING or \
                        r.stats.get("draining"):
                    continue
                have[r.role if r.role in have else None] = True
            return have["prefill"] and have["decode"]

    def _has_role(self, role):
        with self._lock:
            return any(r.role == role
                       and r.state != ReplicaState.DRAINING
                       and not r.stats.get("draining")
                       for r in self._replicas.values())

    def generate(self, prompt, max_new_tokens, eos_id=None,
                 temperature=0.0, top_k=None, top_p=None, seed=0,
                 session=None, timeout=None, handoff=None, tc=None,
                 on_token=None, speculative=False):
        """Route one sequence generation through the fleet
        (docs/serving.md §disaggregated prefill).

        Disaggregated fleet (prefill + decode roles both present): the
        prefill fans to the least-loaded prefill replica (preferring
        one with this prompt length warmed), the session places on the
        decode replica with most free slots — established pins keep
        their affinity semantics untouched — and the exported KV
        blob ships WITH the admit, so the decode replica runs zero
        prefill graph calls. Any other fleet: the generate frame goes
        to one colocated replica that prefills and decodes locally —
        decode-role replicas when any exist (a ``role: batch``
        neighbor cannot answer a generate frame), otherwise any
        non-prefill replica (legacy no-role fleets, bit for bit).
        Both paths emit exactly what a single-process
        ``Generator.generate`` would for this prompt + seed.

        ``handoff``: a prefill reply the CALLER already holds (the
        replica-surface contract — a client that paid its own remote
        prefill must not pay a second one through the router); the
        prefill leg is skipped and the blob ships as-is.

        ``timeout`` is a best-effort end-to-end budget: the decode
        leg receives what remains of it after the prefill leg.
        Transport-fault replays can stretch the total past it (each
        replayed attempt re-arms its read window — the price of
        exactly-one-response delivery); callers needing a hard wall
        enforce it on their own side of the wire.

        ``on_token``: streaming mode — the decode leg asks its
        replica to stream and each NEW token relays through
        ``on_token(tok)`` the moment its frame arrives, without
        buffering the row. The recovery record extends to the
        DELIVERED-TOKEN PREFIX: every leg attempt — failover replay
        on a survivor, migration resume — re-reads its replica's
        stream from emission index 0, and the router verifies the
        replayed tokens against what it already delivered (a mismatch
        fails loudly as a determinism violation), forwarding only the
        tail. No duplicated or missing frames, across any number of
        mid-stream replica deaths. Streamed legs drop the blanket
        whole-completion deadline for the per-frame
        ``MXNET_STREAM_IDLE_TIMEOUT`` idle bound.

        ``speculative``: forwarded on every decode leg — first
        dispatch, failover replay AND migration resume — as the pure
        performance hint it is: a draft-carrying replica decodes the
        request in draft/verify rounds, a draft-less one ignores it,
        and the emitted tokens are byte-identical either way, so the
        delivered-prefix verification and the fault-free oracle both
        hold across mixed fleets."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        P = int(prompt.size)
        if P < 1:
            raise ValueError("empty prompt")
        t_entry = _telemetry.now_ms()
        if tc is None:
            tc = _trace.current_context()
        disagg = handoff is None and self._disagg_active()
        gsp = _trace.start_span("serve.router.generate", parent=tc,
                                tokens=P, disagg=disagg)
        try:
            if disagg:
                handoff = self._route(
                    P, None, None,
                    lambda c: c.prefill(prompt,
                                        temperature=temperature,
                                        top_k=top_k, top_p=top_p,
                                        seed=seed),
                    want=lambda r: r.role == "prefill",
                    span="serve.router.prefill")
                nbytes = kv_blob_nbytes(handoff["kv_blob"])
                self._c_prefills.inc()
                self._h_handoff.observe(nbytes)
                _telemetry.journal_event("serve.router.handoff",
                                         bytes=nbytes, tokens=P)
            if disagg or handoff is not None or \
                    self._has_role("decode"):
                # a blob (routed or caller-supplied) needs a decode
                # admit; and in ANY fleet that has decode-role
                # replicas, the generate frame belongs on them — a
                # 'batch' neighbor has no handle_generate()
                want = lambda r: r.role == "decode"  # noqa: E731
            else:
                want = None              # legacy no-role fleet
            # the decode leg must stay BOUNDED even when the caller
            # passed no timeout: an unbounded wire read on a hung
            # replica would wedge this dispatch thread forever (the
            # exact failure MXNET_ROUTER_IO_TIMEOUT exists to catch
            # on the infer path). Scale the ceiling with the work —
            # a second per requested token plus queue slack is hung
            # on any hardware, not slow. A caller budget is
            # END-TO-END: the decode leg gets what the prefill leg
            # left of it (floored so an already-blown budget fails
            # fast with the decoder's typed RequestTimeout)
            if timeout is not None:
                leg_timeout = max(
                    0.001, float(timeout)
                    - (_telemetry.now_ms() - t_entry) / 1000.0)
            elif on_token is not None:
                # streamed leg: liveness is per FRAME, not per
                # completion — the client applies the
                # MXNET_STREAM_IDLE_TIMEOUT idle bound to every frame
                # read, so the old scale-with-the-work ceiling has
                # nothing left to catch (a hung replica misses one
                # inter-frame gap and fails over)
                leg_timeout = None
            else:
                leg_timeout = 120.0 + float(max_new_tokens)
            # the recovery record: every attempt of this generate —
            # first dispatch, failover replay, migration resume —
            # re-sends the same request under ONE admit-id lineage,
            # so a replay onto a replica that already admitted it
            # rides the original admission (exactly-once)
            admit_id = "%s:%d" % (self._admit_cid,
                                  next(self._admit_seq))
            # the delivered-token prefix — the streaming half of the
            # recovery record: tokens already relayed to the caller.
            # Each leg attempt re-reads its replica's stream from
            # emission index 0 (a deduped or resumed admission
            # replays the emitted prefix first), so a leg-local
            # cursor IS the global emission index: verify against
            # the prefix, relay only the tail
            delivered = []

            def leg_relay():
                cur = [0]

                def relay(tok):
                    k = cur[0]
                    cur[0] += 1
                    if k < len(delivered):
                        if delivered[k] != tok:
                            raise ServeError(
                                "stream replay diverged at token %d: "
                                "%d then %d — determinism violation"
                                % (k, delivered[k], tok))
                        return
                    if k > len(delivered):
                        raise ServeError(
                            "stream relay skipped to token %d past "
                            "the delivered prefix (%d)"
                            % (k, len(delivered)))
                    delivered.append(tok)
                    if k == 0 and _trace.enabled():
                        _trace.instant("serve.router.stream_relay")
                    on_token(tok)
                return relay

            def leg(c, resume=None, aid=admit_id):
                return c.generate(prompt, max_new_tokens,
                                  eos_id=eos_id,
                                  temperature=temperature,
                                  top_k=top_k, top_p=top_p,
                                  seed=seed, session=session,
                                  handoff=None if resume is not None
                                  else handoff,
                                  timeout=leg_timeout,
                                  admit_id=aid, resume=resume,
                                  on_token=None if on_token is None
                                  else leg_relay(),
                                  speculative=speculative)
            out = self._route(P, session, None, leg, want=want,
                              span="serve.router.decode",
                              recoverable=True)
            hops = 0
            while isinstance(out, dict) and "evacuated" in out:
                # the replica exported this in-flight session instead
                # of finishing it (migrating recycle / SIGTERM
                # evacuation): resume the portable state on a
                # survivor. The session re-pins where the resume
                # lands; the resumed stream re-derives its PRNG key
                # by advancing the same splits, so the remaining
                # tokens are bit-identical to an unmigrated run.
                mstate = out["evacuated"]
                hops += 1
                if hops > self._migration_limit:
                    raise EngineClosed(
                        "generate migrated %d times without "
                        "completing (MXNET_ROUTER_MIGRATION_LIMIT="
                        "%d) — the fleet is evacuating faster than "
                        "it decodes" % (hops - 1,
                                        self._migration_limit))
                self._c_migrations.inc()
                _telemetry.journal_event(
                    "serve.router.migrate", hop=hops,
                    session=str(session),
                    tokens=len(mstate.get("emitted") or ()))
                out = self._route(
                    P, session, None,
                    lambda c, s=mstate, h=hops: leg(
                        c, resume=s,
                        # a fresh id per hop: a resume that bounces
                        # back to a re-opened replica must never
                        # collide with a STALE dedup entry from an
                        # earlier life of this request
                        aid="%s:m%d" % (admit_id, h)),
                    want=want, span="serve.router.migrate",
                    recoverable=True)
            self._c_generates.inc()
            if on_token is not None:
                self._c_streams.inc()
            return out
        finally:
            _trace.end_span(gsp)

    def handle_generate(self, payload):
        """The ``generate`` wire frame when a ServeServer fronts the
        router — clients still cannot tell a router from a replica:
        the same frame a colocated replica admits, the router fans
        across the fleet."""
        return self.generate(
            payload["prompt"], payload["max_new_tokens"],
            eos_id=payload.get("eos_id"),
            temperature=payload.get("temperature") or 0.0,
            top_k=payload.get("top_k"), top_p=payload.get("top_p"),
            seed=payload.get("seed") or 0,
            session=payload.get("session"),
            timeout=payload.get("timeout"),
            handoff=payload.get("handoff"),
            speculative=bool(payload.get("speculative")))

    def handle_generate_stream(self, payload, emit):
        """The streamed ``generate`` frame through a router-fronting
        ServeServer: relay each leg frame straight out as a front-end
        frame — the router never buffers the row (``emit`` fires on
        this dispatch thread the moment a replica frame lands, while
        the replica is still decoding). ``offset`` restarts at the
        delivered count, never replays: the router's own prefix
        verification already absorbed the leg-side replays."""
        sent = [0]

        def on_token(tok):
            emit([int(tok)], sent[0])
            sent[0] += 1

        return self.generate(
            payload["prompt"], payload["max_new_tokens"],
            eos_id=payload.get("eos_id"),
            temperature=payload.get("temperature") or 0.0,
            top_k=payload.get("top_k"), top_p=payload.get("top_p"),
            seed=payload.get("seed") or 0,
            session=payload.get("session"),
            timeout=payload.get("timeout"),
            handoff=payload.get("handoff"),
            speculative=bool(payload.get("speculative")),
            on_token=on_token)

    def _dispatch(self, arrays, deadline_ms, session, tc):
        if not arrays:
            raise ValueError("dispatch needs at least one input array")
        rows = int(arrays[0].shape[0]) if arrays[0].ndim else 0
        if rows < 1:
            raise ValueError(
                "inputs need a leading batch axis (a single sample is "
                "shape (1, ...)), got %r" % (arrays[0].shape,))
        return self._route(
            rows, session, tc,
            lambda client: client.request(arrays,
                                          deadline_ms=deadline_ms,
                                          session=session))

    def _route(self, rows, session, tc, call, want=None,
               span="serve.router.dispatch", recoverable=False):
        """THE dispatch scaffolding every routed wire op shares —
        pick-and-charge, shed-and-retry via the RetryPolicy reroute
        hook, suspect marking, session-pin hygiene. ``call(client)``
        performs the actual round trip (infer / prefill / generate);
        ``want`` restricts candidates to a role (disaggregated legs);
        ``span`` names the dispatch span (the infer path keeps its
        established ``serve.router.dispatch`` vocabulary).

        ``recoverable``: the generate-failover contract — ``call`` is
        a full recovery record (the router re-sends prompt, sampling
        opts, seed and handoff on every attempt, under one admit id).
        A transport fault on an ESTABLISHED session then probes the
        pinned replica: alive → replay to it (the decode-side dedup
        admits exactly once); dead → drop the pin and replay on a
        survivor, token-for-token identical. Without it (infer legs,
        or ``MXNET_ROUTER_FAILOVER`` off) an established session's
        fault retries only its own replica, the pre-failover
        behavior."""
        t0 = _telemetry.now_ms()
        excluded = set()                 # replicas that shed THIS req
        fresh_pins = set()               # pins THIS dispatch placed
        state = {"rep": None, "established": False, "reroutes": 0}

        def attempt():
            state["rep"] = None
            rep, established = self._pick(rows, session, excluded,
                                          fresh_pins, want)
            state["rep"], state["established"] = rep, established
            client = self._acquire(rep)
            answered = False
            try:
                try:
                    out = call(client)
                    answered = True
                    return out
                except ServeError:
                    # a typed reply IS an answer: the transport (and
                    # the replica) demonstrably work — keep both
                    answered = True
                    raise
            finally:
                self._finish_dispatch(rep)
                if answered:
                    self._release(rep, client)
                    if rep.state == ReplicaState.SUSPECT:
                        self._revive(rep)   # it answered: healthy
                else:
                    client.close()        # never pool a faulted client

        def on_retry(exc, attempt_n, delay):
            # fires before EVERY retry sleep — both transient
            # transport faults and on_fatal-approved reroutes land
            # here. Typed replies (shed/drain) already did their
            # bookkeeping in on_fatal; only a TRANSPORT fault (real or
            # injected) makes the replica suspect
            del attempt_n, delay
            if isinstance(exc, ServeError):
                return
            rep = state["rep"]
            if rep is not None:
                self._mark_suspect(rep, exc)
                if state["established"]:
                    if not (recoverable and self._failover):
                        # the session's KV state lives on that
                        # replica: the retry goes back to it (a blip
                        # heals, a dead replica exhausts the budget —
                        # rerouting would silently orphan the decode
                        # state instead)
                        return
                    if self._probe(rep):
                        # the replica survived — the fault was the
                        # wire's. Replay to the pin: the dedup table
                        # returns the original admission, so the
                        # replay admits exactly once
                        self._c_replays.inc()
                        _trace.instant("serve.router.replay",
                                       replica=rep.name)
                        return
                    # the pinned replica is DEAD mid-generate: drop
                    # the pin and replay the full recovery record on
                    # a survivor — prefill is pure and the request's
                    # PRNG stream splits once per emitted token, so
                    # the replayed completion is token-for-token
                    # identical to what the dead replica would have
                    # finished
                    with self._lock:
                        if self._sessions.get(session) == rep.name:
                            self._sessions.pop(session, None)
                    self._c_failovers.inc()
                    self._c_replays.inc()
                    _telemetry.journal_event("serve.router.failover",
                                             name=rep.name,
                                             session=str(session))
                    _trace.instant("serve.router.failover",
                                   replica=rep.name)
                    self._log.warning(
                        "router: replica %s dead mid-generate (probe "
                        "failed) — replaying session %r on a "
                        "survivor", rep.name, session)
                    if self._has_other_candidate(rep, excluded, want):
                        rep.rerouted_from += 1
                        state["reroutes"] += 1
                        self._c_rerouted.inc()
                    return
                if session is not None:
                    # a SPECULATIVE pin (this dispatch placed it, no
                    # KV state exists) must not chain the retry back
                    # to the faulted replica through the pinned-branch
                    # fast path — drop it so the retry re-places
                    with self._lock:
                        if self._sessions.get(session) == rep.name:
                            self._sessions.pop(session, None)
                if not self._has_other_candidate(rep, excluded, want):
                    # single-replica fleet (or nothing else standing):
                    # the retry necessarily returns HERE — that is a
                    # plain transport retry, not a reroute; counting
                    # it would fake fleet motion in the metrics
                    return
                rep.rerouted_from += 1
                state["reroutes"] += 1    # span attr and counter agree
                self._c_rerouted.inc()
                _trace.instant("serve.router.reroute",
                               replica=rep.name, fault=True)

        def on_fatal(exc):
            # the RetryPolicy reroute hook: a replica-local shed (or a
            # drain-window EngineClosed) retries on the next candidate
            # — but only a REPLICA's answer qualifies (state["rep"] is
            # None when _pick itself raised the every-replica-shed
            # Overloaded, which must propagate), and an ESTABLISHED
            # session never leaves the replica holding its KV slot on
            # a shed (a pin this dispatch placed speculatively is
            # free to move — no state exists yet)
            rep = state["rep"]
            if rep is None or not isinstance(exc, (Overloaded,
                                                   EngineClosed)):
                return False
            if state["established"] and isinstance(exc, Overloaded):
                return False
            if isinstance(exc, EngineClosed):
                # the replica is draining under us (external SIGTERM,
                # a recycle racing this dispatch): cache the observed
                # fact into the SAME channel the poller writes —
                # _candidates skips it from now on, and the next
                # successful poll clears it if the replica comes back
                # (a state flip to DRAINING would be forever: only
                # recycle() readmits from that state)
                with self._lock:
                    rep.stats["draining"] = True
                _telemetry.journal_event("serve.router.observed_drain",
                                         name=rep.name)
            rep.rerouted_from += 1
            excluded.add(rep.name)
            state["reroutes"] += 1
            self._c_rerouted.inc()
            _trace.instant("serve.router.reroute", replica=rep.name,
                           shed=True)
            return True

        # the default budget scales with the fleet: every live replica
        # must get its chance to shed before Overloaded reaches the
        # caller (a fixed budget smaller than the fleet would raise by
        # exhaustion mid-sweep, skipping the all_shed accounting)
        policy = self._user_retry or RetryPolicy(
            max_retries=max(8, len(self._replicas) + 2),
            base_delay=0.005, seed="router")
        sp = _trace.start_span(span, parent=tc, rows=rows)
        try:
            out = policy.run(attempt, describe="router.dispatch",
                             on_retry=on_retry, on_fatal=on_fatal)
            self._c_dispatched.inc()
            self._h_dispatch.observe(_telemetry.now_ms() - t0)
            return out
        except BaseException:
            # a pin THIS dispatch placed must die with the dispatch —
            # left behind, the session's next request would treat it
            # as an established pin (with no KV state behind it) and
            # refuse to reroute off the failed replica
            if session is not None and fresh_pins:
                with self._lock:
                    if self._sessions.get(session) in fresh_pins:
                        self._sessions.pop(session, None)
            raise
        finally:
            rep = state["rep"]
            _trace.end_span(sp, replica=rep.name if rep else None,
                            reroutes=state["reroutes"])

    # -- sessions -----------------------------------------------------------
    def release_session(self, session):
        """Forget a session pin (its decode slot freed on the
        replica); the next request with this id places fresh."""
        with self._lock:
            dropped = self._sessions.pop(session, None) is not None
        if dropped:
            self._update_gauges()
        return dropped

    def sessions(self):
        """{session id: replica name} snapshot of the affinity table."""
        with self._lock:
            return dict(self._sessions)

    # -- rolling restart ----------------------------------------------------
    def recycle(self, name, restart=None, warm=True, timeout=None,
                admit=True):
        """Zero-drop rolling restart of one replica.

        1. stop routing new work to it (state -> draining; dispatch
           excludes it from the same instant, under the same lock);
        2. for a decode-role replica, EVACUATE first: the ``evacuate``
           frame exports every active session mid-decode, the blocked
           generate dispatches resume them on survivors (bit-exact —
           docs/robustness.md), and the drain below is bounded by
           export+import cost instead of the longest sequence in
           flight. Then wait for the router's own in-flight count to
           reach zero (condition-signaled, exact) and for the
           replica's stats-observed engine ``in_flight``/
           ``queue_depth`` to reach zero (covers other frontends);
        3. run ``restart()`` — the operator hook that actually
           restarts the replica (SIGTERM → GracefulShutdown drain →
           fresh process, a k8s pod delete, or an in-process
           engine+server rebuild). It may return a new ``(host,
           port)`` / ``"host:port"`` (None = same address). With
           ``restart=None`` the replica is only drained, re-warmed
           and readmitted (a config-reload recycle);
        4. re-warm the declared buckets over the wire (``warm``
           frame) so the readmitted replica never pays a cold
           compile on a live request;
        5. readmit (state -> live) and refresh its stats — unless
           ``admit=False``, which leaves the restarted replica
           QUARANTINED (state stays draining, dispatch never routes
           to it) until :meth:`admit_replica`. That is the rollout
           gate's seam: the fleet controller recycles a replica onto
           a candidate artifact, canaries it directly while zero
           live traffic can reach it, and only admits on a passed
           gate.

        Raises ValueError when no OTHER live replica exists (a
        one-replica fleet cannot recycle without dropping requests)
        and TimeoutError when the drain outlives the budget
        (``MXNET_ROUTER_DRAIN_TIMEOUT`` / ``timeout``; a replica
        whose hello declared role ``decode`` drains on
        ``MXNET_DECODE_DRAIN_TIMEOUT`` instead — the same clock its
        own ``ContinuousDecoder.close`` honors, validated loudly
        there, so a decode drain is never cut short by a router knob
        tuned for batch replicas). A drain timeout fails OPEN, never
        stranding the replica in DRAINING: decode-role replicas park
        SUSPECT (wedged sequences make the replica suspect by
        definition; the next successful poll revives it), other
        roles return LIVE."""
        with self._lock:
            # ONE lock section from lookup to the DRAINING flip — a
            # concurrent remove_replica must not slip between them and
            # leave this recycle operating on an orphaned record
            rep = self._replicas.get(name)
            if rep is None:
                raise KeyError("no replica %r" % name)
            if timeout is not None:
                budget = float(timeout)
            elif rep.role == "decode":
                budget = _decode_drain_timeout()
            else:
                budget = self._drain_timeout
            deadline = time.monotonic() + budget
            if not any(r.state == ReplicaState.LIVE
                       and r.name != name
                       for r in self._replicas.values()):
                raise ValueError(
                    "recycling %r would leave no live replica — add "
                    "capacity first (or close the router outright)"
                    % name)
            rep.state = ReplicaState.DRAINING
            for sid in [s for s, n in self._sessions.items()
                        if n == name]:
                self._sessions.pop(sid, None)   # pins re-place fresh
            idle = list(rep.idle)
            rep.idle.clear()
        for cl in idle:
            cl.close()
        self._update_gauges()
        t0 = _telemetry.now_ms()
        drained_ms = self._drain_replica(rep, deadline, budget,
                                         event="serve.router.recycle")
        try:
            if restart is not None:
                rep.control.close()
                addr = restart()
                if addr is not None:
                    rep.host, rep.port = _parse_addr(addr)
                rep.control = self._make_client(rep, control=True)
                # the bind window of a REAL process restart (fresh
                # interpreter, torch import, bind) is seconds, far past
                # the control client's own ~30 ms retry budget — keep
                # knocking until the recycle's remaining drain budget
                # runs out
                while True:
                    try:
                        rep.declared = rep.control.hello()
                        rep.role = (rep.declared or {}).get("role")
                        rep.model_id = (rep.declared or {}) \
                            .get("model_id")
                        break
                    except ServeError:
                        raise             # it answered: misconfigured
                    except Exception:     # noqa: BLE001 — transport;
                        if time.monotonic() >= deadline:
                            raise         # outer fail-open -> SUSPECT
                        time.sleep(0.05)
            if warm:
                self._warm_replica(rep)
        except Exception as exc:          # noqa: BLE001 — fail OPEN:
            # a botched restart/hello must not strand the replica in
            # DRAINING (a permanently shrunk fleet); park it SUSPECT
            # so the poller readmits it the moment it answers stats
            with self._lock:
                rep.state = ReplicaState.SUSPECT
            self._update_gauges()
            _telemetry.journal_event("serve.router.recycle",
                                     name=name, phase="failed",
                                     error=type(exc).__name__)
            raise
        self._poll_replica(rep)
        with self._lock:
            if admit:
                rep.state = ReplicaState.LIVE
                # the observed-draining flag must not outlive the
                # recycle: if the final poll blipped, a stale True
                # here would keep dispatch skipping a replica the
                # gauge counts as live (and a poll_now-driven
                # deployment would never clear it)
                rep.stats.pop("draining", None)
            rep.recycles += 1
        self._c_recycles.inc()
        self._update_gauges()
        _telemetry.journal_event(
            "serve.router.recycle", name=name,
            phase="readmit" if admit else "quarantined",
            drained_ms=round(drained_ms, 3),
            total_ms=round(_telemetry.now_ms() - t0, 3))

    def admit_replica(self, name):
        """Admit a quarantined replica (``recycle(admit=False)``) to
        traffic: state -> live, routable from this instant. Idempotent
        on an already-live replica; KeyError on an unknown one."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                raise KeyError("no replica %r" % name)
            rep.state = ReplicaState.LIVE
            rep.stats.pop("draining", None)
        self._update_gauges()
        _telemetry.journal_event("serve.router.admit", name=name)

    def retire_replica(self, name, timeout=None):
        """Zero-drop scale-in: stop routing to the replica, drain it
        exactly like :meth:`recycle` (decode-role replicas evacuate
        their active sessions onto survivors first), then REMOVE it
        from the fleet. The replica process itself is not stopped —
        its lifecycle belongs to whoever started it (the fleet
        controller's ``retire`` hook reaps it after this returns).
        Refuses to retire the last live replica; a drain past the
        budget raises TimeoutError with the replica failed OPEN
        (routable again — nothing dropped, nothing removed)."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                raise KeyError("no replica %r" % name)
            if timeout is not None:
                budget = float(timeout)
            elif rep.role == "decode":
                budget = _decode_drain_timeout()
            else:
                budget = self._drain_timeout
            deadline = time.monotonic() + budget
            if not any(r.state == ReplicaState.LIVE
                       and r.name != name
                       for r in self._replicas.values()):
                raise ValueError(
                    "retiring %r would leave no live replica — the "
                    "fleet floor is one" % name)
            rep.state = ReplicaState.DRAINING
            for sid in [s for s, n in self._sessions.items()
                        if n == name]:
                self._sessions.pop(sid, None)   # pins re-place fresh
            idle = list(rep.idle)
            rep.idle.clear()
        for cl in idle:
            cl.close()
        self._update_gauges()
        drained_ms = self._drain_replica(rep, deadline, budget,
                                         event="serve.router.retire")
        self.remove_replica(name)
        _telemetry.journal_event("serve.router.retire", name=name,
                                 phase="removed",
                                 drained_ms=round(drained_ms, 3))

    def _drain_replica(self, rep, deadline, budget, event):
        """THE zero-drop drain body recycle() and retire_replica()
        share: evacuate a decode replica's active sessions, wait for
        the router's own in-flight count (condition-signaled, exact),
        then for the replica's stats-observed engine in-flight/queue
        depth (covers other frontends). The replica must already be
        DRAINING. A budget overrun raises TimeoutError with the
        replica failed OPEN (SUSPECT for decode roles — wedged
        sequences make it suspect by definition; LIVE otherwise) so
        it is never stranded unroutable. Returns the drain wall time
        in ms."""
        name = rep.name
        t0 = _telemetry.now_ms()
        _telemetry.journal_event(event, name=name, phase="drain")
        if rep.role == "decode":
            # migrating recycle: evacuate active sessions FIRST —
            # each in-flight generate on this replica answers with
            # its portable state and resumes on a survivor (the
            # dispatch threads repin it there), so the drain below
            # is bounded by export+import cost instead of the
            # longest sequence in flight. A replica that declines
            # (no evacuate(): an old build) falls back to the full
            # drain; an unreachable one is already dead — the drain
            # loop below classifies that as drained.
            try:
                evacuated = rep.control.evacuate()
                self._c_evacuations.inc()
                _telemetry.journal_event(
                    event, name=name,
                    phase="evacuate", sessions=int(evacuated or 0))
            except ServeError as exc:
                self._log.warning(
                    "router: %s declined evacuation (%s) — falling "
                    "back to a full decode drain", name, exc)
            except Exception as exc:      # noqa: BLE001 — transport:
                self._log.warning(
                    "router: evacuate frame to %s failed (%s) — "
                    "continuing with the drain", name, exc)
        # a decode replica that cannot drain is suspect by definition
        # (sequences wedged past their own drain clock); any other
        # role fails open LIVE — its requests are short, the timeout
        # usually means budget misconfiguration, and SUSPECT would
        # deprioritize a working replica. Either way the replica is
        # never stranded DRAINING: the next successful poll revives
        # a suspect, and LIVE routes immediately.
        fail_open = ReplicaState.SUSPECT if rep.role == "decode" \
            else ReplicaState.LIVE
        timed_out = 0
        with self._cond:
            while rep.inflight > 0:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    # re-checked AFTER every wait: a wait that times
                    # out concurrently with the last completion must
                    # re-read the predicate, not fail a finished drain
                    rep.state = fail_open
                    timed_out = rep.inflight
                    break
                self._cond.wait(remain)
        if timed_out:
            self._update_gauges()         # the fail-open is routable
            raise TimeoutError(
                "replica %r still has %d router-dispatched "
                "request(s) in flight after %.1fs drain budget"
                % (name, timed_out, budget))
        # router-sent work is answered; now confirm the replica-side
        # engine is empty too (work from OTHER frontends counts)
        while True:
            try:
                st = self._extract(rep.control.stats())
            except Exception as exc:      # noqa: BLE001 — a replica
                # mid-external-restart stops answering; that IS drained
                self._log.info("router: %s stopped answering during "
                               "drain (%s) — treating as drained",
                               name, exc)
                break
            if st["in_flight"] == 0 and st["queue_depth"] == 0:
                break
            if time.monotonic() >= deadline:
                with self._lock:
                    rep.state = fail_open
                self._update_gauges()
                raise TimeoutError(
                    "replica %r engine still reports %d in flight / "
                    "%d queued after %.1fs drain budget"
                    % (name, st["in_flight"], st["queue_depth"],
                       budget))
            with self._cond:
                self._cond.wait(0.01)     # remote state: bounded poll
        return _telemetry.now_ms() - t0

    # -- engine-surface lifecycle / introspection ---------------------------
    def _warm_replica(self, rep):
        """One warm frame + bookkeeping — THE warm path for both
        warmup() and recycle(). A typed ServeError decline (engine
        without warmup()/feature shapes) is logged, not raised: the
        replica works, it just pays its compiles on live traffic.
        Transport errors propagate to the caller's policy."""
        try:
            warmed = rep.control.warm()
            with self._lock:
                rep.stats["warmed"] = list(warmed or [])
        except ServeError as exc:
            self._log.warning("router: warm of %s declined: %s",
                              rep.name, exc)

    def warmup(self):
        """Engine-surface warmup: re-warm every non-draining replica
        (the ``warm`` frame on each)."""
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.state != ReplicaState.DRAINING]
        for rep in reps:
            try:
                self._warm_replica(rep)
            except Exception as exc:      # noqa: BLE001 — a TRANSPORT
                # failure during warmup is a health signal
                self._mark_suspect(rep, exc)

    @property
    def warmed_buckets(self):
        """Buckets warmed on EVERY non-draining replica (the fleet
        serves a bucket cold-compile-free only when all of them can)."""
        with self._lock:
            pools = [set(r.stats.get("warmed") or ())
                     for r in self._replicas.values()
                     if r.state != ReplicaState.DRAINING]
        return sorted(set.intersection(*pools)) if pools else []

    @property
    def draining(self):
        return self._closed

    def stats(self):
        """Aggregated engine-style stats (sums over the fleet) +
        router accounting."""
        with self._lock:
            reps = list(self._replicas.values())
            sessions = len(self._sessions)
        return {
            "replicas": len(reps),
            "live": sum(r.state == ReplicaState.LIVE for r in reps),
            "dispatched": sum(r.dispatched for r in reps),
            "in_flight": sum(r.inflight for r in reps),
            "queue_depth": sum(r.stats.get("queue_depth", 0)
                               for r in reps),
            "rerouted": sum(r.rerouted_from for r in reps),
            "recycles": sum(r.recycles for r in reps),
            "sessions": sessions,
            # fleet-wide windowed rates (per poll window, summed over
            # replicas) — the controller's scale signals, next to the
            # cumulative counters above
            "shed_rate": sum(r.stats.get("shed_rate", 0)
                             for r in reps),
            "req_rate": sum(r.stats.get("req_rate", 0) for r in reps),
        }

    def introspect(self):
        """The ``stats`` frame's engine half when a ServeServer fronts
        the router: fleet aggregate + per-replica detail — one query
        answers for the whole fleet."""
        out = self.stats()
        out["role"] = self.role
        out["draining"] = self.draining
        with self._lock:
            out["per_replica"] = {n: r.describe()
                                  for n, r in self._replicas.items()}
        return out

    def close(self):
        """Stop the poller and close every client. Replicas are NOT
        told anything — their lifecycle belongs to whoever started
        them (drain them via recycle()/their own SIGTERM path)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._poll_stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(5.0)
        with self._lock:
            reps = list(self._replicas.values())
            clients = []
            for rep in reps:
                clients.extend(rep.idle)
                rep.idle.clear()
                if rep.control is not None:
                    clients.append(rep.control)
        for cl in clients:
            cl.close()
        _telemetry.journal_event("serve.router.stop")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
