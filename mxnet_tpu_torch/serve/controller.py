"""Fleet controller: the serving fleet operates itself
(docs/serving.md §fleet controller).

The :class:`~mxnet_tpu_torch.serve.ServeRouter` can dispatch, drain,
recycle and re-warm replicas, and its poller already sees every load
signal — but a human has to watch the gauges and act.
:class:`FleetController` closes that loop: it supervises one router
against a declared capacity policy and turns the polled signals into
actions.

* **Health-gated autoscaling** — sustained queue depth (or a shedding
  window) scales out through a caller-supplied ``spawn()`` hook; the
  new replica warms its declared buckets BEFORE admitting traffic
  (``add_replica(warm=True)``). A sustained idle window scales in
  through the router's zero-drop ``retire_replica`` drain. Hysteresis
  (``MXNET_CTRL_SUSTAIN`` consecutive ticks) and a post-action
  cooldown (``MXNET_CTRL_COOLDOWN`` ticks) keep a noisy signal from
  flapping the fleet. Both are counted in TICKS, never wall time, so
  every decision is deterministic under ``tick()``-driven tests.
* **Self-healing** — a replica the poller marked suspect whose control
  probe confirms dead is retired and respawned under the SAME name;
  in-flight generates ride the router's token-exact failover path, so
  healing changes nobody's tokens. Healing is exempt from cooldown —
  a dead replica is replaced immediately.
* **Rolling rollout with automatic rollback** — :meth:`rollout`
  promotes a new ``Predictor.export_buckets`` artifact
  (manifest-addressed) replica by replica through
  ``router.recycle(restart=)``, gating every step on a health probe:
  the promoted replica must come back live, carry the new artifact's
  ``model_id`` stamp, answer a canary infer within
  ``MXNET_CTRL_CANARY_TIMEOUT``, and keep its shed window under the
  policy. A failed gate rolls every already-promoted replica BACK to
  the prior manifest — the fleet is never left mixed-version after
  the controller returns.
* **Crash-safe state** — every action journals through
  ``guardrail.durable_replace`` atomic writes. A controller restarted
  on the same journal resumes: a rollout that died mid-promote is
  rolled back to the prior manifest on the next :meth:`tick` instead
  of being re-decided from scratch.

The controller owns NO transport: every byte still rides the router's
``serve/net.py`` clients (the serve lint holds), and every decision
reads the router's polled state (the ``poll_now()`` discipline —
``MXNET_CTRL_POLL_MS=0`` disables the background loop and tests drive
:meth:`tick` explicitly, no wall-clock sleeps anywhere).
"""
from __future__ import annotations

import json
import logging
import math
import os
import threading

from .. import config as _config
from .. import telemetry as _telemetry
from .. import trace as _trace
from ..guardrail import durable_replace
from .router import ReplicaState

__all__ = ["FleetController", "RolloutResult"]

_JOURNAL_VERSION = 1
_MAX_ACTIONS = 256                 # journaled action-log bound


class RolloutResult:
    """What :meth:`FleetController.rollout` did: which replicas were
    promoted, whether the fleet rolled back, and the manifest the
    fleet uniformly serves now."""

    __slots__ = ("promoted", "rolled_back", "manifest", "reason")

    def __init__(self, promoted, rolled_back, manifest, reason=None):
        self.promoted = list(promoted)
        self.rolled_back = bool(rolled_back)
        self.manifest = manifest
        self.reason = reason

    def __repr__(self):
        return ("RolloutResult(promoted=%r, rolled_back=%r, "
                "manifest=%r, reason=%r)"
                % (self.promoted, self.rolled_back, self.manifest,
                   self.reason))


def _checked(name, value, typ, low=None, finite=False):
    value = typ(value)
    if low is not None and value < low:
        raise ValueError("%s must be >= %r, got %r" % (name, low, value))
    if finite and not math.isfinite(value):
        raise ValueError("%s must be finite, got %r" % (name, value))
    return value


class FleetController:
    """Supervise a :class:`ServeRouter` against a capacity policy.

    Parameters
    ----------
    router : ServeRouter
        The fleet to supervise. The controller polls it, scales it,
        heals it and rolls artifacts through it; it never owns the
        replica processes themselves.
    spawn : callable
        ``spawn(manifest) -> address`` — start one replica serving the
        given ``export_buckets`` manifest (``None`` = the caller's
        current/default artifact) and return its ``"host:port"`` /
        ``(host, port)`` once it answers the wire. The controller's
        only way to create capacity.
    retire : callable, optional
        ``retire(name, address)`` — reap a replica process the
        controller just drained-and-removed (scale-in) or declared
        dead (heal). Omitted: the caller leak-checks its own
        processes.
    journal : str, optional
        Path for the crash-safe state file (atomic
        ``durable_replace`` rewrites after every action). An existing
        file is LOADED: the controller resumes its manifest and
        finishes any interrupted rollout (by rolling back) on the
        next :meth:`tick`. Omitted: state is process-local.
    canary_inputs : list of array, optional
        Inputs for the rollout health gate's canary infer (batch-1
        shaped like a live request). Omitted: the gate skips the
        canary and checks liveness/stamp/shed only.
    clock : callable, optional
        Timestamp source for journal records (default
        ``telemetry.now_ms``). Decisions never read it — hysteresis
        and cooldown count ticks, so tests inject nothing and still
        get determinism.
    min_replicas / max_replicas / scale_out_depth / scale_out_shed /
    scale_in_depth / sustain / cooldown / canary_timeout / poll_ms
        Override the ``MXNET_CTRL_*`` knobs (docs/env_vars.md). All
        validated loudly here.
    """

    def __init__(self, router, spawn, retire=None, *, journal=None,
                 canary_inputs=None, clock=None, logger=None,
                 min_replicas=None, max_replicas=None,
                 scale_out_depth=None, scale_out_shed=None,
                 scale_in_depth=None, sustain=None, cooldown=None,
                 canary_timeout=None, poll_ms=None):
        if not callable(spawn):
            raise ValueError("spawn must be callable, got %r" % (spawn,))
        if retire is not None and not callable(retire):
            raise ValueError("retire must be callable, got %r"
                             % (retire,))
        self._router = router
        self._spawn = spawn
        self._retire = retire
        self._log = logger or logging.getLogger(__name__)
        self._now = clock or _telemetry.now_ms
        self._canary_inputs = canary_inputs

        def knob(override, name):
            return override if override is not None \
                else _config.get(name)
        self._min = _checked(
            "MXNET_CTRL_MIN_REPLICAS",
            knob(min_replicas, "MXNET_CTRL_MIN_REPLICAS"), int, low=1)
        self._max = _checked(
            "MXNET_CTRL_MAX_REPLICAS",
            knob(max_replicas, "MXNET_CTRL_MAX_REPLICAS"), int,
            low=self._min)
        self._out_depth = _checked(
            "MXNET_CTRL_SCALE_OUT_DEPTH",
            knob(scale_out_depth, "MXNET_CTRL_SCALE_OUT_DEPTH"), float,
            low=0.0, finite=True)
        self._out_shed = _checked(
            "MXNET_CTRL_SCALE_OUT_SHED",
            knob(scale_out_shed, "MXNET_CTRL_SCALE_OUT_SHED"), float,
            finite=True)
        if self._out_shed <= 0:
            raise ValueError(
                "MXNET_CTRL_SCALE_OUT_SHED must be > 0 (a zero "
                "threshold would scale out on every single shed), "
                "got %r" % self._out_shed)
        self._in_depth = _checked(
            "MXNET_CTRL_SCALE_IN_DEPTH",
            knob(scale_in_depth, "MXNET_CTRL_SCALE_IN_DEPTH"), float,
            low=0.0, finite=True)
        if self._in_depth >= self._out_depth:
            raise ValueError(
                "MXNET_CTRL_SCALE_IN_DEPTH (%r) must be below "
                "MXNET_CTRL_SCALE_OUT_DEPTH (%r) — an overlapping "
                "band would scale in and out of the same signal"
                % (self._in_depth, self._out_depth))
        self._sustain = _checked(
            "MXNET_CTRL_SUSTAIN",
            knob(sustain, "MXNET_CTRL_SUSTAIN"), int, low=1)
        self._cooldown = _checked(
            "MXNET_CTRL_COOLDOWN",
            knob(cooldown, "MXNET_CTRL_COOLDOWN"), int, low=0)
        self._canary_timeout = _checked(
            "MXNET_CTRL_CANARY_TIMEOUT",
            knob(canary_timeout, "MXNET_CTRL_CANARY_TIMEOUT"), float,
            finite=True)
        if self._canary_timeout <= 0:
            raise ValueError(
                "MXNET_CTRL_CANARY_TIMEOUT must be positive, got %r"
                % self._canary_timeout)
        self._poll_ms = _checked(
            "MXNET_CTRL_POLL_MS",
            knob(poll_ms, "MXNET_CTRL_POLL_MS"), float, low=0.0,
            finite=True)

        # decision state: tick-counted, never wall-clocked
        self._ticks = 0
        self._hot = 0                  # consecutive over-threshold ticks
        self._cold = 0                 # consecutive idle ticks
        self._cooldown_until = 0       # tick number scaling resumes at
        self._manifest = None          # the artifact the fleet serves
        self._pending = None           # interrupted-rollout record
        self._actions = []
        self._op_lock = threading.Lock()   # tick/rollout serialization

        # the serve.ctrl.* vocabulary (docs/observability.md). These
        # counters are registered HERE — a process that never builds a
        # controller never publishes them, so the pre-controller perf
        # baselines stay byte-identical (the router's precedent)
        self._c_scale_outs = _telemetry.counter("serve.ctrl.scale_outs")
        self._c_scale_ins = _telemetry.counter("serve.ctrl.scale_ins")
        self._c_heals = _telemetry.counter("serve.ctrl.heals")
        self._c_promotes = _telemetry.counter("serve.ctrl.promotes")
        self._c_rollbacks = _telemetry.counter("serve.ctrl.rollbacks")

        self._journal_path = journal
        if journal and os.path.exists(journal):
            self._load_journal()
        _telemetry.journal_event(
            "serve.ctrl.start", min_replicas=self._min,
            max_replicas=self._max, resumed=self._pending is not None)

        self._closed = False
        self._tick_thread = None
        self._tick_stop = threading.Event()
        if self._poll_ms > 0:
            self._tick_thread = threading.Thread(
                target=self._tick_loop, name="mxnet-ctrl-tick",
                daemon=True)
            self._tick_thread.start()

    # -- crash-safe journal -------------------------------------------------
    def _load_journal(self):
        with open(self._journal_path) as f:
            doc = json.load(f)
        if doc.get("version") != _JOURNAL_VERSION:
            raise ValueError(
                "controller journal %s has version %r, this build "
                "reads %d — refusing to guess at its semantics"
                % (self._journal_path, doc.get("version"),
                   _JOURNAL_VERSION))
        self._manifest = doc.get("manifest")
        self._pending = doc.get("pending_rollout")
        self._actions = list(doc.get("actions") or [])[-_MAX_ACTIONS:]

    def _save_journal(self):
        if not self._journal_path:
            return
        doc = {"version": _JOURNAL_VERSION,
               "manifest": self._manifest,
               "pending_rollout": self._pending,
               "actions": self._actions[-_MAX_ACTIONS:]}
        tmp = self._journal_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        durable_replace(tmp, self._journal_path)

    def _record(self, action, **fields):
        """One action: journal event + durable state write. The event
        rides the telemetry journal (operators), the state file makes
        a restarted controller resume instead of re-deciding."""
        rec = {"action": action, "t": self._now()}
        rec.update(fields)
        self._actions.append(rec)
        del self._actions[:-_MAX_ACTIONS]
        _telemetry.journal_event("serve.ctrl.%s" % action, **fields)
        self._save_journal()

    # -- the decision step --------------------------------------------------
    def tick(self):
        """One deterministic supervision step: poll the fleet, finish
        any journal-recovered rollout, heal confirmed-dead replicas,
        then evaluate the scale policy (hysteresis + cooldown, all
        tick-counted). Returns ``{"healed": [...], "scaled_out": [...],
        "scaled_in": [...], "recovered": bool}`` describing what this
        tick actually did. The background loop calls this every
        ``MXNET_CTRL_POLL_MS``; deterministic tests call it directly
        (the ``poll_now()`` discipline — no sleeps anywhere)."""
        with self._op_lock:
            return self._tick_locked()

    def _tick_locked(self):
        self._ticks += 1
        out = {"healed": [], "scaled_out": [], "scaled_in": [],
               "recovered": False}
        if self._pending is not None:
            # a previous controller died mid-rollout (the journal
            # still holds the pending record): restore the invariant
            # FIRST — a mixed-version fleet must not also be scaled
            self._recover_pending()
            out["recovered"] = True
        self._router.poll_now()
        reps = self._router.replicas()

        # -- heal: suspect + probe-confirmed dead -> retire + respawn
        for name, desc in list(reps.items()):
            if desc["state"] != ReplicaState.SUSPECT:
                continue
            if self._router.probe_replica(name):
                continue               # a blip; the poller revives it
            self._heal(name, desc)
            out["healed"].append(name)
        if out["healed"]:
            self._router.poll_now()
            reps = self._router.replicas()

        # -- scale signals over the routable fleet ----------------------
        live = {n: d for n, d in reps.items()
                if d["state"] == ReplicaState.LIVE
                and not d["stats"].get("draining")}
        n_live = len(live)
        if not n_live:
            return out                 # nothing routable: healing only
        depth = sum(d["stats"].get("queue_depth", 0)
                    for d in live.values()) / n_live
        shed = sum(d["stats"].get("shed_rate", 0)
                   for d in live.values())
        hot = depth >= self._out_depth or shed >= self._out_shed
        cold = depth <= self._in_depth and shed == 0
        # hysteresis: an oscillating signal keeps resetting the
        # streak and never moves the fleet
        self._hot = self._hot + 1 if hot else 0
        self._cold = self._cold + 1 if cold else 0
        if self._ticks < self._cooldown_until:
            return out                 # observing the last action
        if self._hot >= self._sustain and n_live < self._max:
            name = self._scale_out(depth, shed)
            if name is not None:
                out["scaled_out"].append(name)
        elif self._cold >= self._sustain and n_live > self._min:
            name = self._scale_in(live, depth)
            if name is not None:
                out["scaled_in"].append(name)
        return out

    def _arm_cooldown(self):
        self._hot = self._cold = 0
        self._cooldown_until = self._ticks + self._cooldown

    def _scale_out(self, depth, shed):
        addr = self._spawn(self._manifest)
        host, port = _split_addr(addr)
        name = self._router.add_replica(host, port, warm=True)
        self._c_scale_outs.inc()
        self._arm_cooldown()
        self._record("scale_out", name=name,
                     addr="%s:%d" % (host, port),
                     depth=round(depth, 3), shed_rate=shed)
        self._log.info("ctrl: scaled out -> %s at %s:%d "
                       "(depth %.2f, shed %s)", name, host, port,
                       depth, shed)
        return name

    def _scale_in(self, live, depth):
        # victim: the last-admitted live replica (insertion order) —
        # the longest-standing replicas keep their warmed caches and
        # session gravity
        name = next(reversed(list(live)))
        desc = live[name]
        addr = "%s:%d" % (desc["host"], desc["port"])
        self._router.retire_replica(name)      # zero-drop drain+remove
        if self._retire is not None:
            self._retire(name, addr)
        self._c_scale_ins.inc()
        self._arm_cooldown()
        self._record("scale_in", name=name, addr=addr,
                     depth=round(depth, 3))
        self._log.info("ctrl: scaled in -> retired %s at %s (depth "
                       "%.2f)", name, addr, depth)
        return name

    def _heal(self, name, desc):
        addr = "%s:%d" % (desc["host"], desc["port"])
        if self._retire is not None:
            self._retire(name, addr)           # reap the corpse
        self._router.remove_replica(name)
        new_addr = self._spawn(self._manifest)
        host, port = _split_addr(new_addr)
        # same name: in-flight generates pinned to the dead replica
        # already took the token-exact failover path the moment their
        # transport faulted; the respawn just restores capacity
        self._router.add_replica(host, port, name=name, warm=True)
        self._c_heals.inc()
        self._record("heal", name=name, dead_addr=addr,
                      addr="%s:%d" % (host, port))
        self._log.warning("ctrl: healed %s — dead at %s, respawned "
                          "at %s:%d", name, addr, host, port)

    # -- rolling rollout ----------------------------------------------------
    def rollout(self, manifest, model_id=None, canary_inputs=None):
        """Promote ``manifest`` (an ``export_buckets`` prefix) across
        the fleet, one replica at a time, each step gated on health.

        Every replica recycles through the router's zero-drop drain
        with a ``restart`` hook that retires the old process and
        spawns one serving ``manifest`` — and comes back QUARANTINED
        (``recycle(admit=False)``): warmed but unroutable, so live
        traffic cannot reach the candidate artifact while it is still
        unproven. The gate then requires: the quarantined replica
        answering its liveness probe, its hello-declared ``model_id``
        matching the new artifact's stamp, a canary infer answered
        within ``MXNET_CTRL_CANARY_TIMEOUT`` (when canary inputs are
        configured), and the shed window under the scale-out
        threshold. Only a passed gate admits the replica to traffic.
        A failed gate rolls the failed replica AND every
        already-promoted one back to the prior manifest — the fleet
        is uniform again before this returns, and no client request
        was ever routed to the rejected artifact.

        ``model_id``: the expected stamp; default reads it from
        ``manifest + ".serve.json"`` when that file is readable here,
        else the stamp check is skipped (the spawn hook may realize
        manifests on machines this process cannot read).

        Returns a :class:`RolloutResult`. Raises only when the
        recovery itself fails (a rollback recycle erroring) — the
        journal then still holds the pending record, and the next
        :meth:`tick` (or a restarted controller) retries the
        rollback."""
        with self._op_lock:
            return self._rollout_locked(manifest, model_id,
                                        canary_inputs)

    def _rollout_locked(self, manifest, model_id, canary_inputs):
        if self._pending is not None:
            self._recover_pending()
        if model_id is None:
            model_id = _manifest_stamp(manifest)
        prior = self._manifest
        names = list(self._router.replicas())
        self._pending = {"manifest": manifest, "prior": prior,
                         "model_id": model_id, "promoted": [],
                         "promoting": None}
        self._record("rollout", phase="start", manifest=str(manifest),
                     prior=str(prior), replicas=len(names))
        sp = _trace.start_span("serve.ctrl.rollout",
                               replicas=len(names))
        try:
            for name in names:
                self._pending["promoting"] = name
                self._save_journal()
                try:
                    self._promote(name, manifest, admit=False)
                except Exception as exc:   # noqa: BLE001 — a recycle/
                    # spawn error mid-promote: the failed replica may
                    # be on either version — roll back everything
                    # touched (it is in the pending record)
                    self._rollback("promote of %s failed: %s"
                                   % (name, exc))
                    return RolloutResult(
                        [], True, prior,
                        reason="promote of %s failed: %s (%s)"
                        % (name, exc, type(exc).__name__))
                self._pending["promoted"].append(name)
                self._pending["promoting"] = None
                self._save_journal()
                ok, reason = self._gate(name, model_id, canary_inputs)
                if not ok:
                    self._rollback("gate failed on %s: %s"
                                   % (name, reason))
                    return RolloutResult(
                        [], True, prior,
                        reason="gate failed on %s: %s" % (name, reason))
                self._router.admit_replica(name)
                self._c_promotes.inc()
                self._record("promote", name=name,
                             manifest=str(manifest))
            promoted = list(self._pending["promoted"])
            self._manifest = manifest
            self._pending = None
            self._record("rollout", phase="complete",
                         manifest=str(manifest), promoted=len(promoted))
            return RolloutResult(promoted, False, manifest)
        finally:
            _trace.end_span(sp)

    def _promote(self, name, manifest, admit=True):
        def restart():
            desc = self._router.replicas().get(name)
            if desc is not None and self._retire is not None:
                self._retire(name, "%s:%d" % (desc["host"],
                                              desc["port"]))
            return self._spawn(manifest)
        self._router.recycle(name, restart=restart, warm=True,
                             admit=admit)

    def _gate(self, name, model_id, canary_inputs):
        """The per-step health probe, run against the QUARANTINED
        candidate (still unroutable — only canary traffic can reach
        it). Returns ``(ok, reason)``."""
        self._router.poll_now()
        desc = self._router.replicas().get(name)
        if desc is None:
            return False, "replica vanished during promote"
        if not self._router.probe_replica(name):
            return False, "liveness probe failed after promote"
        if model_id is not None and desc.get("model_id") != model_id:
            return False, ("artifact stamp mismatch: hello says %r, "
                           "manifest says %r"
                           % (desc.get("model_id"), model_id))
        inputs = canary_inputs if canary_inputs is not None \
            else self._canary_inputs
        if inputs is not None:
            try:
                self._router.canary(name, inputs,
                                    timeout=self._canary_timeout)
            except Exception as exc:   # noqa: BLE001 — ANY failure —
                # typed replica error, timeout, transport fault — is
                # exactly what the gate exists to catch
                return False, ("canary failed: %s (%s)"
                               % (exc, type(exc).__name__))
            self._router.poll_now()
            desc = self._router.replicas().get(name) or desc
        if desc["stats"].get("shed_rate", 0) >= self._out_shed:
            return False, ("shed window over policy: %s >= %s"
                           % (desc["stats"]["shed_rate"],
                              self._out_shed))
        return True, None

    def _rollback(self, reason):
        """Restore the fleet to the pending record's prior manifest:
        recycle every touched replica (promoted + the one mid-promote)
        back, newest first. Clears the pending record only when every
        rollback recycle succeeded — a crash or error here leaves the
        journal intact for the next attempt."""
        pend = self._pending
        names = list(pend.get("promoted") or [])
        if pend.get("promoting") and pend["promoting"] not in names:
            names.append(pend["promoting"])
        prior = pend.get("prior")
        for name in reversed(names):
            if self._router.replicas().get(name) is None:
                continue               # vanished: nothing to restore
            self._promote(name, prior)
            self._c_rollbacks.inc()
            self._record("rollback", name=name, manifest=str(prior))
        self._manifest = prior
        self._pending = None
        self._record("rollout", phase="rolled_back",
                     reason=str(reason), replicas=len(names))
        self._log.warning("ctrl: rollout rolled back (%s) — fleet "
                          "uniform on %r", reason, prior)

    def _recover_pending(self):
        """Finish a journal-recovered rollout by rolling it back —
        the conservative resume: the prior manifest is the last state
        the journal PROVES every replica can serve."""
        self._log.warning("ctrl: resuming interrupted rollout from "
                          "journal — rolling back to %r",
                          self._pending.get("prior"))
        self._rollback("controller restarted mid-rollout")

    # -- lifecycle ----------------------------------------------------------
    @property
    def manifest(self):
        """The artifact the fleet uniformly serves (None = whatever
        the replicas were born with — no rollout has completed)."""
        return self._manifest

    def describe(self):
        """Controller introspection: policy, decision state, and the
        journaled action tail."""
        with self._op_lock:
            return {
                "min_replicas": self._min, "max_replicas": self._max,
                "scale_out_depth": self._out_depth,
                "scale_out_shed": self._out_shed,
                "scale_in_depth": self._in_depth,
                "sustain": self._sustain, "cooldown": self._cooldown,
                "ticks": self._ticks, "hot": self._hot,
                "cold": self._cold,
                "cooldown_until": self._cooldown_until,
                "manifest": self._manifest,
                "pending_rollout": self._pending is not None,
                "actions": list(self._actions),
            }

    def _tick_loop(self):
        failing = False
        while not self._tick_stop.wait(self._poll_ms / 1000.0):
            try:
                self.tick()
                failing = False
            except Exception:   # noqa: BLE001 — the supervision loop
                # must outlive any one failed action (a spawn hook
                # erroring, a drain timing out): log the first failure
                # of a streak loudly, repeats at debug
                if not failing:
                    self._log.exception(
                        "ctrl: tick failed — loop keeps running "
                        "(repeats logged at debug)")
                else:
                    self._log.debug("ctrl: tick failed again",
                                    exc_info=True)
                failing = True

    def close(self):
        """Stop the background loop. The router and the replicas stay
        up — the controller supervises, it does not own."""
        if self._closed:
            return
        self._closed = True
        self._tick_stop.set()
        if self._tick_thread is not None:
            self._tick_thread.join(5.0)
        _telemetry.journal_event("serve.ctrl.stop")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _split_addr(addr):
    if addr is None:
        raise ValueError("spawn() returned no address")
    if isinstance(addr, (tuple, list)):
        host, port = addr
        return str(host), int(port)
    host, _, port = str(addr).rpartition(":")
    if not host:
        raise ValueError("spawn() must return HOST:PORT or "
                         "(host, port), got %r" % (addr,))
    return host, int(port)


def _manifest_stamp(manifest):
    """The expected model_id of an export_buckets manifest, when its
    ``.serve.json`` is readable from this process (the spawn hook may
    realize manifests on machines this controller cannot read — then
    the stamp gate is skipped rather than guessed)."""
    if not isinstance(manifest, str):
        return None
    path = manifest + ".serve.json"
    try:
        with open(path) as f:
            return json.load(f).get("model_id")
    except (OSError, ValueError):
        return None
