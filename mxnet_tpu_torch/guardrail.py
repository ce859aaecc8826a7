"""Training guardrails — the PyTorch twin of ``mxnet_tpu/guardrail.py``:
numerical-fault containment and preemption safety for ``TrainStep.fit``,
and the graceful-shutdown handler the serving engine shares.

* **Non-finite detection on the device.** The guarded step computes an
  all-finite flag over the loss outputs and the (scaled) gradients as a
  0-d tensor on the card (``ops/optimizer_kernels.norm_finite``: one
  kernel over every gradient) and masks the whole update there when it
  is false: parameters, optimizer state and BatchNorm statistics keep
  their bits. The host reads the flag at the dispatch window's wait it
  pays anyway, so detection adds no blocking host sync.
* :class:`DynamicLossScaler` — grow-on-N-good-steps / halve-on-overflow
  loss scaling (``MXNET_LOSS_SCALE=dynamic|<float>``); its state rides
  the step's aux dict under reserved ``__gr_*`` keys, on the device, and
  in checkpoints. Scales are powers of two, so unscaling is exact.
* :class:`EscalationPolicy` — after ``MXNET_MAX_BAD_STEPS`` consecutive
  masked steps the fit loop rolls back to the newest readable checkpoint
  (the lr times ``MXNET_ROLLBACK_LR_FACTOR``); after
  ``MXNET_MAX_ROLLBACKS`` rollbacks it raises :class:`NumericalDivergence`.
* :class:`GracefulShutdown` — a SIGTERM/SIGINT handler that chains the
  previous one and requests a checkpoint at the next step boundary; the
  fit loop exits with :data:`EXIT_PREEMPTED` and a rerun resumes there.
* ``nan@N`` / ``sigterm@N`` rules of ``MXNET_FAULT_SPEC``
  (``parallel/resilience.py``) drive both paths deterministically.
* :func:`durable_replace` — crash-durable atomic publish (fsync the file,
  rename, fsync the directory) for checkpoints.
"""
from __future__ import annotations

import contextlib
import logging
import math
import os
import signal

import torch

from . import config as _config
from . import telemetry as _telemetry
from . import trace as _trace

__all__ = ["NumericalDivergence", "RollbackNeeded", "PreemptionSignal",
           "DynamicLossScaler", "EscalationPolicy", "GracefulShutdown",
           "FitGuard", "GuardSpec", "all_finite", "mask_stats",
           "check_and_mask", "durable_replace", "fsync_file",
           "EXIT_PREEMPTED", "GR_PREFIX", "SCALE_KEY", "GOOD_KEY"]

# process exit code of a preemption-triggered boundary-checkpoint exit:
# a relauncher tells "resume me" (this) from a crash (anything else);
# 128+15 (a shell's SIGTERM death) would be indistinguishable
EXIT_PREEMPTED = 83

# reserved aux key space for guardrail state carried through the step
# (saved in checkpoints as ordinary aux entries)
GR_PREFIX = "__gr_"
SCALE_KEY = "__gr_loss_scale__"
GOOD_KEY = "__gr_good_steps__"


class NumericalDivergence(RuntimeError):
    """Training diverged numerically and the guardrails are exhausted:
    MXNET_MAX_BAD_STEPS consecutive steps produced non-finite loss or
    gradients even after MXNET_MAX_ROLLBACKS checkpoint rollbacks (or
    there was no checkpoint to roll back to). The weights are still
    finite — every bad update was masked on the device."""


class RollbackNeeded(Exception):
    """Internal control flow: the consecutive-bad-step threshold fired;
    the fit loop must restore the newest readable checkpoint. Never
    escapes fit (it becomes NumericalDivergence when rollback is
    impossible or exhausted)."""


class PreemptionSignal(Exception):
    """Internal control flow: a graceful-shutdown request was observed
    at a step boundary inside an epoch loop; carries the number of
    batches already trained this epoch."""

    def __init__(self, nbatch):
        super().__init__("preemption requested at batch %d" % nbatch)
        self.nbatch = nbatch


# ---------------------------------------------------------------------------
# device-side helpers (plain torch: no host sync)
# ---------------------------------------------------------------------------

def all_finite(tensors):
    """0-d bool tensor: every element of every tensor is finite. Plain
    torch, one reduction a tensor; the fit step uses the one-kernel
    ``ops.optimizer_kernels.norm_finite`` instead."""
    tensors = list(tensors)
    if not tensors:
        return torch.tensor(True)
    flags = [torch.isfinite(t).all() for t in tensors]
    ok = flags[0]
    for f in flags[1:]:
        ok = torch.logical_and(ok, f.to(ok.device))
    return ok


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def mask_stats(stats, ok):
    """Zero a metric stats tree where ``ok`` is False — a masked step
    contributes to neither ``sum`` nor ``num``."""
    return _tree_map(lambda s: torch.where(ok, s, torch.zeros_like(s)),
                     stats)


def check_and_mask(grads, outs):
    """(ok, grads zeroed where ok is False): the all-finite flag over
    grads and outputs, and ``where`` (``nan * 0`` is NaN) on the device."""
    grads = list(grads)
    ok = all_finite(grads + list(outs))
    return ok, [torch.where(ok, g, torch.zeros_like(g)) for g in grads]


# ---------------------------------------------------------------------------
# dynamic loss scaling
# ---------------------------------------------------------------------------

class DynamicLossScaler:
    """Grow/halve loss-scale state machine, evaluated on the device
    inside the step (no host sync).

    The scale multiplies the head cotangent (every loss head propagates
    the incoming head-grad scale), so the whole backward carries it; the
    gradients are unscaled (exactly: powers of two) before clipping and
    the update. Overflow (a non-finite scaled gradient) halves the scale
    and masks the step; ``window`` consecutive good steps double it, up
    to ``max_scale``."""

    def __init__(self, init_scale=2.0 ** 16, window=None, dynamic=True,
                 max_scale=2.0 ** 24, min_scale=1.0):
        self.init_scale = float(init_scale)
        self.window = int(window if window is not None
                          else _config.get("MXNET_LOSS_SCALE_WINDOW"))
        self.dynamic = bool(dynamic)
        self.max_scale = float(max_scale)
        self.min_scale = float(min_scale)

    @staticmethod
    def from_env():
        """None (off), a dynamic scaler, or a static one — from
        ``MXNET_LOSS_SCALE`` ('', 'dynamic', or a float literal)."""
        raw = str(_config.get("MXNET_LOSS_SCALE")).strip()
        if not raw:
            return None
        if raw.lower() == "dynamic":
            return DynamicLossScaler()
        try:
            scale = float(raw)
        except ValueError:
            raise ValueError(
                "MXNET_LOSS_SCALE must be '', 'dynamic', or a float, "
                "got %r" % raw)
        if not scale > 0:
            raise ValueError("MXNET_LOSS_SCALE must be positive, got %r"
                             % raw)
        # snap to the nearest power of two: scale/unscale cancels bit
        # for bit only for exponent-shift scales
        pow2 = 2.0 ** round(math.log2(scale))
        if pow2 != scale:
            logging.getLogger(__name__).warning(
                "MXNET_LOSS_SCALE=%s rounded to the nearest power of "
                "two (%g) to keep scale/unscale numerically exact",
                raw, pow2)
        return DynamicLossScaler(init_scale=pow2, dynamic=False)

    def init_aux(self, device=None):
        """Fresh device-state entries for the step's aux dict."""
        return {SCALE_KEY: torch.tensor(self.init_scale,
                                        dtype=torch.float32, device=device),
                GOOD_KEY: torch.tensor(0.0, dtype=torch.float32,
                                       device=device)}

    def next_state(self, scale, good, finite):
        """The update rule on 0-d tensors: (new_scale, new_good_steps)."""
        if not self.dynamic:
            return scale, good
        zero = torch.zeros_like(good)
        good_next = torch.where(finite, good + 1.0, zero)
        grow = good_next >= float(self.window)
        new_scale = torch.where(
            finite,
            torch.where(grow, torch.clamp(scale * 2.0, max=self.max_scale),
                        scale),
            torch.clamp(scale * 0.5, min=self.min_scale))
        good_next = torch.where(torch.logical_or(grow, ~finite), zero,
                                good_next)
        return new_scale, good_next


class GuardSpec:
    """What the guarded step needs to know: detection is implied by the
    spec's existence; ``scaler`` is the optional loss scaler."""

    def __init__(self, scaler=None):
        self.scaler = scaler


# ---------------------------------------------------------------------------
# host-side escalation
# ---------------------------------------------------------------------------

class EscalationPolicy:
    """Consecutive-bad-step accounting and the rollback budget.

    ``record(finite)`` is fed every drained step flag; it raises
    :class:`RollbackNeeded` when the streak reaches ``max_bad_steps``.
    The fit loop then calls :meth:`begin_rollback` (which raises
    :class:`NumericalDivergence` once the budget is spent) before
    restoring the newest readable checkpoint."""

    def __init__(self, max_bad_steps=None, max_rollbacks=None,
                 lr_factor=None, logger=None):
        self.max_bad_steps = int(
            max_bad_steps if max_bad_steps is not None
            else _config.get("MXNET_MAX_BAD_STEPS"))
        self.max_rollbacks = int(
            max_rollbacks if max_rollbacks is not None
            else _config.get("MXNET_MAX_ROLLBACKS"))
        self.lr_factor = float(
            lr_factor if lr_factor is not None
            else _config.get("MXNET_ROLLBACK_LR_FACTOR"))
        self.log = logger or logging.getLogger(__name__)
        self.bad_streak = 0
        self.masked_steps = 0
        self.rollbacks_done = 0
        self.lr_mult = 1.0

    def record(self, finite):
        """Feed one drained step flag; raises RollbackNeeded when the
        consecutive-bad-step threshold fires."""
        if finite:
            self.bad_streak = 0
            return
        self.masked_steps += 1
        self.bad_streak += 1
        _telemetry.counter("guardrail.masked_steps").inc()
        _telemetry.journal_event("guardrail.masked_step",
                                 streak=self.bad_streak,
                                 total=self.masked_steps)
        _trace.instant("guardrail.masked_step", streak=self.bad_streak,
                       total=self.masked_steps)
        self.log.warning(
            "guardrail: non-finite step detected and masked on device "
            "(%d consecutive, %d total)", self.bad_streak,
            self.masked_steps)
        if self.bad_streak >= self.max_bad_steps:
            raise RollbackNeeded()

    def begin_rollback(self):
        """Account one rollback attempt; NumericalDivergence when the
        budget is exhausted. On success the LR multiplier shrinks by
        ``lr_factor`` and the streak resets."""
        if self.rollbacks_done >= self.max_rollbacks:
            _telemetry.journal_event(
                "guardrail.divergence",
                reason="MXNET_MAX_ROLLBACKS exhausted",
                rollbacks=self.rollbacks_done,
                masked_steps=self.masked_steps)
            raise NumericalDivergence(
                "training diverged: %d consecutive non-finite steps "
                "after %d rollback(s) (%d masked steps total); "
                "MXNET_MAX_ROLLBACKS exhausted"
                % (self.bad_streak, self.rollbacks_done,
                   self.masked_steps))
        self.rollbacks_done += 1
        self.bad_streak = 0
        self.lr_mult *= self.lr_factor
        _telemetry.counter("guardrail.rollbacks").inc()
        _telemetry.journal_event("guardrail.rollback",
                                 rollback=self.rollbacks_done,
                                 lr_mult=self.lr_mult)
        _trace.instant("guardrail.rollback",
                       rollback=self.rollbacks_done,
                       lr_mult=self.lr_mult)

    def no_checkpoint(self, why):
        """Rollback is needed but impossible — typed failure."""
        _telemetry.journal_event("guardrail.divergence", reason=why,
                                 masked_steps=self.masked_steps)
        raise NumericalDivergence(
            "training diverged: %d consecutive non-finite steps and no "
            "checkpoint to roll back to (%s)" % (self.bad_streak, why))

    def report(self):
        return {"masked_steps": self.masked_steps,
                "rollbacks": self.rollbacks_done,
                "lr_mult": self.lr_mult}


class GracefulShutdown:
    """Chaining SIGTERM/SIGINT handler requesting a graceful stop.

    The handler only sets a flag; a serving engine drains its queue.
    The previously-installed handler is CHAINED, not clobbered (except
    SIG_DFL and the default SIGINT KeyboardInterrupt raiser).
    Installation from a non-main thread degrades to a no-op instead of
    raising.

    on_request: optional callable invoked FROM THE HANDLER when a
    signal arrives (before chaining). It must be signal-safe: set
    flags/events only — no locks that user threads hold, no telemetry,
    no device work. action describes the graceful path in the
    handler's log line."""

    def __init__(self, signals=None, logger=None, on_request=None,
                 action=None):
        self._signals = tuple(signals if signals is not None
                              else (signal.SIGTERM, signal.SIGINT))
        self._prev = {}
        self._installed = False
        self._log = logger or logging.getLogger(__name__)
        self._on_request = on_request
        self._action = action or "graceful stop requested"
        self.requested = False

    def _handler(self, signum, frame):
        # deliberately NO telemetry here: the handler can interrupt a
        # thread holding the journal/counter lock mid-write, and those
        # locks are not reentrant
        self.requested = True
        if self._on_request is not None:
            try:
                self._on_request()
            except Exception:
                # a signal handler must never propagate — the chained
                # handler below still runs, and `requested` is set
                pass
        self._log.warning("guardrail: received signal %d — %s",
                          signum, self._action)
        prev = self._prev.get(signum)
        if callable(prev) and prev is not signal.default_int_handler:
            prev(signum, frame)

    @property
    def installed(self):
        return self._installed

    def install(self):
        if self._installed:
            return self
        try:
            for sig in self._signals:
                self._prev[sig] = signal.getsignal(sig)
                signal.signal(sig, self._handler)
            self._installed = True
        except ValueError:
            # non-main thread: signals can't be installed here; the
            # run simply has no graceful-shutdown window
            self._prev.clear()
        return self

    def uninstall(self):
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


# ---------------------------------------------------------------------------
# per-fit runtime
# ---------------------------------------------------------------------------

class FitGuard:
    """Everything a fit loop needs, bundled: the step's spec (None =
    detection off), the host escalation policy, the graceful shutdown
    handler (None when the run has no checkpoint_prefix to write a
    boundary checkpoint to), and the deterministic step-fault poller."""

    def __init__(self, spec, policy, shutdown, logger=None):
        self.spec = spec
        self.policy = policy
        self.shutdown = shutdown
        self.log = logger or logging.getLogger(__name__)

    @classmethod
    def create(cls, logger=None, checkpointing=False):
        detect = bool(_config.get("MXNET_GUARDRAIL"))
        scaler = DynamicLossScaler.from_env()
        if scaler is not None:
            detect = True    # scaling needs the overflow flag
        spec = GuardSpec(scaler=scaler) if detect else None
        policy = EscalationPolicy(logger=logger) if detect else None
        shutdown = GracefulShutdown(
            logger=logger,
            action="will checkpoint at the next step boundary and exit %d"
            % EXIT_PREEMPTED) if checkpointing else None
        return cls(spec, policy, shutdown, logger=logger)

    @property
    def lr_mult(self):
        return self.policy.lr_mult if self.policy is not None else 1.0

    def preempt_requested(self):
        return self.shutdown is not None and self.shutdown.requested

    def shutdown_scope(self):
        """Context manager installing the chaining handlers for the
        duration of fit (no-op when shutdown is disabled)."""
        if self.shutdown is None:
            return contextlib.nullcontext()
        return self.shutdown

    def poll_faults(self):
        """Once per training step: consult the active FaultInjector's
        step-indexed rules. A ``sigterm@N`` hit raises a real SIGTERM
        through the installed chaining handler (no-op without one —
        counting still advances). Returns the gradient multiplier for
        this step: 1.0, or NaN on a ``nan@N`` hit, which rides into the
        step and exercises the real detection path."""
        from .parallel import resilience
        inj = resilience.active_injector()
        if inj is None:
            return 1.0
        fire_nan = inj.on_train_step("nan")
        if inj.on_train_step("sigterm") and self.shutdown is not None \
                and self.shutdown.installed:
            # only with the chaining handler really installed (install()
            # is a no-op off the main thread, and a raw SIGTERM there
            # would kill the process uncheckpointed)
            signal.raise_signal(signal.SIGTERM)
        return float("nan") if fire_nan else 1.0

    def report(self):
        return self.policy.report() if self.policy is not None else {}


# ---------------------------------------------------------------------------
# crash-durable checkpoint publish
# ---------------------------------------------------------------------------

def fsync_file(path):
    """fsync a file by path (works regardless of which fd wrote it)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def durable_replace(tmp_path, final_path):
    """Crash-durable atomic publish: fsync the tmp file's bytes, rename
    over the destination, then fsync the containing directory so the
    rename itself survives power loss."""
    fsync_file(tmp_path)
    os.replace(tmp_path, final_path)
    dir_path = os.path.dirname(os.path.abspath(final_path)) or "."
    try:
        dfd = os.open(dir_path, os.O_RDONLY)
    except OSError:          # platforms that can't open directories
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)
