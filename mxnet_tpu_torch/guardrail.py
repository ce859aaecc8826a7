"""The host-side pieces of ``mxnet_tpu/guardrail.py`` that serving and
telemetry need: the chaining graceful-shutdown signal handler and the
crash-durable atomic file publish.

The device-side numerical guardrail (non-finite step masking, loss
scaling, rollback) comes with the training step.
"""
from __future__ import annotations

import logging
import os
import signal

__all__ = ["GracefulShutdown", "durable_replace", "fsync_file"]


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
