"""Training callbacks: checkpointing, metric logging, throughput — a
copy of ``mxnet_tpu/callback.py`` (reference python/mxnet/callback.py),
which holds no JAX: epoch-end checkpoint factories and batch-end logging
callbacks used by the fit loops.
"""
from __future__ import annotations

import logging
import math
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def _every(period):
    """Normalize a period and return a due-predicate over epoch index."""
    period = max(1, int(period))
    return lambda epoch: (epoch + 1) % period == 0


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving a Module (symbol, params and, when asked,
    the optimizer states) every `period` epochs."""
    due = _every(period)

    def _callback(epoch_no, sym=None, arg=None, aux=None):
        if due(epoch_no):
            mod.save_checkpoint(prefix, epoch_no + 1,
                                save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback writing prefix-symbol.json + prefix-NNNN.params
    every `period` epochs."""
    from .model import save_checkpoint
    due = _every(period)

    def _callback(epoch_no, sym, arg, aux):
        if due(epoch_no):
            save_checkpoint(prefix, epoch_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the running training metric every
    `period` batches."""
    def _callback(param):
        metric = param.eval_metric
        if metric is not None and param.nbatch % period == 0:
            for name, value in metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                metric.reset()
    return _callback


class Speedometer:
    """Batch-end callback logging samples/sec (and the running metric)
    every `frequent` batches.

    When a telemetry run journal is active (``MXNET_TELEMETRY``,
    docs/observability.md) the throughput is sourced from the journal's
    per-step records — one timing source of truth with
    ``tools/telemetry_report.py`` — and the line additionally reports
    the window's mean and p95 batch time. Without a journal it falls
    back to its own wall-clock timer, exactly as before."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._last_time = None
        self._last_count = 0

    def _telemetry_timing(self):
        """(speed, extra-text) from the last `frequent` journal step
        records, or None when telemetry is off / hasn't seen enough
        steps yet (then the wall-clock fallback runs)."""
        from . import telemetry
        if telemetry.journal() is None:
            return None
        steps = telemetry.recent_steps(self.frequent)
        if len(steps) < self.frequent:
            return None
        # compile-flagged steps carry a one-off compile wall, not
        # steady-state batch time — same exclusion the report applies
        steps = [s for s in steps if not s.get("compile")]
        if len(steps) < max(2, self.frequent // 2):
            return None
        walls = sorted(float(s.get("wall_ms", 0.0)) for s in steps)
        total_s = sum(walls) / 1000.0
        if total_s <= 0.0:
            return None
        samples = sum(int(s.get("samples", self.batch_size))
                      for s in steps)
        p95 = telemetry.quantile(walls, 0.95)
        return samples / total_s, \
            "\tmean-batch: %.2f ms\tp95-batch: %.2f ms" \
            % (sum(walls) / len(walls), p95)

    def __call__(self, param):
        count = param.nbatch
        if count < self._last_count:
            self._last_time = None       # new epoch: restart the clock
        self._last_count = count

        if self._last_time is None:
            self._last_time = time.time()
            return
        if count % self.frequent != 0:
            return

        sourced = self._telemetry_timing()
        if sourced is not None:
            speed, timing = sourced
        else:
            elapsed = time.time() - self._last_time
            speed = self.frequent * self.batch_size / elapsed \
                if elapsed else 0.0
            timing = ""
        metric = param.eval_metric
        if metric is not None:
            pairs = metric.get_name_value()
            if self.auto_reset:
                metric.reset()
            text = "".join("\t%s=%f" % pair for pair in pairs)
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s%s",
                         param.epoch, count, speed, timing, text)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, count, speed, timing)
        self._last_time = time.time()


class ProgressBar:
    """Batch-end callback drawing an ASCII progress bar."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        filled = int(round(self.bar_len * frac))
        bar = "=" * filled + "-" * (self.bar_len - filled)
        logging.info("[%s] %s%s\r", bar, math.ceil(100.0 * frac), "%")


class LogValidationMetricsCallback:
    """Score-end callback logging each validation metric."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
