"""The pieces of ``mxnet_tpu/profiler.py`` that serving and the fit loop
use: device-memory sampling, the blocking-host-sync counter and the
per-step marker. The profiler proper (host timeline, ``torch.profiler``
device traces, ``dump_profile``) comes with ROADMAP Queue A item 9b.5."""
from __future__ import annotations

import torch

from . import telemetry as _telemetry

__all__ = ["sample_device_memory", "count_host_sync", "host_sync_count",
           "reset_host_sync_count", "step_scope"]

# -- blocking-host-sync accounting ------------------------------------------
# The fit loop's claim "at most one blocking host sync a step" is asserted
# by tests against this counter, so it is always on (one locked int
# increment). Counted sites: NDArray.asnumpy / wait_to_read, the metric
# accumulator's read in EvalMetric.get, and the fit loop's dispatch-window
# waits. The count lives in the telemetry registry ("host_syncs").

_HOST_SYNCS = _telemetry.counter("host_syncs")


def count_host_sync(kind="sync"):
    """Count one blocking host synchronization (a device-to-host read or
    a wait for the card). ``kind`` names the site."""
    _HOST_SYNCS.inc()


def host_sync_count():
    """Monotonic count of blocking host syncs since import (tests take
    deltas around the region under scrutiny)."""
    return _HOST_SYNCS.value


def reset_host_sync_count():
    _HOST_SYNCS.reset()


class step_scope:
    """Step marker for training loops: one ``torch.profiler``
    ``record_function`` range named ``train_step#N`` around the step, so
    a device trace groups each step's kernels under it."""

    def __init__(self, step_num, name="train_step"):
        self.name = name
        self.step_num = int(step_num)
        self._ctx = None

    def __enter__(self):
        self._ctx = torch.profiler.record_function(
            "%s#%d" % (self.name, self.step_num))
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        return False


def sample_device_memory(site="boundary"):
    """Device-memory watermark sample into the ``mem.hbm_bytes_in_use``
    / ``mem.hbm_peak_bytes`` gauges, from PyTorch's caching allocator on
    the current CUDA device. A host-side read: no device sync. Returns
    ``{"bytes_in_use", "peak_bytes_in_use"}``, or None when CUDA has not
    been initialized in this process (nothing to sample)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    in_use = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    _telemetry.gauge("mem.hbm_bytes_in_use").set(in_use)
    _telemetry.gauge("mem.hbm_peak_bytes").set(peak)
    _telemetry.journal_event("mem.sample", site=site,
                             bytes_in_use=in_use, peak_bytes=peak)
    return {"bytes_in_use": in_use, "peak_bytes_in_use": peak}
