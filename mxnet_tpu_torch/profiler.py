"""Profiler — per-op host timeline + ``torch.profiler`` device traces
(``mx.profiler``); the PyTorch twin of ``mxnet_tpu/profiler.py``.

Reference: src/engine/profiler.{h,cc} (engine-integrated op stats, Chrome
trace-event JSON dump, profiler.h:122-127) and python/mxnet/profiler.py
(profiler_set_config / profiler_set_state / dump_profile).

Two layers:

- **Host timeline** (this module): eager dispatch (``mode='all'``) and
  executor runs are timed around their dispatch sites
  (``ops/registry.py`` ``invoke_eager``, ``executor.py``
  ``Executor.forward``/``backward``) and dumped as Chrome trace-event
  JSON — open in chrome://tracing or Perfetto, like the reference's
  dump. Durations are host-side: CUDA launches are asynchronous, so a
  step's device time shows up on the op that blocks (the reference's
  WaitToRead attribution).
- **Device traces**: when a trace directory is configured
  (``xplane_dir``, the JAX package's argument name, or
  MXNET_PROFILER_XPLANE), start/stop also drive a ``torch.profiler``
  trace with CPU and CUDA activities (CPU alone when CUDA is absent,
  because the caller then asked for the CPU), written as a Chrome trace
  into that directory: the per-kernel timeline. ``scope`` and
  ``step_scope`` also mark it.

When the profiler is stopped each dispatch site costs one attribute
read (``_P.timing_ops`` / ``_P.running``).

Env parity (docs/how_to/env_var.md:97-108): MXNET_PROFILER_AUTOSTART,
MXNET_PROFILER_MODE (0 => symbolic-only, 1 => all ops).

The blocking-host-sync counter, ``step_scope`` and
``sample_device_memory`` serve the fit loops and serving whether or not
the profiler runs.
"""
from __future__ import annotations

import json
import os
import threading
import time

import torch

from . import telemetry as _telemetry

__all__ = ["profiler_set_config", "profiler_set_state", "dump_profile",
           "set_config", "set_state", "dump", "State", "record_event",
           "scope", "is_running", "mode", "step_scope", "count_host_sync",
           "host_sync_count", "reset_host_sync_count",
           "sample_device_memory"]


class _ProfilerState:
    def __init__(self):
        self.mode = "symbolic"            # 'symbolic' | 'all'
        self.filename = "profile.json"
        self.xplane_dir = None
        self.running = False
        self.timing_ops = False           # running and mode == 'all'
        self.events = []
        self.lock = threading.Lock()
        self._tracing = False
        self._prof = None                 # the live torch.profiler.profile
        self.device_traces = []           # Chrome traces written, in order


_P = _ProfilerState()


class State:
    stop = "stop"
    run = "run"


def profiler_set_config(mode="symbolic", filename="profile.json",
                        xplane_dir=None, **_kwargs):
    """Configure the profiler (reference profiler.py:profiler_set_config;
    modes 'symbolic' = executor runs only, 'all' = every eager op too).
    ``xplane_dir``: the directory of the device trace (else
    MXNET_PROFILER_XPLANE; empty = none)."""
    if mode not in ("symbolic", "all"):
        raise ValueError("mode must be 'symbolic' or 'all'")
    _P.mode = mode
    _P.timing_ops = _P.running and mode == "all"
    _P.filename = filename
    from . import config as _config
    _P.xplane_dir = xplane_dir or \
        _config.get("MXNET_PROFILER_XPLANE") or None


def _start_device_trace():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    _P._prof = profile(activities=acts)
    _P._prof.start()
    _P._tracing = True


def _stop_device_trace():
    prof, _P._prof, _P._tracing = _P._prof, None, False
    prof.stop()
    os.makedirs(_P.xplane_dir, exist_ok=True)
    path = os.path.join(_P.xplane_dir, "trace_%d_%d.json" % (
        os.getpid(), len(_P.device_traces)))
    prof.export_chrome_trace(path)
    _P.device_traces.append(path)


def profiler_set_state(state="stop"):
    """Start/stop collection (reference profiler_set_state). Starting
    clears the host events; with a trace directory it also starts a
    device trace, which stopping writes into that directory
    (``device_traces`` lists the files)."""
    if state not in (State.stop, State.run):
        raise ValueError("state must be 'run' or 'stop'")
    was = _P.running
    _P.running = state == State.run
    _P.timing_ops = _P.running and _P.mode == "all"
    if _P.running and not was:
        with _P.lock:
            _P.events = []
        if _P.xplane_dir:
            _start_device_trace()
    elif was and not _P.running and _P._tracing:
        _stop_device_trace()


def is_running():
    return _P.running


def mode():
    return _P.mode


def record_event(name, category, start_us, dur_us, tid=0, args=None):
    """Append one complete ('X') trace event; called by the dispatch
    sites (ops/registry.py, executor.py)."""
    if not _P.running:
        return
    ev = {"name": name, "cat": category, "ph": "X",
          "ts": start_us, "dur": dur_us, "pid": 0, "tid": tid}
    if args:
        ev["args"] = args
    with _P.lock:
        _P.events.append(ev)


# -- blocking-host-sync accounting ------------------------------------------
# The fit loop's claim "at most one blocking host sync a step" is asserted
# by tests against this counter, so it is always on (one locked int
# increment). Counted sites: NDArray.asnumpy / wait_to_read, the metric
# accumulator's read in EvalMetric.get, the Monitor's batched read, and
# the fit loop's dispatch-window waits. The count lives in the telemetry
# registry ("host_syncs").

_HOST_SYNCS = _telemetry.counter("host_syncs")


def count_host_sync(kind="sync"):
    """Count one blocking host synchronization (a device-to-host read or
    a wait for the card). ``kind`` names the site; a timeline event when
    the profiler runs."""
    _HOST_SYNCS.inc()
    if _P.running:
        record_event("host_sync:" + kind, "sync",
                     time.perf_counter_ns() // 1000, 1)


def host_sync_count():
    """Monotonic count of blocking host syncs since import (tests take
    deltas around the region under scrutiny)."""
    return _HOST_SYNCS.value


def reset_host_sync_count():
    _HOST_SYNCS.reset()


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


class scope:
    """Context manager timing one region into the profile (and, while a
    device trace is live, into it as a ``torch.profiler``
    ``record_function`` range)."""

    def __init__(self, name, category="op"):
        self.name = name
        self.category = category
        self._ctx = None

    def __enter__(self):
        self._start = time.perf_counter_ns()
        if _P._tracing:
            self._ctx = torch.profiler.record_function(self.name)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
        end = time.perf_counter_ns()
        record_event(self.name, self.category, self._start // 1000,
                     max((end - self._start) // 1000, 1))
        return False


class step_scope:
    """Step marker for training loops: one ``torch.profiler``
    ``record_function`` range named ``train_step#N`` around the step, so
    a device trace groups each step's kernels under it, plus a host
    timeline event when the profiler runs."""

    def __init__(self, step_num, name="train_step"):
        self.name = name
        self.step_num = int(step_num)
        self._ctx = None
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter_ns()
        self._ctx = torch.profiler.record_function(
            "%s#%d" % (self.name, self.step_num))
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        end = time.perf_counter_ns()
        record_event("%s#%d" % (self.name, self.step_num), "step",
                     self._start // 1000,
                     max((end - self._start) // 1000, 1))
        return False


def dump_profile(filename=None):
    """Write the collected events as Chrome trace-event JSON (reference
    profiler.h:122-127 DumpProfile), with the telemetry registry's
    snapshot as metadata."""
    path = filename or _P.filename
    with _P.lock:
        events = list(_P.events)
    payload = {"traceEvents": events, "displayTimeUnit": "ms",
               "telemetry": _telemetry.snapshot()}
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


# the later reference's names
set_config = profiler_set_config
set_state = profiler_set_state
dump = dump_profile


from . import config as _cfg_mod  # noqa: E402

if _cfg_mod.get("MXNET_PROFILER_AUTOSTART"):
    profiler_set_config(
        mode="all" if _cfg_mod.get("MXNET_PROFILER_MODE") else "symbolic")
    profiler_set_state(State.run)
