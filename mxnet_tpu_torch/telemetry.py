"""Unified runtime telemetry — metrics registry, run journal, exporters.

A near-copy of ``mxnet_tpu/telemetry.py`` (which imports no jax): the same
registry, journal schema and exporters, so the JAX package's
``tools/telemetry_report.py`` reads the port's journals unchanged.

The reference framework had one engine-integrated profiler
(src/engine/profiler.{h,cc}) that gave every op a place in a single
timeline. This reproduction had grown three mute observability islands
instead: the profiler's host timeline, the async PS's resilience
machinery (retries, reconnects, dead workers — visible only as log
lines), and the guardrail's masked-step/loss-scale/rollback state.
This module is the one place they all report to:

* **Metrics registry** — process-global, thread-safe counters, gauges
  and fixed-bucket histograms (p50/p95/p99). Always on: an update is a
  lock + integer add, noise next to anything worth measuring, so
  callers never need to guard their counts.

* **Run journal** — a schema-versioned JSONL file (one record per
  training step, one per notable event) written when ``MXNET_TELEMETRY``
  names a directory (or :func:`start_journal` is called). The fit hot
  loops, the PS client/server and the guardrails append to it;
  ``tools/telemetry_report.py`` turns it back into a human-readable run
  summary. Journal writes are host-side file appends — they add **zero**
  blocking host syncs to the hot loop (asserted against
  ``profiler.host_sync_count`` in ``tests/test_telemetry.py``) and the
  whole journal path costs nothing when ``MXNET_TELEMETRY`` is unset
  (one config lookup per ``journal()`` call; the hot loops hoist even
  that out by checking once per fit).

* **Exporters** — a Prometheus textfile writer (``MXNET_TELEMETRY_PROM``,
  republished atomically via ``guardrail.durable_replace`` every
  ``MXNET_TELEMETRY_PERIOD`` seconds while a journal is active) and a
  registry snapshot embedded in ``profiler.dump_profile()`` metadata.

Timing discipline: ad-hoc ``time.time()``/``time.perf_counter()`` call
sites in ``mxnet_tpu/parallel/`` are rejected by the ``tools/obs_smoke.sh``
lint — instrumented code uses :func:`now_ms` / :meth:`Histogram.timer`
so every measurement lands in the registry.

See docs/observability.md for the journal schema and the report format.
"""
from __future__ import annotations

import bisect
import json
import logging
import os
import re
import threading
import time
from collections import deque

from . import config as _config
from . import guardrail as _guardrail

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "registry",
           "counter", "gauge", "histogram", "snapshot", "now_ms",
           "quantile",
           "Journal", "journal", "start_journal", "close_journal",
           "journal_step", "journal_event", "recent_steps",
           "render_prom", "write_prom", "SCHEMA_VERSION",
           "LATENCY_BUCKETS_MS", "COUNT_BUCKETS"]

# bump when a journal record's required keys change; readers
# (tools/telemetry_report.py) refuse schemas they don't know
SCHEMA_VERSION = 1

# default histogram buckets: millisecond latencies from sub-ms op
# dispatch to minute-scale barrier waits (upper bounds; +inf implied)
LATENCY_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 30000.0, 60000.0)

# small-count buckets (batch fill, slot occupancy): powers of two up to
# the largest serving bucket anyone sane would configure
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                 512.0, 1024.0)


def now_ms():
    """Monotonic milliseconds — the one clock instrumented code uses
    (the obs lint rejects raw perf_counter call sites in parallel/)."""
    return time.perf_counter() * 1000.0


def quantile(sorted_vals, q):
    """Exact nearest-rank quantile of an already-sorted sequence (the
    numpy 'linear' convention's index rounding). The ONE quantile rule
    for in-process consumers (Speedometer, bench harnesses); the
    standalone tools mirror it in tools/telemetry_report.py:_quantile,
    which must not import the framework."""
    if not sorted_vals:
        return None
    return sorted_vals[int(round(q * (len(sorted_vals) - 1)))]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic counter (reset only for test isolation)."""

    kind = "counter"
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    def snapshot(self):
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = None

    def set(self, v):
        with self._lock:
            self._value = float(v)

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return {"type": "gauge", "value": self._value}


class _Timer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist):
        self._hist = hist

    def __enter__(self):
        self._t0 = now_ms()
        return self

    def __exit__(self, *exc):
        self._hist.observe(now_ms() - self._t0)
        return False


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max and
    bucket-interpolated quantiles (p50/p95/p99 in the snapshot).

    Buckets are upper bounds; one overflow bucket catches the rest.
    Fixed buckets keep ``observe`` O(log buckets) with bounded memory —
    the right trade for always-on hot-path counters. Exact quantiles of
    the raw per-step series come from the journal records instead
    (tools/telemetry_report.py)."""

    kind = "histogram"
    __slots__ = ("name", "_bounds", "_counts", "_lock", "_count",
                 "_sum", "_min", "_max")

    def __init__(self, name, buckets=LATENCY_BUCKETS_MS):
        self.name = name
        self._bounds = tuple(sorted(float(b) for b in buckets))
        if not self._bounds:
            raise ValueError("histogram %r needs at least one bucket"
                             % name)
        self._counts = [0] * (len(self._bounds) + 1)
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def timer(self):
        """Context manager observing the elapsed milliseconds."""
        return _Timer(self)

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def quantile(self, q):
        """Approximate quantile by linear interpolation inside the
        target bucket, clamped to the observed [min, max]. None when
        empty."""
        with self._lock:
            count = self._count
            counts = list(self._counts)
            mn, mx = self._min, self._max
        if not count:
            return None
        target = max(1.0, float(q) * count)
        cum = 0
        for i, c in enumerate(counts):
            if c and cum + c >= target:
                lo = self._bounds[i - 1] if i > 0 else \
                    min(mn, self._bounds[0])
                hi = self._bounds[i] if i < len(self._bounds) else mx
                val = lo + (target - cum) / c * (hi - lo)
                return min(max(val, mn), mx)
            cum += c
        return mx

    def snapshot(self):
        with self._lock:
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
        out = {"type": "histogram", "count": count,
               "sum": round(total, 3), "min": mn, "max": mx}
        if count:
            out["mean"] = round(total / count, 3)
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                val = self.quantile(q)
                out[key] = round(val, 3) if val is not None else None
        return out


class Registry:
    """Name -> metric, created on first use. One process-global
    instance (:func:`registry`); the name IS the identity, so two call
    sites asking for the same counter share it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get(self, name, cls, *args):
        m = self._metrics.get(name)       # GIL-atomic fast path
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(name, *args)
        if not isinstance(m, cls):
            raise TypeError("telemetry metric %r is a %s, not a %s"
                            % (name, type(m).__name__, cls.__name__))
        return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def histogram(self, name, buckets=None):
        return self._get(name, Histogram,
                         *((buckets,) if buckets is not None else ()))

    def snapshot(self):
        """{name: metric.snapshot()} for every registered metric."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}


_REGISTRY = Registry()


def registry():
    return _REGISTRY


def counter(name):
    return _REGISTRY.counter(name)


def gauge(name):
    return _REGISTRY.gauge(name)


def histogram(name, buckets=None):
    return _REGISTRY.histogram(name, buckets)


def snapshot():
    return _REGISTRY.snapshot()


# ---------------------------------------------------------------------------
# run journal
# ---------------------------------------------------------------------------

class Journal:
    """Append-only JSONL run journal. Every record carries the schema
    version (``v``) and a wall-clock timestamp (``t``, epoch seconds);
    writers add ``kind`` (run_start | step | event | snapshot). Each
    record is written + flushed as one line, so a crash tears at most
    the final line (the reader tolerates exactly that)."""

    def __init__(self, path, run=None):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a")
        self._broken = False
        self.write({"kind": "run_start", "pid": os.getpid(),
                    "run": run, "schema": SCHEMA_VERSION})

    def write(self, record):
        if self._broken:
            return
        rec = {"v": SCHEMA_VERSION, "t": round(time.time(), 3)}
        rec.update(record)
        line = json.dumps(rec) + "\n"
        with self._lock:
            if self._broken:
                return
            try:
                self._f.write(line)
                self._f.flush()
            except ValueError:    # closed underneath us at teardown
                pass
            except OSError as e:
                # ENOSPC / a dir yanked mid-run: observability must
                # never poison the training step — disable this
                # journal with ONE warning and keep training
                self._broken = True
                try:
                    self._f.close()
                except (OSError, ValueError):
                    pass
                logging.getLogger(__name__).warning(
                    "telemetry journal %s unwritable (%s); journal "
                    "writes disabled for the rest of this run",
                    self.path, e)

    def close(self):
        with self._lock:
            try:
                self._f.flush()
                self._f.close()
            except (OSError, ValueError):
                pass


_STATE_LOCK = threading.Lock()
_JOURNAL = None
# the periodic Prometheus republish disables itself (one warning) when
# the destination becomes unwritable mid-run — ENOSPC on the metrics
# volume must not fail training steps. Reset by close_journal().
_PROM_BROKEN = [False]
# last journal step records, for in-process consumers (Speedometer
# sources its throughput from here when a journal is active)
_RECENT = deque(maxlen=4096)
_LAST_EXPORT = [0.0]
# now_ms() timestamp of a "compile" event not yet matched to a step
# record: the step whose wall window COVERS the event gets flagged, so
# throughput readers (telemetry_report, Speedometer) can separate
# steady-state step time from the one-off compile wall without
# outlier guessing. A compile outside any step window (e.g. score()'s
# infer compile between epochs) flags nothing — the next step's wall
# doesn't contain it.
_COMPILE_PENDING = [None]


def journal():
    """The active run journal, lazily opened from ``MXNET_TELEMETRY``;
    None when telemetry is disabled (the fast path — one config
    lookup)."""
    jr = _JOURNAL
    if jr is not None:
        return jr
    where = _config.get("MXNET_TELEMETRY")
    if not where:
        return None
    return start_journal(where)


def start_journal(path=None, run=None):
    """Open the process journal (idempotent — an already-open journal
    wins). ``path``: a directory (one ``telemetry-<pid>.jsonl`` file is
    created in it) or an explicit ``*.jsonl`` file path; defaults to
    ``MXNET_TELEMETRY``."""
    global _JOURNAL
    with _STATE_LOCK:
        if _JOURNAL is not None:
            return _JOURNAL
        path = path or _config.get("MXNET_TELEMETRY")
        if not path:
            raise ValueError("no journal destination: pass a path or "
                             "set MXNET_TELEMETRY")
        if path.endswith(".jsonl"):
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            file_path = path
        else:
            os.makedirs(path, exist_ok=True)
            file_path = os.path.join(
                path, "telemetry-%d.jsonl" % os.getpid())
        _JOURNAL = Journal(file_path, run=run)
        return _JOURNAL


def close_journal():
    """Write a final registry snapshot record, close the journal, and
    publish the Prometheus file one last time. Returns the journal
    path (None when no journal was open)."""
    global _JOURNAL
    with _STATE_LOCK:
        jr = _JOURNAL
        _JOURNAL = None
    if jr is None:
        return None
    jr.write({"kind": "snapshot", "metrics": snapshot()})
    jr.close()
    _RECENT.clear()
    _PROM_BROKEN[0] = False     # a fresh run gets a fresh chance
    try:
        write_prom()
    except OSError:
        pass
    return jr.path


def journal_step(**fields):
    """Append one per-training-step record (kind=step). No-op without
    an active journal. Conventional fields: ``loop`` (trainstep |
    module | bench), ``step``, ``epoch``, ``wall_ms``, ``data_wait_ms``,
    ``window_wait_ms``, ``samples``."""
    jr = journal()
    if jr is None:
        return
    rec = dict(fields)
    rec["kind"] = "step"
    t_ev = _COMPILE_PENDING[0]
    if t_ev is not None:
        _COMPILE_PENDING[0] = None
        wall = float(rec.get("wall_ms") or 0.0)
        if t_ev >= now_ms() - wall - 1.0:
            rec.setdefault("compile", True)
    _RECENT.append(dict(rec))
    jr.write(rec)
    _maybe_export()


def journal_event(event, **fields):
    """Append one notable-event record (kind=event). No-op without an
    active journal. ``compile`` events additionally bump the
    ``compile.events`` counter, so the final registry snapshot carries
    a fingerprint-friendly compile count (``tools/perf_gate.py``
    asserts steady-state steps never recompile against it)."""
    jr = journal()
    if jr is None:
        return
    if event == "compile":
        _COMPILE_PENDING[0] = now_ms()
        counter("compile.events").inc()
    rec = {"kind": "event", "event": event}
    if fields:
        rec["fields"] = fields
    jr.write(rec)


def recent_steps(n=None):
    """The most recent journal step records (in-process view; empty
    when no journal is active)."""
    steps = list(_RECENT)
    if n is None:
        return steps
    return steps[-int(n):]


# ---------------------------------------------------------------------------
# Prometheus textfile exporter
# ---------------------------------------------------------------------------

def _prom_name(name):
    return "mxnet_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _prom_value(v):
    if v is None:
        return "NaN"
    return repr(float(v))


def render_prom():
    """The registry as Prometheus text exposition format (counters,
    gauges, histograms-as-summaries with p50/p95/p99 quantiles)."""
    lines = []
    for name, snap in snapshot().items():
        pn = _prom_name(name)
        if snap["type"] == "counter":
            lines += ["# TYPE %s counter" % pn,
                      "%s %s" % (pn, _prom_value(snap["value"]))]
        elif snap["type"] == "gauge":
            lines += ["# TYPE %s gauge" % pn,
                      "%s %s" % (pn, _prom_value(snap["value"]))]
        else:
            lines.append("# TYPE %s summary" % pn)
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                if key in snap:
                    lines.append('%s{quantile="%s"} %s'
                                 % (pn, q, _prom_value(snap[key])))
            lines += ["%s_sum %s" % (pn, _prom_value(snap["sum"])),
                      "%s_count %d" % (pn, snap["count"])]
    return "\n".join(lines) + "\n"


def write_prom(path=None):
    """Atomically publish the registry to a Prometheus textfile
    (``MXNET_TELEMETRY_PROM`` by default; no-op when unset). Published
    via ``guardrail.durable_replace`` so a scraper never reads a torn
    file."""
    path = path or _config.get("MXNET_TELEMETRY_PROM")
    if not path:
        return None
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(render_prom())
    _guardrail.durable_replace(tmp, path)
    return path


def _maybe_export():
    """Opportunistic periodic Prometheus export, piggybacking on
    journal step writes (no background thread to manage/leak). An
    export failure after startup (ENOSPC, dir made unwritable)
    disables further periodic exports with one warning instead of
    re-failing on every step."""
    if _PROM_BROKEN[0]:
        return
    path = _config.get("MXNET_TELEMETRY_PROM")
    if not path:
        return
    period = float(_config.get("MXNET_TELEMETRY_PERIOD"))
    now = time.monotonic()
    if now - _LAST_EXPORT[0] < period:
        return
    _LAST_EXPORT[0] = now
    try:
        write_prom(path)
    except OSError as e:
        _PROM_BROKEN[0] = True
        logging.getLogger(__name__).warning(
            "telemetry: Prometheus export to %s failed (%s); periodic "
            "export disabled for the rest of this run", path, e)
