"""Monitor — per-op tensor statistics for debugging; the PyTorch twin of
``mxnet_tpu/monitor.py`` (reference python/mxnet/monitor.py, backed by
ExecuteMonCallback, graph_executor.h:200).

It rides the Executor's per-node capture hook
(``Executor.set_monitor_callback``): on a monitored step the graph runs
with the hook, which hands every node's output to the stat function;
``toc`` gathers the step's stats with one device-to-host read.
"""
from __future__ import annotations

import logging
import re
from math import sqrt

import torch

from .ndarray import NDArray, op as _op

__all__ = ["Monitor"]


def _default_stat(x):
    """Mean absolute scale: |x|_2 / sqrt(size)."""
    return _op.norm(x) / sqrt(max(x.size, 1))


class Monitor:
    """Collects (step, tensor_name, stat) rows every `interval` steps.

    interval: sampling period in steps (tic/toc pairs).
    stat_func: NDArray -> NDArray statistic (default: scaled L2 norm).
    pattern: regex; only matching tensor names are recorded.
    sort: sort rows by tensor name in toc().
    monitor_all: also record variable (arg/aux input) nodes, not just op
    outputs."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        self.interval = interval
        self.stat_func = stat_func or _default_stat
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self._monitor_all = monitor_all

        def stat_helper(name, array):
            if self.activated and self.re_prog.match(name):
                self.queue.append((self.step, name, self.stat_func(array)))
        # the executor skips the capture hook while this monitor is
        # dormant
        stat_helper.mon = self
        self.stat_helper = stat_helper

    def install(self, exe, monitor_all=None):
        """Attach to an executor's per-node callback."""
        exe.set_monitor_callback(
            self.stat_helper,
            self._monitor_all if monitor_all is None else monitor_all)
        self.exes.append(exe)

    # -- step protocol -----------------------------------------------------
    def tic(self):
        """Begin a step; activates collection when the step is due."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End a step: append param/aux stats, return collected rows as
        (step, name, formatted_value) tuples."""
        if not self.activated:
            return []
        for exe in self.exes:
            for name, array in zip(exe._arg_names, exe.arg_arrays):
                if self.re_prog.match(name):
                    self.queue.append(
                        (self.step, name, self.stat_func(array)))
            for name, array in zip(exe._aux_names, exe.aux_arrays):
                if self.re_prog.match(name):
                    self.queue.append(
                        (self.step, name, self.stat_func(array)))
        self.activated = False

        if self.sort:
            self.queue.sort(key=lambda row: row[1])
        # one batched device-to-host read for every stat of the step,
        # counted in the profiler's host-sync budget
        from . import profiler

        flat = []
        for _step, _name, value in self.queue:
            values = value if isinstance(value, list) else [value]
            for v in values:
                assert isinstance(v, NDArray)
                flat.append(v._data.detach())
        host = [t.to("cpu", non_blocking=True) for t in flat]
        if any(t.is_cuda for t in flat):
            torch.cuda.synchronize()
        profiler.count_host_sync("monitor_toc")

        rows = []
        i = 0
        for step, name, value in self.queue:
            values = value if isinstance(value, list) else [value]
            rendered = ""
            for v in values:
                t = host[i]
                arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
                i += 1
                scalar = v.shape in ((), (1,))
                rendered += (str(arr.reshape(())[()]) if scalar
                             else str(arr)) + "\t"
            rows.append((step, name, rendered))
        self.queue = []
        return rows

    def toc_print(self):
        """toc() and log each row."""
        for step, name, value in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, value)
