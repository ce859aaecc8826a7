"""Device-memory sampling for the telemetry registry — the piece of
``mxnet_tpu/profiler.py`` the serving engine uses. The profiler proper
(host timeline, ``torch.profiler`` device traces) comes with ROADMAP
Queue A item 9."""
from __future__ import annotations

import torch

from . import telemetry as _telemetry

__all__ = ["sample_device_memory"]


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
