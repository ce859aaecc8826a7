"""Inference serving (the PyTorch twin of ``mxnet_tpu/serve``).

:class:`ServeEngine` (``engine.py``) — in-process dynamic batching over
any forward-capable model (``Predictor`` or a user wrapper): bounded
queue, bucketed coalescing, typed backpressure, graceful drain, full
telemetry. Continuous decode, the TCP front end, the router and the
fleet controller come with ROADMAP Queue A item 8.
"""
from .engine import (EngineClosed, Overloaded, RequestTimeout,  # noqa: F401
                     ServeEngine, ServeError, ServeFuture, SessionEvacuated,
                     typed_error)
