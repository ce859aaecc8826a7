"""Inference serving (the PyTorch twin of ``mxnet_tpu/serve``).

* :class:`ServeEngine` (``engine.py``) — in-process dynamic batching over
  any forward-capable model (``Predictor``, the bucketed export through
  :meth:`ServeEngine.from_export`, or a user wrapper): bounded queue,
  bucketed coalescing, typed backpressure, graceful drain, telemetry.
* :class:`ContinuousDecoder` (``decode.py``) — continuous-batching token
  generation for the transformer ``Generator``: a fixed slot pool over
  the device caches, its (B, 1) per-row step one captured CUDA graph.
* :class:`ServeServer` / :class:`ServeClient` (``net.py``) — the TCP
  front end, on the JAX package's wire framing (``_wire.py``), so port
  and JAX replicas and routers interoperate.
* :class:`ServeRouter` (``router.py``) — one endpoint over N replicas:
  least-loaded dispatch, session affinity, shed-and-retry, failover,
  zero-drop rolling restarts.
* :class:`PrefillEngine` (``prefill.py``) — the prefill half of
  prefill/decode disaggregation (``{first_token, kv_blob, pos}``).
* :class:`FleetController` (``controller.py``) — autoscaling,
  self-healing and rollout with rollback, journaled crash-safe.
"""
from .controller import FleetController, RolloutResult
from .decode import ContinuousDecoder, DecodeFuture
from .engine import (EngineClosed, Overloaded, RequestTimeout,
                     ServeEngine, ServeError, ServeFuture,
                     SessionEvacuated, typed_error)  # noqa: F401
from .net import ServeClient, ServeServer
from .prefill import PrefillEngine
from .router import ReplicaState, ServeRouter

__all__ = ["ServeEngine", "ServeFuture", "ServeError", "Overloaded",
           "RequestTimeout", "EngineClosed", "SessionEvacuated",
           "ContinuousDecoder", "DecodeFuture", "PrefillEngine",
           "ServeClient", "ServeServer", "ServeRouter",
           "ReplicaState", "FleetController", "RolloutResult"]
