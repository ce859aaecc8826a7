"""Typed runtime configuration (the dmlc::GetEnv analogue).

The PyTorch twin of ``mxnet_tpu/config.py``: the same resolution rules
(override > environment > default) and the same knob names, declared
here for the knobs the port reads. Later slices declare theirs as they
port the code that reads them. Ops read their knobs through :func:`get`
at call time, as the JAX ops read ``os.environ`` at call time, so one
process can run an op under either value.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = ["define", "get", "set_override", "clear_override", "describe"]

_BOOLY = {"1": True, "true": True, "yes": True, "on": True,
          "0": False, "false": False, "no": False, "off": False}


@dataclass
class _Knob:
    name: str
    typ: type
    default: object
    doc: str


_REGISTRY: dict[str, _Knob] = {}
_OVERRIDES: dict[str, object] = {}


def define(name, typ, default, doc):
    """Declare a config knob (idempotent for identical declarations)."""
    prev = _REGISTRY.get(name)
    if prev is not None and (prev.typ, prev.default) != (typ, default):
        raise ValueError("conflicting re-declaration of %s" % name)
    _REGISTRY[name] = _Knob(name, typ, default, doc)
    return name


def _coerce(knob, raw):
    if knob.typ is bool:
        try:
            return _BOOLY[str(raw).strip().lower()]
        except KeyError:
            raise ValueError("%s expects a boolean, got %r"
                             % (knob.name, raw))
    return knob.typ(raw)


def get(name):
    """Current value: programmatic override > environment > default."""
    knob = _REGISTRY[name]
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    raw = os.environ.get(name)
    return knob.default if raw is None else _coerce(knob, raw)


def set_override(name, value):
    """Set a process-local value that beats the environment (tests,
    notebooks). ``None`` resets to environment/default resolution."""
    knob = _REGISTRY[name]
    if value is None:
        clear_override(name)
    else:
        _OVERRIDES[name] = _coerce(knob, value)


def clear_override(name=None):
    if name is None:
        _OVERRIDES.clear()
    else:
        _OVERRIDES.pop(name, None)


def describe():
    """All declared knobs as (name, type, default, doc) rows, sorted."""
    return [(k.name, k.typ.__name__, k.default, k.doc)
            for k in sorted(_REGISTRY.values(), key=lambda k: k.name)]


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------
define("MXNET_MATMUL_PRECISION", str, "highest",
       "float32 matmul precision on the card: highest (full f32: TF32 "
       "off for cuBLAS and cuDNN) | high (TF32 allowed) | default "
       "(PyTorch's own defaults left untouched)")
define("MXNET_TELEMETRY", str, "",
       "directory (or explicit *.jsonl path) for the telemetry run "
       "journal: one schema-versioned JSONL record per step and per "
       "notable event. Empty = no journal; the metrics registry still "
       "counts either way")
define("MXNET_TELEMETRY_PROM", str, "",
       "path for the Prometheus textfile export of the telemetry "
       "registry, atomically republished every MXNET_TELEMETRY_PERIOD "
       "seconds while a journal is active; empty = disabled")
define("MXNET_TELEMETRY_PERIOD", float, 10.0,
       "seconds between periodic Prometheus textfile exports "
       "(piggybacked on journal step writes)")
define("MXNET_TRACE", str, "",
       "directory (or explicit *.jsonl path) for the distributed-trace "
       "span spill file. Empty = tracing off (no-op fast path)")
define("MXNET_SERVE_BUCKETS", str, "1,2,4,8",
       "serving batch buckets (comma-separated, ascending): the "
       "ServeEngine batcher pads each coalesced request group to the "
       "smallest bucket that fits")
define("MXNET_SERVE_MAX_WAIT_MS", float, 5.0,
       "serving coalesce window: how long the batcher holds the "
       "oldest queued request waiting for more to arrive before it "
       "dispatches a partially-filled bucket (0 = dispatch "
       "immediately)")
define("MXNET_SERVE_QUEUE_CAP", int, 128,
       "serving admission bound: requests queued beyond this are shed "
       "with the typed Overloaded error")
define("MXNET_SERVE_DEADLINE_MS", float, 0.0,
       "default per-request serving deadline: a request still queued "
       "past it fails with the typed RequestTimeout (0 = no deadline; "
       "submit(deadline_ms=) overrides per request)")
define("MXNET_POOL_DENSE_BWD", bool, False,
       "2-D max-pool backward as kh*kw dense passes that split the "
       "gradient among tied maxima, instead of one winner per window "
       "(experiment)")
define("MXNET_BN_IMPL", str, "",
       "training BatchNorm impl: empty = two-pass statistics with autograd "
       "backward (default) | onepass = the shifted one-pass core with its "
       "closed-form backward (experiment)")
define("MXNET_BN_STATS", str, "",
       "training BN statistics on the default route: empty = reductions "
       "(default) | dot = sums as contractions | auto = contractions only "
       "where C >= 2*H*W and H*W >= 128 (experiments)")
define("MXNET_BN_PALLAS", bool, False,
       "route 4-D NCHW training BatchNorm (axis 1) through the hand-written "
       "CUDA kernels of csrc/bn_train.cu on the card (their plain PyTorch "
       "versions on the CPU); the name is the JAX package's")
define("MXNET_NMS_IMPL", str, "",
       "MultiBoxDetection NMS route when impl='auto': pallas = the "
       "hand-written CUDA kernel of csrc/nms.cu (its plain PyTorch version "
       "on the CPU) | xla = the dense (A, A) IoU path in plain PyTorch; "
       "empty = the kernel on CUDA tensors, the dense path on the CPU. The "
       "values are the JAX package's")
define("MXNET_DISPATCH_AHEAD", int, 2,
       "bounded dispatch window of TrainStep.fit: how many steps may be "
       "queued on the card before the loop blocks on the step K back "
       "(1 = fully synchronous stepping)")
define("MXNET_GUARDRAIL", bool, True,
       "non-finite step detection in TrainStep.fit: the step computes an "
       "all-finite flag on the device and masks a bad update there "
       "(weights never ingest a NaN); the flag is read at the dispatch "
       "window's wait, so it adds no blocking host sync")
define("MXNET_LOSS_SCALE", str, "",
       "loss scaling for TrainStep.fit: empty = off | 'dynamic' = "
       "grow/halve DynamicLossScaler | <float> = static scale; the "
       "scaler's state rides the step's aux dict and its checkpoints")
define("MXNET_LOSS_SCALE_WINDOW", int, 200,
       "dynamic loss scaling: consecutive finite steps before the "
       "scale doubles (overflow always halves it immediately)")
define("MXNET_MAX_BAD_STEPS", int, 10,
       "consecutive masked (non-finite) steps before the fit loop rolls "
       "back to the newest readable checkpoint")
define("MXNET_MAX_ROLLBACKS", int, 2,
       "checkpoint rollbacks the guardrail may perform before raising "
       "NumericalDivergence")
define("MXNET_ROLLBACK_LR_FACTOR", float, 1.0,
       "learning-rate multiplier applied on every guardrail rollback "
       "(e.g. 0.5 halves the LR after each divergence rollback)")
define("MXNET_NATIVE_RECORDIO", bool, False,
       "the JAX package's mmap'd native RecordIO reader; not ported yet "
       "(ROADMAP Queue A item 10): when set, recordio logs once that it "
       "reads with the Python reader")
define("MXNET_BACKWARD_DO_MIRROR", bool, False,
       "rematerialise the forward during the backward in TrainStep "
       "(gradient mirroring): activation memory traded for recompute; "
       "the default of TrainStep(remat=None)")
