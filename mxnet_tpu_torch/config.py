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
define("MXNET_FSDP_MIN_SIZE", int, 1024,
       "SpecLayout auto-rule threshold: parameters with fewer elements "
       "than this replicate instead of sharding over the 'fsdp' mesh "
       "axis (a per-layer all-gather costs more than the memory a tiny "
       "tensor saves)")
define("MXNET_GSPMD_CONSTRAIN_ACTS", bool, True,
       "with a SpecLayout bound, pin activation batch dims to the "
       "data axes at module boundaries (lenient sharding constraints "
       "at FullyConnected/Convolution/... outputs) so GSPMD "
       "propagation can't drift activations off the batch sharding")
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
define("MXNET_NATIVE_RECORDIO", bool, True,
       "use the native C++ mmap RecordIO reader")
define("MXNET_NATIVE_IMAGE", bool, True,
       "use the native C++ batched image decode+crop+resize pipeline "
       "when the augment list allows it")
define("MXNET_CAPI_DEVICE", str, "gpu",
       "the device a C host's predictor or training step runs on through "
       "the C ABI (_native/predict_shim.cc): gpu (cuda:0) or cpu")
define("MXNET_CAPI_TIMING", bool, False,
       "the C ABI writes each exported call's wall time to stderr as "
       "'capi: <function> <ms> ms' (read by the C side at its first call)")
define("MXNET_BACKWARD_DO_MIRROR", bool, False,
       "rematerialise the forward during the backward in TrainStep "
       "(gradient mirroring): activation memory traded for recompute; "
       "the default of TrainStep(remat=None)")

# the serving stack's knobs (serve/decode.py, prefill.py, net.py,
# router.py, controller.py) and RetryPolicy's, as the JAX package
# declares them
define("MXNET_DECODE_SLOTS", str, "",
       "decode slot-pool sizing hint: 'auto' logs a "
       "ContinuousDecoder.describe() report at construction — cache "
       "bytes per slot (int8 + per-token scales under quantize_kv) "
       "and how many slots fit the device's reported HBM limit at "
       "the configured max_len; 'auto:<bytes>' sizes against an "
       "explicit budget (e.g. auto:16e9). Empty = no report; the "
       "serve.decode.kv_bytes_per_slot gauge is published either way")
define("MXNET_DECODE_DRAIN_TIMEOUT", float, 60.0,
       "continuous-decode drain budget: seconds "
       "ContinuousDecoder.close() waits for admitted sequences to "
       "finish, and the budget router.recycle() uses to drain a "
       "replica whose hello declared role 'decode' (one drain clock "
       "for the decode path; MXNET_ROUTER_DRAIN_TIMEOUT keeps "
       "covering every other role). Must be positive and finite — "
       "validated loudly at use")
define("MXNET_PREFILL_CHUNK", int, 0,
       "colocated chunked-prefill width (tokens): a queued prompt "
       "longer than this is fed to the cache in chunk-sized forwards, "
       "one chunk interleaved per decode-loop iteration, so active "
       "sessions keep emitting tokens while a long prompt prefills "
       "(bounds inter-token p99 under long-prompt arrivals; "
       "docs/serving.md §streaming). 0 = off (whole-prompt prefill). "
       "Chunk forwards ride the shared-position prefill graph — the "
       "(B, 1) decode step stays a single XLA specialization")
define("MXNET_SPEC_DRAFT", str, "",
       "speculative-decoding draft for the serving decoder: "
       "'layers=<d>[,gamma=<g>]' makes every ContinuousDecoder built "
       "without an explicit draft= attach a truncated_draft of its "
       "own generator (the first <d> transformer blocks, shared "
       "weights) and verify <g> proposed tokens per round (default "
       "gamma=4). Requests still opt in per call "
       "(submit(speculative=True)); the knob only provisions the "
       "draft, so whole fleets — including subprocess replicas — "
       "turn it on through the environment. Empty = no draft. "
       "Validated loudly at decoder construction; docs/serving.md "
       "§speculative")
define("MXNET_STREAM_IDLE_TIMEOUT", float, 30.0,
       "streamed-generate per-frame idle timeout (seconds): a "
       "streaming client (ServeClient.generate(on_token=) and every "
       "router decode leg relaying frames) fails the read when the "
       "gap since the previous frame exceeds it — a hung replica "
       "fails over after one missed inter-frame gap instead of the "
       "old whole-completion deadline (120 s + 1 s/token). Must be "
       "positive and finite — validated loudly at use")
define("MXNET_ROUTER_POLL_MS", float, 200.0,
       "fleet router stats-poll period: how often the ServeRouter's "
       "background poller refreshes each replica's cached load "
       "signals (queue depth, in-flight, warmed buckets, free decode "
       "slots) via the stats frame. 0 disables the background poller "
       "— deterministic tests drive router.poll_now() explicitly")
define("MXNET_ROUTER_CONNS", int, 8,
       "fleet router data-connection pool: idle connections kept per "
       "replica (bursts open extras; surplus closes on release). "
       "Concurrency to one replica is bounded only by offered load, "
       "not by this")
define("MXNET_ROUTER_SESSION_CAP", int, 4096,
       "fleet router session-affinity table bound: pinned "
       "continuous-decode sessions beyond it evict "
       "least-recently-dispatched (an evicted session re-places like "
       "a new one — decode state on the old replica is orphaned until "
       "its slot frees)")
define("MXNET_ROUTER_IO_TIMEOUT", float, 30.0,
       "fleet router per-replica socket timeout (seconds): a replica "
       "that accepts but never answers surfaces as a transport fault "
       "(suspect + reroute) instead of wedging the dispatching thread "
       "and the stats poller forever. 0 = unbounded (trusted local "
       "fleets only)")
define("MXNET_ROUTER_DRAIN_TIMEOUT", float, 60.0,
       "fleet router recycle budget: seconds router.recycle() waits "
       "for a draining replica's in-flight work (router-tracked and "
       "stats-observed) to reach zero before giving up loudly")
define("MXNET_ROUTER_FAILOVER", bool, True,
       "fleet router generate failover: when the replica pinned to an "
       "in-flight generate dies mid-call (transport fault + failed "
       "control probe), the router replays its retained recovery "
       "record (prompt, sampling opts, seed, handoff blob) on a "
       "survivor — token-for-token identical, and the decode-side "
       "admit-id dedup table makes a replay onto a replica that "
       "actually survived admit exactly once. Off restores the "
       "pre-failover contract: an established session's transport "
       "fault retries only its own replica")
define("MXNET_ROUTER_MIGRATION_LIMIT", int, 8,
       "fleet router migration bound: how many evacuated-session "
       "resume hops one generate may take (each migrating recycle or "
       "SIGTERM evacuation crossing the request's path costs one) "
       "before the router fails it with EngineClosed — a cascade of "
       "evacuating replicas must not bounce a request forever")
define("MXNET_CTRL_MIN_REPLICAS", int, 1,
       "fleet controller floor: scale-in never takes the fleet below "
       "this many live replicas (and the controller refuses to retire "
       "the last live replica regardless). Must be >= 1 — validated "
       "loudly at controller construction")
define("MXNET_CTRL_MAX_REPLICAS", int, 8,
       "fleet controller ceiling: scale-out never spawns past this "
       "many live replicas, however hard the load signal pushes. Must "
       "be >= MXNET_CTRL_MIN_REPLICAS — validated loudly at "
       "controller construction")
define("MXNET_CTRL_SCALE_OUT_DEPTH", float, 4.0,
       "fleet controller scale-out trigger: mean polled queue depth "
       "per live replica at or above this for MXNET_CTRL_SUSTAIN "
       "consecutive ticks requests one spawn (shed_rate crossing "
       "MXNET_CTRL_SCALE_OUT_SHED is the OR'd second trigger)")
define("MXNET_CTRL_SCALE_OUT_SHED", float, 1.0,
       "fleet controller scale-out trigger on backpressure: fleet-wide "
       "shed_rate (requests shed per poll window, summed over "
       "replicas) at or above this for MXNET_CTRL_SUSTAIN consecutive "
       "ticks requests one spawn — sheds mean admission is already "
       "failing, so this fires even while queues look shallow")
define("MXNET_CTRL_SCALE_IN_DEPTH", float, 0.5,
       "fleet controller scale-in trigger: mean polled queue depth "
       "per live replica at or below this AND a zero-shed window for "
       "MXNET_CTRL_SUSTAIN consecutive ticks retires one replica "
       "through the zero-drop drain path (never below "
       "MXNET_CTRL_MIN_REPLICAS)")
define("MXNET_CTRL_SUSTAIN", int, 3,
       "fleet controller hysteresis: consecutive ticks a scale signal "
       "must hold before the controller acts — a one-tick spike (or "
       "an oscillating signal that keeps resetting the streak) never "
       "moves the fleet. Must be >= 1 — validated loudly at "
       "controller construction")
define("MXNET_CTRL_COOLDOWN", int, 5,
       "fleet controller cooldown: ticks after any scale action "
       "during which further scaling is suppressed, so the fleet "
       "observes the new capacity before deciding again (healing is "
       "exempt — a dead replica is replaced immediately)")
define("MXNET_CTRL_CANARY_TIMEOUT", float, 30.0,
       "fleet controller rollout health gate: seconds a freshly "
       "promoted replica has to answer the canary infer before the "
       "gate fails and the rollout rolls back. Must be positive and "
       "finite — validated loudly at controller construction")
define("MXNET_CTRL_POLL_MS", float, 500.0,
       "fleet controller tick period: how often the background "
       "supervision loop polls the router and evaluates the capacity "
       "policy. 0 disables the background loop — deterministic tests "
       "drive controller.tick() explicitly (the poll_now() "
       "discipline)")
define("MXNET_PROFILER_AUTOSTART", bool, False,
       "start profiler collection at import")
define("MXNET_PROFILER_MODE", bool, False,
       "False = symbolic executor events only, True = every eager op")
define("MXNET_PROFILER_XPLANE", str, "",
       "directory for torch.profiler device traces (empty = disabled)")
define("MXNET_PS_RETRY_MAX", float, 8,
       "RetryPolicy default retry count (parallel/resilience.py; the "
       "policy reads the environment directly and falls back to this "
       "default on a malformed value)")
define("MXNET_PS_RETRY_BASE", float, 0.05,
       "RetryPolicy default first backoff in seconds (doubling per "
       "retry, deterministic jitter)")
define("MXNET_PS_RETRY_MAX_DELAY", float, 2.0,
       "RetryPolicy default cap on one backoff sleep, in seconds")
define("MXNET_PS_OP_DEADLINE", float, 120.0,
       "RetryPolicy default budget for one op including its retries and "
       "backoff sleeps, in seconds (0 = unlimited)")
