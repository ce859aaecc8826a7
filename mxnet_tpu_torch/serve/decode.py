"""Continuous-batching decode for the transformer ``Generator``
(docs/serving.md §continuous decode) — the PyTorch twin of
``mxnet_tpu/serve/decode.py``, with the same admission, migration,
speculative and chunked-prefill semantics.

On the card the (B, 1) per-row step is ONE captured CUDA graph
(``generation._CapturedLoop``): its ``data`` (B, 1), ``positions`` (B, 1)
and ``cache_pos`` (B,) inputs are static device tensors the loop fills
before each replay, the pool caches are the Generator's ``_fresh_aux()``
tensors at fixed addresses (admission, handoff and resume write rows into
them in place and never replace them), and the last logits land in a
static (B, V) float32 buffer. The ``serve.decode.jit_cache_size`` gauge
counts captured step graphs: 1 across any slot turnover. The speculative
draft's (B, 1) step is captured the same way
(``serve.spec.draft_jit_cache_size``); the (B, γ+1) verify forward runs
eagerly. On the CPU the same step runs uncaptured over the same static
tensors, and the gauges count that one step program. The host side of a
step is the JAX package's: read the (B, V) logits, then pick per request
(greedy rows by argmax of the host copy, sampled rows by ``_pick_token``
on the logits' device with the request's own threefry stream).

Static-batch generation dies with its slowest sequence: a (B,) batch
holds every slot until the LAST row finishes, so mean device
utilization decays toward 1/B as lengths diverge. Continuous batching
(the O(1)-per-token cached-decode serving model, arXiv:2603.09555)
fixes the shape instead of the membership: a fixed slot pool over the
on-device decode state — per-slot KV-cache rows for attention blocks,
a constant (H, hd, hd) recurrent blob for ``block_type="ssm"`` layers
— where a finished sequence frees its slot at the step it finishes
and the next queued prompt is admitted at the following step. Decode
throughput then tracks offered load, not the longest request in
flight.

What makes the single captured step possible is the per-row-position
decode graph (``get_decode_symbol(per_row_pos=True)`` →
``cached_attention`` — or ``cached_attention_q8`` under
``quantize_kv`` — with a (B,) ``pos``): every slot decodes at its
own depth inside ONE (B, 1) program, so slot membership changes
never capture it again. SSM layers need no twin at all — the recurrent
state carries its own position, so their per-row graph IS the shared
graph and the same one-program discipline holds for free. Prompt
admission reuses the Generator's ordinary shared-position prefill
(all admitted rows start at position 0) and merges the prefilled
state into the pool with a batch-axis scatter — under ``quantize_kv``
that merge carries the per-token f32 scale caches alongside the int8
rows, and SSM state blobs ride the same scatter with no length axis.

Decode is bandwidth-bound and the per-slot state is its dominant HBM
stream (re-read every step; each weight read once), so shrinking that
state directly raises how many slots fit a chip: an int8 cache
(``Generator(quantize_kv=True)``) roughly halves an attention slot's
bytes, and an SSM slot pins a CONSTANT byte count independent of
``max_len`` entirely. The ``serve.decode.kv_bytes_per_slot`` gauge
(state-agnostic despite the legacy name —
``Generator.state_bytes_per_slot()``) and :meth:`describe` /
``MXNET_DECODE_SLOTS=auto`` report the sizing math.

Exactness contract: greedy decode (temperature 0) emits token-for-token
what ``Generator.generate`` emits for the same prompt — the per-row
graph computes the same per-row math and rows are independent (pinned
in tests/test_serve_decode.py). Sampled requests are reproducible per
request (each carries its own PRNG stream keyed by ``seed``, split once
per emitted token exactly like ``generate``'s loop) and match a
``batch_size=1`` ``Generator.generate(seed=...)``, but not a
multi-row static batch — ``categorical`` draws one noise
tensor per CALL, so row b of a (B, V) batch and the same logits alone
see different noise.

Because every piece of a mid-decode sequence is either portable
(cache rows via ``export_kv_rows``) or derivable (PRNG progress =
``len(emitted)`` splits — ``generation.replay_key``), an active
session survives its replica: :meth:`export_session` packages one
slot's full recovery state, ``submit(resume=...)`` readmits it on
another pool at its own depth, and :meth:`evacuate` (also wired to
SIGTERM via ``install_sigterm=True``) exports every active slot at
once so a migrating recycle is bounded by export+import cost instead
of longest-sequence drain (docs/robustness.md, fleet failure
semantics).

Speculative decoding (docs/serving.md §speculative): an optional
draft Generator (``draft=`` or ``MXNET_SPEC_DRAFT``) gives the pool a
second, smaller model sharing the slot shape. When any live slot
opted in (``submit(speculative=True)``), a loop iteration becomes a
ROUND: γ compiled (B, 1) draft steps propose tokens per slot, then
ONE (B, γ+1) target verify forward scores them all — with PER-ROW
acceptance (each slot keeps its own longest-matching prefix, unlike
the eager path's lockstep rule) and per-row position bookkeeping, so
rejected speculative cache entries are simply overwritten in place
and never attended. Verification is common-random-numbers exact: the
emission at index j is always ``_pick_token(target_logits_j, sub_j)``
with ``sub_j`` the request stream's (j+1)-th split, and the draft
proposes with the SAME sub — so output is byte-identical to plain
``generate``/non-speculative serving for the same (seed, prompt,
sampling args), which keeps failover replay and the dedup contract
token-exact. ``speculative`` is therefore a pure performance hint: a
draft-less replica admits the same request down the ordinary (B, 1)
path with identical output. Every emission funnels through
:meth:`_emit` one token at a time, so TTFT/inter-token metrics,
streamed frames and mid-stream failover cursors work unchanged.
"""
from __future__ import annotations

import logging
import signal
import threading
from collections import OrderedDict, deque

import numpy as np
import torch

from .. import _threefry
from .. import config as _config
from .. import telemetry as _telemetry
from .. import trace as _trace
from ..executor import _graph_eval_fn
from ..generation import _CapturedLoop, _pick_token, replay_key
from ..models import transformer
from ..ndarray.ndarray import _from_numpy
from .engine import (EngineClosed, Overloaded, RequestTimeout,
                     SessionEvacuated)

__all__ = ["ContinuousDecoder", "DecodeFuture", "drain_timeout",
           "prefill_chunk", "spec_draft"]

# replay dedup (the PS client's (cid, seq) pattern on the serving side): how
# many admit ids a decode replica remembers. Sized far past any
# plausible in-flight window — eviction is LRU, and evicting an id
# that could still be replayed would re-open the double-admit hole,
# so the cap exists only to bound memory over a replica's lifetime.
_DEDUP_CAP = 4096


def drain_timeout():
    """``MXNET_DECODE_DRAIN_TIMEOUT``, loudly validated: the drain
    budget for a decode replica — :meth:`ContinuousDecoder.close`
    waits this long for admitted sequences to finish, and the fleet
    router's :meth:`~mxnet_tpu.serve.ServeRouter.recycle` of a
    replica whose hello declared ``role: decode`` budgets its drain
    from the SAME knob (one drain clock; the router knob keeps
    covering every other role)."""
    import math
    t = float(_config.get("MXNET_DECODE_DRAIN_TIMEOUT"))
    if not (math.isfinite(t) and t > 0):
        raise ValueError(
            "MXNET_DECODE_DRAIN_TIMEOUT=%r: wants a positive finite "
            "number of seconds (a non-positive or non-finite drain "
            "budget would wedge or skip the drain silently)" % (t,))
    return t


def prefill_chunk():
    """``MXNET_PREFILL_CHUNK``, loudly validated: the colocated
    chunked-prefill width in tokens (0 = off, whole-prompt prefill).
    Read per admission round so tests and live reconfigures take
    effect without rebuilding the pool."""
    c = int(_config.get("MXNET_PREFILL_CHUNK") or 0)
    if c < 0:
        raise ValueError(
            "MXNET_PREFILL_CHUNK=%r: wants a non-negative chunk width "
            "in tokens (0 disables chunking)" % (c,))
    return c


def spec_draft():
    """``MXNET_SPEC_DRAFT``, loudly validated: the serving fleet's
    zero-config speculative draft. ``'layers=<d>[,gamma=<g>]'`` makes
    every :class:`ContinuousDecoder` built WITHOUT an explicit
    ``draft=`` attach ``generator.truncated_draft(num_layers=<d>)``
    and verify ``<g>`` proposals per round (default 4) — subprocess
    replicas (the chaos harness's children, spawned fleets) opt in
    through the environment with zero code changes. Empty = no draft.
    Returns ``(layers, gamma)`` or ``None``."""
    raw = str(_config.get("MXNET_SPEC_DRAFT") or "").strip()
    if not raw:
        return None
    layers, gamma = None, 4
    for part in raw.split(","):
        if "=" not in part:
            raise ValueError(
                "MXNET_SPEC_DRAFT=%r: wants 'layers=<d>[,gamma=<g>]' "
                "(got the fieldless part %r)" % (raw, part))
        k, v = (s.strip() for s in part.split("=", 1))
        try:
            val = int(v)
        except ValueError:
            raise ValueError(
                "MXNET_SPEC_DRAFT=%r: %s wants an integer, got %r"
                % (raw, k, v)) from None
        if k == "layers":
            layers = val
        elif k == "gamma":
            gamma = val
        else:
            raise ValueError(
                "MXNET_SPEC_DRAFT=%r: unknown field %r (supported: "
                "layers, gamma)" % (raw, k))
    if layers is None or layers < 1:
        raise ValueError(
            "MXNET_SPEC_DRAFT=%r: wants layers >= 1 (the draft must "
            "run at least one block)" % (raw,))
    if gamma < 1:
        raise ValueError(
            "MXNET_SPEC_DRAFT=%r: wants gamma >= 1 (a round must "
            "propose at least one token)" % (raw,))
    return layers, gamma


def _blob_dtype_ok(arr, dtype):
    """Does a blob array's numpy dtype carry the pool's torch ``dtype``
    bit for bit? bf16 travels as raw ``|V2`` words (the port's
    ``export_kv_rows``) or, from the JAX package, as an ml_dtypes
    ``bfloat16`` array (only where ml_dtypes imported it: the wire's
    unpickler refuses it otherwise)."""
    have = np.asarray(arr).dtype
    if dtype == torch.bfloat16:
        return have == np.dtype("V2") or have.name == "bfloat16"
    return have == torch.empty((), dtype=dtype).numpy().dtype


def _scatter_rows(pool, src, slots):
    """Rows 0..len(slots)-1 of every ``src`` cache into the pool's rows
    ``slots``, in place (``index_copy_`` on the batch axis): the pool's
    tensors keep their addresses, which the captured step reads."""
    idx = torch.as_tensor(list(slots), dtype=torch.int64)
    for name, dst in pool.items():
        dst.index_copy_(0, idx.to(dst.device), src[name][:len(slots)])


class _RowStep(_CapturedLoop):
    """The (B, 1) per-row-position decode step of one Generator's pool
    (``get_decode_symbol(per_row_pos=True)``) over static device tensors:
    ``data`` (B, 1), ``positions`` (B, 1), ``cache_pos`` (B,), the pool
    caches ``aux`` (written in place) and the last logits ``last``
    (B, V) float32. Captured once as a CUDA graph on the card and
    replayed; run directly elsewhere. :meth:`forward` runs the same graph
    eagerly at any Tnew (the speculative verify)."""

    def __init__(self, gen, aux, what="per-row decode symbol"):
        super().__init__(gen.device)
        sym = transformer.get_decode_symbol(
            **dict(gen._decode_opts, per_row_pos=True))
        if sym.list_arguments() != gen._sym.list_arguments():
            # checkpoint-binding contract: both variants must bind the
            # same parameter names
            raise ValueError(
                "%s drifted from the scalar twin: %r vs %r"
                % (what, sym.list_arguments(), gen._sym.list_arguments()))
        self._eval = _graph_eval_fn(sym)
        self.aux = aux
        B, dev = gen.batch_size, gen.device
        self.args = dict(gen._params)
        self.args["data"] = torch.zeros((B, 1), dtype=torch.float32,
                                        device=dev)
        self.args["positions"] = torch.zeros((B, 1), dtype=torch.float32,
                                             device=dev)
        self.args["cache_pos"] = torch.zeros((B,), dtype=torch.float32,
                                             device=dev)
        self.last = torch.zeros((B, gen.vocab_size), dtype=torch.float32,
                                device=dev)
        self.programs = 0        # the jit_cache_size gauge's value

    def forward(self, args):
        """The per-row graph over ``args`` with the pool caches; returns
        the (B, Tnew, V) logits. The caches must come back in place: a
        replaced tensor would leave the captured step reading stale
        memory."""
        with torch.no_grad():
            outs, new = self._eval(args, self.aux, 0, False)
        if any(new[k] is not v for k, v in self.aux.items()):
            raise RuntimeError("a cache op returned a new tensor: the "
                               "captured step needs its caches in place")
        return outs[0]

    def _step(self):
        self.last.copy_(self.forward(self.args)[:, -1])

    def run(self, toks, pos):
        """One step: ``toks`` (B, 1) ids and ``pos`` (B,) depths (host
        float32) into the static inputs, one replay (the first call
        captures), then the (B, V) logits read back to the host."""
        self.args["data"].copy_(torch.from_numpy(toks))
        self.args["positions"].copy_(torch.from_numpy(pos[:, None]))
        self.args["cache_pos"].copy_(torch.from_numpy(pos))
        self._steps(1)
        self.programs = 1
        return self.last.cpu().numpy()


class DecodeFuture:
    """One sequence's pending result: the full token row
    (prompt + generated, eos included when hit) or a typed error.

    Streaming consumers :meth:`subscribe` a sink to see every emitted
    token as the decode loop picks it (plus a ``None`` sentinel when
    the sequence settles) — the engine half of the serve path's
    streamed generate frames."""

    __slots__ = ("prompt", "max_new", "eos_id", "temperature", "top_k",
                 "top_p", "seed", "_key", "t_enq", "t_admit", "t_last",
                 "tc", "emitted", "pending", "n_cached", "handoff",
                 "resume", "speculative", "_ev", "_value", "_exc",
                 "_slock", "_sinks")

    def __init__(self, prompt, max_new, eos_id, temperature, top_k,
                 top_p, seed, handoff=None, speculative=False):
        self.prompt = prompt               # (P,) int64
        self.max_new = max_new
        self.eos_id = eos_id
        self.temperature = float(temperature or 0.0)
        self.top_k = top_k
        self.top_p = top_p
        self.seed = int(seed or 0)         # kept for export_session
        # one PRNG stream per request, split once per emitted token —
        # the exact key discipline of Generator.generate's loop, so a
        # sampled request reproduces independently of what else shares
        # the pool
        self._key = _threefry.PRNGKey(self.seed) \
            if self.temperature > 0 else None
        self.handoff = handoff             # remote-prefill admit state
        self.resume = None                 # migrated-session admit state
        self.speculative = bool(speculative)   # performance HINT only
        if handoff is not None and self._key is not None:
            # the remote prefill consumed the stream's FIRST split for
            # the first token it ships — advance past it so local
            # picks continue the exact generate() key discipline
            self._key, _ = _threefry.split(self._key)
        self.t_enq = _telemetry.now_ms()
        self.t_admit = None                # set when a slot is claimed
        self.t_last = None                 # last emission (inter-token)
        self.tc = _trace.current_context()  # submitter's span, if any
        self.emitted = []
        self.pending = None                # sampled but not yet fed
        self.n_cached = 0
        self._ev = threading.Event()
        self._value = None
        self._exc = None
        self._slock = threading.Lock()     # emitted/sink consistency
        self._sinks = []                   # streaming subscribers

    def _pick(self, row_logits, row_dev=None):
        """Next token id from this row's last-position logits: the host
        float32 copy ``row_logits`` (V,) for a greedy pick, the same row
        on the logits' device ``row_dev`` (V,) for a sampled one (the
        draw runs where ``generate``'s does)."""
        if self.temperature > 0:
            self._key, sub = _threefry.split(self._key)
            row = row_dev if row_dev is not None else \
                torch.from_numpy(np.asarray(row_logits, np.float32))
            return int(_pick_token(row[None], self.temperature,
                                   self.top_k, sub, self.top_p)[0])
        return int(np.argmax(np.asarray(row_logits)))

    def _peek_subs(self, k):
        """The next ``k`` sampling subs WITHOUT advancing the stream —
        the speculative draft proposes with the SAME noise the verify
        pick will use (common random numbers), and the stream itself
        only advances per EMITTED token (via :meth:`_pick`), so the
        key discipline stays exactly ``generate``'s whatever mix of
        proposals gets accepted."""
        key, subs = self._key, []
        for _ in range(k):
            key, sub = _threefry.split(key)
            subs.append(sub)
        return subs

    def subscribe(self, sink):
        """Register a token sink: it is first fed every
        already-emitted token in order (the replayed prefix a deduped
        or resumed streaming attempt owes its client), then each new
        token as the loop emits it, then ``None`` once the sequence
        settles (result or error). Delivery holds the emission lock,
        so a sink sees the stream exactly once, in order, with no gap
        between the prefix replay and live emissions — sinks must be
        cheap and non-blocking (a queue put)."""
        with self._slock:
            for t in self.emitted:
                sink(t)
            if self._ev.is_set():
                sink(None)
            else:
                self._sinks.append(sink)

    def unsubscribe(self, sink):
        with self._slock:
            try:
                self._sinks.remove(sink)
            except ValueError:
                pass

    def _emit(self, tok):
        """One emission: append + notify streaming sinks atomically
        (decode loop thread only)."""
        with self._slock:
            self.emitted.append(tok)
            for s in self._sinks:
                s(tok)
        self.pending = tok

    def _settle_sinks(self):
        with self._slock:
            self._ev.set()
            sinks, self._sinks = self._sinks, []
        for s in sinks:
            s(None)

    def _finish_ok(self):
        self._value = np.concatenate(
            [self.prompt, np.asarray(self.emitted, np.int64)])
        self._settle_sinks()

    def _fail(self, exc):
        self._exc = exc
        self._settle_sinks()

    def done(self):
        return self._ev.is_set()

    def result(self, timeout=None):
        if not self._ev.wait(timeout):
            raise RequestTimeout(
                "sequence still decoding after %.3fs" % timeout)
        if self._exc is not None:
            raise self._exc
        return self._value


class ContinuousDecoder:
    """Fixed-slot continuous batching over a Generator's decode state
    (KV caches for attention blocks, O(1) recurrent blobs for ssm
    blocks, both side by side in a mixed stack).

    The pool width is the Generator's ``batch_size``; its ``max_len``
    caps prompt + max_new_tokens per request. Requests queue FIFO
    (bounded by ``queue_cap`` → typed ``Overloaded``); ``close()``
    drains: admitted sequences finish, new submissions raise
    ``EngineClosed``.

    Int8 KV caches (``Generator(quantize_kv=True)``) are supported:
    the per-row op scatters the int8 rows and their per-token f32
    scale rows at each slot's own depth, halving cache bytes per slot.
    SSM blocks (``block_type="ssm"``) are supported: each slot's state
    is a constant-size blob, so a slot costs the same HBM at any
    depth. Not supported: rolling caches (the circular-buffer op has
    no per-row-position variant) and speculative drafts with ssm
    blocks (no per-position state to roll back) — both raised at
    construction here, not mid-request.

    Disaggregated serving (docs/serving.md §disaggregated prefill):
    ``submit(handoff=...)`` admits a sequence whose prefill ran on a
    REMOTE prefill replica — the shipped cache rows scatter into the
    slot (:meth:`import_kv_rows`) and admission runs zero prefill
    graph calls; the ``role`` attribute is what the fleet router's
    hello frame reads to learn this replica decodes."""

    role = "decode"                       # the hello frame's identity

    def __init__(self, generator, queue_cap=64, logger=None,
                 install_sigterm=False, draft=None, lookahead=None):
        if getattr(generator, "_rolling", False):
            raise ValueError(
                "continuous batching does not support rolling caches "
                "(the circular-buffer op has no per-row-position "
                "variant; quantize_kv int8 caches ARE supported — "
                "drop rolling_cache and size max_len to prompt + "
                "max_new_tokens instead)")
        self._gen = generator
        self._B = int(generator.batch_size)
        self._log = logger or logging.getLogger(__name__)
        self._cap = int(queue_cap)

        # the pool caches, at fixed addresses for the pool's lifetime,
        # and the per-row-position twin of the generator's decode graph
        # over them — same parameter names, so the generator's own
        # (placed, maybe quantized) param dict binds unchanged
        self._aux = generator._fresh_aux()
        self._row = _RowStep(generator, self._aux)

        # -- speculative decoding (docs/serving.md §speculative) --
        # draft=None consults MXNET_SPEC_DRAFT so subprocess replicas
        # opt whole fleets in through the environment; an explicit
        # draft= (any Generator sharing vocab + slot-pool width) wins
        if draft is None:
            cfg = spec_draft()
            if cfg is not None:
                layers, env_gamma = cfg
                draft = generator.truncated_draft(num_layers=layers)
                if lookahead is None:
                    lookahead = env_gamma
        self._draft = draft
        self._gamma = max(1, int(lookahead)) if lookahead else 4
        if draft is not None:
            if getattr(generator, "_has_ssm", False) or \
                    getattr(draft, "_has_ssm", False):
                # the env path (MXNET_SPEC_DRAFT -> truncated_draft)
                # already refused above; this catches an explicit
                # draft= with ssm blocks on either side
                raise ValueError(
                    "speculative decoding is not supported with ssm "
                    "blocks: the recurrent state has no per-position "
                    "entries to overwrite, so rejected proposals "
                    "would corrupt it (serve SSM models without a "
                    "draft, or use attention blocks for speculative "
                    "serving)")
            if draft.vocab_size != generator.vocab_size or \
                    draft.batch_size != generator.batch_size:
                raise ValueError(
                    "speculative draft must share vocab_size/"
                    "batch_size with the target (draft %d/%d vs "
                    "target %d/%d) — the draft decodes the same slot "
                    "pool" % (draft.vocab_size, draft.batch_size,
                              generator.vocab_size,
                              generator.batch_size))
            if getattr(draft, "_rolling", False):
                raise ValueError(
                    "speculative draft must not use a rolling cache "
                    "(rejected entries could alias older positions)")
            # the draft's own per-row-position twin: γ (B, 1) propose
            # steps per round, ONE captured step across slot turnover —
            # same discipline as the target step
            self._daux = draft._fresh_aux()    # the draft's pool caches
            self._drow = _RowStep(draft, self._daux,
                                  "per-row draft symbol")
            # verify rounds write up to γ speculative entries past a
            # row's live depth (on BOTH pools: the target's verify
            # chunk and the draft's propose steps), so every admission
            # needs γ headroom while a draft is attached — enforced
            # pool-wide in submit() because non-speculative rows ride
            # the same verify forward with junk tails
            self._spec_cap = min(int(generator.max_len),
                                 int(draft.max_len)) - self._gamma
            if self._spec_cap < 2:
                raise ValueError(
                    "lookahead %d leaves no speculative headroom at "
                    "min(target max_len=%d, draft max_len=%d) — grow "
                    "max_len or shrink lookahead"
                    % (self._gamma, generator.max_len, draft.max_len))
        else:
            self._drow = None
            self._daux = None
            self._spec_cap = None
        self._slots = [None] * self._B         # DecodeFuture per slot
        self._reserved = set()                 # slots held mid-chunk
        self._chunking = None                  # in-progress chunked prefill
        self._queue = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._draining = False
        self._closed = False
        # replay dedup (admit id -> the admission's own future): a
        # fleet-router replay after a transient fault returns the
        # ORIGINAL admission instead of double-admitting
        self._dedup = OrderedDict()
        self._evac_waiters = []                # (Event, [result]) pairs
        self._evac_flag = False                # SIGTERM handler sets

        self._admitted = 0
        self._finished = 0
        self._shed = 0
        self._steps = 0
        self._prefills = 0
        self._imported = 0
        self._resumed = 0
        self._evacuated = 0
        self._deduped = 0
        self._streams = 0
        self._streams_inflight = 0
        self._g_active = _telemetry.gauge("serve.decode.active_slots")
        # pool-measured twin of the Generator's static sizing gauge:
        # actual device-array bytes of the live cache pytree per slot.
        # Re-published every step (the gauge is last-write-wins and
        # any OTHER Generator construction — a speculative draft, a
        # second model — overwrites it with ITS static figure; the
        # live pool must win while it is serving)
        self._kv_bytes_per_slot = sum(
            v.numel() * v.element_size()
            for v in self._aux.values()) // self._B
        self._g_kv = _telemetry.gauge("serve.decode.kv_bytes_per_slot")
        self._g_kv.set(self._kv_bytes_per_slot)
        # one captured (B, 1) step across slot turnover is THE
        # property continuous batching exists for: the gauge counts
        # captured step graphs and reads 1 after any turnover (the
        # speculative verify runs eagerly and captures nothing)
        self._g_jit = _telemetry.gauge("serve.decode.jit_cache_size")
        self._h_slotfill = _telemetry.histogram(
            "serve.decode.slot_fill", buckets=_telemetry.COUNT_BUCKETS)
        self._h_req = _telemetry.histogram("serve.decode.request_ms")
        self._c_admitted = _telemetry.counter("serve.decode.admitted")
        self._c_finished = _telemetry.counter("serve.decode.finished")
        self._c_steps = _telemetry.counter("serve.decode.steps")
        self._c_imported = _telemetry.counter("serve.decode.imported")
        self._h_import = _telemetry.histogram("serve.decode.import_ms")
        self._c_resumed = _telemetry.counter("serve.decode.resumed")
        self._c_evacuated = _telemetry.counter("serve.decode.evacuated")
        self._c_deduped = _telemetry.counter("serve.decode.deduped")
        # interactive-latency product metrics: time to first
        # emitted token (from enqueue) and the gap between consecutive
        # emissions of one sequence — what streaming users actually
        # feel; tools/telemetry_report.py renders the quantiles
        self._h_ttft = _telemetry.histogram("serve.ttft_ms")
        self._h_itl = _telemetry.histogram("serve.inter_token_ms")
        self._c_streams = _telemetry.counter("serve.decode.streams")
        self._g_streams = _telemetry.gauge(
            "serve.decode.streams_active")
        self._c_chunks = _telemetry.counter(
            "serve.decode.prefill_chunks")

        # speculative accounting: instance ints always (stats() deltas
        # for benches), but the serve.spec.* telemetry series register
        # ONLY when a draft is attached — a draft-less pool must leave
        # the global snapshot exactly as before (perf-gate baselines
        # fingerprint every counter in it)
        self._spec_rounds = 0
        self._draft_steps = 0
        self._verify_steps = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._draft_prefills = 0
        if self._draft is not None:
            self._c_srounds = _telemetry.counter("serve.spec.rounds")
            self._c_dsteps = _telemetry.counter(
                "serve.spec.draft_steps")
            self._c_vsteps = _telemetry.counter(
                "serve.spec.verify_steps")
            self._c_proposed = _telemetry.counter(
                "serve.spec.proposed")
            self._c_accepted = _telemetry.counter(
                "serve.spec.accepted")
            self._c_dprefills = _telemetry.counter(
                "serve.spec.draft_prefills")
            # per-round per-row accepted/γ in [0, 1]; eighths resolve
            # the useful range at any lookahead <= 8
            self._h_accept = _telemetry.histogram(
                "serve.spec.accept_rate",
                buckets=tuple((i + 1) / 8 for i in range(8)))
            # one captured (B, 1) draft propose step across slot
            # turnover — the draft half of the one-graph discipline
            self._g_djit = _telemetry.gauge(
                "serve.spec.draft_jit_cache_size")

        self._shutdown = None
        if install_sigterm:
            from .. import guardrail as _guardrail
            self._shutdown = _guardrail.GracefulShutdown(
                signals=(signal.SIGTERM,), logger=self._log,
                on_request=self._request_evacuate,
                action="decode pool evacuating (active sessions "
                       "export for migration, then the pool drains)"
            ).install()

        slots_hint = str(_config.get("MXNET_DECODE_SLOTS") or "")
        if slots_hint and not slots_hint.startswith("auto"):
            raise ValueError(
                "MXNET_DECODE_SLOTS=%r: supported forms are '' (off), "
                "'auto' (report against the device HBM limit) or "
                "'auto:<bytes>' — the pool width itself is the "
                "Generator's batch_size, not this knob" % (slots_hint,))
        if slots_hint:
            budget = None
            if ":" in slots_hint:
                raw = slots_hint.split(":", 1)[1]
                try:
                    budget = float(raw)
                except ValueError:
                    budget = float("nan")
                import math
                if not (math.isfinite(budget) and budget > 0):
                    raise ValueError(
                        "MXNET_DECODE_SLOTS=%r: the budget after "
                        "'auto:' must be a positive finite number of "
                        "bytes (e.g. auto:16e9), got %r"
                        % (slots_hint, raw))
            self._log.info("decode slot sizing\n%s",
                           self.describe(hbm_budget=budget))

        self._thread = threading.Thread(
            target=self._loop, name="mxnet-serve-decode", daemon=True)
        self._thread.start()

    def describe(self, hbm_budget=None):
        """SpecLayout.describe()-style sizing report: pool geometry,
        state bytes per slot (KV rows — int8 + f32 scale rows under
        quantize_kv — and/or fixed-size SSM state blobs), and — given
        an HBM budget in bytes — how many slots would fit at the
        configured max_len. hbm_budget=None tries the device's
        reported bytes_limit (``MXNET_DECODE_SLOTS=auto:<bytes>``
        passes one explicitly). The budget math covers per-slot
        decode state only; weights and activations claim their share
        of HBM on top."""
        gen = self._gen
        bps = self._kv_bytes_per_slot
        kinds = []
        if any(not n.endswith("_state") for n in self._aux):
            kind = "int8 + f32 per-token scales" if gen._quantize_kv \
                else str(gen._cache_dtype).replace("torch.", "")
            kinds.append("KV rows %s (%s)" % (
                "x".join(str(d) for d in gen._cache_shape[1:]), kind))
        if any(n.endswith("_state") for n in self._aux):
            kinds.append("ssm state %s (float32, O(1) in max_len)" % (
                "x".join(str(d) for d in gen._state_shape[1:])))
        lines = [
            "ContinuousDecoder pool: %d slot(s), max_len=%d, "
            "%d layer(s)" % (self._B, gen.max_len,
                             gen.num_layers),
            "  per-slot state: %s" % "; ".join(kinds),
            "  kv_bytes_per_slot: %d (%.2f MiB)  pool total: %.2f MiB"
            % (bps, bps / 2 ** 20, bps * self._B / 2 ** 20),
        ]
        if hbm_budget is None and gen.device.type == "cuda":
            # the card's total memory (torch.cuda.mem_get_info), as the
            # JAX package reads the device's bytes_limit
            hbm_budget = float(torch.cuda.mem_get_info(gen.device)[1]) \
                or None
        if hbm_budget:
            fit = int(hbm_budget // bps) if bps else 0
            lines.append(
                "  HBM budget %.2f GiB -> %d slot(s) fit at "
                "max_len=%d (cache bytes only; weights/activations "
                "not counted)" % (hbm_budget / 2 ** 30, fit,
                                  gen.max_len))
        else:
            lines.append(
                "  no HBM budget known (the pool is not on a CUDA "
                "device) — set MXNET_DECODE_SLOTS=auto:<bytes>")
        return "\n".join(lines)

    # -- admission ----------------------------------------------------------
    def _check_blob(self, blob, want_pos=None,
                    why="the handoff must ship exactly the prompt's "
                        "prefill state"):
        """Loud structural validation of a handoff/resume blob BEFORE
        it is queued: names/shapes/dtypes must match this pool's own
        cache spec exactly (a blob from a mismatched generator — wrong
        architecture, wrong quantize_kv, wrong dtype — would scatter
        silently-wrong state; device-roundtrip exactness starts with
        refusing anything that isn't bit-compatible). ``want_pos``:
        the cached depth the blob must cover exactly — the prompt
        length for a handoff, prompt + fed tokens for a migrated
        session (None = trust the blob's own ``pos`` — the bare
        import_kv_rows surface)."""
        if not isinstance(blob, dict) or blob.get("v") != 1:
            raise ValueError("kv_blob is not an export_kv_rows v1 "
                             "blob: %r" % (type(blob).__name__,))
        pos = int(blob.get("pos", 0))
        if not 1 <= pos <= self._gen.max_len:
            raise ValueError(
                "kv_blob pos %d out of range for max_len=%d"
                % (pos, self._gen.max_len))
        if want_pos is not None and pos != want_pos:
            raise ValueError(
                "kv_blob covers %d cached token(s) but the admission "
                "expects %d — %s" % (pos, want_pos, why))
        rows = blob.get("rows") or {}
        if set(rows) != set(self._aux):
            raise ValueError(
                "kv_blob caches %s do not match this pool's %s"
                % (sorted(rows), sorted(self._aux)))
        for name, arr in rows.items():
            _, dtype = self._gen._aux_spec(name)
            want = self._gen._aux_row_shape(name, pos)
            if not _blob_dtype_ok(arr, dtype) or \
                    tuple(np.shape(arr)) != want:
                raise ValueError(
                    "kv_blob cache %r is %s%r, expected %s%r — blob "
                    "and pool generators disagree (architecture, "
                    "dtype or quantize_kv mismatch)"
                    % (name, np.asarray(arr).dtype, np.shape(arr),
                       str(dtype).replace("torch.", ""), want))
        return pos

    def import_kv_rows(self, slot, blob):
        """Scatter one exported sequence's decode state into ``slot``
        — the decode half of the handoff, exact to the bit vs the
        prefill device's own state. For KV caches only the blob's
        ``pos``-token prefix lands; stale entries past it in the slot
        are never attended (the per-row cache-position mask). SSM
        state blobs have no length axis and land whole — the same
        O(1) bytes at any ``pos``. Called by the decode loop during
        handoff admission; external callers must own a quiescent pool
        (the loop thread is the aux mutator)."""
        slot = int(slot)
        if not 0 <= slot < self._B:
            raise ValueError("slot %d out of range for %d-slot pool"
                             % (slot, self._B))
        pos = self._check_blob(blob)
        t0 = _telemetry.now_ms()
        # written into the pool's own tensors in place: the captured
        # step reads them at fixed addresses, so a replaced tensor would
        # leave it reading stale memory (and no program is built per pos)
        for name, arr in blob["rows"].items():
            t = _from_numpy(np.asarray(arr)).to(self._gen.device)
            dst = self._aux[name][slot]
            if not name.endswith("_state"):
                dst = dst[:, :pos]
            dst.copy_(t)
        if self._gen.device.type == "cuda":
            # import_ms times the copy, not its enqueue
            torch.cuda.synchronize(self._gen.device)
        ms = _telemetry.now_ms() - t0
        self._imported += 1
        self._c_imported.inc()
        self._h_import.observe(ms)
        return pos

    def export_session(self, slot):
        """The portable mid-decode state of one active slot — every
        piece a survivor needs to continue the sequence bit-exactly:
        the cache rows at ``pos = prompt + fed`` (device-exact, via
        the Generator's ``export_kv_rows``), the full request
        contract (prompt, sampling opts, seed), the emitted tokens
        and the pending not-yet-fed one. PRNG progress ships as
        DERIVED state — the stream splits once per drawn token, so
        ``submit(resume=...)`` re-derives the key by advancing
        ``len(emitted)`` splits (``generation.replay_key``) instead
        of trusting a shipped key. Callers outside the decode loop
        must own a quiescent pool (the loop thread is the aux
        mutator; :meth:`evacuate` runs this ON the loop thread)."""
        slot = int(slot)
        if not 0 <= slot < self._B:
            raise ValueError("slot %d out of range for %d-slot pool"
                             % (slot, self._B))
        req = self._slots[slot]
        if req is None:
            raise ValueError("slot %d holds no active sequence" % slot)
        blob = self._gen.export_kv_rows(self._aux, slot, req.n_cached)
        return {"v": 1,
                "prompt": np.asarray(req.prompt, np.int64),
                "max_new_tokens": int(req.max_new),
                "eos_id": req.eos_id,
                "temperature": req.temperature,
                "top_k": req.top_k,
                "top_p": req.top_p,
                "seed": req.seed,
                "emitted": [int(t) for t in req.emitted],
                "pending": int(req.pending),
                # a HINT for the survivor, not identity: resume works
                # (byte-identically) whether or not it carries a draft
                "speculative": bool(req.speculative),
                "kv_blob": blob}

    def submit(self, prompt, max_new_tokens, eos_id=None,
               temperature=0.0, top_k=None, top_p=None, seed=0,
               handoff=None, admit_id=None, resume=None,
               speculative=False):
        """Queue one sequence; returns a :class:`DecodeFuture` whose
        result is the full (prompt + generated) id row, exactly as
        ``Generator.generate`` would emit it for this prompt alone.

        ``handoff``: a remote prefill's ``{"first_token", "kv_blob",
        "pos"}`` reply (the ``prefill`` wire frame / a
        :class:`PrefillEngine` return). Admission then scatters the
        shipped cache rows into the slot and emits the shipped first
        token — zero prefill graph calls on this replica (asserted by
        the ``prefills`` stat).

        ``admit_id``: opaque exactly-once token (the fleet router
        sends one per generate). A resubmission carrying an id this
        replica has already admitted returns the ORIGINAL admission's
        future — a failover replay after a transient transport fault
        can never double-admit onto a replica that actually survived.

        ``resume``: an :meth:`export_session` state dict — readmit a
        session migrated off another replica mid-decode. The request
        args must describe the SAME request (the router re-sends the
        originals); the state supplies the progress: emitted tokens,
        the pending not-yet-fed token, and the cache rows, which
        scatter at ``pos = prompt + fed`` with zero prefill graph
        calls. The PRNG stream re-derives its key by advancing
        ``len(emitted)`` splits (``generation.replay_key``), so the
        remaining tokens are bit-identical to an unmigrated run.

        ``speculative``: opt this request into draft/verify rounds
        when the pool carries a draft — a pure performance HINT, not
        part of the request's identity: output is byte-identical
        either way (common-random-numbers verification), so a
        draft-less replica — e.g. the failover survivor of a
        speculative session — admits the same request down the
        ordinary (B, 1) path, and a resume need not restate it."""
        self._gen._check_sampling(temperature, top_k, top_p)
        prefill_chunk()   # loud knob validation on the CALLER's
        #                   thread — the decode loop must never die
        #                   on a config typo
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        P, n = int(prompt.shape[0]), int(max_new_tokens)
        if P < 1:
            raise ValueError("empty prompt")
        if handoff is not None and resume is not None:
            raise ValueError(
                "handoff and resume are mutually exclusive — a "
                "migrated session's state already contains its cache "
                "rows; the original handoff was consumed before the "
                "export")
        if handoff is not None:
            if not isinstance(handoff, dict) or \
                    "first_token" not in handoff or \
                    "kv_blob" not in handoff:
                raise ValueError(
                    "handoff wants the prefill frame's {'first_token',"
                    " 'kv_blob', 'pos'} dict, got %r"
                    % (type(handoff).__name__,))
            # structural blob validation happens HERE on the caller's
            # thread — a mismatched blob must fail the submission
            # loudly, never reach the decode loop
            self._check_blob(handoff["kv_blob"], P)
        emitted = None
        if resume is not None:
            if not isinstance(resume, dict) or resume.get("v") != 1 \
                    or "kv_blob" not in resume \
                    or "emitted" not in resume:
                raise ValueError(
                    "resume wants an export_session() state dict, "
                    "got %r" % (type(resume).__name__,))
            if not np.array_equal(
                    prompt, np.asarray(resume["prompt"],
                                       np.int64).reshape(-1)):
                raise ValueError(
                    "resume state is for a different prompt — the "
                    "request args and the migrated state must "
                    "describe the same generate")
            emitted = [int(t) for t in resume["emitted"]]
            if not emitted:
                raise ValueError(
                    "resume state carries no emitted tokens — a "
                    "session exports only after its first emission; "
                    "replay the request from scratch instead")
            if len(emitted) >= n:
                raise ValueError(
                    "resume state already holds %d emitted token(s) "
                    "of a max_new_tokens=%d request — nothing left "
                    "to decode" % (len(emitted), n))
            # the request args are authoritative, but they must
            # RESTATE the migrated request: a resume admitted under
            # different sampling opts would continue the stream
            # silently diverged from the donor (the PRNG key and the
            # pick discipline both derive from these args)
            for fld, have in (
                    ("temperature", float(temperature or 0.0)),
                    ("top_k", top_k), ("top_p", top_p),
                    ("seed", int(seed or 0))):
                theirs = resume.get(fld)
                if fld == "temperature":
                    theirs = float(theirs or 0.0)
                elif fld == "seed":
                    theirs = int(theirs or 0)
                if theirs != have:
                    raise ValueError(
                        "resume state was exported with %s=%r but "
                        "this admission says %s=%r — the request "
                        "args must restate the migrated request "
                        "(the resumed stream would silently "
                        "diverge)" % (fld, theirs, fld, have))
            # after k emitted tokens the last one is still pending
            # (not yet fed through the step), so the cache covers
            # exactly P + k - 1 positions
            self._check_blob(
                resume["kv_blob"], P + len(emitted) - 1,
                why="a migrated session's rows must cover prompt + "
                    "fed tokens")
        if P + n > self._gen.max_len:
            raise ValueError(
                "prompt (%d) + max_new_tokens (%d) exceeds the cache "
                "capacity max_len=%d" % (P, n, self._gen.max_len))
        if self._draft is not None and P + n > self._spec_cap:
            # pool-wide, not per-request: verify rounds write up to
            # lookahead speculative entries past EVERY live row's
            # depth (non-speculative rows ride the verify forward with
            # junk tails), so the headroom must hold for any row that
            # could share a round
            raise ValueError(
                "prompt (%d) + max_new_tokens (%d) exceeds the "
                "speculative headroom %d = min(target max_len=%d, "
                "draft max_len=%d) - lookahead %d; while a draft is "
                "attached every admission needs the headroom"
                % (P, n, self._spec_cap, self._gen.max_len,
                   self._draft.max_len, self._gamma))
        if self._gen._pos_rows is not None and \
                P + n > self._gen._pos_rows:
            raise ValueError(
                "prompt (%d) + max_new_tokens (%d) exceeds the "
                "trained position table (%d rows)"
                % (P, n, self._gen._pos_rows))
        req = DecodeFuture(prompt, n, eos_id, temperature, top_k,
                           top_p, seed, handoff=handoff,
                           speculative=speculative)
        if resume is not None:
            # PRNG progress is DERIVED state: one split per drawn
            # token, whatever path drew it (local pick or remote
            # handoff) — re-derive rather than ship a key
            if req._key is not None:
                req._key = replay_key(req.seed, len(emitted))
            req.emitted = emitted
            req.pending = int(resume["pending"])
            req.resume = resume["kv_blob"]
        if n == 0:                        # generate()'s n=0 contract
            req._finish_ok()
            return req
        if admit_id is not None:
            admit_id = str(admit_id)
        with self._cond:
            if admit_id is not None:
                prev = self._dedup.get(admit_id)
                if prev is not None:
                    # exactly-once admit: the replay rides the
                    # original admission (checked before the draining
                    # gate so a replayed request can still collect
                    # its answer from a draining replica)
                    self._dedup.move_to_end(admit_id)
                    self._deduped += 1
                    self._c_deduped.inc()
                    return prev
            if self._draining or self._closed:
                raise EngineClosed(
                    "decoder is draining — sequence rejected")
            if len(self._queue) >= self._cap:
                self._shed += 1
                _telemetry.counter("serve.shed").inc()
                raise Overloaded(
                    "decode queue full (%d sequences)"
                    % len(self._queue))
            if admit_id is not None:
                self._dedup[admit_id] = req
                while len(self._dedup) > _DEDUP_CAP:
                    self._dedup.popitem(last=False)
            self._queue.append(req)
            self._admitted += 1
            self._c_admitted.inc()
            self._cond.notify_all()
        return req

    def handle_generate(self, payload):
        """The ``generate`` wire frame (serve/net.py): submit one
        sequence — with its ``handoff`` blob when a remote prefill ran
        — and block the handler thread until the full row is back
        (concurrency comes from concurrent connections, the wire's
        standing contract). Payload keys mirror :meth:`submit`."""
        fut = self.submit(
            payload["prompt"], payload["max_new_tokens"],
            eos_id=payload.get("eos_id"),
            temperature=payload.get("temperature") or 0.0,
            top_k=payload.get("top_k"), top_p=payload.get("top_p"),
            seed=payload.get("seed") or 0,
            handoff=payload.get("handoff"),
            admit_id=payload.get("admit_id"),
            resume=payload.get("resume"),
            speculative=bool(payload.get("speculative")))
        try:
            return fut.result(payload.get("timeout"))
        except SessionEvacuated as exc:
            # the reply IS the session's portable state — the fleet
            # router resumes it on a survivor (serve/router.py) rather
            # than surfacing an error for a request nothing lost
            return {"evacuated": exc.state}

    def handle_generate_stream(self, payload, emit):
        """The streamed twin of :meth:`handle_generate`
        (serve/net.py's ``generate`` frame with ``stream: True``):
        submit the sequence, then relay every emitted token to
        ``emit(tokens, offset)`` ON THIS handler thread as the decode
        loop picks it — ``offset`` is the emission index of the
        chunk's first token, so a deduped replay (whose subscription
        replays the already-emitted prefix from offset 0) lets the
        client resume token-exact with no duplicated or missing
        frames. Returns the same final value as the one-shot path
        (the full id row, or the ``evacuated`` state dict) — the
        terminal frame carries it for bitwise comparison."""
        import queue as _qmod
        fut = self.submit(
            payload["prompt"], payload["max_new_tokens"],
            eos_id=payload.get("eos_id"),
            temperature=payload.get("temperature") or 0.0,
            top_k=payload.get("top_k"), top_p=payload.get("top_p"),
            seed=payload.get("seed") or 0,
            handoff=payload.get("handoff"),
            admit_id=payload.get("admit_id"),
            resume=payload.get("resume"),
            speculative=bool(payload.get("speculative")))
        q = _qmod.Queue()
        sink = q.put
        timeout = payload.get("timeout")
        deadline = None if timeout is None else \
            _telemetry.now_ms() + float(timeout) * 1000.0
        with self._lock:
            self._streams += 1
            self._streams_inflight += 1
            self._g_streams.set(self._streams_inflight)
        self._c_streams.inc()
        fut.subscribe(sink)
        try:
            offset = 0
            settled = False
            while not settled:
                wait = None if deadline is None else max(
                    0.0, (deadline - _telemetry.now_ms()) / 1000.0)
                try:
                    item = q.get(timeout=wait)
                except _qmod.Empty:
                    raise RequestTimeout(
                        "sequence still decoding after %.3fs"
                        % float(timeout))
                toks = []
                while True:
                    if item is None:       # settle sentinel
                        settled = True
                        break
                    toks.append(int(item))
                    try:
                        item = q.get_nowait()
                    except _qmod.Empty:
                        break
                if toks:
                    emit(toks, offset)
                    offset += len(toks)
        finally:
            fut.unsubscribe(sink)
            with self._lock:
                self._streams_inflight -= 1
                self._g_streams.set(self._streams_inflight)
        try:
            return fut.result(0)
        except SessionEvacuated as exc:
            return {"evacuated": exc.state}

    def generate_many(self, prompts, max_new_tokens, eos_id=None,
                      timeout=None, **kwargs):
        """Submit a batch of (possibly ragged) prompts and wait for all
        results — the closed-loop convenience wrapper; returns a list
        of id rows (ragged lengths when eos fires early)."""
        futs = [self.submit(p, max_new_tokens, eos_id=eos_id, **kwargs)
                for p in prompts]
        return [f.result(timeout) for f in futs]

    # -- the decode loop ----------------------------------------------------
    def _free_slots(self):
        return [i for i, s in enumerate(self._slots)
                if s is None and i not in self._reserved]

    def _draft_prefill_rows(self, slot, tokens):
        """Prefill the DRAFT cache for one admitted row from raw token
        ids — the local draft leg of handoff/resume admission (the
        wire blobs carry TARGET rows only; prefill replicas stay
        draft-agnostic). Rides the draft Generator's shared-position
        prefill graph, chunked by ``MXNET_PREFILL_CHUNK`` when set so
        arbitrary handoff lengths reuse the chunk-width programs
        instead of compiling one prefill shape per length."""
        toks = np.asarray(tokens, np.int64).reshape(-1)
        n = len(toks)
        aux = self._draft._fresh_aux()
        width = prefill_chunk() or n
        lo = 0
        while lo < n:
            hi = min(lo + width, n)
            rows = np.stack([toks[lo:hi]] * self._B)
            _, aux = self._draft._forward(
                aux, rows.astype(np.float32), lo)
            lo = hi
        _scatter_rows(self._daux, aux, [slot])
        self._draft_prefills += 1
        self._c_dprefills.inc()

    def _admit_handoff(self, slot, req):
        """Admit one remote-prefilled sequence: scatter its shipped
        cache rows into the slot (zero TARGET prefill graph calls —
        the ``prefills`` stat must not move; a speculative request
        does prefill its DRAFT cache locally) and emit the shipped
        first token. A bad blob fails THAT request's future and frees
        the slot; the loop and the other slots are untouched."""
        t0 = _telemetry.now_ms()
        try:
            pos = self.import_kv_rows(slot, req.handoff["kv_blob"])
            tok = int(req.handoff["first_token"])
            if self._draft is not None and req.speculative:
                self._draft_prefill_rows(slot, req.prompt)
        except Exception as exc:          # noqa: BLE001 — the future
            # is this sequence's one response; a scatter failure must
            # not kill the decode loop for every other slot
            req._fail(exc)
            return
        self._slots[slot] = req
        req.handoff = None     # the rows live on device now — holding
        #                        the host blob would double memory per
        #                        imported slot for the whole decode
        req.t_admit = _telemetry.now_ms()
        req.n_cached = pos
        if _trace.enabled():
            _trace.add_span("serve.decode.import", t0, req.t_admit,
                            parent=req.tc, slot=slot, pos=pos)
        self._emit(req, tok)
        self._maybe_finish(slot, tok)

    def _admit_resume(self, slot, req):
        """Admit one migrated mid-decode session: scatter its exported
        rows at ``pos = prompt + fed`` and continue the stream — no
        first-token emission (the state already carries the pending
        token) and no prefill graph call. A bad blob fails THAT
        request's future; the loop and the other slots are
        untouched."""
        t0 = _telemetry.now_ms()
        try:
            pos = self.import_kv_rows(slot, req.resume)
            if self._draft is not None and req.speculative:
                # the cache covers prompt + fed tokens (the pending
                # last emission is not yet fed) — prefill the draft
                # over exactly that prefix
                self._draft_prefill_rows(
                    slot, np.concatenate(
                        [np.asarray(req.prompt, np.int64),
                         np.asarray(req.emitted[:-1], np.int64)]))
        except Exception as exc:          # noqa: BLE001 — the future
            # is this sequence's one response; an import failure must
            # not kill the decode loop for every other slot
            req._fail(exc)
            return
        self._slots[slot] = req
        req.resume = None      # the rows live on device now
        req.t_admit = _telemetry.now_ms()
        req.n_cached = pos
        self._resumed += 1
        self._c_resumed.inc()
        if _trace.enabled():
            _trace.add_span("serve.decode.resume", t0, req.t_admit,
                            parent=req.tc, slot=slot, pos=pos,
                            emitted=len(req.emitted))

    def _admit(self):
        """Move queued prompts into free slots. Remote-prefilled
        sequences (a ``handoff`` rode the submit) scatter their
        shipped rows directly — no prefill graph call. Fresh prompts:
        one shared-position prefill per distinct prompt length per
        round (all admitted rows start at position 0, so the
        Generator's ordinary prefill graph serves); cache rows merge
        into the pool by a batch-axis scatter that walks the WHOLE aux
        pytree — under quantize_kv that carries the per-token f32
        scale caches alongside the int8 k/v rows (a merged row without
        its scales would dequant to garbage)."""
        with self._lock:
            free = self._free_slots()
            if not free or not self._queue:
                return
            batch = [self._queue.popleft()
                     for _ in range(min(len(free), len(self._queue)))]
        chunk = prefill_chunk()
        by_len = {}
        waiting = []       # long prompts parked behind an active chunk
        for req in batch:
            if req.resume is not None:
                self._admit_resume(free.pop(0), req)
                continue
            if req.handoff is not None:
                self._admit_handoff(free.pop(0), req)
                continue
            if chunk and len(req.prompt) > chunk:
                # long prompt: feed it to the cache chunk-by-chunk,
                # interleaved with decode steps, instead of stalling
                # every active slot for one monolithic (B, P) forward.
                # One chunked prefill at a time; later long prompts
                # wait their turn at the queue front (short prompts
                # are deliberately NOT held behind them)
                if self._chunking is None:
                    slot = free.pop(0)
                    self._reserved.add(slot)
                    self._chunking = {"req": req, "slot": slot,
                                      "aux": self._gen._fresh_aux(),
                                      "pos": 0,
                                      "t0": _telemetry.now_ms()}
                    if self._draft is not None and req.speculative:
                        # the draft cache prefills alongside, chunk
                        # by chunk on the same widths
                        self._chunking["daux"] = \
                            self._draft._fresh_aux()
                else:
                    waiting.append(req)
                continue
            by_len.setdefault(len(req.prompt), []).append(req)
        if waiting:
            with self._lock:
                self._queue.extendleft(reversed(waiting))
        for P, reqs in sorted(by_len.items()):
            rows = np.stack([r.prompt for r in reqs] +
                            [reqs[0].prompt] * (self._B - len(reqs)))
            logits, pref_aux = self._gen._forward(
                self._gen._fresh_aux(), rows.astype(np.float32), 0)
            self._prefills += 1
            last_dev = logits[:, -1].float()
            last = last_dev.cpu().numpy()
            _scatter_rows(self._aux, pref_aux, free[:len(reqs)])
            if self._draft is not None and \
                    any(r.speculative for r in reqs):
                # the draft's cache rows for this group, one shared-
                # position prefill on the draft's OWN graph (its
                # per-row propose program never sees prefill shapes) —
                # scattered for the whole group: non-speculative rows'
                # draft rows are unread garbage either way
                _, d_pref = self._draft._forward(
                    self._draft._fresh_aux(),
                    rows.astype(np.float32), 0)
                _scatter_rows(self._daux, d_pref, free[:len(reqs)])
                self._draft_prefills += 1
                self._c_dprefills.inc()
            for i, req in enumerate(reqs):
                slot = free.pop(0)
                self._slots[slot] = req
                req.t_admit = _telemetry.now_ms()
                req.n_cached = P
                tok = req._pick(last[i], last_dev[i])
                self._emit(req, tok)
                self._maybe_finish(slot, tok)

    def _emit(self, req, tok):
        """One token emission: latency metrics (TTFT on the first
        emission of a fresh request, inter-token gap after that), then
        the append + streaming-sink notify. Every emission path —
        fresh-prefill pick, shipped handoff token, chunked-prefill
        completion, per-step pick — funnels through here so the
        latency histograms and streamed frames can never drift from
        the row the one-shot path returns."""
        now = _telemetry.now_ms()
        if not req.emitted:
            self._h_ttft.observe(now - req.t_enq)
        elif req.t_last is not None:
            # resumed sessions arrive with a non-empty emitted prefix
            # but no local t_last — their first local emission gap
            # spans the migration, not a decode step, so it is skipped
            self._h_itl.observe(now - req.t_last)
        req.t_last = now
        req._emit(tok)

    def _maybe_finish(self, slot, tok):
        """Retire the slot's sequence if this emission ended it (eos or
        budget) — the slot frees NOW, so the next admission round can
        reuse it at the following step."""
        req = self._slots[slot]
        if (req.eos_id is not None and tok == req.eos_id) or \
                len(req.emitted) >= req.max_new:
            req._finish_ok()
            now = _telemetry.now_ms()
            self._h_req.observe(now - req.t_enq)
            self._finished += 1
            self._c_finished.inc()
            _telemetry.journal_event(
                "serve.decode.finish",
                tokens=len(req.emitted),
                ms=round(now - req.t_enq, 3))
            if _trace.enabled():
                # sequence lifecycle spans, retroactive from the
                # timestamps already taken: queue wait, then the slot
                # occupancy from admission to the finishing emission
                ctx = _trace.add_span(
                    "serve.decode.seq", req.t_enq, now, parent=req.tc,
                    tokens=len(req.emitted), prompt=len(req.prompt))
                if req.t_admit is not None:
                    _trace.add_span("serve.decode.queue", req.t_enq,
                                    req.t_admit, parent=ctx)
                    _trace.add_span("serve.decode.slot", req.t_admit,
                                    now, parent=ctx, slot=slot,
                                    tokens=len(req.emitted))
                # the decode thread holds no open span — flush the
                # retired sequence's records as one write
                _trace.flush()
            self._slots[slot] = None

    def _step(self):
        """One (B, 1) per-row-position decode step: every active slot
        ingests its pending token at its own depth and samples the
        next; inactive slots feed a dummy token at position 0 (their
        cache rows are garbage until the next admission overwrites
        them wholesale)."""
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return
        toks = np.zeros((self._B, 1), np.float32)
        pos = np.zeros((self._B,), np.float32)
        for i in active:
            toks[i, 0] = float(self._slots[i].pending)
            pos[i] = float(self._slots[i].n_cached)
        last = self._row.run(toks, pos)
        self._steps += 1
        self._c_steps.inc()
        self._h_slotfill.observe(len(active))
        self._g_active.set(len(active))
        # stays 1 across slot turnover — admissions never capture the
        # (B, 1) step again
        self._g_jit.set(self._row.programs)
        self._g_kv.set(self._kv_bytes_per_slot)   # live pool wins
        for i in active:
            req = self._slots[i]
            req.n_cached += 1
            tok = req._pick(last[i], self._row.last[i])
            self._emit(req, tok)
            self._maybe_finish(i, tok)

    def _draft_forward(self, toks, pos):
        """One (B, 1) per-row-position DRAFT step: the propose half of
        a speculative round. Returns the (B, V) last-position logits
        as float32 numpy (the device copy stays in ``_drow.last`` until
        the next draft step)."""
        last = self._drow.run(toks, pos)
        self._draft_steps += 1
        self._c_dsteps.inc()
        # stays 1 across slot turnover and round count
        self._g_djit.set(self._drow.programs)
        return last

    def _spec_round(self):
        """One speculative draft/verify round: γ compiled (B, 1) draft
        steps propose per-slot continuations, ONE (B, γ+1) target
        forward verifies them, and each row keeps its own longest-
        matching prefix plus the target's next token — per-row
        acceptance, lifting the eager path's lockstep rule.

        Exactness: the emission at index j is ALWAYS the target's own
        ``_pick`` on its logits for that index, with the request
        stream's (j+1)-th split; the draft proposed with the SAME sub
        (``_peek_subs`` — common random numbers), so "proposal
        accepted" literally means "equals what generate() would have
        picked". Byte-identity to the non-speculative path follows for
        greedy AND sampled requests, up to the verify forward's
        Tnew=γ+1 kernel-numerics caveat (generation.py,
        generate_speculative docstring).

        Cache discipline, per row: the verify forward writes γ+1
        entries at positions n_cached..n_cached+γ; the walk advances
        n_cached once per EMITTED token, so rejected entries sit past
        the row's depth where (a) the per-row mask keeps any
        correctly-conditioned query from attending them and (b) the
        next round's writes overwrite them before the row's depth
        reaches them. Same argument on the draft pool, which is why
        every admission pays γ headroom (``submit``'s _spec_cap
        check). Non-speculative rows ride the verify forward with
        junk tails and take only their column-0 pick — identical math
        to :meth:`_step`."""
        t0 = _telemetry.now_ms()
        active = [i for i, s in enumerate(self._slots)
                  if s is not None]
        spec = [i for i in active if self._slots[i].speculative]
        g = self._gamma
        toks = np.zeros((self._B, 1), np.float32)
        pos0 = np.zeros((self._B,), np.float32)
        for i in active:
            toks[i, 0] = float(self._slots[i].pending)
            pos0[i] = float(self._slots[i].n_cached)
        # peek each sampled row's subs WITHOUT advancing its stream —
        # the verify walk's _pick() calls advance it, once per
        # emitted token, exactly like every other emission path
        subs = {i: self._slots[i]._peek_subs(g) for i in spec
                if self._slots[i].temperature > 0}

        # -- propose: γ (B, 1) draft steps -----------------------------
        props = np.zeros((self._B, g), np.int64)
        cur = np.zeros((self._B, 1), np.float32)
        dpos = np.zeros((self._B,), np.float32)
        for t in range(g):
            for i in spec:
                cur[i, 0] = toks[i, 0] if t == 0 else \
                    float(props[i, t - 1])
                dpos[i] = pos0[i] + t
            # non-speculative and empty rows feed token 0 at draft
            # position 0: their draft cache rows are garbage by
            # definition, and position 0 is always in capacity
            dl = self._draft_forward(cur, dpos)
            for i in spec:
                req = self._slots[i]
                if req.temperature > 0:
                    props[i, t] = int(_pick_token(
                        self._drow.last[i][None], req.temperature,
                        req.top_k, subs[i][t], req.top_p)[0])
                else:
                    props[i, t] = int(np.argmax(dl[i]))

        # -- verify: ONE (B, γ+1) target forward -----------------------
        chunk = np.zeros((self._B, g + 1), np.float32)
        for i in active:
            chunk[i, 0] = toks[i, 0]
            for t in range(g):
                # non-speculative rows repeat their pending token as a
                # junk tail; only their column-0 logits are read
                chunk[i, t + 1] = float(props[i, t]) if i in spec \
                    else toks[i, 0]
        dev = self._gen.device
        args = dict(self._gen._params)
        args["data"] = torch.from_numpy(chunk).to(dev)
        args["positions"] = torch.from_numpy(
            pos0[:, None] + np.arange(g + 1, dtype=np.float32)[None]
        ).to(dev)
        args["cache_pos"] = torch.from_numpy(pos0).to(dev)
        # the verify runs eagerly over the pool caches (in place)
        vlog = self._row.forward(args).float()           # (B, g+1, V)
        logits = vlog.cpu().numpy()
        self._steps += 1
        self._c_steps.inc()
        self._verify_steps += 1
        self._c_vsteps.inc()
        self._spec_rounds += 1
        self._c_srounds.inc()
        self._h_slotfill.observe(len(active))
        self._g_active.set(len(active))
        self._g_jit.set(self._row.programs)
        self._g_kv.set(self._kv_bytes_per_slot)   # live pool wins

        # -- per-row acceptance walk -----------------------------------
        accepted = proposed = 0
        full = []          # rows needing the draft catch-up feed
        for i in active:
            req = self._slots[i]
            if i not in spec:
                # the _step() math, read off the verify forward
                req.n_cached += 1
                tok = req._pick(logits[i, 0], vlog[i, 0])
                self._emit(req, tok)
                self._maybe_finish(i, tok)
                continue
            proposed += g
            acc = 0
            for j in range(g + 1):
                req.n_cached += 1
                tok = req._pick(logits[i, j], vlog[i, j])
                self._emit(req, tok)
                matched = j < g and int(props[i, j]) == tok
                if matched:
                    acc += 1
                self._maybe_finish(i, tok)
                if self._slots[i] is None or not matched:
                    break
            accepted += acc
            self._h_accept.observe(acc / g)
            if acc == g and self._slots[i] is not None:
                full.append(i)
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        self._c_proposed.inc(proposed)
        self._c_accepted.inc(accepted)

        if full:
            # full acceptance: the draft never ingested its last
            # proposal's k/v (its loop stops after computing it) —
            # one conditional catch-up step fills the hole at the
            # row's old pos0+γ. Rows that were speculative this round
            # but are not catching up write JUNK at their own pos0+γ
            # (inside the γ headroom, past their valid prefix, and
            # overwritten by a later feed before any correctly-
            # conditioned query can attend it — NEVER at position 0,
            # which holds their live prompt k/v); non-speculative and
            # empty rows write at their garbage rows' position 0
            for i in range(self._B):
                if i in full:
                    cur[i, 0] = float(props[i, g - 1])
                    dpos[i] = pos0[i] + g
                elif i in spec:
                    cur[i, 0] = 0.0
                    dpos[i] = pos0[i] + g
                else:
                    cur[i, 0] = 0.0
                    dpos[i] = 0.0
            self._draft_forward(cur, dpos)
        if _trace.enabled():
            _trace.add_span("serve.spec.round", t0,
                            _telemetry.now_ms(), rows=len(spec),
                            proposed=proposed, accepted=accepted)

    def _chunk_step(self):
        """Feed ONE chunk of the in-progress chunked prefill — called
        once per loop iteration between admission and the (B, 1) step,
        so active sessions pay one chunk-width forward per token
        instead of the whole prompt at once. Chunk forwards ride the
        Generator's ordinary shared-position graph, run eagerly; the
        per-row (B, 1) step's captured graph never moves. The
        math is bit-identical to the monolithic prefill: every forward
        attends the full masked cache buffer, so splitting the query
        axis changes no reduction a kept position sees."""
        ch = self._chunking
        if ch is None:
            return
        req, slot = ch["req"], ch["slot"]
        P = len(req.prompt)
        lo = ch["pos"]
        hi = min(lo + prefill_chunk(), P)
        rows = np.stack([req.prompt[lo:hi]] * self._B)
        try:
            logits, ch["aux"] = self._gen._forward(
                ch["aux"], rows.astype(np.float32), lo)
            if "daux" in ch:
                _, ch["daux"] = self._draft._forward(
                    ch["daux"], rows.astype(np.float32), lo)
        except Exception as exc:          # noqa: BLE001 — the future
            # is this sequence's one response; a failed chunk must not
            # kill the decode loop for every other slot
            self._chunking = None
            self._reserved.discard(slot)
            req._fail(exc)
            return
        ch["pos"] = hi
        self._c_chunks.inc()
        if _trace.enabled():
            _trace.add_span("serve.decode.prefill_chunk",
                            ch.pop("t_chunk", ch["t0"]),
                            _telemetry.now_ms(), parent=req.tc,
                            slot=slot, lo=lo, hi=hi)
            ch["t_chunk"] = _telemetry.now_ms()
        if hi < P:
            return
        # final chunk: merge the fully-prefilled row into the pool
        # (same batch-axis scatter as the monolithic path) and emit
        # the first token
        _scatter_rows(self._aux, ch["aux"], [slot])
        if "daux" in ch:
            _scatter_rows(self._daux, ch["daux"], [slot])
            self._draft_prefills += 1
            self._c_dprefills.inc()
        self._prefills += 1
        last_dev = logits[:1, -1].float()
        last = last_dev.cpu().numpy()
        self._chunking = None
        self._reserved.discard(slot)
        self._slots[slot] = req
        req.t_admit = _telemetry.now_ms()
        req.n_cached = P
        tok = req._pick(last[0], last_dev[0])
        self._emit(req, tok)
        self._maybe_finish(slot, tok)

    def _loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._draining and \
                        not self._evac_waiters and \
                        not self._evac_flag and \
                        self._chunking is None and \
                        all(s is None for s in self._slots):
                    self._cond.wait(0.05)
                if self._draining and not self._queue and \
                        not self._evac_waiters and \
                        not self._evac_flag and \
                        self._chunking is None and \
                        all(s is None for s in self._slots):
                    break
            if self._evac_waiters or self._evac_flag:
                self._do_evacuate()
                continue
            self._admit()
            self._chunk_step()
            if self._draft is not None and any(
                    s is not None and s.speculative
                    for s in self._slots):
                self._spec_round()
            else:
                # draft-less pools and rounds with no speculative
                # participant run the ordinary (B, 1) step — a
                # mixed-traffic pool flips between the captured step
                # and the eager verify, never captures a second step
                self._step()
        self._g_active.set(0)
        _telemetry.journal_event("serve.decode.stop")

    # -- migration ----------------------------------------------------------
    def evacuate(self, timeout=30.0):
        """Export every active session off the pool: each in-flight
        generate's future fails with :class:`SessionEvacuated`
        carrying its :meth:`export_session` state (the wire handler
        turns that into an ``evacuated`` reply the fleet router
        resumes on a survivor); queued-but-unadmitted requests fail
        with ``EngineClosed`` and replay from scratch. The export runs
        on the decode loop thread (the pool's one aux mutator); this
        call blocks until it completes and returns the number of
        sessions exported. The pool itself stays OPEN — a
        config-reload recycle re-warms and readmits this replica —
        so a migrating recycle is bounded by export+import cost, not
        by its longest sequence."""
        ev = threading.Event()
        out = []
        with self._cond:
            if self._closed:
                raise EngineClosed("decoder is closed")
            self._evac_waiters.append((ev, out))
            self._cond.notify_all()
        if not ev.wait(timeout):
            raise RequestTimeout(
                "evacuation still pending after %.3fs" % timeout)
        return out[0]

    def _request_evacuate(self):
        # SIGTERM-handler context (guardrail.GracefulShutdown): set
        # the flag only — no locks, no telemetry, no device work. The
        # decode loop notices within one 0.05s cond-wait tick.
        self._evac_flag = True

    def _do_evacuate(self):
        """Runs ON the decode loop thread: export + fail every active
        slot, reject the queue, wake the evacuate() waiters. A SIGTERM
        evacuation (``_evac_flag``) also drains the pool — the process
        is ending, so there is nothing to readmit for."""
        t0 = _telemetry.now_ms()
        with self._cond:
            waiters, self._evac_waiters = self._evac_waiters, []
            sig, self._evac_flag = self._evac_flag, False
            if sig:
                self._draining = True
            queued = list(self._queue)
            self._queue.clear()
        n = 0
        for slot in range(self._B):
            req = self._slots[slot]
            if req is None:
                continue
            try:
                state = self.export_session(slot)
            except Exception as exc:      # noqa: BLE001 — the future
                # is this sequence's one response; a failed export
                # must surface there, not kill the loop
                self._slots[slot] = None
                req._fail(exc)
                continue
            self._slots[slot] = None
            req._fail(SessionEvacuated(state))
            n += 1
        ch, self._chunking = self._chunking, None
        if ch is not None:
            # a half-prefilled prompt has no portable session yet
            # (no emitted token, partial cache) — prefill is pure, so
            # it replays from scratch exactly like a queued request
            self._reserved.discard(ch["slot"])
            queued.append(ch["req"])
        for req in queued:
            req._fail(EngineClosed(
                "evacuated before admission — replay the request on "
                "another replica"))
        self._evacuated += n
        if n:
            self._c_evacuated.inc(n)
        self._g_active.set(0)
        _telemetry.journal_event(
            "serve.decode.evacuate", sessions=n, queued=len(queued),
            sigterm=bool(sig),
            ms=round(_telemetry.now_ms() - t0, 3))
        for ev, out in waiters:
            out.append(n)
            ev.set()

    # -- lifecycle ----------------------------------------------------------
    @property
    def draining(self):
        return self._draining or self._closed

    def close(self, timeout=None):
        """Drain: admitted sequences decode to completion, new
        submissions raise EngineClosed, then the loop thread exits.
        ``timeout=None`` reads ``MXNET_DECODE_DRAIN_TIMEOUT`` (the
        router's recycle of a decode replica budgets its drain from
        the same knob — one drain clock, not a hardcoded 60 here and
        a knob everywhere else)."""
        if timeout is None:
            timeout = drain_timeout()
        with self._cond:
            already = self._closed
            self._draining = True
            pending = len(self._queue)
            self._cond.notify_all()
        if not already:
            _telemetry.journal_event("serve.decode.drain",
                                     pending=pending)
        self._thread.join(timeout)
        self._closed = True
        if self._shutdown is not None:
            self._shutdown.uninstall()
            self._shutdown = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def stats(self):
        return {"admitted": self._admitted, "finished": self._finished,
                "shed": self._shed,
                "steps": self._steps, "prefills": self._prefills,
                "imported": self._imported, "resumed": self._resumed,
                "evacuated": self._evacuated,
                "deduped": self._deduped,
                "streams": self._streams,
                "spec_rounds": self._spec_rounds,
                "draft_steps": self._draft_steps,
                "spec_proposed": self._spec_proposed,
                "spec_accepted": self._spec_accepted,
                "draft_prefills": self._draft_prefills,
                "active": sum(s is not None for s in self._slots),
                "queued": len(self._queue)}

    def introspect(self):
        """Live state for the ``stats`` introspection frame
        (serve/net.py answers it for ANY engine-like object): slot
        headroom and queue depth. ``decode_free_slots`` is the signal
        the fleet router's session placement consumes — a new decode
        session goes to the replica with the most free slots
        (serve/router.py)."""
        out = self.stats()
        out["queue_depth"] = out.pop("queued")
        out["in_flight"] = out["active"] + out["queue_depth"]
        out["decode_free_slots"] = (self._B - out["active"]
                                    - len(self._reserved))
        out["slots"] = self._B
        out["streams_in_flight"] = self._streams_inflight
        out["speculative"] = self._draft is not None
        out["draining"] = self.draining
        return out
