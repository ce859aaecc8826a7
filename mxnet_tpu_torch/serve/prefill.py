"""Dedicated prefill engine — the compute half of prefill/decode
disaggregation (docs/serving.md §disaggregated prefill). The PyTorch twin
of ``mxnet_tpu/serve/prefill.py``: the same frames, batching and key
discipline (the first token consumes the first threefry split of the
request's stream, ``_threefry``, bit-compatible with the JAX package's).

In a colocated replica every long prompt stalls the
``ContinuousDecoder`` step loop: the (B, P) prefill graph call runs on
the same device stream as the (B, 1) decode step, so every active
slot's inter-token latency inflates by the whole prefill while it
runs, and decode HBM headroom has to cover prefill activation peaks.
Splitting the phases is the paper's own identity applied to inference
— state moves between machines (the exported KV rows over the wire,
PAPER.md's push/pull), compute stays local (the prefill graph on
prefill chips, the decode step on decode chips) — grounded by the
portable O(1) decode state of arXiv 2603.09555 and halved in bytes by
the int8 KV cache.

:class:`PrefillEngine` is the engine a prefill replica's
``ServeServer`` fronts: it answers the ``prefill`` wire frame with
``{"first_token", "kv_blob", "pos"}`` — one shared-position prefill
forward, the first sampled/greedy token (consuming exactly the first
split of the request's PRNG stream, so the decode side continues the
``generate()`` key discipline bit-for-bit), and the sequence's cache
rows exported via :meth:`Generator.export_kv_rows`. Prefill is PURE:
the same prompt + seed always lands the same reply, so a transport
fault mid-handoff simply replays (no dedup table, exactly like the
infer path's contract in serve/net.py). The same purity is one leg
of the fleet's replica-death failover: when a decode replica dies
mid-generate, the router replays the whole request — a re-run
prefill (local or remote) recomputes the identical first token and
blob, so the replayed completion is token-for-token what the dead
replica would have emitted (docs/robustness.md, fleet failure
semantics).

No sockets here — transport is serve/net.py's job (lint-enforced).
"""
from __future__ import annotations

import logging
import threading

import numpy as np

from .. import config as _config
from .. import telemetry as _telemetry
from .. import trace as _trace
from ..generation import kv_blob_nbytes
from .engine import EngineClosed

__all__ = ["PrefillEngine"]


class _PendingPrefill:
    """One queued prefill awaiting the coalescing batcher."""

    __slots__ = ("prompt", "temperature", "top_k", "top_p", "seed",
                 "ev", "out", "exc")

    def __init__(self, prompt, temperature, top_k, top_p, seed):
        self.prompt = prompt
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed
        self.ev = threading.Event()
        self.out = None                    # (first_token, blob)
        self.exc = None


class PrefillEngine:
    """One Generator serving the ``prefill`` frame.

    The generator's ``batch_size`` is a compute detail here (the
    prompt is replicated across rows and row 0 exported); size it 1
    on a dedicated prefill chip unless you batch prefills some other
    way. ``max_len`` bounds the prompt length this replica accepts —
    the DECODE side's capacity bounds prompt + max_new_tokens.

    ``warm_lengths``: prompt lengths ``warmup()`` pre-compiles (the
    prefill graph specializes per (B, P) like any bucket; the fleet
    router's ``warm`` frame lands here on recycle). Empty = warmup is
    a no-op.

    Batched prefill: with ``batch_size > 1``, concurrent
    prefills coalesce — a batcher thread holds the oldest queued
    prompt for the ``MXNET_SERVE_MAX_WAIT_MS`` window (the serve
    batcher's own knob: one coalescing clock for the whole stack),
    right-pads the group to its longest prompt and runs ONE shared-
    position (B, P_max) forward, exporting each row at its own true
    length. Causal masking makes the padding inert: a row's kept
    positions attend only its own prefix, and the masked tail
    contributes exact zeros to every reduction — each coalesced reply
    is bitwise the solo reply (pinned in
    tests/test_serve_streaming.py). A window of 0 or a 1-row pool
    restores the direct per-request path."""

    role = "prefill"                      # the hello frame's identity

    def __init__(self, generator, warm_lengths=(), logger=None):
        if getattr(generator, "_rolling", False):
            raise ValueError(
                "prefill disaggregation does not support rolling "
                "caches (export_kv_rows needs position-aligned rows)")
        self._gen = generator
        self._log = logger or logging.getLogger(__name__)
        self._warm_lengths = tuple(int(p) for p in warm_lengths)
        # exactly prefill()'s own prompt bounds — a length the
        # constructor accepts must never make warmup() raise later
        # (a recycle re-warm that always fails would park the freshly
        # restarted replica SUSPECT every time)
        cap = generator.max_len
        if generator._pos_rows is not None:
            cap = min(cap, generator._pos_rows)
        if any(p < 1 or p >= cap for p in self._warm_lengths):
            raise ValueError(
                "warm_lengths %r out of range 1..%d (max_len and the "
                "trained position table both need decode headroom "
                "past the prompt)" % (self._warm_lengths, cap - 1))
        self._lock = threading.Lock()
        self._inflight = 0
        self._prefills = 0
        self._warmed = []
        self._c_requests = _telemetry.counter("serve.prefill.requests")
        self._c_tokens = _telemetry.counter("serve.prefill.tokens")
        self._h_ms = _telemetry.histogram("serve.prefill.ms")
        self._h_export = _telemetry.histogram("serve.prefill.export_ms")
        # byte-scale buckets (the ms/count defaults top out far below
        # a cache blob): 1 KiB .. 64 MiB in x4 steps
        self._h_bytes = _telemetry.histogram(
            "serve.prefill.blob_bytes",
            buckets=tuple(float(1 << s) for s in range(10, 27, 2)))
        self._c_batched = _telemetry.counter("serve.prefill.batched")
        self._h_fill = _telemetry.histogram(
            "serve.prefill.batch_fill",
            buckets=_telemetry.COUNT_BUCKETS)
        # the coalescing batcher: only worth a thread when the pool
        # can actually hold more than one row and the window allows
        # coalescing at all
        self._wait_ms = float(
            _config.get("MXNET_SERVE_MAX_WAIT_MS") or 0.0)
        self._pending = []
        self._pcond = threading.Condition()
        self._closed = False
        self._batcher = None
        if generator.batch_size > 1 and self._wait_ms > 0:
            self._batcher = threading.Thread(
                target=self._batch_loop, name="mxnet-serve-prefill",
                daemon=True)
            self._batcher.start()

    def prefill(self, prompt, temperature=0.0, top_k=None, top_p=None,
                seed=0, _record=True, speculative=False, **_ignored):
        """One sequence's prefill: returns the handoff dict
        ``{"first_token": int, "kv_blob": export_kv_rows blob,
        "pos": len(prompt)}`` a remote
        ``ContinuousDecoder.submit(handoff=...)`` admits from.
        Pure — replaying the same call lands the same reply.
        ``_record=False`` (warmup's compile drives) keeps the
        request-level telemetry/stats clean: ``serve.prefill.*`` and
        ``stats()['prefills']`` count served traffic only — and skips
        the coalescing batcher (a warmup must compile the exact
        declared length, not a group's padded one).

        ``speculative`` is accepted and deliberately IGNORED: prefill
        replicas are draft-agnostic. The handoff blob carries TARGET
        cache rows only — a speculative decode admission prefills its
        DRAFT cache locally from the prompt ids it already holds,
        riding the chunked-prefill widths (decode.py
        ``_draft_prefill_rows``), so drafts never change the wire
        format, the blob bytes, or this replica's compiled shapes."""
        gen = self._gen
        gen._check_sampling(temperature, top_k, top_p)
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        P = int(prompt.shape[0])
        if P < 1:
            raise ValueError("empty prompt")
        if P >= gen.max_len:
            raise ValueError(
                "prompt (%d) leaves no decode headroom at this "
                "prefill replica's max_len=%d" % (P, gen.max_len))
        if gen._pos_rows is not None and P >= gen._pos_rows:
            raise ValueError(
                "prompt (%d) exceeds the trained position table (%d "
                "rows)" % (P, gen._pos_rows))
        t0 = _telemetry.now_ms()
        sp = _trace.start_span("serve.prefill", tokens=P)
        req = _PendingPrefill(prompt, float(temperature or 0.0),
                              top_k, top_p, int(seed or 0))
        try:
            with self._lock:
                self._inflight += 1
            if self._batcher is not None and _record:
                with self._pcond:
                    if self._closed:
                        raise EngineClosed("prefill engine closed")
                    self._pending.append(req)
                    self._pcond.notify_all()
                req.ev.wait()
            else:
                self._run_group([req])
            if req.exc is not None:
                raise req.exc
            tok, blob, export_ms = req.out
            t1 = _telemetry.now_ms()
            if _record:
                nbytes = kv_blob_nbytes(blob)
                with self._lock:
                    self._prefills += 1
                self._c_requests.inc()
                self._c_tokens.inc(P)
                self._h_ms.observe(t1 - t0)
                self._h_export.observe(export_ms)
                self._h_bytes.observe(nbytes)
                _telemetry.journal_event(
                    "serve.prefill", tokens=P, blob_bytes=nbytes,
                    ms=round(t1 - t0, 3))
            return {"first_token": tok, "kv_blob": blob, "pos": P}
        finally:
            with self._lock:
                self._inflight -= 1
            _trace.end_span(sp)

    def _run_group(self, group):
        """One shared-position forward for a coalesced group: prompts
        right-pad to the group's longest, spare pool rows replicate
        row 0, and each request's first token and cache rows come off
        ITS row at ITS true length — causal masking keeps every kept
        position's math identical to a solo run (the padded tail is
        never attended by a real position, and masked terms are exact
        zeros in the reductions), so coalescing is invisible in the
        bits. Solo callers (warmup, 1-row pools, window 0) pass a
        1-element group and run on their own thread.

        SSM generators coalesce only length-homogeneous groups: the
        recurrent state has no positional mask — a padded tail's
        tokens would be ABSORBED into the exported state blob — so a
        mixed-length group splits into per-length subgroups, each its
        own shared forward (same replies, one extra graph call per
        extra distinct length)."""
        from .. import _threefry
        from ..generation import _pick_token
        gen = self._gen
        if getattr(gen, "_has_ssm", False):
            by_len = {}
            for g in group:
                by_len.setdefault(int(g.prompt.shape[0]),
                                  []).append(g)
            if len(by_len) > 1:
                for sub in by_len.values():
                    self._run_group(sub)
                return
        pmax = max(int(g.prompt.shape[0]) for g in group)
        rows = np.zeros((gen.batch_size, pmax), np.int64)
        for i, g in enumerate(group):
            rows[i, :g.prompt.shape[0]] = g.prompt
        for i in range(len(group), gen.batch_size):
            rows[i] = rows[0]
        try:
            logits, aux = gen._forward(gen._fresh_aux(),
                                       rows.astype(np.float32), 0)
        except Exception as exc:          # noqa: BLE001 — each waiter
            # owns its own failure; the batcher thread must survive
            for g in group:
                g.exc = exc
                g.ev.set()
            return
        if len(group) > 1:
            self._c_batched.inc()
        self._h_fill.observe(len(group))
        for i, g in enumerate(group):
            try:
                P = int(g.prompt.shape[0])
                # the request PRNG stream's FIRST split picks the
                # first token — exactly generate()'s round-1
                # discipline; the decode side advances its own key
                # past this split
                _, sub = _threefry.split(_threefry.PRNGKey(g.seed))
                tok = int(_pick_token(
                    logits[i:i + 1, P - 1], g.temperature, g.top_k,
                    sub, g.top_p)[0])
                t_exp = _telemetry.now_ms()
                blob = gen.export_kv_rows(aux, i, P)
                g.out = (tok, blob,
                         _telemetry.now_ms() - t_exp)
            except Exception as exc:      # noqa: BLE001 — per-row
                g.exc = exc
            g.ev.set()

    def _batch_loop(self):
        """The coalescing batcher (one per engine, like the serve
        batcher): hold the oldest queued prefill for the
        MXNET_SERVE_MAX_WAIT_MS window or until the pool is full,
        then run the group as one padded forward."""
        B = self._gen.batch_size
        while True:
            with self._pcond:
                while not self._pending and not self._closed:
                    self._pcond.wait(0.05)
                if self._closed and not self._pending:
                    return
                t0 = _telemetry.now_ms()
                while len(self._pending) < B and not self._closed:
                    left = self._wait_ms - (_telemetry.now_ms() - t0)
                    if left <= 0:
                        break
                    self._pcond.wait(left / 1000.0)
                group = self._pending[:B]
                del self._pending[:B]
            if group:
                self._run_group(group)

    # -- engine-surface lifecycle / introspection ---------------------------
    def warmup(self):
        """Pre-compile the declared prompt-length specializations so a
        recycled prefill replica never pays a cold first-call compile on a
        live prompt (the fleet router's ``warm`` frame)."""
        for P in self._warm_lengths:
            # compile drive only: request-level telemetry stays clean
            # (warmups must never read as served traffic)
            self.prefill(np.zeros((P,), np.int64), _record=False)
            if P not in self._warmed:
                self._warmed.append(P)
        _telemetry.journal_event("serve.prefill.warmup",
                                 lengths=list(self._warm_lengths))

    @property
    def warmed_buckets(self):
        """Prompt lengths warmup() pre-compiled (the warm frame's
        reply; a prefill 'bucket' is a prompt length)."""
        return list(self._warmed)

    @property
    def draining(self):
        return False

    def stats(self):
        with self._lock:
            return {"prefills": self._prefills,
                    "in_flight": self._inflight}

    def introspect(self):
        """The ``stats`` frame's engine half: in-flight prefills are
        the load signal (there is no queue — concurrency is the
        connection count, each prefill synchronous on its handler
        thread)."""
        out = self.stats()
        out["queue_depth"] = 0
        out["draining"] = self.draining
        out["warmed"] = self.warmed_buckets
        return out

    def close(self, timeout=None):
        """In-flight prefills finish on their handler threads; the
        coalescing batcher (when running) drains its queue and
        exits — anything still queued after the join fails with
        ``EngineClosed`` rather than hanging its waiter."""
        batcher = self._batcher
        with self._pcond:
            self._closed = True
            self._pcond.notify_all()
        if batcher is not None:
            batcher.join(5.0 if timeout is None else timeout)
        with self._pcond:
            stranded, self._pending = self._pending, []
        for req in stranded:
            req.exc = EngineClosed("prefill engine closed")
            req.ev.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
