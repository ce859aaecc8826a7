"""Thin TCP front end for the serving engine — the PyTorch twin of
``mxnet_tpu/serve/net.py`` (same frames, same fault points, same
stream-idle timeout), so a port replica answers the JAX package's router
and the port's router drives JAX replicas.

Deliberately REUSES the async-PS wire plumbing instead of inventing a
second transport: the 4-byte length-prefixed pickle framing
(``serve/_wire.py`` ``_send_msg`` / ``_recv_msg``; its unpickler
resolves only the types a serving frame holds), the
``RetryPolicy`` transient/fatal classification, and the deterministic
``FaultInjector`` — so the whole ``MXNET_FAULT_SPEC`` fault grammar
works unchanged against the serving path, under the serve-specific
point names:

* ``serve_send`` / ``serve_recv`` — client request/reply plumbing
* ``serve_srv_send`` / ``serve_srv_recv`` — server-side plumbing
* ``prefill_send`` / ``prefill_recv`` — the ``prefill`` frame's
  client plumbing, a GLOBAL pair regardless of the client's point
  family: the disaggregation handoff leg can be killed
  deterministically without perturbing infer/stats counts. Prefill is
  pure (same prompt + seed → same reply), so a torn handoff simply
  replays — the replayed prefill lands the identical blob and the
  decode side admits exactly once.

(The fleet router's clients rename the client-side pair per replica —
``router<I>_send`` / ``router<I>_recv`` and ``router<I>_ctl_*`` for
its control connection — via ``ServeClient(fault_points=...)``, so a
single replica's transport can be killed deterministically.)

e.g. ``MXNET_FAULT_SPEC="serve_send:disconnect@3;serve_recv:drop@5"``
tears the 3rd request frame mid-message and severs before the 5th
reply read — and the client's retry/reconnect must still deliver
exactly one response per request (inference is pure, so a replayed
request is safe — no dedup table needed, unlike the PS push path).

Typed engine errors (Overloaded, RequestTimeout, EngineClosed) cross
the wire BY NAME and re-raise as themselves client-side; they are
application replies over a working transport, so RetryPolicy correctly
classifies them fatal (retrying an Overloaded against the same full
queue is how retry storms are born — the client backs off or routes
elsewhere, its call).

Trusted-cluster assumption, exactly like the PS: the wire unpickles.
The server binds 127.0.0.1 unless told otherwise; exposing it is an
explicit operator decision, never the default.
"""
from __future__ import annotations

import logging
import socket
import threading

import numpy as np

from .. import config as _config
from .. import telemetry as _telemetry
from .. import trace as _trace
from ._wire import WireRefused, _recv_msg, _send_msg
from ..parallel.resilience import RetryPolicy
from . import engine as _engine

__all__ = ["ServeServer", "ServeClient", "stream_idle_timeout"]


def stream_idle_timeout():
    """``MXNET_STREAM_IDLE_TIMEOUT``, loudly validated: the per-frame
    idle bound every streamed-generate read applies — the gap since
    the previous frame, not the whole completion, is what a healthy
    streaming replica keeps short, so a hung replica surfaces as a
    transport fault after ONE missed inter-frame gap instead of the
    one-shot path's whole-completion deadline. The first frame's gap
    covers queue wait + prefill (TTFT), so size the knob past worst-
    case admission latency — the fleet router warms recycled replicas
    precisely so a cold first-call compile never lands here."""
    import math
    t = float(_config.get("MXNET_STREAM_IDLE_TIMEOUT"))
    if not (math.isfinite(t) and t > 0):
        raise ValueError(
            "MXNET_STREAM_IDLE_TIMEOUT=%r: wants a positive finite "
            "number of seconds (a non-positive or non-finite idle "
            "bound would either fail every stream instantly or wedge "
            "on a hung replica forever)" % (t,))
    return t


class ServeServer:
    """Accept loop + one handler thread per connection, each feeding
    the shared :class:`~mxnet_tpu_torch.serve.ServeEngine`. Requests on one
    connection serialize (reply order = request order, like the PS
    client plumbing); concurrency comes from concurrent connections —
    which is exactly what the engine's batcher wants to coalesce."""

    def __init__(self, engine, host="127.0.0.1", port=0, logger=None):
        self._engine = engine
        self._log = logger or logging.getLogger(__name__)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        # accept() must notice close(): on Linux closing the listener
        # does NOT unblock a blocked accept, so the loop polls
        self._sock.settimeout(0.2)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = False
        self._conns = set()
        self._conn_threads = set()         # live handler threads only
        self._conn_lock = threading.Lock()
        self._c_conns = _telemetry.counter("serve.net.connections")
        self._c_frames = _telemetry.counter("serve.net.stream_frames")
        self._c_streams = _telemetry.counter("serve.net.streams")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="mxnet-serve-accept",
            daemon=True)
        self._accept_thread.start()

    @property
    def address(self):
        return "%s:%d" % (self.host, self.port)

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue                  # poll the stop flag
            except OSError:
                break                     # listener closed
            conn.settimeout(None)         # inherit-from-listener trap
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._c_conns.inc()
            with self._conn_lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="mxnet-serve-conn", daemon=True)
            with self._conn_lock:
                self._conn_threads.add(t)
            t.start()

    def _serve_conn(self, conn):
        try:
            while not self._stop:
                try:
                    msg = _recv_msg(conn, "serve_srv_recv")
                except WireRefused as exc:
                    # the frame was read whole, so the stream is still
                    # in step: refuse it typed and keep the connection
                    _send_msg(conn, ("err", "ServeError", str(exc)),
                              "serve_srv_send")
                    continue
                if msg is None:           # clean EOF or torn frame
                    break
                reply = self._handle(msg, conn)
                _send_msg(conn, reply, "serve_srv_send")
        except (ConnectionError, OSError) as exc:
            # includes injected FaultInjected severs: this connection
            # is gone, the client's RetryPolicy reconnects and replays
            self._log.debug("serve conn dropped: %s", exc)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conn_lock:
                self._conns.discard(conn)
                self._conn_threads.discard(threading.current_thread())

    def _handle(self, msg, conn=None):
        try:
            op, payload = msg
        except (TypeError, ValueError):
            return ("err", "ServeError", "malformed request frame")
        if op == "ping":
            return ("ok", None)
        if op == "hello":
            # registration frame: who/what this server fronts, so a
            # fleet router (serve/router.py) can learn a replica's
            # declared buckets and capabilities at add_replica time
            # instead of carrying them in its own config. Answered
            # from live engine state, never cached.
            try:
                # model_id: generation stamp of the served artifact
                # (export_buckets manifest), None for in-process
                # models. Optional on the wire — old peers that never
                # send/read it keep working (duck-typed frames).
                return ("ok", {
                    "role": getattr(self._engine, "role",
                                    type(self._engine).__name__),
                    "model_id": getattr(self._engine, "model_id", None),
                    "engine": self._engine_state()})
            except Exception as exc:      # noqa: BLE001 — reply = report
                return ("err", "ServeError",
                        "%s: %s" % (type(exc).__name__, exc))
        if op == "warm":
            # re-warm frame: pre-compile every declared bucket (the
            # router calls this on a freshly recycled replica BEFORE
            # readmitting it, so its first live request never pays a
            # cold first-call compile)
            try:
                warmup = getattr(self._engine, "warmup", None)
                if not callable(warmup):
                    return ("err", "ServeError",
                            "engine %s has no warmup()"
                            % type(self._engine).__name__)
                warmup()
                return ("ok", list(getattr(self._engine,
                                           "warmed_buckets", []) or []))
            except _engine.ServeError as exc:
                return ("err", type(exc).__name__, str(exc))
            except Exception as exc:      # noqa: BLE001 — reply = report
                return ("err", "ServeError",
                        "%s: %s" % (type(exc).__name__, exc))
        if op == "evacuate":
            # migration frame: export every active decode session off
            # this replica — each in-flight generate answers with its
            # portable state instead of a row, and the fleet router
            # resumes it on a survivor (docs/robustness.md). Duck-typed
            # like everything else: an engine without evacuate() (a
            # batch ServeEngine, a PrefillEngine, a router) declines
            # typed, and the router falls back to a full drain.
            fn = getattr(self._engine, "evacuate", None)
            if not callable(fn):
                return ("err", "ServeError",
                        "engine %s has no evacuate() — not a "
                        "migratable replica"
                        % type(self._engine).__name__)
            try:
                return ("ok", fn())
            except _engine.ServeError as exc:
                return ("err", type(exc).__name__, str(exc))
            except Exception as exc:      # noqa: BLE001 — reply = report
                self._log.exception("serve: evacuate handling failed")
                return ("err", "ServeError",
                        "%s: %s" % (type(exc).__name__, exc))
        if op == "stats":
            # introspection frame: the telemetry registry snapshot +
            # live engine state (queue depth, warmed buckets). Read by
            # ServeClient.stats() and `tools/telemetry_report.py
            # --stats host:port`.
            try:
                return ("ok", {"telemetry": _telemetry.snapshot(),
                               "engine": self._engine_state()})
            except Exception as exc:      # noqa: BLE001 — reply = report
                return ("err", "ServeError",
                        "%s: %s" % (type(exc).__name__, exc))
        if op in ("prefill", "generate"):
            # disaggregation frames (docs/serving.md §disaggregated
            # prefill), duck-typed like everything else the wire
            # fronts: `prefill` wants an engine with prefill() (a
            # PrefillEngine) and answers {first_token, kv_blob, pos};
            # `generate` wants handle_generate() (a ContinuousDecoder
            # admitting — with the shipped blob when one rode along —
            # or a ServeRouter fanning the whole prefill→decode path
            # out) and answers the full id row.
            attr = "prefill" if op == "prefill" else "handle_generate"
            fn = getattr(self._engine, attr, None)
            if not callable(fn):
                return ("err", "ServeError",
                        "engine %s has no %s() — not a %s-capable "
                        "replica" % (type(self._engine).__name__,
                                     attr, op))
            rtc = _trace.TraceContext.from_wire(payload.get("tc")) \
                if isinstance(payload, dict) else None
            hsp = _trace.start_span("serve.handle", op=op,
                                    parent=rtc) \
                if _trace.enabled() else None
            try:
                kw = {k: v for k, v in payload.items()
                      if k not in ("tc", "stream")}
                if op == "prefill":
                    return ("ok", fn(kw.pop("prompt"), **kw))
                sfn = getattr(self._engine, "handle_generate_stream",
                              None)
                if payload.get("stream") and conn is not None and \
                        callable(sfn):
                    # streamed generate: intermediate ("frame", {seq,
                    # offset, tokens}) frames ride THIS connection
                    # ahead of the ordinary terminal reply (which
                    # still carries the full row — the bitwise cross-
                    # check against the one-shot path). A client that
                    # asked to stream against an engine without the
                    # handler simply gets the one-shot reply: zero
                    # frames is a valid stream.
                    seq = [0]

                    def emit(tokens, offset):
                        _send_msg(conn, ("frame",
                                         {"seq": seq[0],
                                          "offset": int(offset),
                                          "tokens": [int(t)
                                                     for t in tokens]}),
                                  "serve_srv_send")
                        seq[0] += 1
                        self._c_frames.inc()

                    self._c_streams.inc()
                    return ("ok", sfn(kw, emit))
                return ("ok", fn(kw))
            except _engine.ServeError as exc:
                return ("err", type(exc).__name__, str(exc))
            except Exception as exc:      # noqa: BLE001 — the reply
                # IS the error report; the client re-raises it typed
                self._log.exception("serve: %s handling failed", op)
                return ("err", "ServeError",
                        "%s: %s" % (type(exc).__name__, exc))
            finally:
                _trace.end_span(hsp)
        if op != "infer":
            return ("err", "ServeError", "unknown op %r" % (op,))
        # handler span: adopts the remote caller's trace context ("tc"
        # in the payload — an extra key old servers never read) so
        # client and server share one trace_id; the engine's lifecycle
        # spans parent to this handler through submit(tc=).
        rtc = _trace.TraceContext.from_wire(payload.get("tc")) \
            if isinstance(payload, dict) else None
        hsp = _trace.start_span("serve.handle", parent=rtc) \
            if _trace.enabled() else None
        try:
            kw = {"deadline_ms": payload.get("deadline_ms"),
                  "tc": hsp.context() if hsp is not None else rtc}
            if isinstance(payload, dict) and \
                    payload.get("session") is not None:
                # optional routing key (old clients never send it):
                # the fleet router pins it to the replica holding the
                # session's decode state; a plain engine ignores it
                kw["session"] = payload["session"]
            fut = self._engine.submit(*payload["inputs"], **kw)
            return ("ok", fut.result())
        except _engine.ServeError as exc:
            return ("err", type(exc).__name__, str(exc))
        except Exception as exc:          # noqa: BLE001 — the reply IS
            # the error report; the client re-raises it typed
            self._log.exception("serve: request handling failed")
            return ("err", "ServeError",
                    "%s: %s" % (type(exc).__name__, exc))
        finally:
            _trace.end_span(hsp)

    def _engine_state(self):
        """The engine's live state for the ``stats`` frame — duck-typed
        so any forward-capable wrapper with a stats() works."""
        eng = self._engine
        introspect = getattr(eng, "introspect", None)
        if callable(introspect):
            return introspect()
        stats = getattr(eng, "stats", None)
        return dict(stats()) if callable(stats) else {}

    def close(self):
        """Stop accepting, sever open connections, leave the engine to
        its own drain (callers own the engine lifecycle)."""
        self._stop = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conn_lock:
            conns = list(self._conns)
            threads = list(self._conn_threads)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in [self._accept_thread] + threads:
            t.join(5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ServeClient:
    """Blocking request client with reconnect-and-replay.

    Transport faults (drops, torn frames, resets — real or injected)
    are transient: the broken socket is dropped and the request is
    REPLAYED on a fresh connection under the RetryPolicy's
    deterministic backoff. Inference is pure, so replay is safe without
    a dedup table. Typed engine errors arrive as replies and re-raise
    as themselves (fatal: the transport demonstrably works)."""

    def __init__(self, host, port, retry=None, timeout=None,
                 logger=None, fault_points="serve"):
        self._addr = (host, int(port))
        self._retry = retry or RetryPolicy(seed="serve:%s:%d"
                                           % (host, int(port)))
        self._timeout = timeout
        # injection-point family for this client's wire plumbing
        # (resilience.FaultInjector grammar). Default "serve" keeps
        # the documented serve_send/serve_recv points; the fleet
        # router names a family per replica (router<I>/router<I>_ctl)
        # so one replica's transport can be killed deterministically
        # without touching the others.
        self._pt_send = "%s_send" % fault_points
        self._pt_recv = "%s_recv" % fault_points
        self._log = logger or logging.getLogger(__name__)
        self._sock = None
        self._lock = threading.Lock()
        self._c_retries = _telemetry.counter("serve.net.retries")

    def _ensure(self):
        if self._sock is None:
            s = socket.create_connection(self._addr,
                                         timeout=self._timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def _drop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _on_retry(self, exc, attempt, delay):
        self._c_retries.inc()
        self._log.debug("serve client retry #%d in %.3fs after %s",
                        attempt, delay, exc)
        self._drop()

    _KEEP_TIMEOUT = object()             # sentinel: socket's own

    def _roundtrip(self, frame, describe, pt_send=None, pt_recv=None,
                   read_timeout=_KEEP_TIMEOUT):
        """One framed round trip under the retry policy: transport
        faults drop the socket and replay on a fresh connection, an
        err reply re-raises the engine's typed error. ``pt_send`` /
        ``pt_recv`` override this client's injection-point family
        (the global ``prefill_*`` pair rides here). ``read_timeout``
        overrides the socket timeout for THIS op only (the generate
        frame legitimately blocks for a whole decode — the client's
        io timeout must not misread a long generation as a dead
        replica); restored before the socket returns to normal use."""
        pt_send = pt_send or self._pt_send
        pt_recv = pt_recv or self._pt_recv

        def attempt():
            sock = self._ensure()
            if read_timeout is not self._KEEP_TIMEOUT:
                sock.settimeout(read_timeout)
            try:
                _send_msg(sock, frame, pt_send)
                reply = _recv_msg(sock, pt_recv)
            except Exception:
                self._drop()
                raise
            finally:
                if read_timeout is not self._KEEP_TIMEOUT and \
                        self._sock is sock:
                    sock.settimeout(self._timeout)
            if reply is None:
                self._drop()
                raise ConnectionError(
                    "server closed the connection mid-reply")
            return reply

        with self._lock:
            reply = self._retry.run(attempt, describe=describe,
                                    on_retry=self._on_retry)
        if reply[0] == "ok":
            return reply[1]
        _, kind, msg = reply
        raise _engine.typed_error(kind, msg)

    def request(self, inputs, deadline_ms=None, session=None):
        """One inference round trip; returns the per-request output
        list. Retries transport faults; raises the engine's typed
        error otherwise. ``session``: optional continuous-decode
        session id the fleet router pins to one replica (a plain
        engine accepts and ignores it)."""
        payload = {"inputs": [np.asarray(a) for a in inputs]}
        if deadline_ms is not None:
            payload["deadline_ms"] = deadline_ms
        if session is not None:
            payload["session"] = session
        # request span + wire trace context: the server's handler span
        # (and the engine's queue/forward lifecycle) joins this trace.
        # Old servers never read the extra "tc" key.
        rsp = _trace.start_span("serve.request",
                                rows=int(payload["inputs"][0].shape[0])
                                if payload["inputs"][0].ndim else 0)
        if rsp is not None:
            payload["tc"] = rsp.context().to_wire()
        try:
            return self._roundtrip(("infer", payload), "serve.infer")
        finally:
            _trace.end_span(rsp)

    def prefill(self, prompt, temperature=0.0, top_k=None, top_p=None,
                seed=0):
        """The ``prefill`` frame: run one sequence's prefill on the
        remote replica and return its handoff dict ``{"first_token",
        "kv_blob", "pos"}``. Injection points are the GLOBAL
        ``prefill_send`` / ``prefill_recv`` pair (not this client's
        family); prefill is pure, so the transport-fault replay is
        safe by construction — a replayed prefill lands the identical
        blob."""
        payload = {"prompt": np.asarray(prompt, np.int64).reshape(-1),
                   "temperature": temperature, "top_k": top_k,
                   "top_p": top_p, "seed": seed}
        rsp = _trace.start_span("serve.prefill.request",
                                tokens=int(payload["prompt"].size))
        if rsp is not None:
            payload["tc"] = rsp.context().to_wire()
        # first contact with a prompt length pays the server-side
        # (B, P) first-call compile — minutes on real hardware, far past a
        # dead-transport io timeout; give the read a compile-sized
        # allowance so a cold prefill is never misread as a dead
        # replica (and replayed into ANOTHER cold compile)
        wire_timeout = None if self._timeout is None \
            else float(self._timeout) + 300.0
        try:
            return self._roundtrip(("prefill", payload),
                                   "serve.prefill",
                                   "prefill_send", "prefill_recv",
                                   read_timeout=wire_timeout)
        finally:
            _trace.end_span(rsp)

    def generate(self, prompt, max_new_tokens, eos_id=None,
                 temperature=0.0, top_k=None, top_p=None, seed=0,
                 session=None, handoff=None, timeout=None,
                 admit_id=None, resume=None, on_token=None,
                 speculative=False):
        """The ``generate`` frame: admit one sequence on the remote
        replica (with its ``handoff`` blob when a remote prefill ran)
        and block for the full id row. Replay caveat: a transport
        fault AFTER the admission landed replays the whole admit —
        without an ``admit_id`` the orphaned first admission still
        decodes to completion and frees its slot, and both admissions
        emit identical tokens (greedy, or the same per-request PRNG
        stream), so the caller still sees exactly one, correct
        response; WITH an ``admit_id`` (the fleet router always sends
        one) the replay rides the original admission outright —
        exactly-once admit, no orphan.

        ``resume``: an evacuated session's ``export_session`` state —
        readmit a migrated sequence mid-decode
        (``ContinuousDecoder.submit(resume=...)``).

        ``speculative``: ask the replica to decode this request with
        draft/verify rounds when it carries a speculative draft
        (docs/serving.md §speculative). A pure performance hint —
        output is byte-identical either way, and a draft-less replica
        ignores it — so failover and replay semantics are unchanged.

        The wire read is bounded by ``timeout`` (plus this client's
        io timeout as slack) when one is given, and UNBOUNDED
        otherwise — a decode lasts as long as its tokens; the
        client's io timeout exists to catch dead transports and must
        not misclassify a healthy long generation. Pass ``timeout``
        to bound a generate against a hung replica.

        ``on_token``: streaming mode — the server emits a frame per
        decode step and ``on_token(tok)`` fires per NEW token, in
        emission order, exactly once each (transport replays re-read
        the stream from offset 0; tokens already delivered are
        verified against the replay, never re-delivered). Streamed
        reads replace the whole-completion deadline with the
        per-frame ``MXNET_STREAM_IDLE_TIMEOUT`` idle bound: a replica
        that stops producing frames fails after one missed gap. The
        returned row is the terminal frame's full result — bitwise
        what the one-shot path returns."""
        payload = {"prompt": np.asarray(prompt, np.int64).reshape(-1),
                   "max_new_tokens": int(max_new_tokens),
                   "eos_id": eos_id, "temperature": temperature,
                   "top_k": top_k, "top_p": top_p, "seed": seed}
        if session is not None:
            payload["session"] = session
        if handoff is not None:
            payload["handoff"] = handoff
        if timeout is not None:
            payload["timeout"] = timeout
        if admit_id is not None:
            payload["admit_id"] = admit_id
        if resume is not None:
            payload["resume"] = resume
        if speculative:
            payload["speculative"] = True
        if on_token is not None:
            payload["stream"] = True
        rsp = _trace.start_span("serve.generate.request",
                                tokens=int(payload["prompt"].size),
                                max_new=payload["max_new_tokens"],
                                stream=bool(on_token))
        if rsp is not None:
            payload["tc"] = rsp.context().to_wire()
        try:
            if on_token is not None:
                return self._stream_roundtrip(payload, on_token)
            wire_timeout = None if timeout is None \
                else float(timeout) + (self._timeout or 30.0)
            return self._roundtrip(("generate", payload),
                                   "serve.generate",
                                   read_timeout=wire_timeout)
        finally:
            _trace.end_span(rsp)

    def _stream_roundtrip(self, payload, on_token):
        """The streamed ``generate`` round trip: read ("frame", {seq,
        offset, tokens}) frames until the terminal ok/err reply, each
        read bounded by the per-frame idle timeout. ``offset`` (the
        emission index of a frame's first token) is what makes replay
        exact: a retry — same socket replay or a fleet failover — re-
        reads the stream from 0; tokens at already-delivered offsets
        must MATCH what was delivered (a mismatch is a determinism
        violation and fails loudly, typed) and only the tail past the
        delivered prefix reaches ``on_token``. No token is ever
        delivered twice or skipped."""
        idle = stream_idle_timeout()
        delivered = []
        first = [True]

        def attempt():
            sock = self._ensure()
            sock.settimeout(idle)
            last_seq = -1
            try:
                _send_msg(sock, ("generate", payload), self._pt_send)
                while True:
                    reply = _recv_msg(sock, self._pt_recv)
                    if reply is None:
                        raise ConnectionError(
                            "server closed the connection mid-stream")
                    if not (isinstance(reply, tuple) and reply and
                            reply[0] == "frame"):
                        return reply      # terminal ok/err
                    fr = reply[1]
                    seq = int(fr.get("seq", -1))
                    if seq != last_seq + 1:
                        raise ConnectionError(
                            "stream frame seq %d after %d — torn "
                            "stream" % (seq, last_seq))
                    last_seq = seq
                    off = int(fr["offset"])
                    if off > len(delivered):
                        raise ConnectionError(
                            "stream offset %d past the delivered "
                            "prefix (%d) — torn stream"
                            % (off, len(delivered)))
                    for i, t in enumerate(fr["tokens"]):
                        self._deliver(off + i, int(t), delivered,
                                      on_token, first)
            except Exception:
                self._drop()
                raise
            finally:
                if self._sock is sock:
                    sock.settimeout(self._timeout)

        with self._lock:
            reply = self._retry.run(attempt,
                                    describe="serve.generate.stream",
                                    on_retry=self._on_retry)
        if reply[0] != "ok":
            _, kind, msg = reply
            raise _engine.typed_error(kind, msg)
        out = reply[1]
        if isinstance(out, dict):
            # an evacuated-session reply: the caller (the fleet
            # router's migration loop) resumes the stream elsewhere —
            # the delivered prefix stands, nothing terminal to check
            return out
        # terminal cross-check: the full row's generated tail must be
        # exactly the streamed tokens (any tail past the last frame —
        # e.g. a non-streaming engine answered — is delivered now)
        gen = [int(t) for t in
               np.asarray(out).reshape(-1)[payload["prompt"].size:]]
        if gen[:len(delivered)] != delivered or len(gen) < \
                len(delivered):
            raise _engine.ServeError(
                "streamed tokens diverge from the terminal row — "
                "determinism violation (%d streamed, row tail %r...)"
                % (len(delivered), gen[:8]))
        for k in range(len(delivered), len(gen)):
            self._deliver(k, gen[k], delivered, on_token, first)
        return out

    def _deliver(self, k, tok, delivered, on_token, first):
        """Deliver emission-index ``k`` exactly once; verify replays."""
        if k < len(delivered):
            if delivered[k] != tok:
                raise _engine.ServeError(
                    "stream replay diverged at token %d: %d then %d "
                    "— determinism violation" % (k, delivered[k], tok))
            return
        delivered.append(tok)
        if first[0]:
            first[0] = False
            if _trace.enabled():
                _trace.instant("serve.stream.first_token", index=k)
        on_token(tok)

    def generate_stream(self, prompt, max_new_tokens, **kw):
        """Iterator twin of ``generate(on_token=...)``: yields each
        new token as its frame arrives; the generator's return value
        (``StopIteration.value``) is the full id row. The round trip
        runs on a helper thread so the caller pulls tokens at its own
        pace without holding the client lock hostage between
        frames."""
        import queue as _qmod
        q = _qmod.Queue()

        def run():
            try:
                row = self.generate(prompt, max_new_tokens,
                                    on_token=lambda t: q.put(("tok", t)),
                                    **kw)
                q.put(("done", row))
            except BaseException as exc:   # noqa: BLE001 — relayed
                q.put(("exc", exc))

        t = threading.Thread(target=run, daemon=True,
                             name="mxnet-serve-stream")
        t.start()
        while True:
            kind, val = q.get()
            if kind == "tok":
                yield val
            elif kind == "done":
                return val
            else:
                raise val

    def ping(self):
        try:
            self._simple_op("ping", "serve.ping")
            return True
        except _engine.ServeError:
            return False

    def stats(self):
        """Server introspection via the ``stats`` frame:
        ``{"telemetry": <registry snapshot>, "engine": <queue depth,
        drain state, buckets warmed, counters>}`` — the remote twin of
        ``telemetry.snapshot()`` + ``ServeEngine.introspect()``."""
        return self._simple_op("stats", "serve.stats")

    def _simple_op(self, op, describe):
        """One no-payload round trip (hello/warm): retried like any
        transport op, typed errors re-raised."""
        return self._roundtrip((op, None), describe)

    def hello(self):
        """The registration frame: ``{"role": ..., "engine": <live
        engine state>}`` — how a fleet router learns a replica's
        declared buckets and capabilities at add_replica time."""
        return self._simple_op("hello", "serve.hello")

    def warm(self):
        """Ask the server to pre-compile every declared bucket
        (``ServeEngine.warmup``); returns the warmed bucket list. The
        router calls this on a freshly recycled replica before
        readmitting it."""
        return self._simple_op("warm", "serve.warm")

    def evacuate(self):
        """The ``evacuate`` frame: export every active decode session
        off the replica — each in-flight generate answers with its
        portable state instead of a row, and queued admissions fail
        for replay. Returns the number of sessions exported. The fleet
        router sends this at the start of a migrating recycle so the
        drain is bounded by export+import cost, not longest-sequence
        completion (docs/robustness.md, fleet failure semantics)."""
        return self._simple_op("evacuate", "serve.evacuate")

    def close(self):
        with self._lock:
            self._drop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
