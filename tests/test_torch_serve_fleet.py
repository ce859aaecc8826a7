"""The port's serving fleet on the CPU: the wire framing and its
unpickler, ``RetryPolicy`` and the fault points, ``ServeServer`` /
``ServeClient``, ``PrefillEngine`` handoffs, ``ServeRouter`` and
``FleetController`` (``mxnet_tpu_torch/serve``), and a mixed fleet of
JAX and port replicas behind either package's router.

Models are the JAX serve tests' small ones: an MLP ``Predictor`` (8
features, 4 classes) for the batch engines and an LM of vocab 50, 2
layers, 2 heads, dim 32, max_len 24 for the decoders, from numpy
weights (carried to the port with ``convert.params_from_jax``).
Tolerances: tokens exactly (every generate row equals the JAX package's
batch-1 ``Generator.generate`` or the port's, which
tests/test_torch_generation.py holds equal to it); MLP outputs within
rtol 1e-5 / atol 1e-6 of the port's own Predictor. Load signals are
scripted (the controller tests' fake engines) and mid-decode evacuations
hold the decode thread on the decoder's own condition: nothing waits on
the clock.
"""
import collections
import json
import pickle
import socket
import sys
import threading

import numpy as np
import pytest

from mxnet_tpu.generation import Generator as JGenerator
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.serve import ContinuousDecoder as JContinuousDecoder
from mxnet_tpu.serve import PrefillEngine as JPrefillEngine
from mxnet_tpu.serve import ServeRouter as JServeRouter
from mxnet_tpu.serve import ServeServer as JServeServer
from mxnet_tpu.serve.engine import Overloaded as JOverloaded

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.convert import params_from_jax
from mxnet_tpu_torch.generation import Generator
from mxnet_tpu_torch.parallel.resilience import (FaultInjector, RetryPolicy,
                                                 install_fault_injector)
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.serve import (ContinuousDecoder, FleetController,
                                   Overloaded, PrefillEngine, ReplicaState,
                                   ServeClient, ServeEngine, ServeRouter,
                                   ServeServer)
from mxnet_tpu_torch.serve._wire import (WireRefused, _loads, _recv_msg,
                                         _send_msg)

FEAT, CLASSES = 8, 4
V, L, H, DIM, T = 50, 2, 2, 32, 24
SEEDED = dict(temperature=0.8, top_k=8, seed=3)
OUT = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def no_injector():
    yield
    install_fault_injector(None)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _mlp():
    net = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(net, name="fc1", num_hidden=16)
    net = tmx.sym.Activation(net, act_type="tanh")
    net = tmx.sym.FullyConnected(net, name="fc2", num_hidden=CLASSES)
    net = tmx.sym.SoftmaxOutput(net, name="softmax")
    shapes, _, _ = net.infer_shape(data=(2, FEAT))
    rng = np.random.RandomState(7)
    args = {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    return Predictor(net, args, data_names=("data",), ctx=tmx.cpu())


@pytest.fixture(scope="module")
def pred():
    return _mlp()


_LM = {}


def _lm():
    if not _LM:
        sym = jtransformer.get_symbol(V, 12, num_layers=L, num_heads=H,
                                      dim=DIM, max_len=T)
        shapes, _, _ = sym.infer_shape(data=(2, 12), softmax_label=(2, 12))
        rng = np.random.RandomState(0)
        _LM.update({
            n: np.ones(s, np.float32) if n.endswith("_gamma") else
            (rng.randn(*s) * 0.5).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")})
    return _LM


def _gen(batch_size=2, **kw):
    return Generator(params_from_jax(_lm(), "cpu"), V, T, num_layers=L,
                     num_heads=H, dim=DIM, batch_size=batch_size,
                     ctx=tmx.cpu(), **kw)


def _jgen(batch_size=2, **kw):
    return JGenerator(_lm(), V, T, num_layers=L, num_heads=H, dim=DIM,
                      batch_size=batch_size, **kw)


def _want(p, n, **kw):
    """The JAX package's batch-1 generate: the fleet's oracle."""
    return _jgen(1).generate(np.asarray(p)[None], n, eos_id=0, **kw)[0]


def _cval(name):
    return telemetry.counter(name).value


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def test_framing_round_trip():
    """A frame of every type a serving reply holds crosses a socket
    pair intact; a closed peer reads as None."""
    bf16 = np.arange(6, dtype=np.int16).view(np.dtype("V2"))
    frame = ("ok", {"row": np.arange(5, dtype=np.int64),
                    "blob": {"v": 1, "pos": 3,
                             "rows": {"k": np.ones((2, 3), np.float32),
                                      "bf": bf16}},
                    "tok": np.int64(4), "f": np.float32(0.5),
                    "od": collections.OrderedDict(a=1), "s": {1, 2},
                    "t": (None, True, 1.5, "x", b"y")})
    a, b = socket.socketpair()
    try:
        _send_msg(a, frame)
        got = _recv_msg(b)
        assert got[0] == "ok" and got[1]["s"] == {1, 2}
        np.testing.assert_array_equal(got[1]["row"], frame[1]["row"])
        assert got[1]["blob"]["rows"]["bf"].tobytes() == bf16.tobytes()
        assert got[1]["blob"]["rows"]["bf"].dtype == np.dtype("V2")
        assert got[1]["tok"] == 4 and got[1]["t"] == frame[1]["t"]
        a.close()
        assert _recv_msg(b) is None
    finally:
        b.close()


def test_unpickler_refuses_foreign_classes(monkeypatch):
    """A frame naming a ``mxnet_tpu`` class (or any other module) is
    refused; a server answers such a frame with a typed error and keeps
    the connection; an ml_dtypes bfloat16 array resolves only where
    ml_dtypes imports."""
    with pytest.raises(WireRefused, match="mxnet_tpu"):
        _loads(pickle.dumps(("err", JOverloaded("shed")), protocol=4))
    with pytest.raises(WireRefused, match="os.system"):
        _loads(b"\x80\x04\x95\x10\x00\x00\x00\x00\x00\x00\x00\x8c\x02os"
               b"\x94\x8c\x06system\x94\x93\x94.")
    ml_dtypes = pytest.importorskip("ml_dtypes")
    raw = pickle.dumps(np.zeros(3, ml_dtypes.bfloat16), protocol=4)
    assert _loads(raw).dtype.name == "bfloat16"
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(WireRefused, match="bfloat16"):
        _loads(raw)
    monkeypatch.undo()
    eng = ServeEngine(_mlp(), buckets=(1,), max_wait_ms=0.0,
                      install_sigterm=False)
    with ServeServer(eng) as srv:
        s = socket.create_connection((srv.host, srv.port))
        try:
            _send_msg(s, ("infer", JOverloaded("x")))
            reply = _recv_msg(s)
            assert reply[0] == "err" and "not resolve" in reply[2]
            _send_msg(s, ("ping", None))
            assert _recv_msg(s) == ("ok", None)
        finally:
            s.close()
    eng.close()


def test_retry_policy_on_fatal_hook():
    """RetryPolicy.run(on_fatal=): a fatal error retries only when the
    hook approves, the hook is never asked about a transient error, and
    the backoff schedule is deterministic."""
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise Overloaded("shed")
        return "ok"

    pol = RetryPolicy(max_retries=5, base_delay=0.001, seed=4)
    with pytest.raises(Overloaded):
        pol.run(flaky)
    assert len(calls) == 1
    calls.clear()
    assert pol.run(flaky, on_fatal=lambda e: True) == "ok"
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(Overloaded):
        pol.run(flaky, on_fatal=lambda e: False)
    seen = []

    def transient_once():
        seen.append(1)
        if len(seen) < 2:
            raise ConnectionError("blip")
        return "ok"

    assert pol.run(transient_once, on_fatal=lambda e: pytest.fail(
        "on_fatal consulted for a transient error")) == "ok"
    assert [pol.delay(i) for i in (1, 2, 3)] == \
        [RetryPolicy(base_delay=0.001, seed=4).delay(i) for i in (1, 2, 3)]


@pytest.mark.parametrize("spec,needle", [
    ("serve_snd:drop@1", "unknown injection point"),
    ("kill1:drop@2", "unknown injection point"),
    ("kill@", "bad MXNET_FAULT_SPEC rule"),
])
def test_fault_spec_validation(spec, needle):
    with pytest.raises(ValueError, match=needle):
        FaultInjector(spec)


def test_fault_points_fire_and_client_replays(pred):
    """serve_send:disconnect@1 tears the first request frame and
    serve_recv:drop@2 severs before the second reply: the client
    reconnects and replays, one response per request; the router
    family parses and the kill family ticks."""
    FaultInjector("router3_ctl_recv:drop@1;router0_send:delay@2:0.1")
    inj = FaultInjector("kill0@1;kill2@2x2")
    assert inj.on_chaos_tick("kill0") is True
    assert [inj.on_chaos_tick("kill2") for _ in range(4)] == \
        [False, True, True, False]
    eng = ServeEngine(pred, buckets=(1, 2), max_wait_ms=0.0,
                      install_sigterm=False)
    x = np.random.RandomState(1).rand(1, FEAT).astype(np.float32)
    want = pred.forward(x)[0].asnumpy()
    inj = install_fault_injector(FaultInjector(
        "serve_send:disconnect@1;serve_recv:drop@2"))
    with ServeServer(eng) as srv:
        c = ServeClient(srv.host, srv.port,
                        retry=RetryPolicy(base_delay=0.001))
        for _ in range(3):
            np.testing.assert_allclose(c.request([x])[0], want, **OUT)
        c.close()
    eng.close()
    assert [(p, a) for p, _, a in inj.fired] == [
        ("serve_send", "disconnect"), ("serve_recv", "drop")]


# ---------------------------------------------------------------------------
# server, client, prefill
# ---------------------------------------------------------------------------

def test_server_client_frames():
    """request (a batch engine), generate, generate with on_token,
    generate_stream and prefill (a decoder and a prefill replica) over
    the wire: rows equal the JAX oracle, the streamed tokens equal the
    row, hello reports each role."""
    p = np.arange(1, 6)
    dec = ContinuousDecoder(_gen())
    pre = PrefillEngine(_gen(1))
    with ServeServer(dec) as ds, ServeServer(pre) as ps:
        c = ServeClient(ds.host, ds.port)
        cp = ServeClient(ps.host, ps.port)
        assert c.hello()["role"] == "decode"
        assert cp.hello()["role"] == "prefill"
        np.testing.assert_array_equal(c.generate(p, 6, eos_id=0),
                                      _want(p, 6))
        toks = []
        row = c.generate(p, 7, eos_id=0, on_token=toks.append, **SEEDED)
        np.testing.assert_array_equal(row, _want(p, 7, **SEEDED))
        assert toks == row[len(p):].tolist()
        assert list(c.generate_stream(p, 5, eos_id=0)) == \
            _want(p, 5)[len(p):].tolist()
        h = cp.prefill(p, **SEEDED)
        assert h["pos"] == len(p) and set(h) == {"first_token", "kv_blob",
                                                 "pos"}
        before = dec.stats()["prefills"]
        row = c.generate(p, 6, eos_id=0, handoff=h, **SEEDED)
        np.testing.assert_array_equal(row, _want(p, 6, **SEEDED))
        assert dec.stats()["prefills"] == before
        assert c.stats()["engine"]["decode_free_slots"] == 2
        c.close()
        cp.close()
    dec.close()
    pre.close()


@pytest.mark.parametrize("src", ["port", "jax"])
def test_prefill_handoff_into_the_port(src):
    """A float32 handoff from either package's PrefillEngine admits in
    the port's decoder with zero prefill calls; greedy and seeded rows
    equal the oracle; the port's blob is pure (the same reply twice)."""
    pre = PrefillEngine(_gen(1)) if src == "port" else \
        JPrefillEngine(_jgen(1))
    p = np.arange(2, 8)
    with ContinuousDecoder(_gen()) as dec:
        for kw in ({}, SEEDED):
            h = pre.prefill(p, **kw)
            got = dec.submit(p, 6, eos_id=0, handoff=h, **kw).result(60)
            np.testing.assert_array_equal(got, _want(p, 6, **kw))
        st = dec.stats()
        assert st["prefills"] == 0 and st["imported"] == 2
    if src == "port":
        a, b = pre.prefill(p), pre.prefill(p)
        assert a["first_token"] == b["first_token"]
        for n in a["kv_blob"]["rows"]:
            assert a["kv_blob"]["rows"][n].tobytes() == \
                b["kv_blob"]["rows"][n].tobytes()
    pre.close()


def test_jax_bf16_blob_bits_land_in_the_port():
    """A bfloat16 blob from the JAX package (ml_dtypes arrays) passes
    the port's checks and lands in the pool bit for bit; the port's own
    bf16 blob round-trips bit for bit too."""
    pytest.importorskip("ml_dtypes")
    p = np.arange(1, 6)
    jblob = JPrefillEngine(_jgen(1, dtype="bfloat16")).prefill(p)["kv_blob"]
    tg = _gen(2, dtype="bfloat16")
    dec = ContinuousDecoder(tg)
    try:
        for blob in (jblob, tg.export_kv_rows(
                tg._forward(tg._fresh_aux(), np.stack([p, p]), 0)[1], 1, 5)):
            assert dec.import_kv_rows(1, blob) == 5
            back = tg.export_kv_rows(dec._aux, 1, 5)
            for n, arr in blob["rows"].items():
                assert back["rows"][n].tobytes() == \
                    np.asarray(arr).tobytes()
    finally:
        dec.close()


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class _Scripted(ServeEngine):
    """A batch engine whose stats frame reports scripted load signals
    (queue depth, sheds, decode slots) on top of its real state."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.fake_depth = 0
        self.fake_shed = None
        self.free_slots = None

    def introspect(self):
        out = super().introspect()
        out["queue_depth"] += self.fake_depth
        if self.fake_shed is not None:
            out["shed"] = self.fake_shed
        if self.free_slots is not None:
            out["decode_free_slots"] = self.free_slots
        return out


class _Fleet:
    """N in-process MLP replicas behind a poll-less router."""

    def __init__(self, pred, n, caps=None):
        self.pred = pred
        self.engines, self.servers = [], []
        for i in range(n):
            self._build(i, (caps or {}).get(i))
        self.router = ServeRouter(poll_ms=0)
        for i, s in enumerate(self.servers):
            self.router.add_replica(s.host, s.port, name="r%d" % i)
        self.router.poll_now()

    def _build(self, i, cap=None):
        kw = {} if cap is None else {"queue_cap": cap}
        eng = _Scripted(self.pred, buckets=(1, 2, 4), max_wait_ms=0.0,
                        feature_shapes=[(FEAT,)], install_sigterm=False,
                        **kw)
        srv = ServeServer(eng)
        if i < len(self.engines):
            self.engines[i], self.servers[i] = eng, srv
        else:
            self.engines.append(eng)
            self.servers.append(srv)
        return srv

    def restarter(self, i):
        def restart():
            self.servers[i].close()
            self.engines[i].close()
            srv = self._build(i)
            return (srv.host, srv.port)
        return restart

    def close(self):
        self.router.close()
        for s in self.servers:
            s.close()
        for e in self.engines:
            e.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def test_router_least_loaded_affinity_and_shed(pred):
    """Dispatch goes to the least-loaded replica (scripted depth), a
    new session to the most free decode slots and then sticks, and a
    shedding replica's request lands on the next one; Overloaded only
    when every live replica shed. The router's stats frame aggregates."""
    x = np.zeros((1, FEAT), np.float32)
    want = pred.forward(x)[0].asnumpy()
    with _Fleet(pred, 2) as f:
        f.engines[0].fake_depth = 9
        f.router.poll_now()
        np.testing.assert_allclose(f.router.infer(x)[0], want, **OUT)
        assert f.router.replicas()["r1"]["dispatched"] == 1
        f.engines[0].fake_depth = 0
        f.engines[0].free_slots, f.engines[1].free_slots = 4, 1
        f.router.poll_now()
        for _ in range(3):
            f.router.infer(x, session="a")
        assert f.router.sessions()["a"] == "r0"
        assert f.router.replicas()["r0"]["dispatched"] == 3
        assert f.router.release_session("a")
        st = f.router.stats()
        assert st["replicas"] == 2 and st["dispatched"] == 4
        with ServeServer(f.router) as front:
            c = ServeClient(front.host, front.port)
            assert c.stats()["engine"]["role"] == "router"
            c.close()
    with _Fleet(pred, 2, caps={0: 0}) as f:
        np.testing.assert_allclose(f.router.infer(x)[0], want, **OUT)
        reps = f.router.replicas()
        assert reps["r0"]["rerouted_from"] == 1
        assert reps["r1"]["dispatched"] == 1
        f.engines[1]._cap = 0
        with pytest.raises(Overloaded, match="every live replica"):
            f.router.infer(x)


def test_router_rolling_recycle(pred):
    """recycle(): a drained replica re-warms and readmits (no restart
    hook), a restart hook's fresh replica takes the same name, the last
    live replica is never recycled; requests keep landing."""
    x = np.zeros((1, FEAT), np.float32)
    with _Fleet(pred, 2) as f:
        f.router.recycle("r0")
        reps = f.router.replicas()
        assert reps["r0"]["state"] == ReplicaState.LIVE
        assert sorted(reps["r0"]["stats"]["warmed"]) == [1, 2, 4]
        old = f.servers[1].port
        f.router.recycle("r1", restart=f.restarter(1))
        assert f.router.replicas()["r1"]["port"] == f.servers[1].port != old
        assert f.router.stats()["recycles"] == 2
        for _ in range(4):
            f.router.infer(x)
    with _Fleet(pred, 1) as f:
        with pytest.raises(ValueError, match="no live replica"):
            f.router.recycle("r0")


class _DecodeFleet:
    """Two port decode replicas behind a poll-less router."""

    def __init__(self):
        self.decoders = [ContinuousDecoder(_gen()) for _ in range(2)]
        self.servers = [ServeServer(d) for d in self.decoders]
        self.router = ServeRouter(poll_ms=0)
        for i, s in enumerate(self.servers):
            self.router.add_replica(s.host, s.port, name="replica%d" % i)
        self.router.poll_now()

    def close(self):
        self.router.close()
        for s in self.servers:
            s.close()
        for d in self.decoders:
            d.close()


def test_router_failover_and_exactly_once():
    """A pinned replica whose data and control transport die replays on
    the survivor token-exact; a reply lost after admission replays onto
    the same replica, admitted once (the admit-id dedup)."""
    p = np.arange(1, 5)
    want = _want(p, 6, **SEEDED)
    f = _DecodeFleet()
    fo, rp = _cval("serve.router.failovers"), _cval("serve.router.replays")
    try:
        np.testing.assert_array_equal(
            f.router.generate(p, 6, eos_id=0, session="s", **SEEDED), want)
        pin = f.router.sessions()["s"]
        idx = int(pin[-1])
        dec = f.decoders[idx]
        before = dec.stats()
        install_fault_injector(FaultInjector("router%d_recv:drop@1" % idx))
        np.testing.assert_array_equal(
            f.router.generate(p, 6, eos_id=0, session="s", **SEEDED), want)
        after = dec.stats()
        assert after["admitted"] - before["admitted"] == 1
        assert after["deduped"] - before["deduped"] == 1
        install_fault_injector(FaultInjector(
            "router%d_send:drop@1x*;router%d_ctl_send:drop@1x*"
            % (idx, idx)))
        np.testing.assert_array_equal(
            f.router.generate(p, 6, eos_id=0, session="s", **SEEDED), want)
        install_fault_injector(None)
        assert f.router.sessions()["s"] != pin
        assert _cval("serve.router.failovers") == fo + 1
        assert _cval("serve.router.replays") == rp + 2
    finally:
        f.close()


def test_router_migrating_recycle():
    """recycle() of a decode replica mid-sequence evacuates the session
    (held mid-decode on the decoder's condition) and resumes it on the
    survivor: the row equals the unmigrated oracle."""
    p = np.arange(1, 4)
    want = _want(p, 12, **SEEDED)
    f = _DecodeFleet()
    reached = threading.Event()
    for dec in f.decoders:
        def held(req, tok, dec=dec, emit=dec._emit):
            emit(req, tok)
            if len(req.emitted) == 3 and req.resume is None and \
                    not reached.is_set():
                reached.set()
                with dec._cond:
                    dec._cond.wait_for(lambda: dec._evac_waiters, 60.0)
        dec._emit = held
    out = {}
    try:
        t = threading.Thread(target=lambda: out.update(
            row=f.router.generate(p, 12, eos_id=0, session="m", **SEEDED)))
        t.start()
        assert reached.wait(60.0)
        victim = f.router.sessions()["m"]
        f.router.recycle(victim)
        t.join(60.0)
        assert not t.is_alive()
        np.testing.assert_array_equal(out["row"], want)
        assert f.decoders[int(victim[-1])].stats()["evacuated"] == 1
        assert sum(d.stats()["resumed"] for d in f.decoders) == 1
    finally:
        f.close()


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class _Broken:
    def forward(self, *arrays):
        raise RuntimeError("deliberately broken artifact")


class _CtrlFleet:
    """N in-process replicas behind a router, plus the spawn/retire
    hooks a controller drives."""

    def __init__(self, pred, n, model_id=None, **ctrl_kw):
        self.pred = pred
        self.cells = {}
        self.retired = []
        self.spawn_log = []
        self.artifacts = {None: (lambda: self.pred, model_id)}
        self.router = ServeRouter(poll_ms=0)
        for i in range(n):
            host, port = self._spawn(None)
            self.router.add_replica(host, port, name="r%d" % i)
        self.router.poll_now()
        ctrl_kw.setdefault("poll_ms", 0)
        self.ctrl = FleetController(self.router, self.spawn,
                                    retire=self.retire, **ctrl_kw)

    def _spawn(self, manifest):
        factory, stamp = self.artifacts[manifest]
        eng = _Scripted(factory(), buckets=(1, 2, 4), max_wait_ms=0.0,
                        feature_shapes=[(FEAT,)], install_sigterm=False)
        if stamp is not None:
            eng.model_id = stamp
        srv = ServeServer(eng)
        addr = (srv.host, srv.port)
        self.cells["%s:%d" % addr] = (eng, srv)
        return addr

    def spawn(self, manifest=None):
        self.spawn_log.append(manifest)
        return self._spawn(manifest)

    def retire(self, name, addr):
        self.retired.append((name, addr))
        cell = self.cells.pop(addr, None)
        if cell is not None:
            cell[1].close()
            cell[0].close()

    def kill(self, name):
        d = self.router.replicas()[name]
        eng, srv = self.cells.pop("%s:%d" % (d["host"], d["port"]))
        srv.close()
        eng.close()

    def engines(self):
        return {n: self.cells["%s:%d" % (d["host"], d["port"])][0]
                for n, d in self.router.replicas().items()
                if "%s:%d" % (d["host"], d["port"]) in self.cells}

    def close(self):
        self.ctrl.close()
        self.router.close()
        for eng, srv in self.cells.values():
            srv.close()
            eng.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@pytest.mark.parametrize("kw,needle", [
    (dict(min_replicas=0), "MIN_REPLICAS"),
    (dict(min_replicas=3, max_replicas=2), "MAX_REPLICAS"),
    (dict(sustain=0), "SUSTAIN"),
    (dict(canary_timeout=float("inf")), "CANARY_TIMEOUT"),
    (dict(scale_in_depth=5.0, scale_out_depth=4.0), "SCALE_IN_DEPTH"),
    (dict(poll_ms=-1.0), "POLL_MS"),
])
def test_controller_knob_validation(kw, needle):
    router = ServeRouter(poll_ms=0)
    try:
        kw.setdefault("poll_ms", 0)
        with pytest.raises(ValueError, match=needle):
            FleetController(router, lambda m=None: ("h", 1), **kw)
    finally:
        router.close()


def test_controller_autoscale_and_heal(pred, tmp_path):
    """Sustained depth spawns one warmed replica (journaled), sustained
    idle retires to the floor, a killed replica is healed under its
    name, and every replica still serves."""
    x = np.zeros((1, FEAT), np.float32)
    path = str(tmp_path / "ctrl.json")
    with _CtrlFleet(pred, 1, sustain=2, cooldown=0, scale_out_depth=4.0,
                    max_replicas=3, min_replicas=1, journal=path) as f:
        f.engines()["r0"].fake_depth = 8
        assert f.ctrl.tick()["scaled_out"] == []
        new = f.ctrl.tick()["scaled_out"]
        assert len(new) == 1
        assert f.router.replicas()[new[0]]["stats"]["warmed"] == [1, 2, 4]
        with open(path) as fh:
            assert [a["action"] for a in json.load(fh)["actions"]] == \
                ["scale_out"]
        f.engines()["r0"].fake_depth = 0
        f.ctrl.tick()
        assert f.ctrl.tick()["scaled_in"] == [new[0]]
        assert len(f.router.replicas()) == 1
    with _CtrlFleet(pred, 2, sustain=99) as f:
        h0 = _cval("serve.ctrl.heals")
        f.kill("r1")
        assert f.ctrl.tick()["healed"] == ["r1"]
        assert _cval("serve.ctrl.heals") == h0 + 1
        assert f.router.replicas()["r1"]["state"] == ReplicaState.LIVE
        for _ in range(4):
            f.router.infer(x)


def test_controller_rollout_and_rollback(pred):
    """A good artifact promotes every replica onto its stamp; a broken
    one fails the canary on the first replica and rolls back, the fleet
    uniform on the old stamp and a concurrent sweep error-free."""
    x = np.zeros((1, FEAT), np.float32)
    with _CtrlFleet(pred, 2, model_id="v1", sustain=99,
                    canary_inputs=[x]) as f:
        f.artifacts["m2"] = (lambda: f.pred, "v2")
        res = f.ctrl.rollout("m2", model_id="v2")
        assert not res.rolled_back and res.promoted == ["r0", "r1"]
        assert {d["model_id"] for d in f.router.replicas().values()} == \
            {"v2"}
        f.artifacts["bad"] = (_Broken, "v3")
        rb = _cval("serve.ctrl.rollbacks")
        stop, errors, done = threading.Event(), [], []

        def sweep():
            while not stop.is_set():
                try:
                    f.router.infer(x)
                    done.append(1)
                except Exception as exc:   # noqa: BLE001 — counted
                    errors.append(exc)

        t = threading.Thread(target=sweep)
        t.start()
        try:
            res = f.ctrl.rollout("bad", model_id="v3")
        finally:
            stop.set()
            t.join()
        assert res.rolled_back and "canary failed" in res.reason
        assert f.ctrl.manifest == "m2"
        assert _cval("serve.ctrl.rollbacks") == rb + 1
        assert {d["model_id"] for d in f.router.replicas().values()} == \
            {"v2"}
        assert not errors and done


# ---------------------------------------------------------------------------
# a mixed fleet
# ---------------------------------------------------------------------------

MIXED_REQS = [(np.arange(1, 6), 6, {}), (np.arange(3, 7), 7, SEEDED),
              (np.arange(2, 9), 5, {}), (np.arange(4, 8), 6,
                                         dict(SEEDED, seed=11))]


def _mixed_run(router, reqs):
    """Every request at once, one thread each behind a barrier: the
    router charges each dispatch before the next picks, so sessions
    spread over the replicas."""
    outs = [None] * len(reqs)
    barrier = threading.Barrier(len(reqs))

    def one(i, p, n, kw):
        barrier.wait()
        outs[i] = router.generate(p, n, eos_id=0, session="s%d" % i, **kw)

    ts = [threading.Thread(target=one, args=(i,) + r)
          for i, r in enumerate(reqs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120.0)
    for i in range(len(reqs)):
        router.release_session("s%d" % i)
    return outs


def test_mixed_fleet_behind_either_router():
    """One JAX decode replica and one port decode replica (float32),
    first behind the JAX package's router, then behind the port's: every
    row equals the JAX package's generate byte for byte and both replicas
    served. Then disaggregated, in both directions: a port prefill
    replica handing off to the JAX decoder behind the JAX router, a JAX
    prefill replica handing off to the port decoder behind the port's."""
    want = [_want(p, n, **kw) for p, n, kw in MIXED_REQS]
    jdec = JContinuousDecoder(_jgen())
    tdec = ContinuousDecoder(_gen())
    jsrv, tsrv = JServeServer(jdec), ServeServer(tdec)
    try:
        for R in (JServeRouter, ServeRouter):
            router = R(poll_ms=0)
            router.add_replica(jsrv.host, jsrv.port, name="jax")
            router.add_replica(tsrv.host, tsrv.port, name="port")
            router.poll_now()
            got = _mixed_run(router, MIXED_REQS)
            for g, w in zip(got, want):
                assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
            reps = router.replicas()
            assert reps["jax"]["dispatched"] > 0
            assert reps["port"]["dispatched"] > 0
            router.close()
        for R, pre, dec_srv, dec in (
                (JServeRouter, PrefillEngine(_gen(1)), jsrv, jdec),
                (ServeRouter, JPrefillEngine(_jgen(1)), tsrv, tdec)):
            psrv = (ServeServer if isinstance(pre, PrefillEngine)
                    else JServeServer)(pre)
            router = R(poll_ms=0)
            router.add_replica(psrv.host, psrv.port, name="prefill")
            router.add_replica(dec_srv.host, dec_srv.port, name="decode")
            router.poll_now()
            before = dec.stats()["prefills"]
            got = _mixed_run(router, MIXED_REQS)
            for g, w in zip(got, want):
                assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
            assert dec.stats()["prefills"] == before
            assert dec.stats()["imported"] >= len(MIXED_REQS)
            router.close()
            psrv.close()
            pre.close()
    finally:
        jsrv.close()
        tsrv.close()
        jdec.close()
        tdec.close()
