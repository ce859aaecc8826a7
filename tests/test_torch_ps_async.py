"""The ``dist_async`` parameter server of the PyTorch port
(``mxnet_tpu_torch.parallel.ps_async``) against the JAX package's
(``mxnet_tpu.parallel.ps_async``).

The in-process cases of tests/test_dist_async.py run against the port's
server in a thread: its protocol (replace without an optimizer, the
server-side optimizer, first writer wins, per-key locks, the counted
barrier) and its resilience (retries, the fault spec, dedup of replayed
ops, dead-worker detection, elastic shrink, revival). Then the two
packages side by side: the same pushes leave equal weights (rtol 1e-6,
SGD momentum and Adam on the server), key routing and stripe plans are
equal, and each package's client talks to the other's server, except
that the port's server refuses a JAX optimizer's pickle. One
multiprocess test runs Module.fit(kvstore='dist_async') with one server
started through the port's import hook and two workers, on the CPU.
"""
import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.parallel import ps_async
from mxnet_tpu_torch.parallel.ps_async import (AsyncPSClient, AsyncPSServer,
                                               ShardedPSClient,
                                               shard_for_key)
from mxnet_tpu_torch.parallel.resilience import (DeadWorkerError,
                                                 FaultInjected,
                                                 FaultInjector, RetryPolicy,
                                                 install_fault_injector)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the two packages' servers after the same pushes: within 1e-6 of each
# element and of the array's largest magnitude (XLA contracts the update
# into fused multiply-adds that torch rounds op by op: an element near
# zero lands a few ulps of the array's scale apart)
SERVER_RTOL = 1e-6


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(cls=AsyncPSServer, num_workers=2):
    srv = cls(host="127.0.0.1", port=0, num_workers=num_workers)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def server():
    srv = _serve()
    yield srv
    srv.stop()


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    """A failing fault test must not leak its injector into the next
    test's socket traffic."""
    yield
    install_fault_injector(None)


def _client(srv, cls=AsyncPSClient):
    return cls(host="127.0.0.1", port=srv.port)


# -- the protocol ---------------------------------------------------------

def test_push_replaces_without_optimizer(server):
    c = _client(server)
    c.init("w", np.full((3,), 5.0, np.float32))
    np.testing.assert_allclose(c.pull("w"), 5.0)
    c.push("w", np.full((3,), 2.0, np.float32))
    np.testing.assert_allclose(c.pull("w"), 2.0)   # replaced, not summed
    c.close()


def test_async_apply_with_server_side_optimizer(server):
    a, b = _client(server), _client(server)
    a.set_optimizer(mx.optimizer.SGD(learning_rate=0.1))
    a.init("w", np.ones((4,), np.float32))
    a.push("w", np.ones((4,), np.float32))       # applied at once
    np.testing.assert_allclose(a.pull("w"), 0.9, rtol=1e-6)
    b.push("w", np.full((4,), 2.0, np.float32))   # lands on a's result
    np.testing.assert_allclose(b.pull("w"), 0.7, rtol=1e-6)
    np.testing.assert_allclose(a.pull("w"), 0.7, rtol=1e-6)
    a.close()
    b.close()


def test_init_first_writer_wins(server):
    a, b = _client(server), _client(server)
    a.init("w", np.zeros((2,), np.float32))
    b.init("w", np.ones((2,), np.float32))      # ignored: already there
    np.testing.assert_allclose(b.pull("w"), 0.0)
    a.close()
    b.close()


def test_concurrent_pushes_to_distinct_keys_apply_in_parallel(server):
    """Per-key locks: two slow applies on distinct keys overlap in time
    (a global lock would force their intervals apart)."""
    c = _client(server)
    c.init("a", np.zeros((2,), np.float32))
    c.init("b", np.zeros((2,), np.float32))
    intervals = []

    def slow_updater(index, grad, weight):
        t0 = time.time()
        time.sleep(0.4)
        intervals.append((t0, time.time()))

    server._updater = slow_updater
    clients = [_client(server), _client(server)]
    ts = [threading.Thread(target=clients[i].push,
                           args=("ab"[i], np.ones((2,), np.float32)))
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert len(intervals) == 2
    (s0, e0), (s1, e1) = intervals
    assert s0 < e1 and s1 < e0, intervals
    for cl in clients + [c]:
        cl.close()


def test_barrier_counts_workers(server):
    a, b = _client(server), _client(server)
    hits = []
    t = threading.Thread(target=lambda: (b.barrier(), hits.append("b")),
                         daemon=True)
    t.start()
    time.sleep(0.2)
    assert not hits              # b waits until a arrives
    a.barrier()
    t.join(timeout=10)
    assert hits == ["b"]
    a.close()
    b.close()


def test_concurrent_push_stress_no_lost_updates():
    """4 client threads push constant gradients to 3 shared keys: any
    lost or torn update changes the deterministic final value."""
    srv = _serve(num_workers=99)
    try:
        boot = _client(srv)
        boot.set_optimizer(mx.optimizer.SGD(learning_rate=0.01,
                                            rescale_grad=1.0))
        keys = ["wa", "wb", "wc"]
        for k in keys:
            boot.init(k, np.full((4,), 5.0, np.float32))
        pushes, errs = 25, []

        def worker(seed):
            try:
                c = _client(srv)
                rng = np.random.RandomState(seed)
                for _ in range(pushes):
                    c.push(keys[rng.randint(3)], np.ones((4,), np.float32))
                c.close()
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert not errs, errs
        total = 0.0
        for k in keys:
            w = np.asarray(boot.pull(k))
            assert np.all(w == w[0])          # never torn
            total += (5.0 - w[0]) / 0.01
        assert abs(total - 4 * pushes) < 0.5, total
        boot.close()
    finally:
        srv.stop()


# -- resilience -----------------------------------------------------------

def test_retry_policy_deterministic_backoff_and_classification():
    a, b = RetryPolicy(seed="w3"), RetryPolicy(seed="w3")
    assert [a.delay(i) for i in range(1, 6)] == \
        [b.delay(i) for i in range(1, 6)]
    raw = RetryPolicy(seed=0, base_delay=0.1, max_delay=60.0)
    assert raw.delay(4) > raw.delay(1)
    assert raw.delay(1) <= 0.1
    assert RetryPolicy.is_transient(ConnectionResetError())
    assert RetryPolicy.is_transient(socket.timeout())
    assert RetryPolicy.is_transient(FaultInjected("x"))
    assert not RetryPolicy.is_transient(DeadWorkerError("x"))
    assert not RetryPolicy.is_transient(ValueError("x"))
    assert not RetryPolicy.is_transient(RuntimeError("async PS error"))


def test_fault_spec_parsing_and_counting():
    with pytest.raises(ValueError, match="MXNET_FAULT_SPEC"):
        FaultInjector("send:explode@1")
    with pytest.raises(ValueError, match="MXNET_FAULT_SPEC"):
        FaultInjector("send@1")

    class _Sock:
        def shutdown(self, *_a):
            pass

        def close(self):
            pass

    inj = FaultInjector("send:drop@2x2")
    hits = []
    for _ in range(5):
        try:
            inj.on_send("send", _Sock(), b"xx")
            hits.append(False)
        except FaultInjected:
            hits.append(True)
    assert hits == [False, True, True, False, False]
    assert inj.fired == [("send", 2, "drop"), ("send", 3, "drop")]
    inj = FaultInjector("recv:drop@2x*")
    inj._step("send")
    with pytest.raises(FaultInjected):
        [inj.on_recv("recv", _Sock()) for _ in range(2)]


def test_mid_push_disconnect_same_final_weights(monkeypatch):
    """A push frame torn mid-message and a severed pull reply land on
    the fault-free weights: the server never applies a retried push
    twice."""
    monkeypatch.setenv("MXNET_PS_RETRY_BASE", "0.01")

    def run(spec):
        srv = _serve(num_workers=1)
        c = _client(srv)
        c.set_optimizer(mx.optimizer.SGD(learning_rate=0.1,
                                         rescale_grad=1.0))
        c.init("w", np.ones((4,), np.float32))
        inj = install_fault_injector(FaultInjector(spec)) if spec else None
        try:
            for i in range(8):
                c.push("w", np.full((4,), float(i % 3), np.float32))
        finally:
            install_fault_injector(None)
        w = np.asarray(c.pull("w"))
        c.close()
        srv.stop()
        return w, inj

    w_plain, _ = run(None)
    w_fault, inj = run("send:disconnect@3;recv:drop@6")
    assert inj.fired == [("send", 3, "disconnect"), ("recv", 6, "drop")]
    np.testing.assert_array_equal(w_fault, w_plain)


def test_drop_connection_mid_pull_retries(monkeypatch):
    monkeypatch.setenv("MXNET_PS_RETRY_BASE", "0.01")
    srv = _serve(num_workers=1)
    try:
        c = _client(srv)
        c.init("w", np.full((3,), 7.0, np.float32))
        inj = install_fault_injector(FaultInjector("recv:drop@1"))
        try:
            np.testing.assert_allclose(c.pull("w"), 7.0)
        finally:
            install_fault_injector(None)
        assert inj.fired == [("recv", 1, "drop")]
        c.close()
    finally:
        srv.stop()


def test_dead_server_push_fails_cleanly_after_bounded_retries(
        monkeypatch):
    monkeypatch.setenv("MXNET_PS_RETRY_MAX", "2")
    monkeypatch.setenv("MXNET_PS_RETRY_BASE", "0.01")
    srv = _serve(num_workers=1)
    try:
        c = _client(srv)
        c.init("w", np.zeros((2,), np.float32))
        inj = install_fault_injector(FaultInjector("send:drop@1x*"))
        t0 = time.time()
        with pytest.raises(ConnectionError):
            c.push("w", np.ones((2,), np.float32))
        install_fault_injector(None)
        assert time.time() - t0 < 30
        assert len(inj.fired) == 3       # the attempt + 2 replays
        np.testing.assert_allclose(c.pull("w"), 0.0)
        c.close()
    finally:
        install_fault_injector(None)
        srv.stop()


def _two_workers(srv, monkeypatch):
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    a = _client(srv)
    monkeypatch.setenv("DMLC_WORKER_ID", "1")
    b = _client(srv)
    return a, b


def _kill_without_bye(c):
    """What a SIGKILL'd worker looks like to the server: no more
    heartbeats, the socket closed without a bye."""
    c._hb_stop.set()
    if c._hb_thread is not None:
        c._hb_thread.join(timeout=10)
    with c._lock:
        c._drop_connection_locked()


def _heartbeats(monkeypatch, timeout="1.0", elastic=False):
    monkeypatch.setenv("MXNET_PS_HEARTBEAT_INTERVAL", "0.2")
    monkeypatch.setenv("MXNET_PS_HEARTBEAT_TIMEOUT", timeout)
    if elastic:
        monkeypatch.setenv("MXNET_PS_ELASTIC", "1")


def test_worker_death_during_barrier_releases_with_error(monkeypatch):
    _heartbeats(monkeypatch)
    srv = _serve()
    try:
        a, b = _two_workers(srv, monkeypatch)
        time.sleep(0.6)
        _kill_without_bye(b)
        t0 = time.time()
        with pytest.raises(DeadWorkerError):
            a.barrier()
        assert time.time() - t0 < 10
        with pytest.raises(DeadWorkerError):
            a.barrier()                  # broken for good
        a.close()
    finally:
        srv.stop()


def test_worker_death_elastic_shrinks_cohort(monkeypatch):
    _heartbeats(monkeypatch, elastic=True)
    srv = _serve()
    try:
        a, b = _two_workers(srv, monkeypatch)
        time.sleep(0.6)
        _kill_without_bye(b)
        done = []
        t = threading.Thread(target=lambda: (a.barrier(),
                                             done.append(True)),
                             daemon=True)
        t.start()
        t.join(timeout=15)
        assert done == [True]
        assert srv._num_workers == 1
        a.init("w", np.zeros((2,), np.float32))
        a.push("w", np.full((2,), 3.0, np.float32))
        np.testing.assert_allclose(a.pull("w"), 3.0)
        a.close()
    finally:
        srv.stop()


def test_barrier_replay_is_idempotent(monkeypatch):
    monkeypatch.setenv("MXNET_PS_RETRY_BASE", "0.01")
    srv = _serve()
    try:
        a, b = _two_workers(srv, monkeypatch)
        released = []

        def barrier_through_fault():
            install_fault_injector(FaultInjector("recv:drop@1"))
            try:
                a.barrier()
            finally:
                install_fault_injector(None)
            released.append("a")

        t = threading.Thread(target=barrier_through_fault, daemon=True)
        t.start()
        time.sleep(0.7)
        assert not released
        b.barrier()
        t.join(timeout=15)
        assert released == ["a"]
        a.close()
        b.close()
    finally:
        srv.stop()


def test_replay_of_inflight_push_waits_not_reexecutes(monkeypatch):
    from mxnet_tpu_torch import optimizer as opt_mod
    monkeypatch.setenv("MXNET_PS_RETRY_BASE", "0.01")
    monkeypatch.setenv("MXNET_PS_OP_TIMEOUT", "0.3")
    srv = _serve(num_workers=1)
    try:
        c = _client(srv)
        c.init("w", np.zeros((2,), np.float32))
        real = opt_mod.get_updater(
            opt_mod.SGD(learning_rate=1.0, rescale_grad=1.0))
        applies = []

        def slow_updater(index, grad, weight):
            applies.append(index)
            time.sleep(0.8)              # past MXNET_PS_OP_TIMEOUT
            real(index, grad, weight)

        srv._updater = slow_updater
        c.push("w", np.ones((2,), np.float32))
        assert len(applies) == 1, applies
        srv._updater = None
        np.testing.assert_allclose(c.pull("w"), -1.0)
        c.close()
    finally:
        srv.stop()


def test_concurrent_op_cannot_evict_dedup_during_backoff(monkeypatch):
    monkeypatch.setenv("MXNET_PS_RETRY_BASE", "0.05")
    srv = _serve(num_workers=1)
    try:
        c = _client(srv)
        c.set_optimizer(mx.optimizer.SGD(learning_rate=1.0,
                                         rescale_grad=1.0))
        c.init("w", np.zeros((2,), np.float32))
        inj = install_fault_injector(FaultInjector("recv:drop@1"))
        try:
            threads = [threading.Thread(
                target=lambda: [c.push("w", np.ones((2,), np.float32))
                                for _ in range(3)]) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            install_fault_injector(None)
        assert inj.fired == [("recv", 1, "drop")]
        np.testing.assert_allclose(c.pull("w"), -6.0)   # exactly once
        c.close()
    finally:
        srv.stop()


def test_clean_bye_is_not_a_death(monkeypatch):
    _heartbeats(monkeypatch)
    srv = _serve()
    try:
        a, b = _two_workers(srv, monkeypatch)
        time.sleep(0.6)
        b.close()
        time.sleep(2.0)              # past the heartbeat timeout
        assert not srv._dead_workers
        assert srv._barrier_abort is None
        a.close()
    finally:
        srv.stop()


def _stall(srv, c, wid):
    c._hb_stop.set()
    c._hb_thread.join(timeout=10)
    deadline = time.time() + 15
    while wid not in srv._dead_workers and time.time() < deadline:
        time.sleep(0.05)
    assert wid in srv._dead_workers


def test_false_death_revives_on_next_ping_elastic(monkeypatch):
    _heartbeats(monkeypatch, timeout="1.2", elastic=True)
    srv = _serve()
    try:
        a, b = _two_workers(srv, monkeypatch)
        time.sleep(0.5)
        _stall(srv, b, 1)
        assert srv._num_workers == 1
        b._call("ping", b._wid)
        assert 1 not in srv._dead_workers and srv._num_workers == 2
        released = []
        t = threading.Thread(target=lambda: (a.barrier(),
                                             released.append("a")),
                             daemon=True)
        t.start()
        time.sleep(0.5)
        assert not released
        b.barrier()
        t.join(timeout=15)
        assert released == ["a"]
        a.close()
        b.close()
    finally:
        srv.stop()


def test_elastic_floor_death_then_revive_does_not_inflate(monkeypatch):
    _heartbeats(monkeypatch, timeout="1.2", elastic=True)
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    srv = _serve(num_workers=1)
    try:
        a = _client(srv)
        time.sleep(0.4)
        _stall(srv, a, 0)
        assert srv._num_workers == 1         # floored, never 0
        a._call("ping", a._wid)
        assert 0 not in srv._dead_workers
        assert srv._num_workers == 1         # not inflated to 2
        a.barrier()
        a.close()
    finally:
        srv.stop()


def test_full_cohort_revival_clears_barrier_abort(monkeypatch):
    _heartbeats(monkeypatch, timeout="1.2")
    srv = _serve()
    try:
        a, b = _two_workers(srv, monkeypatch)
        time.sleep(0.5)
        b._hb_stop.set()
        b._hb_thread.join(timeout=10)
        with pytest.raises(DeadWorkerError):
            a.barrier()
        b._call("ping", b._wid)
        assert srv._barrier_abort is None
        released = []
        t = threading.Thread(target=lambda: (a.barrier(),
                                             released.append("a")),
                             daemon=True)
        t.start()
        time.sleep(0.3)
        assert not released
        b.barrier()
        t.join(timeout=15)
        assert released == ["a"]
        a.close()
        b.close()
    finally:
        srv.stop()


# -- against the JAX package ----------------------------------------------

def _optimizers(kind):
    """The same optimizer in both packages."""
    import mxnet_tpu as jmx
    if kind == "sgd_momentum":
        kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
                  rescale_grad=0.5)
        return jmx.optimizer.SGD(**kw), mx.optimizer.SGD(**kw)
    kw = dict(learning_rate=0.01, wd=1e-4, rescale_grad=0.5)
    return jmx.optimizer.Adam(**kw), mx.optimizer.Adam(**kw)


@pytest.mark.parametrize("kind", ["sgd_momentum", "adam"])
def test_same_pushes_leave_equal_weights(kind):
    """Init, set_optimizer and eight pushes over two keys through each
    package's server (its own client): the stores end within
    SERVER_RTOL."""
    from mxnet_tpu.parallel import ps_async as jps
    rng = np.random.RandomState(3)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (("w", (6, 5)), ("b", (5,)))}
    grads = [(k, rng.standard_normal(init[k].shape).astype(np.float32))
             for k in ("w", "b", "w", "w", "b", "w", "b", "w")]
    out = []
    for (srv_cls, cli_cls), opt in zip(
            ((jps.AsyncPSServer, jps.AsyncPSClient),
             (AsyncPSServer, AsyncPSClient)), _optimizers(kind)):
        srv = _serve(srv_cls, num_workers=1)
        try:
            c = _client(srv, cli_cls)
            c.set_optimizer(opt)
            for k, v in init.items():
                c.init(k, v)
            for k, g in grads:
                c.push(k, g)
            out.append({k: np.asarray(c.pull(k)) for k in init})
            c.close()
        finally:
            srv.stop()
    for k in init:
        assert not np.allclose(out[1][k], init[k])
        np.testing.assert_allclose(
            out[1][k], out[0][k], rtol=SERVER_RTOL,
            atol=SERVER_RTOL * float(np.abs(out[0][k]).max()), err_msg=k)


def test_key_routing_and_stripe_plans_match_jax(monkeypatch):
    """shard_for_key and the stripe plans are the JAX package's for the
    same keys, shapes and bounds; a striped key written through a JAX
    client pulls back whole through the port's, from shape alone."""
    from mxnet_tpu.parallel import ps_async as jps
    keys = ["w%d" % i for i in range(40)] + [3, 17, "fc1_weight",
                                               "embed__strip1", ""]
    for n in (1, 2, 3, 5, 8):
        assert [shard_for_key(k, n) for k in keys] == \
            [jps.shard_for_key(k, n) for k in keys]
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "100")
    srvs = [_serve(num_workers=99) for _ in range(3)]
    try:
        eps = [("127.0.0.1", s.port) for s in srvs]
        mine, theirs = ShardedPSClient(eps), jps.ShardedPSClient(eps)
        for shape in ((100,), (101,), (257, 1), (7, 31), (1000, 3)):
            for dt in (np.float32, np.int32):
                assert mine._should_stripe(int(np.prod(shape))) == \
                    theirs._should_stripe(int(np.prod(shape)))
                assert mine._stripe_plan("k", shape, dt) == \
                    theirs._stripe_plan("k", shape, dt)
        big = np.arange(257 * 3, dtype=np.float32).reshape(257, 3)
        theirs.init("emb", big)
        held = [set(AsyncPSClient(*ep).stats()) for ep in eps]
        assert all("emb__strip%d" % i in held[i] for i in range(3))
        fresh = ShardedPSClient(eps)
        np.testing.assert_array_equal(
            fresh.pull("emb", shape=(257, 3), dtype=np.float32), big)
        fresh.push("emb", big * 2)       # replace stripe-wise
        np.testing.assert_array_equal(
            theirs.pull("emb", shape=(257, 3), dtype=np.float32), big * 2)
        for c in (mine, theirs, fresh):
            c.close()
    finally:
        for s in srvs:
            s.stop()


def test_cross_package_wire():
    """A port client against a JAX server and a JAX client against the
    port's server give the same init/push/pull/barrier results; the
    port's server refuses a JAX optimizer's pickle."""
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import ps_async as jps
    w0 = np.arange(6, dtype=np.float32).reshape(2, 3)
    results = []
    for srv_cls, cli_cls in ((jps.AsyncPSServer, AsyncPSClient),
                             (AsyncPSServer, jps.AsyncPSClient)):
        srv = _serve(srv_cls, num_workers=1)
        try:
            c = _client(srv, cli_cls)
            c.init("w", w0)
            c.init("w", w0 + 100)            # first writer wins
            got = [np.asarray(c.pull("w"))]
            c.push("w", w0 * 3)              # no optimizer: replaced
            got.append(np.asarray(c.pull("w")))
            c.barrier()
            got.append(sorted(c.stats()))
            if srv_cls is AsyncPSServer:
                with pytest.raises(RuntimeError, match="mxnet_tpu"):
                    c.set_optimizer(jmx.optimizer.SGD(learning_rate=0.1))
                c.push("w", w0)              # still serving, no updater
                got.append(np.asarray(c.pull("w")))
            c.close()
            results.append(got)
        finally:
            srv.stop()
    (j0, j1, jk), (p0, p1, pk, p2) = results
    np.testing.assert_array_equal(j0, w0)
    np.testing.assert_array_equal(p0, w0)
    np.testing.assert_array_equal(j1, w0 * 3)
    np.testing.assert_array_equal(p1, w0 * 3)
    assert jk == pk == ["w"]
    np.testing.assert_array_equal(p2, w0)
    with pytest.raises(pickle.UnpicklingError, match="mxnet_tpu"):
        ps_async._loads(pickle.dumps(jmx.optimizer.SGD(), protocol=4))
    with pytest.raises(pickle.UnpicklingError, match="os.system"):
        ps_async._loads(b"\x80\x04\x95\x10\x00\x00\x00\x00\x00\x00\x00"
                        b"\x8c\x02os\x94\x8c\x06system\x94\x93\x94.")
    port_opt = ps_async._loads(pickle.dumps(
        mx.optimizer.SGD(learning_rate=0.3, momentum=0.9), protocol=4))
    assert type(port_opt) is mx.optimizer.SGD and port_opt.lr == 0.3


# -- one server and two workers through the import hook -------------------

_SERVER_SRC = r"""
import mxnet_tpu_torch
raise SystemExit("the server role returned into the script")
"""

_FIT_WORKER_SRC = r"""
import os, sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io

rank = int(os.environ["DMLC_WORKER_ID"])
rng = np.random.RandomState(0)
protos = rng.randn(10, 32).astype(np.float32)
lab = rng.randint(0, 10, 512)
X = (protos[lab] + 0.3 * rng.randn(512, 32)).astype(np.float32)
y = lab.astype(np.float32)
Xw, yw = X[rank::2], y[rank::2]      # updates meet only on the server

net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Activation(
    mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=32,
                          name="fc1"), act_type="relu"),
    num_hidden=10, name="fc2"), name="softmax")
with mx.cpu():
    it = io.NDArrayIter(Xw, yw, batch_size=32, shuffle=True)
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(it, num_epoch=8, optimizer="sgd", kvstore="dist_async",
            initializer=mx.init.Xavier(),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "rescale_grad": 1.0 / 32})
    kv = mod._kvstore
    assert kv.type == "dist_async" and kv._async_client is not None
    assert kv.rank == rank and kv.num_workers == 2
    score = mod.score(it, "acc")
acc = score[0][1]
assert acc > 0.9, "rank %d acc %.3f" % (rank, acc)
assert "jax" not in sys.modules and "mxnet_tpu" not in sys.modules
print("FIT_WORKER_OK", rank)
"""


def test_module_fit_dist_async(tmp_path):
    """Module.fit(kvstore='dist_async'): the server started as
    tools/launch.py starts it (the job's import under DMLC_ROLE=server
    re-execs into ps_async.serve_forever), two workers on disjoint
    shards pushing to the server-side optimizer; both converge and the
    server exits once both have left."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(port), DMLC_NUM_WORKER="2",
               MXNET_KVSTORE_TYPE="dist_async", OMP_NUM_THREADS="1")
    (tmp_path / "server.py").write_text(_SERVER_SRC)
    (tmp_path / "worker.py").write_text(_FIT_WORKER_SRC)
    server = subprocess.Popen(
        [sys.executable, str(tmp_path / "server.py")],
        env=dict(env, DMLC_ROLE="server"), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    workers = []
    try:
        for wid in range(2):
            workers.append(subprocess.Popen(
                [sys.executable, str(tmp_path / "worker.py")],
                env=dict(env, DMLC_ROLE="worker", DMLC_WORKER_ID=str(wid)),
                cwd=str(tmp_path), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for wid, w in enumerate(workers):
            out, _ = w.communicate(timeout=240)
            assert w.returncode == 0, "worker %d:\n%s" % (wid, out[-1500:])
            assert "FIT_WORKER_OK %d" % wid in out
        sout, _ = server.communicate(timeout=60)
        assert server.returncode == 0, "server:\n%s" % sout[-1500:]
    finally:
        for p in workers + [server]:
            if p.poll() is None:
                p.kill()
