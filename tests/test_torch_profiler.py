"""The profiler of the PyTorch port (``mxnet_tpu_torch.profiler``) against
the JAX package's (``mxnet_tpu.profiler``): the four cases of
tests/test_profiler.py on the port, the same programs through both
packages giving equal event streams (names, categories and nesting) and
dumps with the same top-level keys, and the port's device trace over
``torch.profiler`` (CPU activities here)."""
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

PKGS = ("mxnet_tpu", "mxnet_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mx(name):
    return importlib.import_module(name)


@pytest.fixture(autouse=True)
def _stopped():
    yield
    for name in PKGS:
        prof = _mx(name).profiler
        prof.profiler_set_state("stop")
        prof.profiler_set_config(mode="symbolic", filename="profile.json",
                                 xplane_dir=None)


def _trace(prof):
    return json.load(open(prof.dump_profile()))


# -- the four cases of tests/test_profiler.py, on the port ---------------

def test_eager_op_timeline(tmp_path):
    import mxnet_tpu_torch as mx
    prof = mx.profiler
    prof.profiler_set_config(mode="all", filename=str(tmp_path / "p.json"))
    prof.profiler_set_state("run")
    try:
        with mx.cpu():
            a = mx.nd.ones((8, 8))
            b = mx.nd.dot(a, a)
            (b + 1).wait_to_read()
    finally:
        prof.profiler_set_state("stop")
    trace = _trace(prof)
    names = [e["name"] for e in trace["traceEvents"]]
    assert "dot" in names
    assert any(n in names for n in ("_plus_scalar", "broadcast_add"))
    ev = trace["traceEvents"][0]
    assert ev["ph"] == "X" and ev["dur"] >= 1
    assert {e["cat"] for e in trace["traceEvents"]} >= {"operator", "sync"}


def test_symbolic_mode_records_executor_only(tmp_path):
    import mxnet_tpu_torch as mx
    prof = mx.profiler
    prof.profiler_set_config(mode="symbolic",
                             filename=str(tmp_path / "p.json"))
    prof.profiler_set_state("run")
    try:
        with mx.cpu():
            x = mx.sym.Variable("data")
            y = mx.sym.FullyConnected(x, num_hidden=4, name="fc")
            ex = y.simple_bind(data=(2, 3))
            for name, arr in ex.arg_dict.items():
                if name != "data":
                    arr[:] = np.ones(arr.shape, "float32")
            ex.forward(data=np.ones((2, 3), "float32"))
            mx.nd.ones((4,)).wait_to_read()   # eager: not recorded
    finally:
        prof.profiler_set_state("stop")
    trace = _trace(prof)
    cats = {e["cat"] for e in trace["traceEvents"]}
    names = [e["name"] for e in trace["traceEvents"]]
    assert "executor" in cats and "operator" not in cats
    assert "executor_forward" in names
    assert "_ones" not in names


def test_stop_clears_collection_on_restart(tmp_path):
    import mxnet_tpu_torch as mx
    prof = mx.profiler
    prof.profiler_set_config(mode="all", filename=str(tmp_path / "p.json"))
    prof.profiler_set_state("run")
    with mx.cpu():
        mx.nd.ones((2,)).wait_to_read()
    prof.profiler_set_state("stop")
    prof.profiler_set_state("run")
    prof.profiler_set_state("stop")
    assert _trace(prof)["traceEvents"] == []


def test_scope_nesting(tmp_path):
    import mxnet_tpu_torch as mx
    prof = mx.profiler
    prof.profiler_set_config(mode="all", filename=str(tmp_path / "s.json"))
    prof.profiler_set_state("run")
    try:
        with prof.scope("outer", "user"), mx.cpu():
            (mx.nd.ones((2,)) + 1).wait_to_read()
    finally:
        prof.profiler_set_state("stop")
    names = [e["name"] for e in _trace(prof)["traceEvents"]]
    assert "outer" in names and "_plus_scalar" in names


# -- the same programs through both packages ------------------------------

def _program(mx, mode, path):
    """Eager ops inside a user scope, a host sync, a bound graph's
    inference forward and a step marker, under ``mode``."""
    prof = mx.profiler
    prof.profiler_set_config(mode=mode, filename=path)
    prof.profiler_set_state("run")
    try:
        with mx.cpu():
            with prof.scope("outer", "user"):
                a = mx.nd.ones((8, 8))
                b = mx.nd.dot(a, a)
                with prof.scope("inner", "user"):
                    c = mx.nd.relu(b - 3.0)
                (c + 1).wait_to_read()
            x = mx.sym.Variable("data")
            y = mx.sym.FullyConnected(x, num_hidden=4, name="fc")
            ex = y.simple_bind(mx.cpu(), data=(2, 3))
            with prof.step_scope(7):
                ex.forward(data=np.ones((2, 3), "float32"))
            c.asnumpy()
            prof.record_event("mark", "user", 0, 1)
    finally:
        prof.profiler_set_state("stop")
    return _trace(prof)


def _stream(trace):
    """(name, category, enclosing event's name) in record order; an
    event encloses another when its span holds the other's (1 us of
    slack for the microsecond truncation of both)."""
    evs = trace["traceEvents"]
    out = []
    for i, e in enumerate(evs):
        parents = [p for p in evs[i + 1:]
                   if p["ts"] - 1 <= e["ts"] and
                   e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1 and
                   p["dur"] > e["dur"]]
        out.append((e["name"], e["cat"],
                    parents[0]["name"] if parents else None))
    return out


@pytest.mark.parametrize("mode", ["all", "symbolic"])
def test_event_streams_match_jax(tmp_path, mode):
    traces = [_program(_mx(name), mode, str(tmp_path / ("%s.json" % name)))
              for name in PKGS]
    want, got = (_stream(t) for t in traces)
    assert got == want
    assert sorted(traces[0]) == sorted(traces[1]) == \
        ["displayTimeUnit", "telemetry", "traceEvents"]
    assert traces[1]["displayTimeUnit"] == "ms"
    names = [n for n, _, _ in got]
    assert "train_step#7" in names and "executor_forward" in names
    if mode == "symbolic":
        assert not any(c == "operator" for _, c, _ in got)
    else:
        assert ("relu", "operator", "inner") in got
        assert ("inner", "user", "outer") in got


def test_surface_and_aliases(tmp_path):
    import mxnet_tpu_torch as mx
    from mxnet_tpu import profiler as jprof
    prof = mx.profiler
    assert set(jprof.__all__) == set(prof.__all__)
    assert prof.set_config is prof.profiler_set_config
    assert prof.set_state is prof.profiler_set_state
    assert prof.dump is prof.dump_profile
    assert not prof.is_running() and prof.mode() == "symbolic"
    with pytest.raises(ValueError):
        prof.profiler_set_config(mode="bogus")
    with pytest.raises(ValueError):
        prof.profiler_set_state("pause")
    prof.record_event("dropped", "user", 0, 1)   # stopped: a no-op
    prof.set_config(mode="all", filename=str(tmp_path / "a.json"))
    prof.set_state("run")
    assert prof.is_running() and prof.mode() == "all"
    n = prof.host_sync_count()
    with mx.cpu():
        (mx.nd.ones((2,)) + 1).asnumpy()
    prof.set_state("stop")
    assert prof.host_sync_count() == n + 1
    trace = json.load(open(prof.dump()))
    assert [e["name"] for e in trace["traceEvents"]] == \
        ["_plus_scalar", "host_sync:asnumpy"]
    assert "host_syncs" in json.dumps(trace["telemetry"])


def test_device_trace_records_scopes_and_executor(tmp_path):
    """With a trace directory, run/stop drive a torch.profiler trace
    (CPU activities where CUDA is absent) written as a Chrome trace into
    that directory; scopes, step markers and the executor's runs appear
    in it as record_function ranges."""
    import mxnet_tpu_torch as mx
    prof = mx.profiler
    xdir = tmp_path / "xplane"
    prof.profiler_set_config(mode="symbolic",
                             filename=str(tmp_path / "p.json"),
                             xplane_dir=str(xdir))
    prof.profiler_set_state("run")
    try:
        with mx.cpu():
            x = mx.sym.Variable("data")
            y = mx.sym.FullyConnected(x, num_hidden=4, name="fc")
            ex = y.simple_bind(data=(2, 3), grad_req="write")
            with prof.step_scope(0), prof.scope("user_region", "user"):
                ex.forward(is_train=True, data=np.ones((2, 3), "float32"))
                ex.backward()
    finally:
        prof.profiler_set_state("stop")
    files = sorted(os.listdir(xdir))
    assert len(files) == 1 and files[0].endswith(".json")
    assert prof._P.device_traces == [str(xdir / files[0])]
    dev = json.load(open(xdir / files[0]))
    names = {e.get("name") for e in dev["traceEvents"]}
    assert {"user_region", "train_step#0", "executor_forward_train",
            "executor_backward"} <= names
    host = [e["name"] for e in _trace(prof)["traceEvents"]]
    assert host == ["executor_forward_train", "executor_backward",
                    "user_region", "train_step#0"]


def test_autostart_from_the_environment(tmp_path):
    """MXNET_PROFILER_AUTOSTART starts collection at import, in the mode
    MXNET_PROFILER_MODE names; the package imports no jax."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, mxnet_tpu_torch as mx\n"
         "p = mx.profiler\n"
         "assert p.is_running() and p.mode() == 'all', p.mode()\n"
         "with mx.cpu():\n"
         "    mx.nd.ones((2,)) + 1\n"
         "p.set_state('stop')\n"
         "assert [e['name'] for e in p._P.events] == "
         "['_plus_scalar'], p._P.events\n"
         "assert 'jax' not in sys.modules\n"
         "print('AUTOSTART_OK')\n"],
        env=dict(os.environ, PYTHONPATH=REPO, MXNET_PROFILER_AUTOSTART="1",
                 MXNET_PROFILER_MODE="1"),
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "AUTOSTART_OK" in out.stdout
