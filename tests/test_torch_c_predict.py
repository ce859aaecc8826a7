"""The port's C ABI (``mxnet_tpu_torch/_native/predict_shim.cc``) against
the JAX package, on the CPU (after ``tests/test_c_predict.py``).

The unchanged hosts of ``examples/c_predict/`` (``predict.c``,
``predict_cpp.cc`` over ``mxtpu_cpp.hpp``, ``train.c``) are linked against
the port's shim, built into ``build/native/``, and run as child processes
that embed this interpreter (``MXNET_CAPI_DEVICE=cpu``; a ``jax`` and an
``mxnet_tpu`` that raise on import come first on their path):

* ``predict.c`` and ``predict_cpp.cc`` serve the JAX test's small
  FC-tanh-FC-softmax net at (2, 8), its numpy weights carried across by
  ``convert.params_from_jax``, exported by the port's
  ``Predictor.export``: their printed outputs lie within rtol 1e-5 /
  atol 1e-6 of the JAX package's in-process ``Predictor.forward`` and
  print the port's in-process ``CompiledPredictor`` forward digit for
  digit (``%.8g``);
* ``train.c`` runs 3 SGD-momentum steps of the JAX test's training net
  from one JAX ``init_state``: the softmax output and ``fc1_weight`` lie
  within 1e-5 of 3 steps of the JAX package's exported step, and print
  the port's in-process ``CompiledTrainStep`` digit for digit (``%.6e``);
* the error surface: a bad prefix, an unknown input name, a wrong input
  size and a prefix the JAX package exported (a forward and a training
  step) each end the host with rc 1 and the message on stderr.

The children import torch, so they run concurrently, started once per
module. A failed build of the shim raises; nothing here skips.
"""
import os
import subprocess

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.initializer import Xavier as JXavier
from mxnet_tpu.parallel import make_train_step as jmake_train_step
from mxnet_tpu.parallel.trainer import CompiledTrainStep as JCompiled
from mxnet_tpu.predictor import Predictor as JPredictor

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _native
from mxnet_tpu_torch.convert import params_from_jax
from mxnet_tpu_torch.parallel import make_train_step as tmake_train_step
from mxnet_tpu_torch.parallel.trainer import CompiledTrainStep
from mxnet_tpu_torch.predictor import CompiledPredictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "c_predict")
TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_STEPS, TRAIN_LR, TRAIN_B = 3, 0.2, 32
HOST_TIMEOUT_S = 120

# a host that creates the predictor on its main thread and runs it on
# another: every call must take the GIL itself (the shim releases the
# one the interpreter's first thread held)
THREADED_HOST = r"""
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>

extern void* MXTpuPredCreate(const char* prefix);
extern int MXTpuPredSetInput(void* h, const char* key, const float* data,
                             uint64_t size);
extern int MXTpuPredForward(void* h);
extern int MXTpuPredGetOutput(void* h, uint32_t index, float* data,
                              uint64_t size);
extern void MXTpuPredFree(void* h);
extern const char* MXTpuGetLastError(void);

static void* handle;
static float input[16], output[8];
static int rc;

static void* work(void* arg) {
  (void)arg;
  rc = MXTpuPredSetInput(handle, "data", input, 16) ||
       MXTpuPredForward(handle) ||
       MXTpuPredGetOutput(handle, 0, output, 8);
  return NULL;
}

int main(int argc, char** argv) {
  FILE* f = fopen(argv[2], "rb");
  if (argc != 3 || !f || fread(input, sizeof(float), 16, f) != 16) return 2;
  fclose(f);
  handle = MXTpuPredCreate(argv[1]);
  if (!handle) {
    fprintf(stderr, "create: %s\n", MXTpuGetLastError());
    return 1;
  }
  pthread_t t;
  pthread_create(&t, NULL, work, NULL);
  pthread_join(t, NULL);
  if (rc) {
    fprintf(stderr, "worker: %s\n", MXTpuGetLastError());
    return 1;
  }
  for (int i = 0; i < 8; ++i) printf("%.8g\n", output[i]);
  MXTpuPredFree(handle);
  return 0;
}
"""


def _small_net(mx, data="data"):
    net = mx.sym.Variable(data)
    net = mx.sym.FullyConnected(net, name="fc1", num_hidden=16)
    net = mx.sym.Activation(net, act_type="tanh")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=4)
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _small_weights():
    """The JAX test's Xavier weights, as numpy."""
    net = _small_net(jmx)
    arg_shapes, _, _ = net.infer_shape(data=(2, 8))
    init = JXavier()
    jmx.random.seed(7)
    args = {}
    for name, shp in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        arr = jmx.nd.zeros(shp)
        init(name, arr)
        args[name] = arr.asnumpy()
    return args


def _train_net(mx):
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Activation(
        mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16,
                              name="fc1"), act_type="relu"),
        num_hidden=2, name="fc2"), name="softmax")


TRAIN_OPT = {"momentum": 0.9, "rescale_grad": 1.0 / TRAIN_B}


def _compile(tmp, name, src, cxx=False):
    so = _native.build_predict_shim()
    out = str(tmp / name)
    cmd = (["g++", "-std=c++17", "-I%s" % EXAMPLES] if cxx else ["gcc"]) + \
        [os.path.join(EXAMPLES, src), "-o", out, so,
         "-Wl,-rpath,%s" % os.path.dirname(so), "-pthread"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, "cannot build %s: %s" % (src, r.stderr)
    return out


def _start(argv, poison, **extra):
    """A host process on the CPU whose interpreter finds a ``jax`` and an
    ``mxnet_tpu`` that raise on import before the real ones."""
    env = _native.host_env(device="cpu", **extra)
    env["PYTHONPATH"] = os.pathsep.join([poison, env["PYTHONPATH"]])
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _finish(proc):
    """(rc, stdout, stderr); a host past HOST_TIMEOUT_S (a deadlock) is
    killed and reports rc None."""
    try:
        out, err = proc.communicate(timeout=HOST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        return None, out, err + "\n(killed after %d s)" % HOST_TIMEOUT_S
    return proc.returncode, out, err


def _printed(lines, at):
    """(shape, values as the printed strings, next line index) of one
    ``<what> shape d0 d1 ...`` block."""
    shape = tuple(int(v) for v in lines[at].split("shape")[1].split())
    n = int(np.prod(shape))
    return shape, lines[at + 1:at + 1 + n], at + 1 + n


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every host's run, started together: {case: (rc, stdout, stderr)},
    plus the in-process values they are held to."""
    tmp = tmp_path_factory.mktemp("capi")
    predict = _compile(tmp, "predict", "predict.c")
    predict_cpp = _compile(tmp, "predict_cpp", "predict_cpp.cc", cxx=True)
    train = _compile(tmp, "train", "train.c")
    (tmp / "threaded.c").write_text(THREADED_HOST)
    threaded = _compile(tmp, "threaded", str(tmp / "threaded.c"))

    # -- serving: the JAX test's net, its weights in both packages --------
    args = _small_weights()
    x = np.random.RandomState(0).standard_normal((2, 8)).astype(np.float32)
    want = {"jax": np.asarray(JPredictor(_small_net(jmx), args,
                                         data_names=("data",))
                              .forward(x)[0].asnumpy(), np.float32)}
    tparams = params_from_jax(args, "cpu")
    prefix = str(tmp / "model")
    tmx.Predictor(_small_net(tmx), tparams, data_names=("data",),
                  ctx=tmx.cpu()).export(prefix, {"data": (2, 8)})
    want["port"] = CompiledPredictor.load(prefix, ctx=tmx.cpu()).forward(
        x)[0].asnumpy()
    raw = tmp / "input.f32"
    raw.write_bytes(x.tobytes())
    # a net whose input is named x, not predict.c's "data"
    xprefix = str(tmp / "named_x")
    tmx.Predictor(_small_net(tmx, data="x"), tparams, data_names=("x",),
                  ctx=tmx.cpu()).export(xprefix, {"x": (2, 8)})
    jprefix = str(tmp / "jax_model")
    JPredictor(_small_net(jmx), args, data_names=("data",)).export(
        jprefix, {"data": (2, 8)})

    # -- training: one JAX init_state, exported by both packages ---------
    rng = np.random.RandomState(0)
    X = rng.standard_normal((TRAIN_B, 8)).astype(np.float32)
    y = (X @ rng.standard_normal(8) > 0).astype(np.float32)
    batch = {"data": X, "softmax_label": y}
    shapes = {"data": (TRAIN_B, 8), "softmax_label": (TRAIN_B,)}
    jstep = jmake_train_step(_train_net(jmx), optimizer="sgd",
                             optimizer_params=TRAIN_OPT)
    jmx.random.seed(0)
    jstate = jstep.init_state(JXavier(), shapes)
    jtrain = str(tmp / "jax_train")
    jstep.export(jtrain, jstate, jstep.place_batch(batch))
    tstep = tmake_train_step(_train_net(tmx), optimizer="sgd",
                             optimizer_params=TRAIN_OPT, ctx=tmx.cpu())
    tstate = tstep.init_state(None, shapes, arg_params={
        k: np.asarray(v) for k, v in jstate[0].items()})
    ttrain = str(tmp / "port_train")
    tstep.export(ttrain, tstate, batch)
    w0 = np.asarray(jstate[0]["fc1_weight"], np.float32)
    jct = JCompiled.load(jtrain)
    tct = CompiledTrainStep.load(ttrain, ctx=tmx.cpu())
    for _ in range(TRAIN_STEPS):
        jout = jct.step(batch, TRAIN_LR)
        tout = tct.step(batch, TRAIN_LR)
    want["train_jax"] = (np.asarray(jout[0], np.float32),
                         np.asarray(jct.get_params()["fc1_weight"],
                                    np.float32))
    want["train_port"] = (tout[0], tct.get_params()["fc1_weight"])
    want["w0"] = w0
    (tmp / "x.f32").write_bytes(X.tobytes())
    (tmp / "y.f32").write_bytes(y.tobytes())

    def train_argv(prefix, n=X.size):
        return [train, prefix, str(tmp / "x.f32"), str(n),
                str(tmp / "y.f32"), str(y.size), str(TRAIN_STEPS),
                str(TRAIN_LR), "fc1_weight"]

    argv = {
        "predict": [predict, prefix, str(raw), str(x.size)],
        "predict_cpp": [predict_cpp, prefix, str(raw), str(x.size)],
        "threaded": [threaded, prefix, str(raw)],
        "train": train_argv(ttrain),
        "bad_prefix": [predict, str(tmp / "nope"), str(raw), str(x.size)],
        "unknown_input": [predict, xprefix, str(raw), str(x.size)],
        "wrong_size": [predict, prefix, str(raw), str(x.size - 1)],
        "jax_forward": [predict, jprefix, str(raw), str(x.size)],
        "jax_train": train_argv(jtrain),
    }
    poison = tmp / "poison"
    for name in ("jax", "mxnet_tpu"):
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(
            "raise ImportError('the C host imported %s')\n" % name)
    procs = {k: _start(v, str(poison), **(
        {"MXNET_CAPI_TIMING": "1"} if k == "predict" else {}))
        for k, v in argv.items()}
    return {k: _finish(p) for k, p in procs.items()}, want


@pytest.mark.parametrize("host", ["predict", "predict_cpp"])
def test_c_hosts_serve_the_port_as_jax_serves(runs, host):
    results, want = runs
    rc, out, err = results[host]
    assert rc == 0, "%s failed: %s" % (host, err[-2000:])
    lines = out.strip().splitlines()
    assert lines[0].startswith("output 0 shape")
    shape, printed, end = _printed(lines, 0)
    assert end == len(lines), "one output expected"
    assert shape == want["jax"].shape
    got = np.array([float(v) for v in printed]).reshape(shape)
    np.testing.assert_allclose(got, want["jax"], **TOL)
    assert printed == ["%.8g" % v for v in want["port"].ravel()]
    # MXNET_CAPI_TIMING=1 (set for predict.c only): one stderr line a call
    timed = [line.split()[1] for line in err.splitlines()
             if line.startswith("capi: ") and line.endswith(" ms")]
    assert timed == ([] if host == "predict_cpp" else [
        "MXTpuPredCreate", "MXTpuPredSetInput", "MXTpuPredForward",
        "MXTpuPredGetOutputShape", "MXTpuPredGetOutput",
        "MXTpuPredGetOutputShape"]), timed


def test_calls_from_a_second_host_thread(runs):
    """A host that runs the predictor on a thread other than the one that
    created it (and started the interpreter) gets the same output."""
    results, want = runs
    rc, out, err = results["threaded"]
    assert rc == 0, "threaded host failed: %s" % err[-2000:]
    assert out.split() == ["%.8g" % v for v in want["port"].ravel()]


def test_c_host_trains_the_port_as_jax_trains(runs):
    results, want = runs
    rc, out, err = results["train"]
    assert rc == 0, "train failed: %s" % err[-2000:]
    lines = out.strip().splitlines()
    oshape, oprinted, at = _printed(lines, 0)
    assert lines[at].startswith("param fc1_weight shape")
    pshape, pprinted, _ = _printed(lines, at)
    jout, jw = want["train_jax"]
    tout, tw = want["train_port"]
    assert oshape == jout.shape and pshape == jw.shape
    got_out = np.array([float(v) for v in oprinted]).reshape(oshape)
    got_w = np.array([float(v) for v in pprinted]).reshape(pshape)
    np.testing.assert_allclose(got_out, jout, **TOL)
    np.testing.assert_allclose(got_w, jw, **TOL)
    assert oprinted == ["%.6e" % v for v in tout.ravel()]
    assert pprinted == ["%.6e" % v for v in tw.ravel()]
    # the steps moved the weights (a no-op on both sides would agree too)
    assert np.abs(got_w - want["w0"]).max() > 1e-4


@pytest.mark.parametrize("case, where, message", [
    ("bad_prefix", "create", "no such file"),
    ("unknown_input", "set_input", "unknown input 'data'; model inputs: "
                                   "['x']"),
    ("wrong_size", "set_input", "input 'data': got 15 floats, shape "
                                "[2, 8] needs 16"),
    ("jax_forward", "create", "holds a forward exported by the JAX package"),
    ("jax_train", "create", "holds a training step exported by the JAX "
                            "package"),
])
def test_error_surface(runs, case, where, message):
    """Each error ends the host with rc 1 and MXTpuGetLastError's message
    after the host's ``<where>:``."""
    rc, out, err = runs[0][case]
    assert rc == 1, (case, rc, err[-2000:])
    assert out == ""
    line = err.strip().splitlines()[-1]
    assert line.startswith(where + ": "), line
    assert message.lower() in line.lower(), line


def test_build_is_cached_under_a_hashed_name():
    """The shim lives in build/native/ under a hashed name whose soname
    is that name, and never beside the sources."""
    so = _native.build_predict_shim()
    assert os.path.dirname(so) == str(_native.BUILD_DIR)
    name = os.path.basename(so)
    assert name.startswith("libpredict_shim-") and name.endswith(".so")
    assert _native.build_predict_shim() == so
    r = subprocess.run(["readelf", "-d", so], capture_output=True,
                       text=True, timeout=60)
    assert "Library soname: [%s]" % name in r.stdout
    assert not os.path.exists(os.path.join(_native._DIR,
                                           "libpredict_shim.so"))


def test_failed_build_raises_with_the_compiler_output(monkeypatch):
    """A failed build raises with the compiler's output; it does not
    return None for a caller to skip on."""
    monkeypatch.setattr(_native, "_SHIM", [])
    monkeypatch.setattr(_native, "python_link",
                        lambda: ["-I/nonexistent", "-lno_such_library_x"])
    with pytest.raises(RuntimeError, match="no_such_library_x"):
        _native.build_predict_shim()
