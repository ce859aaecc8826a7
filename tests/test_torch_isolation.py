"""The PyTorch port stands alone: it imports no jax and nothing of the JAX
package, its entry points refuse to fall back to the CPU silently, and
it pins float32 matmul precision as the JAX package does."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_port_and_chip_smoke_import_without_jax():
    """With jax made unimportable, every module of the port (and the
    chip smoke script) imports, the training slice's modules (parallel,
    initializer, random, registry) run one step, the training loop's
    (io, metric, lr_scheduler, callback, guardrail, resilience) one fit
    epoch with a masked step, optimizer one update, the eager surface's
    (autograd, the generated ndarray.op namespace, ops.init_ops) one
    recorded backward, the Executor one bind, the Module slice's
    (module/*, monitor, model, kvstore, recordio, the exported step and
    CompiledTrainStep) one Module fit epoch, a store push, a record and
    a compiled step, the generation slice's (generation, ops/ssm,
    ops/contrib_ops) a hybrid RoPE LM decoded through both loops and an
    int8 one (an SSM layer, the int8 ops), the serving stack's
    (serve/*, the wire, the compiled predictor) a ContinuousDecoder, a
    PrefillEngine, a ServeServer/ServeClient pair, a ServeRouter, a
    FleetController and a CompiledPredictor serving a request each, the
    distributed slice's (parallel/ps_async, the dist kvstore, a Module over
    two contexts, group2ctx, the profiler) a parameter server's host-side
    apply, a Module epoch and a profiled run, the Gluon slice's
    (``gluon`` and each of its submodules) a hybridized Dense + BatchNorm
    net's Trainer step, the RNN slice's (``rnn`` and its submodules,
    ``ops/rnn_op``, ``ops/ctc``) a bucketed fused-LSTM epoch, an rnn
    checkpoint round trip, the plain RNN loop and a gluon CTCLoss, the
    image slice's (``image`` and ``_native``) an ImageRecordIter and an
    ImageDetRecordIter batch over packed JPEGs with none of the JAX
    package's native libraries mapped, and no jax or mxnet_tpu module
    loads."""
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now fails
import mxnet_tpu_torch
for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__, "mxnet_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
# the training slice's modules, used: one step of a tiny LM on the CPU
import numpy as np
from mxnet_tpu_torch import initializer, random, registry
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.parallel import make_train_step
assert registry.get_registry(initializer.Initializer)["xavier"]
random.seed(0)
step = make_train_step(transformer.get_symbol(10, 4, num_layers=1,
                       num_heads=2, dim=8), optimizer="adam",
                       ctx=mxnet_tpu_torch.cpu())
state = step.init_state(initializer.Xavier(), {"data": (2, 4),
                        "softmax_label": (2, 4)})
toks = np.arange(8, dtype=np.float32).reshape(2, 4)
state, outs = step(state, {"data": toks, "softmax_label": toks}, 0.01, 0)
assert outs[0].shape == (8, 10)
# the training loop's modules, used: fit over io, metric, lr_scheduler,
# the guardrail and a nan@1 fault, then the optimizer through an Updater
from mxnet_tpu_torch import (callback, guardrail, io, lr_scheduler, metric,
                             optimizer)
from mxnet_tpu_torch.parallel import resilience
resilience.install_fault_injector(resilience.FaultInjector("nan@1"))
with mxnet_tpu_torch.cpu():
    it = io.NDArrayIter(np.concatenate([toks, toks]),
                        np.concatenate([toks, toks]), batch_size=2)
state, ppl = step.fit(it, num_epoch=1, state=state,
                      lr_scheduler=lr_scheduler.FactorScheduler(1, 0.5),
                      eval_metric=metric.Perplexity(ignore_label=None),
                      batch_end_callback=callback.log_train_metric(1))
assert step.guard_report["masked_steps"] == 1 and ppl > 0
resilience.install_fault_injector(None)
up = optimizer.get_updater(optimizer.create("adam"))
with mxnet_tpu_torch.cpu():
    w = mxnet_tpu_torch.nd.ones((3,))
    up(0, mxnet_tpu_torch.nd.ones((3,)), w)
assert w.asnumpy()[0] < 1 and guardrail.EXIT_PREEMPTED == 83
# the eager surface's modules, used: autograd over nd ops, an init op
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.ndarray import op as nd_op
from mxnet_tpu_torch.ops import init_ops
with mxnet_tpu_torch.cpu():
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    with autograd.record():
        y = (nd_op.exp(x) * nd._ones(shape=(2,))).sum()
    y.backward()
    assert x.grad.asnumpy().tolist() == nd.exp(x).asnumpy().tolist()
    assert init_ops._eye(N=2, device="cpu").shape == (2, 2)
    sym = transformer.get_symbol(10, 4, num_layers=1, num_heads=2, dim=8)
    exe = sym.simple_bind(ctx=mxnet_tpu_torch.cpu(), data=(2, 4),
                          softmax_label=(2, 4))
    exe.forward(is_train=True)
    exe.backward()
# the Module slice, used: a Module fit epoch with a Monitor and a
# module_checkpoint, a KVStore with the optimizer on the store, a record
# file written and read, and an exported step run by CompiledTrainStep
import os, tempfile
from mxnet_tpu_torch import kvstore, monitor, recordio
from mxnet_tpu_torch.parallel.trainer import CompiledTrainStep
tmp = tempfile.mkdtemp()
with mxnet_tpu_torch.cpu():
    net = mxnet_tpu_torch.sym.SoftmaxOutput(mxnet_tpu_torch.sym.FullyConnected(
        mxnet_tpu_torch.sym.Variable("data"), num_hidden=2, name="fc"),
        name="softmax")
    x = np.arange(16, dtype=np.float32).reshape(8, 2) / 16
    it = io.NDArrayIter(x, (x[:, 0] > 0.5).astype(np.float32), batch_size=4)
    mod = mxnet_tpu_torch.mod.Module(net, context=mxnet_tpu_torch.cpu())
    mon = monitor.Monitor(1)
    mod.fit(it, num_epoch=1, monitor=mon,
            epoch_end_callback=callback.module_checkpoint(
                mod, os.path.join(tmp, "m")))
    assert os.path.exists(os.path.join(tmp, "m-0001.params"))
    kv = kvstore.create("local")
    kv.set_optimizer(optimizer.create("sgd", learning_rate=0.5))
    kv.init(0, nd.ones((2,)))
    kv.push(0, [nd.ones((2,)), nd.ones((2,))])
    out = nd.zeros((2,))
    kv.pull(0, out=out)
    assert out.asnumpy().tolist() == [0.0, 0.0]
    rec = recordio.MXRecordIO(os.path.join(tmp, "r.rec"), "w")
    rec.write(recordio.pack((0, 1.0, 0, 0), b"abc"))
    rec.close()
    rec = recordio.MXRecordIO(os.path.join(tmp, "r.rec"), "r")
    assert recordio.unpack(rec.read())[1] == b"abc"
    tstep = make_train_step(net, optimizer="sgd", ctx=mxnet_tpu_torch.cpu())
    st = tstep.init_state(initializer.Xavier(), {"data": (4, 2),
                                                 "softmax_label": (4,)})
    b = {"data": x[:4], "softmax_label": np.zeros(4, np.float32)}
    tstep.export(os.path.join(tmp, "s"), st, b)
    ct = CompiledTrainStep.load(os.path.join(tmp, "s"))
    assert ct.step(b, 0.1)[0].shape == (4, 2)
# the generation slice, used: a hybrid (attention, ssm) RoPE LM decoded by
# Generator through both loops, and an int8-weight, int8-cache Generator
from mxnet_tpu_torch import generation
hyb = dict(block_type=("attention", "ssm"), pos_encoding="rope")
tstep = make_train_step(transformer.get_symbol(10, 4, num_layers=2,
                        num_heads=2, dim=8, **hyb), optimizer="sgd",
                        ctx=mxnet_tpu_torch.cpu())
params = tstep.init_state(initializer.Xavier(), {"data": (2, 4),
                          "softmax_label": (2, 4)})[0]
gen = generation.Generator(params, 10, 8, num_layers=2, num_heads=2, dim=8,
                           batch_size=2, ctx=mxnet_tpu_torch.cpu(), **hyb)
prompt = np.array([[1, 2, 3], [4, 5, 6]])
assert (gen.generate_on_device(prompt, 4) == gen.generate(prompt, 4)).all()
q8 = generation.Generator(params, 10, 8, num_layers=2, num_heads=2, dim=8,
                          batch_size=2, ctx=mxnet_tpu_torch.cpu(),
                          quantize="int8", quantize_kv=True, **hyb)
assert q8.generate(prompt, 3).shape == (2, 6)
# the serving stack, used: a ContinuousDecoder and a PrefillEngine behind
# ServeServers, a ServeClient, a ServeRouter (a disaggregated generate), a
# FleetController's tick, and a CompiledPredictor served by from_export
from mxnet_tpu_torch.serve import (ContinuousDecoder, FleetController,
                                   PrefillEngine, ServeClient, ServeEngine,
                                   ServeRouter, ServeServer)
from mxnet_tpu_torch.predictor import CompiledPredictor
pool = generation.Generator(params, 10, 8, num_layers=2, num_heads=2, dim=8,
                            batch_size=2, ctx=mxnet_tpu_torch.cpu(), **hyb)
one = generation.Generator(params, 10, 8, num_layers=2, num_heads=2, dim=8,
                           batch_size=1, ctx=mxnet_tpu_torch.cpu(), **hyb)
want = one.generate(prompt[:1], 3)[0].tolist()
dec, pre = ContinuousDecoder(pool), PrefillEngine(one)
assert dec.submit(prompt[0], 3).result(60).tolist() == want
dsrv, psrv = ServeServer(dec), ServeServer(pre)
cli = ServeClient(dsrv.host, dsrv.port)
assert cli.generate(prompt[0], 3).tolist() == want
router = ServeRouter(poll_ms=0)
router.add_replica(psrv.host, psrv.port, name="p")
router.add_replica(dsrv.host, dsrv.port, name="d")
router.poll_now()
assert router.generate(prompt[0], 3).tolist() == want
ctrl = FleetController(router, lambda m=None: (dsrv.host, dsrv.port),
                       poll_ms=0, sustain=99)
assert ctrl.tick()["healed"] == []
ctrl.close(); router.close(); cli.close()
dsrv.close(); psrv.close(); dec.close(); pre.close()
with mxnet_tpu_torch.cpu():
    pred = mxnet_tpu_torch.Predictor(net, {"fc_weight": np.ones((2, 2),
        np.float32), "fc_bias": np.zeros(2, np.float32)})
    pred.export_buckets(os.path.join(tmp, "e"), [(2,)], buckets=(1, 2))
    eng = ServeEngine.from_export(os.path.join(tmp, "e"),
                                  install_sigterm=False)
    assert eng.infer(x[:1], timeout=60)[0].shape == (1, 2)
    eng.close()
    assert CompiledPredictor.load(os.path.join(tmp, "e.b1")).forward(
        x[:1])[0].shape == (1, 2)
# the distributed slice, used: a parameter server in a thread applying a
# push on the host, a dist store outside a group, a Module over two
# contexts, group2ctx, and the profiler with a device trace and its dump
import threading
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.parallel import ps_async
srv = ps_async.AsyncPSServer(port=0, num_workers=1)
threading.Thread(target=srv.serve_forever, daemon=True).start()
pc = ps_async.AsyncPSClient("127.0.0.1", srv.port)
pc.set_optimizer(optimizer.SGD(learning_rate=0.5))
pc.init("w", np.ones((2,), np.float32))
pc.push("w", np.ones((2,), np.float32))
assert pc.pull("w").tolist() == [0.5, 0.5]
pc.close(); srv.stop()
profiler.profiler_set_config(mode="all", filename=os.path.join(tmp, "p.json"),
                             xplane_dir=os.path.join(tmp, "x"))
profiler.profiler_set_state("run")
with mxnet_tpu_torch.cpu():
    dkv = kvstore.create("dist_sync")
    dkv.init(0, nd.ones((2,)))
    mod = mxnet_tpu_torch.mod.Module(net, context=[mxnet_tpu_torch.cpu(0),
                                                   mxnet_tpu_torch.cpu(1)])
    mod.fit(it, num_epoch=1, kvstore="device")
    exe = net.simple_bind(mxnet_tpu_torch.cpu(), data=(4, 2),
                          group2ctx={"dev1": mxnet_tpu_torch.cpu(1)})
    exe.forward()
profiler.profiler_set_state("stop")
assert os.listdir(os.path.join(tmp, "x")) and os.path.exists(
    profiler.dump_profile())
# the Gluon slice, used: every gluon submodule imported, and a hybridized
# Dense + BatchNorm net's Trainer step on the CPU
from mxnet_tpu_torch import gluon
for sub in ("block", "parameter", "trainer", "loss", "utils", "nn",
            "nn.basic_layers", "nn.conv_layers", "data", "data.dataset",
            "data.sampler", "data.dataloader", "data.vision", "rnn",
            "rnn.rnn_cell", "rnn.rnn_layer", "model_zoo",
            "model_zoo.vision", "model_zoo.model_store"):
    importlib.import_module("mxnet_tpu_torch.gluon." + sub)
with mxnet_tpu_torch.cpu():
    gnet = gluon.nn.HybridSequential()
    gnet.add(gluon.nn.Dense(4), gluon.nn.BatchNorm(), gluon.nn.Dense(2))
    gnet.initialize(ctx=mxnet_tpu_torch.cpu())
    gnet.hybridize()
    gtr = gluon.Trainer(gnet.collect_params(), "sgd", {"learning_rate": 0.1})
    gx = nd.array(np.arange(12, dtype=np.float32).reshape(4, 3))
    with autograd.record():
        gl = gluon.loss.SoftmaxCrossEntropyLoss()(gnet(gx), nd.zeros((4,)))
    gl.backward()
    w0 = gnet[0].weight.data().asnumpy()
    gtr.step(4)
    assert (gnet[0].weight.data().asnumpy() != w0).any()
# the RNN slice, used: a fused 2-layer LSTM LM (FusedRNN-initialized)
# trained one epoch through BucketingModule over BucketSentenceIter, its
# weights through save_rnn_checkpoint / load_rnn_checkpoint, the plain
# RNN loop, and CTCLoss under gluon
from mxnet_tpu_torch import rnn
from mxnet_tpu_torch.ops import ctc, rnn_op
def lm_gen(seq_len):
    emb = mxnet_tpu_torch.sym.Embedding(mxnet_tpu_torch.sym.Variable("data"),
                                        input_dim=8, output_dim=4, name="e")
    cell = rnn.FusedRNNCell(4, num_layers=2, dropout=0.2, prefix="lstm_")
    out, _ = cell.unroll(seq_len, emb, merge_outputs=True)
    pred = mxnet_tpu_torch.sym.FullyConnected(mxnet_tpu_torch.sym.Reshape(
        out, shape=(-1, 4)), num_hidden=8, name="pred")
    lab = mxnet_tpu_torch.sym.Reshape(mxnet_tpu_torch.sym.Variable(
        "softmax_label"), shape=(-1,))
    return (mxnet_tpu_torch.sym.SoftmaxOutput(pred, lab, name="softmax"),
            ("data",), ("softmax_label",))
with mxnet_tpu_torch.cpu():
    sit = rnn.BucketSentenceIter([[1, 2, 3], [4, 5], [6, 7, 1, 2]] * 4,
                                 batch_size=2, buckets=[3, 5],
                                 invalid_label=0)
    bmod = mxnet_tpu_torch.mod.BucketingModule(lm_gen, 5,
                                               context=mxnet_tpu_torch.cpu())
    bmod.fit(sit, num_epoch=1, optimizer="sgd")
    lcell = rnn.FusedRNNCell(4, num_layers=2, prefix="lstm_")
    bargs = bmod.get_params()[0]
    rnn.save_rnn_checkpoint(lcell, os.path.join(tmp, "r"), 1, lm_gen(5)[0],
                            bargs, {})
    assert "arg:lstm_l1_h2h_o_weight" in nd.load(os.path.join(
        tmp, "r-0001.params"))
    _, rargs, _ = rnn.load_rnn_checkpoint(lcell, os.path.join(tmp, "r"), 1)
    assert (rargs["lstm_parameters"].asnumpy() ==
            bargs["lstm_parameters"].asnumpy()).all()
    import torch
    ref = rnn_op._rnn_reference(torch.zeros(3, 2, 4),
                                bargs["lstm_parameters"].handle,
                                torch.zeros(2, 1, 4), torch.zeros(2, 1, 4),
                                state_size=4, num_layers=2)
    assert ref.shape == (3, 2, 4)
    cl = gluon.loss.CTCLoss()(nd.array(np.zeros((2, 5, 4), np.float32)),
                              nd.array([[1, 2], [3, 0]]))
    assert cl.shape == (2,) and bool(np.isfinite(cl.asnumpy()).all())
# the image slice, used: seeded JPEGs packed, read through the native
# reader and ImageRecordIter (the native decoder where it builds) and
# ImageDetRecordIter; the libraries loaded are the port's own builds
from mxnet_tpu_torch import _native, image
iw = recordio.MXIndexedRecordIO(os.path.join(tmp, "i.idx"),
                                os.path.join(tmp, "i.rec"), "w")
for i in range(4):
    iw.write_idx(i, recordio.pack_img((0, [2, 5, 1, .1, .1, .5, .5], i, 0),
                                      np.full((40, 44, 3), 9 * i, np.uint8)))
iw.close()
with mxnet_tpu_torch.cpu():
    ib = next(iter(io.ImageRecordIter(path_imgrec=os.path.join(tmp, "i.rec"),
                                      data_shape=(3, 32, 32), batch_size=4,
                                      rand_crop=True, label_width=7)))
    assert ib.data[0].shape == (4, 3, 32, 32)
    db = io.ImageDetRecordIter(path_imgrec=os.path.join(tmp, "i.rec"),
                               data_shape=(3, 32, 32), batch_size=2).next()
    assert db.label[0].shape == (2, 16, 5)
with open("/proc/self/maps") as f:
    libs = sorted({l.split()[-1] for l in f if "_native" in l or
                   "build/native" in l})
assert not [l for l in libs if "mxnet_tpu/_native" in l], libs
assert image.native_decode.available() == (_native.load("imgdecode")
                                           is not None)
bad = sorted(n for n, m in sys.modules.items() if m is not None and (
    n == "jax" or n.startswith("jax.") or n.startswith("jaxlib")
    or n == "mxnet_tpu" or n.startswith("mxnet_tpu.")))
print("BAD", bad)
print("N", len([n for n in sys.modules if n.startswith("mxnet_tpu_torch")]))
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    n = int(r.stdout.split("N ")[1].split()[0])
    assert n >= 30, r.stdout


def test_c_abi_glue_imports_neither_jax_nor_mxnet_tpu():
    """The Python glue that the C ABI's shim runs in its embedded
    interpreter names only the port."""
    import re
    with open(os.path.join(REPO, "mxnet_tpu_torch", "_native",
                           "predict_shim.cc")) as f:
        src = f.read()
    glue = src[src.index('kGlue = R"PY('):src.index(')PY";')]
    assert "CompiledPredictor.load" in glue
    assert "CompiledTrainStep.load" in glue
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", glue, re.M)
    assert imports and all(m == "numpy" or m.startswith("mxnet_tpu_torch")
                           for m in imports), imports
    assert not re.search(r"\bjax\b|\bmxnet_tpu\b(?!_torch)", glue)


def test_item_10_6_modules_run_without_jax():
    """With jax made unimportable: mx.rtc runs a source, mx.viz prints a
    summary, contrib.tensorboard writes an event file, test_utils'
    check_speed, discard_stderr and rand_sparse_ndarray run, nd.imresize
    resizes, and the base and context names resolve; no jax or
    mxnet_tpu module loads."""
    code = """
import os, sys, tempfile
sys.modules["jax"] = None
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import base, context, test_utils
from mxnet_tpu_torch.contrib.tensorboard import SummaryWriter
with mx.cpu():
    out = mx.nd.zeros((3,))
    mx.rtc.Rtc("f", ["x"], ["y"], "def f(x):\\n    return torch.exp(x)").push(
        [mx.nd.zeros((3,))], [out])
    assert out.asnumpy().tolist() == [1.0, 1.0, 1.0]
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                name="fc")
    with test_utils.discard_stderr():
        assert mx.viz.print_summary(net, shape={"data": (2, 3)}) == 16
    assert mx.visualization is mx.viz
    assert test_utils.check_speed(net, location={
        "data": np.ones((2, 3), np.float32),
        "fc_weight": np.ones((4, 3), np.float32),
        "fc_bias": np.ones(4, np.float32)}, N=2) > 0
    arr, parts = test_utils.rand_sparse_ndarray((4, 3), "csr")
    assert arr.stype == "csr" and len(parts) == 3
    img = mx.nd.imresize(mx.nd.ones((8, 6, 3)), 3, 4)
    assert img.shape == (4, 3, 3)
with tempfile.TemporaryDirectory() as d:
    with SummaryWriter(d) as w:
        w.add_scalar("loss", 0.5, 1)
    assert os.path.getsize(w.path) > 0
assert base.DTYPE_NP_TO_MX["bfloat16"] == 12 and base.check_name("a_b")
assert context.num_gpus() == 0 and base.env_flag("MXNET_NOT_SET") is False
bad = sorted(n for n, m in sys.modules.items() if m is not None and (
    n == "jax" or n.startswith("jax.") or n.startswith("jaxlib")
    or n == "mxnet_tpu" or n.startswith("mxnet_tpu.")))
print("BAD", bad)
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_parameter_server_interpreter_imports_neither_jax_nor_mxnet_tpu(
        tmp_path):
    """The server role's re-exec'd interpreter (DMLC_ROLE=server,
    MXNET_KVSTORE_TYPE=dist_async) serves a worker's init, optimizer,
    push and pull, and exits when the worker leaves, with ``jax`` and
    ``mxnet_tpu`` made unimportable on its path."""
    import socket
    import numpy as np
    from mxnet_tpu_torch.parallel.ps_async import AsyncPSClient
    poison = tmp_path / "poison"
    for name in ("jax", "mxnet_tpu"):
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(
            "raise ImportError('the parameter server imported %s')\n"
            % name)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(poison), REPO]),
               DMLC_ROLE="server", MXNET_KVSTORE_TYPE="dist_async",
               DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port),
               DMLC_NUM_WORKER="1", MXNET_PS_LINGER="0.2")
    server = subprocess.Popen(
        [sys.executable, "-c", "import mxnet_tpu_torch\n"
         "raise SystemExit('the server role returned')"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        c = AsyncPSClient("127.0.0.1", port)
        c.set_optimizer(tmx.optimizer.SGD(learning_rate=0.5))
        c.init("w", np.ones((3,), np.float32))
        c.push("w", np.ones((3,), np.float32))
        assert c.pull("w").tolist() == [0.5] * 3
        c.close()
        out, _ = server.communicate(timeout=60)
        assert server.returncode == 0, out[-3000:]
    finally:
        if server.poll() is None:
            server.kill()


def test_predictor_without_cuda_and_without_cpu_ctx_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default context is usable")
    sym = transformer.get_symbol(10, 4, num_layers=1, num_heads=2, dim=8)
    with pytest.raises(tmx.MXNetError, match="ctx=mx.cpu"):
        tmx.Predictor(sym, {}, data_names=("data", "softmax_label"))
    with pytest.raises(tmx.MXNetError, match="CUDA"):
        tmx.nd.array([1.0, 2.0])


def test_default_context_is_gpu0_and_cpu_scope_overrides():
    assert tmx.current_context() == tmx.gpu(0)
    assert tmx.tpu(1) == tmx.gpu(1)
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()
        a = tmx.nd.array([1.0, 2.0])
        assert a.context == tmx.cpu() and a.handle.device.type == "cpu"
    assert tmx.current_context() == tmx.gpu(0)
    assert tmx.cpu().torch_device() == torch.device("cpu")


def test_matmul_precision_defaults_to_full_f32():
    """Importing the port turns TF32 off for cuBLAS AND cuDNN (PyTorch
    leaves cuDNN's on), as MXNET_MATMUL_PRECISION=highest asks."""
    env = dict(os.environ)
    env.pop("MXNET_MATMUL_PRECISION", None)
    r = subprocess.run(
        [sys.executable, "-c", "import torch, mxnet_tpu_torch; print("
         "torch.backends.cuda.matmul.allow_tf32, "
         "torch.backends.cudnn.allow_tf32, "
         "torch.get_float32_matmul_precision())"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "False", "highest"]


@pytest.mark.parametrize("prec,tf32", [("highest", False), ("high", True)])
def test_matmul_precision_knob(prec, tf32):
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    try:
        tmx._set_matmul_precision(prec)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
        assert torch.get_float32_matmul_precision() == prec
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    with pytest.raises(ValueError, match="MXNET_MATMUL_PRECISION"):
        tmx._set_matmul_precision("tf32")


def test_chip_smoke_alone_fails_without_printing_a_result(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    (or on a machine without CUDA) the script exits non-zero before any
    result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
    assert "FAIL" in r.stderr
