"""The port's GSPMD layouts (``SpecLayout``, the ``data``, ``fsdp``,
``tp`` and ``model`` axes), its batch-global routes under the replica
axes and ``Generator(mesh=)``, over gloo CPU ranks, held against the JAX
package on its virtual 8-device CPU mesh (``tests/conftest.py``).

A module fixture launches ONE group of four ranks, each a process of
this file (``python tests/test_torch_gspmd.py RANK 4 PORT DIR``) with
``torch.set_num_threads(1)``, a TCP store on 127.0.0.1, backend gloo and
a time limit on the launch and on every collective. Every rank runs
every case on the same numpy inputs (the fixture writes the JAX
``init_state`` of each training case) and writes its results to the
fixture's directory; the tests compute the JAX side (the JAX package's
GSPMD step, fit, Module and Generator on meshes of 4 of its 8 virtual
devices, or its one-device step where the JAX mesh program is the same
global computation) and compare. The cases mirror ``tests/test_gspmd.py``
(the fit epoch, the 1/N optimizer state, the batch over data × fsdp,
the sync budget, the checkpoint across layouts, ``Module(layout=)``,
the gauges, the knob off), ``docs/parallelism.md``'s ``fsdp × tp`` rules,
``tests/test_generation.py``'s ``TestMeshDecode`` and the BatchNorm and
graph reductions of the whole batch (ROADMAP Queue C 17); the
one-process tests mirror ``tests/test_gspmd.py``'s validation, rule and
``describe()`` tests.

Tolerances: parameters after steps rtol 2e-4 / atol 1e-5 (the JAX
package's own, ``tests/test_gspmd.py``); outputs rtol 1e-5 / atol 1e-6;
tokens equal.
"""
import os
import socket
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch

OUT = dict(rtol=1e-5, atol=1e-6)
PARAMS = dict(rtol=2e-4, atol=1e-5)
LAUNCH_TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 120
WORLD = 4

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the small LM of the fsdp x tp case and the Generator case
LM = dict(vocab=64, T=16, B=4, heads=2, dim=32)
GEN = dict(vocab=48, T=24, layers=2, heads=4, dim=32, B=2)
# docs/parallelism.md's rules over fsdp x tp
TP_RULES = (("tok_embed_weight", (("fsdp", "tp"), None)),
            ("*_qkv_weight", "tp,None"), ("*_proj_weight", "tp,None"),
            ("*_fc1_weight", "tp,None"), ("*_fc2_weight", "tp,None"),
            ("*_bias", ()))
BN_X = (8, 4, 6, 6)


# ---------------------------------------------------------------------------
# inputs, made from numpy seeds (the fixture and the ranks read the same)
# ---------------------------------------------------------------------------

def _toy(n=64, d=16, classes=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.float32)
    return X, y


def _separable(n=96, d=16, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    return X, (X @ rng.standard_normal(d) > 0).astype(np.float32)


def _lm_batch(seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, LM["vocab"], (LM["B"], LM["T"])).astype(
        np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"data": toks, "softmax_label": labels}


def _bn_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"data": (rng.randn(*BN_X) * 1.5 + 0.3).astype(np.float32),
            "softmax_label": rng.randint(0, 5, BN_X[0]).astype(np.float32)}


def _mlp(mx, classes=8):
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, name="fc1", num_hidden=32)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=classes)
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _bn_net(mx):
    net = mx.sym.Convolution(mx.sym.Variable("data"), name="conv",
                             num_filter=8, kernel=(3, 3), pad=(1, 1))
    net = mx.sym.BatchNorm(net, name="bn", fix_gamma=False)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = mx.sym.FullyConnected(net, name="fc", num_hidden=5)
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _reduce_net(mx):
    """Batch reductions written into the graph: each row centred by the
    batch mean (``mean`` over axis 0) and shifted by the batch max."""
    h = mx.sym.FullyConnected(mx.sym.Variable("data"), name="fc1",
                              num_hidden=16)
    c = mx.sym.broadcast_sub(h, mx.sym.mean(h, axis=0, keepdims=True))
    m = mx.sym.max(h, axis=0, keepdims=True)
    h = mx.sym.Activation(mx.sym.broadcast_add(c, 0.5 * m), act_type="tanh")
    h = mx.sym.FullyConnected(h, name="fc2", num_hidden=8)
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _lm_sym(transformer):
    return transformer.get_symbol(LM["vocab"], LM["T"], num_layers=1,
                                  num_heads=LM["heads"], dim=LM["dim"])


# training cases: name -> (symbol builder, optimizer, params, lr, steps,
# batch)
TRAIN = {
    "mlp": (lambda mx, tr: _mlp(mx), "adam", {"rescale_grad": 1.0 / 32},
            0.05, 3, lambda: dict(zip(("data", "softmax_label"), _toy()))),
    "tp_fsdp": (lambda mx, tr: _lm_sym(tr), "sgd", {"momentum": 0.9}, 0.5,
                2, _lm_batch),
    "bn": (lambda mx, tr: _bn_net(mx), "sgd", {"momentum": 0.9}, 0.1, 2,
           _bn_batch),
    "reduce": (lambda mx, tr: _reduce_net(mx), "sgd", {"momentum": 0.9},
               0.5, 3, lambda: dict(zip(("data", "softmax_label"),
                                        _toy()))),
    "module": (lambda mx, tr: _mlp(mx, classes=2), "sgd", {}, 0.5, 0,
               lambda: dict(zip(("data", "softmax_label"), _separable()))),
}

# graphs of one batch-mixing op each, refused under the replica axes
REFUSED = {
    "slice_axis": lambda s: s.slice_axis(s.Variable("data"), axis=0,
                                         begin=0, end=2),
    "take": lambda s: s.take(s.Variable("data"), s.Variable("idx")),
    "pick": lambda s: s.pick(s.Variable("data"), s.Variable("idx"),
                             axis=0),
    "reshape": lambda s: s.reshape(s.Variable("data"), shape=(4, -1)),
    "transpose": lambda s: s.transpose(s.Variable("data")),
    "dot": lambda s: s.dot(s.Variable("data"), s.Variable("data"),
                           transpose_a=True),
    "batch_dot": lambda s: s.batch_dot(
        s.reshape(s.Variable("data"), shape=(0, -1)),
        s.reshape(s.Variable("data"), shape=(0, -1)), transpose_b=True),
    "softmax": lambda s: s.softmax(s.Variable("data"), axis=0),
    "sort": lambda s: s.sort(s.Variable("data"), axis=0),
    "topk": lambda s: s.topk(s.Variable("data"), axis=0, k=2),
}


# ---------------------------------------------------------------------------
# the rank side: imports torch and the port only
# ---------------------------------------------------------------------------

def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _load(inputs_dir, name):
    blob = np.load(os.path.join(inputs_dir, name + ".npz"))
    params = {k[2:]: blob[k] for k in blob.files if k.startswith("p:")}
    aux = {k[2:]: blob[k] for k in blob.files if k.startswith("a:")}
    return params, aux


def _rank_cases():
    """name -> fn(inputs_dir) -> {key: array}, run in order on every
    rank."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config, io, profiler, telemetry
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.executor import _graph_eval_fn
    from mxnet_tpu_torch.generation import Generator
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import (P, SpecLayout, dist, make_mesh,
                                          make_train_step)
    from mxnet_tpu_torch.parallel import sharding as shd
    from mxnet_tpu_torch.parallel.trainer import CompiledTrainStep

    def layout(sizes, **kw):
        kw.setdefault("min_shard_size", 0)     # toy tensors are tiny
        return SpecLayout(make_mesh(sizes), **kw)

    def step_for(name, **kw):
        build, opt, opt_params, _, _, _ = TRAIN[name]
        return make_train_step(build(mx, transformer), optimizer=opt,
                               optimizer_params=opt_params, **kw)

    def init(step, name, inputs_dir):
        params, aux = _load(inputs_dir, name)
        batch = TRAIN[name][5]()
        return step.init_state(None, {k: v.shape for k, v in batch.items()},
                               arg_params=params, aux_params=aux), batch

    def run(name, inputs_dir, **kw):
        _, _, _, lr, n, _ = TRAIN[name]
        with mx.cpu():
            step = step_for(name, **kw)
            state, batch = init(step, name, inputs_dir)
            placed = step.place_batch(batch)
            for _ in range(n):
                state, outs = step(state, placed, lr, 0)
            full = step._global_state(state)
        out = {"p:" + k: _np(v) for k, v in full[0].items()}
        out.update({"a:" + k: _np(v) for k, v in full[2].items()})
        out["out0"] = _np(outs[0])
        return step, state, out

    def fit_zero1(inputs_dir):
        """test_gspmd's fit: 3 epochs of Adam on data x fsdp with zero1,
        then one more epoch counting the blocking host syncs."""
        X, y = _toy()
        with mx.cpu():
            step = step_for("mlp", layout=layout({"data": 2, "fsdp": 2}),
                            optimizer_sharding="zero1")
            state, _ = init(step, "mlp", inputs_dir)
            train = io.NDArrayIter(X, y, batch_size=32)
            state, _ = step.fit(train, num_epoch=3, state=state, lr=0.05,
                                seed=3)
            full = step._global_state(state)
            base = profiler.host_sync_count()
            step.fit(train, num_epoch=1, state=state, lr=0.05)
            syncs = profiler.host_sync_count() - base
        out = {"p:" + k: _np(v) for k, v in full[0].items()}
        out["syncs"] = np.array(syncs)
        return out

    def opt_state(inputs_dir):
        """The 1/N optimizer state across steps, params in their layout,
        the batch's rows over data x fsdp, the gauges."""
        mesh_sizes = {"data": 2, "fsdp": 2}
        step, state, out = run("mlp", inputs_dir,
                               layout=layout(mesh_sizes),
                               optimizer_sharding="zero1")
        mesh = step.mesh
        ok = True
        for n, states in state[1].items():
            for s in states:
                ok &= s.numel() * 4 == int(np.prod(step._global_shape[n]))
        for n, v in state[0].items():
            parts, _ = step._layout.spec_for(n, step._global_shape[n])
            ok &= tuple(v.shape) == shd.local_shape(
                step._global_shape[n], parts, mesh)
        X, _ = _toy()
        idx = mesh.axis_index("data") * 2 + mesh.axis_index("fsdp")
        placed = step.place_batch(dict(zip(("data", "softmax_label"),
                                           _toy())))
        out["one_nth"] = np.array(ok)
        out["rows"] = np.array(np.array_equal(
            placed["data"].numpy(), X[idx * 16:(idx + 1) * 16]))
        out["sharded_params"] = np.array(
            telemetry.gauge("gspmd.sharded_params").value)
        out["opt_bytes"] = np.array(
            telemetry.gauge("gspmd.opt_state_bytes_per_dev").value)
        out["opt_bytes_want"] = np.array(sum(
            s.numel() * s.element_size() for ss in state[1].values()
            for s in ss))
        out["describe"] = np.array(step.describe_layout())
        return out

    def checkpoint(inputs_dir):
        """A checkpoint of the data x fsdp zero1 step restores onto the
        same layout, onto a data=4 layout and onto one device."""
        prefix = os.path.join(inputs_dir, "ck")
        batch = dict(zip(("data", "softmax_label"), _toy()))
        out = {}
        with mx.cpu():
            g = step_for("mlp", layout=layout({"data": 2, "fsdp": 2}),
                         optimizer_sharding="zero1")
            state, _ = init(g, "mlp", inputs_dir)
            placed = g.place_batch(batch)
            for _ in range(2):
                state, _ = g(state, placed, 0.05, 0)
            g.save_state(prefix, state)
            ref, outs = g(g.load_state(prefix), placed, 0.05, 0)
            out["ref"] = _np(outs[0])
            out["ref_p"] = _np(g._global_state(ref)[0]["fc1_weight"])
            other = step_for("mlp", layout=layout({"data": 4}),
                             optimizer_sharding="zero1")
            st, outs = other(other.load_state(prefix),
                             other.place_batch(batch), 0.05, 0)
            out["data4"] = _np(outs[0])
            out["data4_p"] = _np(other._global_state(st)[0]["fc1_weight"])
            single = step_for("mlp")
            st, outs = single(single.load_state(prefix), batch, 0.05, 0)
            out["single"] = _np(outs[0])
            out["single_p"] = _np(st[0]["fc1_weight"])
        return out

    def module(inputs_dir):
        """Module(layout=) on data x fsdp: 3 epochs of SGD momentum from
        the JAX init, the fc1 weight held sharded, the accuracy; a batch
        that does not divide the shards raises."""
        params, _ = _load(inputs_dir, "module")
        X, y = _separable()
        lay = layout({"data": 2, "fsdp": 2})
        with mx.cpu():
            mod = mx.mod.Module(_mlp(mx, classes=2), context=mx.cpu(),
                                layout=lay)
            train = io.NDArrayIter(X, y, batch_size=32)
            mod.fit(train, num_epoch=3, optimizer="sgd",
                    arg_params={k: mx.nd.array(v) for k, v in params.items()},
                    optimizer_params={"learning_rate": 0.5,
                                      "momentum": 0.9})
            w = mod._exec_group.execs[0].arg_dict["fc1_weight"]
            arg, _ = mod.get_params()
            acc = dict(mod.score(train, "acc"))["accuracy"]
            msg = ""
            bad = mx.mod.Module(_mlp(mx, classes=2), context=mx.cpu(),
                                layout=lay)
            try:
                bad.bind([("data", (30, 16))], [("softmax_label", (30,))])
            except MXNetError as e:
                msg = str(e)
        out = {"p:" + k: v.asnumpy() for k, v in arg.items()}
        out.update({"w_local": np.array(w.shape), "acc": np.array(acc),
                    "divisible": np.array(msg)})
        return out

    def knob_off(inputs_dir):
        lay = layout({"data": 2, "fsdp": 2}, constrain_activations=False)
        _, _, out = run("mlp", inputs_dir, layout=lay,
                        optimizer_sharding="zero1")
        return {"act_parts_none": np.array(lay.act_parts(2) is None),
                "knob": np.array(config.get("MXNET_GSPMD_CONSTRAIN_ACTS")),
                "finite": np.array(np.isfinite(out["out0"]).all())}

    def tp_fsdp(inputs_dir):
        """The small LM over fsdp x tp with docs/parallelism.md's rules:
        tok_embed over (fsdp, tp), the projections column-parallel."""
        lay = layout({"fsdp": 2, "tp": 2}, rules=[
            (p, P(*s) if isinstance(s, tuple) else s) for p, s in TP_RULES])
        step, state, out = run("tp_fsdp", inputs_dir, layout=lay,
                               optimizer_sharding="zero1")
        out.update({"local:" + k: np.array(v.shape)
                    for k, v in state[0].items()})
        return out

    def generator(inputs_dir):
        """Generator over data x model: greedy generate, the on-device
        loop (uncaptured on the CPU) and int8 weights."""
        params, _ = _load(inputs_dir, "gen")
        kw = dict(num_layers=GEN["layers"], num_heads=GEN["heads"],
                  dim=GEN["dim"], batch_size=GEN["B"], ctx=mx.cpu())
        mesh = make_mesh({"data": 2, "model": 2})
        prompt = np.array([[1, 2, 3], [4, 5, 6]])
        tp = Generator(params, GEN["vocab"], GEN["T"], mesh=mesh, **kw)
        q8 = Generator(params, GEN["vocab"], GEN["T"], mesh=mesh,
                       quantize="int8", **kw)
        return {
            "greedy": tp.generate(prompt, max_new_tokens=6),
            "host": tp.generate(prompt, max_new_tokens=5),
            "device": tp.generate_on_device(prompt, max_new_tokens=5),
            "sampled": tp.generate(prompt, max_new_tokens=5,
                                   temperature=0.8, top_k=10, seed=4),
            "int8": q8.generate(np.array([[1, 2], [3, 4]]),
                                max_new_tokens=3),
            "qkv_local": np.array(tp._params["layer0_qkv_weight"].shape),
            "qkv_spec": np.array(tp._pspec["layer0_qkv_weight"] ==
                                 ("model",)),
            "q8_dtype": np.array(str(q8._params["layer0_qkv_weight"].dtype)),
            "q8_local": np.array(q8._params["layer0_qkv_weight"].shape),
            "cache": np.array(next(iter(tp._fresh_aux().values())).shape)}

    def bn_data2(inputs_dir):
        """The conv-BatchNorm net, two SGD steps under data=2 (tp=2 beside
        it replicates) on the kernel route's plain twin and on the one-pass
        route."""
        out = {}
        for route, knob, val in (("kernels", "MXNET_BN_PALLAS", True),
                                 ("onepass", "MXNET_BN_IMPL", "onepass")):
            config.set_override(knob, val)
            try:
                _, _, res = run("bn", inputs_dir,
                                mesh=make_mesh({"data": 2, "tp": 2}))
            finally:
                config.set_override(knob, None)
            out.update({route + "|" + k: v for k, v in res.items()})
        return out

    def reduce(inputs_dir):
        """Queue C 17: mean and max over the batch axis in the graph under
        data=2 (tp=2 beside it), three SGD steps; then each batch-mixing op
        refused."""
        _, _, out = run("reduce", inputs_dir,
                        mesh=make_mesh({"data": 2, "tp": 2}))
        mesh = make_mesh({"data": 2, "tp": 2})
        with mx.cpu():
            x = torch.tensor(np.arange(24, dtype=np.float32).reshape(
                4, 6, 1))
            for name, build in REFUSED.items():
                sym = build(mx.sym)
                fn = _graph_eval_fn(sym, mesh=mesh,
                                    batch_names=("data", "idx"))
                args = {"data": x, "idx": torch.zeros((4,))}
                try:
                    fn({k: v for k, v in args.items()
                        if k in sym.list_arguments()}, {}, 0, False)
                    out["refused:" + name] = np.array("")
                except MXNetError as e:
                    out["refused:" + name] = np.array(str(e))
        return out

    def compiled(inputs_dir):
        """CompiledTrainStep.load(mesh=) over data=4 on the CPU: the eager
        step over the mesh, against the one-device compiled step."""
        prefix = os.path.join(inputs_dir, "exp")
        X, y = _toy()
        batch = {"data": X[:32], "softmax_label": y[:32]}
        with mx.cpu():
            step = step_for("mlp")
            state, _ = init(step, "mlp", inputs_dir)
            if dist.rank() == 0:
                step.export(prefix, state, batch)
            torch.distributed.barrier()
            out = {}
            for tag, mesh in (("mesh", make_mesh({"data": 4})),
                              ("one", None)):
                ct = CompiledTrainStep.load(prefix, ctx=mx.cpu(), mesh=mesh)
                for i in range(2):
                    outs = ct.step(batch, 0.05, seed=i)
                out[tag + "_out"] = outs[0]
                out.update({tag + ":" + k: v
                            for k, v in ct.get_params().items()})
        return out

    return {"fit_zero1": fit_zero1, "opt_state": opt_state,
            "checkpoint": checkpoint, "module": module,
            "knob_off": knob_off, "tp_fsdp": tp_fsdp,
            "generator": generator, "bn_data2": bn_data2,
            "reduce": reduce, "compiled": compiled}


def _rank_main(rank, world, port, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from mxnet_tpu_torch.parallel import dist
    dist.init("127.0.0.1:%d" % port, world, rank, backend="gloo",
              timeout=COLLECTIVE_TIMEOUT_S)
    for name, fn in _rank_cases().items():
        base = os.path.join(out_dir, "%s.r%d" % (name, rank))
        t0 = time.time()
        try:
            res = fn(out_dir)
            np.savez(base + ".npz", **res)
        except Exception:                       # reported by the test
            with open(base + ".err", "w") as f:
                f.write(traceback.format_exc())
        with open(base + ".s", "w") as f:
            f.write("%.3f" % (time.time() - t0))
    dist.shutdown()


# ---------------------------------------------------------------------------
# the fixture: the JAX inits, one launch of 4 ranks
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_init(name, seed=7):
    """The JAX package's init_state of a training case (seeded), as numpy
    params and aux."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.initializer import Xavier
    from mxnet_tpu.models import transformer
    from mxnet_tpu.parallel import make_train_step
    build, opt, opt_params, _, _, batch = TRAIN[name]
    step = make_train_step(build(jmx, transformer), optimizer=opt,
                           optimizer_params=opt_params)
    jmx.random.seed(seed)
    np.random.seed(seed)
    state = step.init_state(Xavier(), {k: v.shape for k, v in
                                       batch().items()})
    return jax.tree_util.tree_map(np.asarray, state)


def _gen_params():
    """The Generator case's weights: the JAX init of its LM (seeded)."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.initializer import Xavier
    from mxnet_tpu.models import transformer
    from mxnet_tpu.parallel import make_train_step
    sym = transformer.get_symbol(GEN["vocab"], GEN["T"],
                                 num_layers=GEN["layers"],
                                 num_heads=GEN["heads"], dim=GEN["dim"])
    step = make_train_step(sym, optimizer="sgd")
    jmx.random.seed(0)
    state = step.init_state(Xavier(), {"data": (GEN["B"], GEN["T"]),
                                       "softmax_label": (GEN["B"],
                                                         GEN["T"])})
    return jax.tree_util.tree_map(np.asarray, state[0])


def _write_inputs(d):
    for name in TRAIN:
        params, _, aux = _jax_init(name)
        np.savez(os.path.join(d, name + ".npz"),
                 **{"p:" + k: v for k, v in params.items()},
                 **{"a:" + k: v for k, v in aux.items()})
    np.savez(os.path.join(d, "gen.npz"),
             **{"p:" + k: v for k, v in _gen_params().items()})


class _Ranks:
    def __init__(self, d):
        self.dir = d

    def get(self, name, rank=0):
        base = os.path.join(self.dir, "%s.r%d" % (name, rank))
        if os.path.exists(base + ".err"):
            with open(base + ".err") as f:
                pytest.fail("rank %d failed %s:\n%s"
                            % (rank, name, f.read()))
        assert os.path.exists(base + ".npz"), \
            "rank %d wrote no %s (see the launch log)" % (rank, name)
        with np.load(base + ".npz") as blob:
            return {k: blob[k] for k in blob.files}

    def all(self, name):
        return [self.get(name, r) for r in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_gspmd"))
    _write_inputs(d)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("MXNET_DIST_BACKEND", None)
    port = _free_port()
    procs = []
    for r in range(WORLD):
        log = open(os.path.join(d, "launch.r%d.log" % r), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
             str(port), d], env=env, cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT), log))
    deadline = time.time() + LAUNCH_TIMEOUT_S
    failed = []
    for p, log in procs:
        try:
            rc = p.wait(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append((p.args[2], rc, log.name))
    for r, rc, name in failed:
        with open(name) as f:
            sys.stderr.write("rank %s exited %s:\n%s\n" % (r, rc,
                                                           f.read()[-4000:]))
    assert not failed, "rank launches failed: %r" % [
        (r, rc) for r, rc, _ in failed]
    return _Ranks(d)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jmesh(sizes):
    import jax
    from jax.sharding import Mesh
    n = int(np.prod(list(sizes.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(
        tuple(sizes.values())), tuple(sizes))


def _jlayout(sizes, **kw):
    from mxnet_tpu.parallel.sharding import SpecLayout
    kw.setdefault("min_shard_size", 0)
    return SpecLayout(_jmesh(sizes), **kw)


def _jax_run(name, **kw):
    """The JAX step of a training case from its init: (params, aux,
    outputs) as numpy."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.models import transformer
    from mxnet_tpu.parallel import make_train_step
    build, opt, opt_params, lr, n, batch = TRAIN[name]
    params, _, aux = _jax_init(name)
    step = make_train_step(build(jmx, transformer), optimizer=opt,
                           optimizer_params=opt_params, **kw)
    b = batch()
    state = step.init_state(None, {k: v.shape for k, v in b.items()},
                            arg_params=params, aux_params=aux)
    placed = step.place_batch(b)
    for _ in range(n):
        state, outs = step(state, placed, lr, jax.random.PRNGKey(0))
    return ({k: np.asarray(v) for k, v in state[0].items()},
            {k: np.asarray(v) for k, v in state[2].items()},
            [np.asarray(o, np.float32) for o in outs])


def _assert_params(got, want, tol=PARAMS, prefix="p:"):
    assert sorted(k[len(prefix):] for k in got if k.startswith(prefix)) \
        == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[prefix + k], v, err_msg=k, **tol)


# ---------------------------------------------------------------------------
# tests over the ranks: tests/test_gspmd.py
# ---------------------------------------------------------------------------

def test_gspmd_fit_epoch_matches_jax(ranks):
    """A TrainStep.fit of 3 epochs on the data x fsdp layout (sharded
    params, optimizer state folded over the 4 replicas) lands on the
    weights of the JAX package's fit on its data x fsdp layout."""
    import mxnet_tpu as jmx
    from mxnet_tpu import io as jio
    from mxnet_tpu.parallel import make_train_step
    X, y = _toy()
    params, _, aux = _jax_init("mlp")
    step = make_train_step(_mlp(jmx), optimizer="adam",
                           optimizer_params={"rescale_grad": 1.0 / 32},
                           layout=_jlayout({"data": 2, "fsdp": 2}),
                           optimizer_sharding="zero1")
    state = step.init_state(None, {"data": X.shape, "softmax_label":
                                   y.shape}, arg_params=params,
                            aux_params=aux)
    state, _ = step.fit(jio.NDArrayIter(X, y, batch_size=32), num_epoch=3,
                        state=state, lr=0.05, seed=3)
    want = {k: np.asarray(v) for k, v in state[0].items()}
    for r in range(WORLD):
        _assert_params(ranks.get("fit_zero1", r), want)


def test_gspmd_fit_sync_budget_per_step(ranks):
    """At most one blocking host sync a step (2 steps an epoch) plus the
    epoch-end metric read, on every rank."""
    for g in ranks.all("fit_zero1"):
        assert int(g["syncs"]) <= 2 + 1, int(g["syncs"])


def test_gspmd_opt_state_is_one_nth_per_rank(ranks):
    """Every optimizer-state tensor lives 1/4 a rank across steps, and the
    parameters come back in their own layout, not the 1/N slice; three
    steps give the JAX step's parameters and, concatenated in data x fsdp
    order, its outputs."""
    want, _, outs = _jax_run("mlp")
    got = ranks.all("opt_state")
    for g in got:
        assert bool(g["one_nth"])
        _assert_params(g, want)
    np.testing.assert_allclose(np.concatenate([g["out0"] for g in got]),
                               outs[0], **OUT)


def test_gspmd_batch_rides_the_data_axes(ranks):
    """The batch splits over data x fsdp: each of the 4 ranks holds its own
    16 rows, data major, as the JAX package's P(('data', 'fsdp'))."""
    for g in ranks.all("opt_state"):
        assert bool(g["rows"])
        assert g["out0"].shape[0] == 16


def test_layout_bind_telemetry_gauges(ranks):
    """gspmd.sharded_params counts the sharded parameters and
    gspmd.opt_state_bytes_per_dev is the rank's optimizer-state bytes;
    describe_layout() reports the claims."""
    for g in ranks.all("opt_state"):
        assert int(g["sharded_params"]) >= 1
        assert int(g["opt_bytes"]) == int(g["opt_bytes_want"])
        assert "fc1_weight" in str(g["describe"])


def test_gspmd_checkpoint_roundtrip_across_layouts(ranks):
    """A checkpoint written under the data x fsdp zero1 layout restores
    onto the same layout, onto data=4 and onto one device, and each
    continues the same trajectory."""
    for g in ranks.all("checkpoint"):
        for tag in ("data4", "single"):
            np.testing.assert_allclose(g[tag + "_p"], g["ref_p"],
                                       rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(g["data4"], g["ref"], rtol=2e-5,
                                   atol=1e-6)
    got = ranks.all("checkpoint")
    np.testing.assert_allclose(np.concatenate([g["ref"] for g in got]),
                               got[0]["single"], rtol=2e-5, atol=1e-6)


def test_module_accepts_layout_and_shards_params(ranks):
    """Module(layout=) binds the same placement layer: fc1's weight lives
    sharded, three epochs give the JAX Module's parameters on its layout,
    and training converges; a batch that does not divide the shards
    raises MXNetError."""
    import mxnet_tpu as jmx
    from mxnet_tpu import io as jio
    X, y = _separable()
    params, _, _ = _jax_init("module")
    mod = jmx.mod.Module(_mlp(jmx, classes=2), context=jmx.cpu(),
                         layout=_jlayout({"data": 2, "fsdp": 2}))
    mod.fit(jio.NDArrayIter(X, y, batch_size=32), num_epoch=3,
            optimizer="sgd",
            arg_params={k: jmx.nd.array(v) for k, v in params.items()},
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9})
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for g in ranks.all("module"):
        _assert_params(g, want)
        assert np.prod(g["w_local"]) < 32 * 16
        assert float(g["acc"]) > 0.9
        assert "divisible" in str(g["divisible"])


def test_constrain_acts_knob_off_still_trains(ranks):
    for g in ranks.all("knob_off"):
        assert bool(g["knob"]) and bool(g["act_parts_none"])
        assert bool(g["finite"])


def test_fsdp_tp_rules_of_the_docs_match_jax(ranks):
    """docs/parallelism.md's rules over {'fsdp': 2, 'tp': 2}: tok_embed
    split over (fsdp, tp) on dim 0, the qkv/proj/fc1/fc2 weights over tp
    (column-parallel), biases replicated; two SGD-momentum steps with
    zero1 give the JAX step's parameters on the same layout."""
    from jax.sharding import PartitionSpec as JP
    want, _, _ = _jax_run("tp_fsdp", layout=_jlayout(
        {"fsdp": 2, "tp": 2}, rules=[(p, JP(*s) if isinstance(s, tuple)
                                      else s) for p, s in TP_RULES]),
        optimizer_sharding="zero1")
    for g in ranks.all("tp_fsdp"):
        _assert_params(g, want)
        assert tuple(g["local:tok_embed_weight"]) == (LM["vocab"] // 4,
                                                      LM["dim"])
        assert tuple(g["local:layer0_qkv_weight"]) == (3 * LM["dim"] // 2,
                                                       LM["dim"])
        assert tuple(g["local:layer0_fc2_weight"]) == (LM["dim"] // 2,
                                                       4 * LM["dim"])


def test_generator_mesh_decode_matches_jax(ranks):
    """Generator over {'data': 2, 'model': 2}: column-parallel qkv, caches
    split over rows and heads; greedy and sampled generate, the on-device
    loop and int8 weights give the JAX Generator's tokens on its mesh."""
    import mxnet_tpu as jmx  # noqa: F401
    from mxnet_tpu.generation import Generator as JGenerator
    params = _gen_params()
    kw = dict(num_layers=GEN["layers"], num_heads=GEN["heads"],
              dim=GEN["dim"], batch_size=GEN["B"],
              mesh=_jmesh({"data": 2, "model": 2}))
    jg = JGenerator(params, GEN["vocab"], GEN["T"], **kw)
    jq = JGenerator(params, GEN["vocab"], GEN["T"], quantize="int8", **kw)
    prompt = np.array([[1, 2, 3], [4, 5, 6]])
    want = {"greedy": jg.generate(prompt, max_new_tokens=6),
            "host": jg.generate(prompt, max_new_tokens=5),
            "device": jg.generate_on_device(prompt, max_new_tokens=5),
            "sampled": jg.generate(prompt, max_new_tokens=5,
                                   temperature=0.8, top_k=10, seed=4),
            "int8": jq.generate(np.array([[1, 2], [3, 4]]),
                                max_new_tokens=3)}
    for g in ranks.all("generator"):
        for k, v in want.items():
            np.testing.assert_array_equal(g[k], np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(g["host"], g["device"])
        assert bool(g["qkv_spec"])
        assert tuple(g["qkv_local"]) == (3 * GEN["dim"] // 2, GEN["dim"])
        assert str(g["q8_dtype"]) == "torch.int8"
        assert tuple(g["q8_local"]) == (3 * GEN["dim"] // 2, GEN["dim"])
        # rows over data, kv heads over model
        assert tuple(g["cache"]) == (GEN["B"] // 2, GEN["heads"] // 2,
                                     GEN["T"], GEN["dim"] // GEN["heads"])


@pytest.mark.parametrize("route", ["kernels", "onepass"])
def test_batchnorm_shifted_routes_under_data2_match_jax(ranks, route):
    """The BatchNorm kernel route's plain twin and the one-pass route
    under data=2 take the global batch's statistics: two SGD steps of the
    conv-BatchNorm net give the JAX one-device step's parameters and
    moving stats (the JAX BatchNorm of the global batch)."""
    want, aux, _ = _jax_run("bn")
    for g in ranks.all("bn_data2"):
        sub = {k.split("|", 1)[1]: v for k, v in g.items()
               if k.startswith(route + "|")}
        _assert_params(sub, want)
        _assert_params(sub, aux, prefix="a:")


def test_batch_reductions_in_a_graph_are_global(ranks):
    """Queue C 17: mean and max over the batch axis in a graph under
    data=2 reduce the whole batch, so three SGD steps give the JAX step's
    parameters on a data mesh; each batch-mixing op raises naming item
    17."""
    want, _, _ = _jax_run("reduce", mesh=_jmesh({"data": 2}))
    for g in ranks.all("reduce"):
        _assert_params(g, want)
        for name in REFUSED:
            msg = str(g["refused:" + name])
            assert "Queue C 17" in msg and name in msg, (name, msg)


def test_compiled_train_step_over_ranks_on_the_cpu(ranks):
    """CompiledTrainStep.load(mesh=) over data=4 runs the eager step over
    the ranks on the CPU: two steps give the one-device compiled step's
    parameters, and each rank's outputs are its rows."""
    got = ranks.all("compiled")
    for g in got:
        names = [k[5:] for k in g if k.startswith("mesh:")]
        assert names
        for n in names:
            np.testing.assert_allclose(g["mesh:" + n], g["one:" + n],
                                       **PARAMS)
    np.testing.assert_allclose(np.concatenate([g["mesh_out"] for g in got]),
                               got[0]["one_out"], **OUT)


# ---------------------------------------------------------------------------
# one process: make_mesh, SpecLayout, parse_spec, __shard__
# ---------------------------------------------------------------------------

class _StubMesh:
    """A mesh's shape without ranks: SpecLayout's rules read nothing
    else."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)
        self.size = int(np.prod(list(sizes.values())))


def _dxf():
    return _StubMesh({"data": 2, "fsdp": 4})


def test_make_mesh_mismatch_raises_valueerror():
    from mxnet_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError) as e:
        make_mesh({"data": 3, "fsdp": 4})
    msg = str(e.value)
    assert "3" in msg and "4" in msg and "1 ranks" in msg  # sizes AND count


def test_make_mesh_infers_one_axis_and_validates_inference():
    from mxnet_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"data": 1, "fsdp": -1, "tp": 1})
    assert mesh.shape == {"data": 1, "fsdp": 1, "tp": 1}
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh({"data": 3, "fsdp": -1})
    with pytest.raises(ValueError, match="at most one"):
        make_mesh({"data": -1, "fsdp": -1})
    with pytest.raises(ValueError, match="positive"):
        make_mesh({"data": 0, "fsdp": 8})


def test_speclayout_rejects_unknown_axis_and_bad_rules():
    from mxnet_tpu_torch.parallel import P, SpecLayout
    mesh = _dxf()
    with pytest.raises(ValueError, match="not a mesh axis"):
        SpecLayout(mesh, rules=[("*", P("tp"))])
    with pytest.raises(ValueError, match="more than one dim"):
        SpecLayout(mesh, rules=[("*", P("fsdp", "fsdp"))])
    with pytest.raises(ValueError, match="pattern, spec"):
        SpecLayout(mesh, rules=["fsdp"])
    lay = SpecLayout(mesh, rules=[("w", P("fsdp"))], min_shard_size=0)
    with pytest.raises(ValueError, match="not divisible"):
        lay.param_nsharding("w", (6,))
    lay2 = SpecLayout(mesh, rules=[("b", P("fsdp", None))],
                      min_shard_size=0)
    with pytest.raises(ValueError, match="more dims"):
        lay2.param_nsharding("b", (32,))


def test_rule_precedence_first_match_wins_and_auto_fallback():
    from mxnet_tpu_torch.parallel import P, SpecLayout
    lay = SpecLayout(_dxf(), rules=[
        ("fc1_weight", P(None, "fsdp")),      # exact, first
        ("fc1_*", P("fsdp", None)),           # glob, shadowed for fc1_weight
    ], min_shard_size=0)
    parts, label = lay.spec_for("fc1_weight", (32, 16))
    assert parts == (None, "fsdp") and "rule[0]" in label
    parts, label = lay.spec_for("fc1_gamma", (32, 16))
    assert parts == ("fsdp", None) and "rule[1]" in label
    parts, label = lay.spec_for("other_weight", (8, 32))
    assert parts == (None, "fsdp") and label.startswith("auto")
    parts, label = lay.spec_for("odd", (6, 3))
    assert parts == (None, None) and "replicated" in label


def test_auto_rule_min_size_replicates_tiny_tensors():
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.parallel import SpecLayout
    assert config.get("MXNET_FSDP_MIN_SIZE") == 1024
    lay = SpecLayout(_dxf())
    assert lay.min_shard_size == 1024
    parts, label = lay.spec_for("small_bias", (32,))     # 32 < 1024
    assert parts == (None,) and "replicated" in label
    parts, _ = lay.spec_for("big_weight", (64, 64))      # 4096 >= 1024
    assert parts == ("fsdp", None) or parts == (None, "fsdp")


def test_describe_reports_claims_and_unused_rules():
    from mxnet_tpu_torch.parallel import P, SpecLayout
    lay = SpecLayout(_dxf(), rules=[
        ("fc1_weight", P("fsdp", None)),
        ("never_matches_*", P("fsdp")),
    ], min_shard_size=0)
    assert "no parameters placed yet" in lay.describe()
    lay.param_nsharding("fc1_weight", (32, 16))
    lay.param_nsharding("fc2_bias", (8,))
    rep = lay.describe()
    assert "fc1_weight" in rep and "rule[0]" in rep
    assert "8x16" in rep                   # per-rank shard of (32,16)
    assert "fc2_bias" in rep and "auto" in rep
    assert "rule[1]" in rep and "matched no parameter" in rep


def test_parse_spec_grammar():
    from mxnet_tpu_torch.parallel import P
    from mxnet_tpu_torch.parallel.sharding import parse_spec
    assert parse_spec("fsdp,None") == ("fsdp", None)
    assert parse_spec("data+fsdp,None") == (("data", "fsdp"), None)
    assert parse_spec(P("fsdp", None)) == ("fsdp", None)
    assert parse_spec([("data", "fsdp"), None]) == (("data", "fsdp"),
                                                    None)
    assert parse_spec("None") == (None,)
    assert P(("fsdp", "tp"), None) == (("fsdp", "tp"), None)


@pytest.mark.parametrize("case", ["auto", "rules", "tp"])
def test_layout_specs_equal_jax_speclayouts(case):
    """Every spec of the port's SpecLayout (parameter, optimizer state
    with and without the zero fold, batch, activations) equals the JAX
    SpecLayout's on the same mesh shape."""
    from mxnet_tpu.parallel import sharding as jshd
    from mxnet_tpu_torch.parallel import SpecLayout
    sizes = {"data": 2, "fsdp": 4} if case != "tp" else \
        {"data": 2, "fsdp": 2, "tp": 2}
    rules = () if case == "auto" else (
        [("fc1_weight", "fsdp,None"), ("emb*", (("fsdp", "tp"), None)),
         ("*_bias", ())] if case == "tp" else
        [("fc1_weight", (None, "fsdp")), ("fc1_*", ("fsdp", None)),
         ("big", "data+fsdp,None")])
    jl = jshd.SpecLayout(_jmesh(sizes), rules=rules, min_shard_size=64)
    tl = SpecLayout(_StubMesh(sizes), rules=rules, min_shard_size=64)
    shapes = {"fc1_weight": (32, 16), "fc1_gamma": (32, 16),
              "fc2_bias": (8,), "embed": (64, 8), "big": (16, 24),
              "odd": (6, 3), "tall": (128, 4), "w3": (8, 12, 16)}

    def spec(ns):
        return tuple(ns.spec)
    for n, s in shapes.items():
        assert tl.spec_for(n, s) == jl.spec_for(n, s), n
        assert tl.param_nsharding(n, s) == spec(jl.param_nsharding(n, s))
        for zero in (False, True):
            assert tl.opt_nsharding(n, s, zero=zero) == \
                spec(jl.opt_nsharding(n, s, zero=zero)), (n, zero)
    for nd in (1, 2, 4):
        assert tl.batch_nsharding(nd) == spec(jl.batch_nsharding(nd))
        assert tl.act_parts(nd) == jl.act_parts(nd)


def test_lm_parameter_names_meet_the_documented_rules():
    """The transformer's layer%d_ names meet docs/parallelism.md's rules:
    every rule claims a parameter, each layer's qkv/proj/fc1/fc2 weight
    goes to its tp rule, tok_embed to (fsdp, tp), biases to P(), and the
    rest (pos_embed, the LayerNorms, lm_head) to the auto rule."""
    import mxnet_tpu_torch as mx  # noqa: F401
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import P, SpecLayout
    sym = transformer.get_symbol(LM["vocab"], LM["T"], num_layers=2,
                                 num_heads=LM["heads"], dim=LM["dim"])
    shapes, _, _ = sym.infer_shape(data=(LM["B"], LM["T"]),
                                   softmax_label=(LM["B"], LM["T"]))
    lay = SpecLayout(_StubMesh({"fsdp": 2, "tp": 2}), rules=[
        (p, P(*s) if isinstance(s, tuple) else s) for p, s in TP_RULES],
        min_shard_size=0)
    for name, shape in zip(sym.list_arguments(), shapes):
        if name not in ("data", "softmax_label"):
            lay.param_nsharding(name, tuple(shape))
    labels = {n: c[0] for n, c in lay._claims.items()}
    for layer in range(2):
        for i, part in enumerate(("qkv", "proj", "fc1", "fc2")):
            assert labels["layer%d_%s_weight" % (layer, part)].startswith(
                "rule[%d]" % (i + 1)), (layer, part)
            assert labels["layer%d_%s_bias" % (layer, part)].startswith(
                "rule[5]")
    assert labels["tok_embed_weight"].startswith("rule[0]")
    assert labels["lm_head_weight"].startswith("auto")
    assert "matched no parameter" not in lay.describe()


def test_zero1_requires_replica_axis_on_tp_only_layout():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import SpecLayout, make_mesh
    from mxnet_tpu_torch.parallel import make_train_step
    with pytest.raises(ValueError, match="replica axis"):
        make_train_step(_mlp(mx), optimizer="adam",
                        layout=SpecLayout(make_mesh({"tp": 1})),
                        optimizer_sharding="zero1")


def test_layout_and_mesh_are_mutually_exclusive():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import SpecLayout, make_mesh
    from mxnet_tpu_torch.parallel import make_train_step
    with pytest.raises(ValueError, match="not both"):
        make_train_step(_mlp(mx), mesh=make_mesh({"data": 1}),
                        layout=SpecLayout(make_mesh({"data": 1,
                                                     "fsdp": 1})))


def test_shard_annotations_strict_and_lenient():
    """__shard__ is read strictly (an axis the mesh lacks, or a dim the
    axes do not divide, raises MXNetError with the JAX package's
    messages); __shard_hint__ leniently (skipped); a valid annotation
    changes no number."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.executor import _graph_eval_fn, _shard_check
    from mxnet_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"data": 1, "tp": 1})
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)

    def run(sym):
        with mx.cpu():
            return _graph_eval_fn(sym, mesh=mesh)({"data": x}, {}, 0,
                                                 False)[0][0]
    data = mx.sym.Variable("data")
    ok = mx.sym.relu(data)
    ok._set_attr(__shard__="data,None")
    torch.testing.assert_close(run(ok), torch.relu(x))
    bad = mx.sym.relu(data)
    bad._set_attr(__shard__="fsdp,None")
    with pytest.raises(MXNetError, match="not in mesh axes"):
        run(bad)
    hint = mx.sym.relu(data)
    hint._set_attr(__shard_hint__="fsdp,None")
    torch.testing.assert_close(run(hint), torch.relu(x))
    grp = mx.sym.relu(data)
    grp._set_attr(__ctx_group__="dev1")
    with mx.cpu():
        fn = _graph_eval_fn(grp, mesh=mesh, group2spec={"dev1": "sp"})
        with pytest.raises(MXNetError, match="not in mesh axes"):
            fn({"data": x}, {}, 0, False)
    two = _StubMesh({"data": 1, "tp": 2})
    with pytest.raises(MXNetError, match="not divisible"):
        _shard_check(two, "tp,None", (3, 4))
    _shard_check(two, "tp,None", (3, 4), strict=False)
    _shard_check(two, "None,tp", (3, 4))


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
