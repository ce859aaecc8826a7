"""The port's mesh axes over gloo CPU ranks, held against the JAX package
on its virtual 8-device CPU mesh (``tests/conftest.py``).

A module fixture launches the ranks ONCE: two ranks and one four-rank
group, each rank a process of this file (``python tests/test_torch_mesh.py
RANK WORLD PORT DIR``) with ``torch.set_num_threads(1)``, a TCP store on
127.0.0.1, backend gloo and a time limit on the launch and on every
collective. Every rank runs every case of its group on the same numpy
inputs (written by the fixture: the JAX ``init_state`` of each training
case among them) and writes its results to the fixture's directory; the
tests compute the JAX side (the JAX functions on meshes of 2 or 4 of the
8 virtual devices, or the JAX single-device step where the JAX mesh
program is the same global computation) and compare. The cases mirror
``tests/test_attention.py`` (the ring, its gradients, GQA through the op,
the symbol graph on a mesh, no mesh, the LM trained sequence-parallel,
dp x sp x zero1, the banded ring), ``tests/test_pipeline_moe.py`` (all
seven tests) and ``tests/test_parallel.py`` (dp against single, zero1
against replicated, zero1 needing 'data', aux threading, rank and size).

Tolerances: float32 outputs rtol 1e-5 / atol 1e-6; gradients rtol 1e-5 /
atol 1e-6 of the gradient's largest magnitude (``_assert_grad``); parameters after steps rtol 2e-4 / atol 1e-5 (the JAX
package's own, ``tests/test_parallel.py``); ZeRO-1 against the replicated
update inside the port bit for bit.
"""
import json
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
LAUNCH_TIMEOUT_S = 240
COLLECTIVE_TIMEOUT_S = 120

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (vocab, seq, batch) of the LM cases; dims of the toy MLP data
LM = dict(vocab=64, T=16, B=4, heads=2, dim=32)
# the BatchNorm routes' NCHW batch under data=2
BN_SHAPE = (6, 4, 5, 3)


# ---------------------------------------------------------------------------
# inputs, made from numpy seeds (the fixture and the ranks read the same)
# ---------------------------------------------------------------------------

def _f32(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _toy(n=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d)
    return X, (X @ w > 0).astype(np.float32)


def _lm_batch(seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, LM["vocab"], (LM["B"], LM["T"])).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def _qkv(B, H, T, D, seed=0, Hkv=None):
    Hkv = Hkv or H
    return (_f32((B, H, T, D), seed), _f32((B, Hkv, T, D), seed + 1),
            _f32((B, Hkv, T, D), seed + 2))


def _mlp(mx, bn=False, dropout=0.0):
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, name="fc1", num_hidden=32)
    if bn:
        net = mx.sym.BatchNorm(net, name="bn", fix_gamma=False)
    net = mx.sym.Activation(net, act_type="relu")
    if dropout:
        net = mx.sym.Dropout(net, p=dropout)
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=2)
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _regress(mx, normalization):
    """An MLP regressing the label under a MakeLoss head of squared
    errors; 'valid' counts the errors over 0.5."""
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), name="fc1",
                                num_hidden=32)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=1)
    err = net - mx.sym.reshape(mx.sym.Variable("softmax_label"),
                               shape=(-1, 1))
    return mx.sym.MakeLoss(mx.sym.square(err), normalization=normalization,
                           valid_thresh=0.5)


def _lm_sym(transformer, **kw):
    return transformer.get_symbol(LM["vocab"], LM["T"], num_layers=1,
                                  num_heads=LM["heads"], dim=LM["dim"], **kw)


# training cases: name -> (symbol builder, optimizer, params, lr, steps,
# rng seed a step); the mesh and options are the rank side's
TRAIN = {
    "dp_mlp": (lambda mx, tr: _mlp(mx), "sgd",
               {"rescale_grad": 1.0 / 64}, 0.5, 5),
    "dp_dropout": (lambda mx, tr: _mlp(mx, dropout=0.3), "sgd",
                   {"rescale_grad": 1.0 / 64}, 0.5, 2),
    "zero1": (lambda mx, tr: _mlp(mx), "sgd",
              {"momentum": 0.9, "rescale_grad": 1.0 / 64}, 0.5, 5),
    "bn_aux": (lambda mx, tr: _mlp(mx, bn=True), "sgd",
               {"momentum": 0.9}, 0.1, 3),
    "lm_sp": (lambda mx, tr: _lm_sym(tr, seq_axis="sp"), "sgd", {}, 1.0, 1),
    "lm_expert": (lambda mx, tr: _lm_sym(tr, num_experts=4,
                                         expert_axis="expert"),
                  "sgd", {}, 1.0, 1),
    "dp_sp_zero1": (lambda mx, tr: _lm_sym(tr, seq_axis="sp"), "sgd",
                    {"momentum": 0.9}, 0.5, 2),
    "lm_data_expert": (lambda mx, tr: _lm_sym(tr, num_experts=4,
                                              expert_axis="expert"),
                       "sgd", {"momentum": 0.9}, 0.5, 2),
    "makeloss_batch": (lambda mx, tr: _regress(mx, "batch"), "sgd", {},
                       0.1, 3),
    "makeloss_valid": (lambda mx, tr: _regress(mx, "valid"), "sgd", {},
                       0.1, 3),
}
MLP_CASES = ("dp_mlp", "dp_dropout", "zero1", "bn_aux", "makeloss_batch",
             "makeloss_valid")


def _train_batch(name):
    if name in MLP_CASES:
        X, y = _toy()
        return {"data": X, "softmax_label": y}
    toks, labels = _lm_batch()
    return {"data": toks, "softmax_label": labels}


# ---------------------------------------------------------------------------
# the rank side: imports torch and the port only
# ---------------------------------------------------------------------------

def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _load_state(path):
    blob = np.load(path)
    params = {k[2:]: blob[k] for k in blob.files if k.startswith("p:")}
    aux = {k[2:]: blob[k] for k in blob.files if k.startswith("a:")}
    return params, aux


def _run_train(name, mesh, inputs_dir, zero=None, compute_dtype=None,
               steps=None):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import make_train_step
    build, opt, opt_params, lr, n = TRAIN[name]
    params, aux = _load_state(os.path.join(inputs_dir, name + ".npz"))
    batch = _train_batch(name)
    with mx.cpu():
        step = make_train_step(build(mx, transformer), optimizer=opt,
                               optimizer_params=opt_params, mesh=mesh,
                               optimizer_sharding=zero,
                               compute_dtype=compute_dtype)
        state = step.init_state(None, {k: v.shape for k, v in batch.items()},
                                arg_params=params, aux_params=aux)
        placed = step.place_batch(batch)
        for i in range(steps or n):
            state, outs = step(state, placed, lr, 0)
        full = step._global_state(state)
    return step, state, full, outs


def _run_fit(mesh, inputs_dir, tag="fit"):
    """2 epochs of TrainStep.fit on the toy MLP (SGD momentum, clip_norm,
    the default guardrail, "acc" on the device) from the dp_mlp init;
    checkpoints and an export under ``inputs_dir``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io
    from mxnet_tpu_torch.parallel import make_train_step
    params, aux = _load_state(os.path.join(inputs_dir, "dp_mlp.npz"))
    X, y = _toy()
    prefix = os.path.join(inputs_dir, tag)
    with mx.cpu():
        step = make_train_step(_mlp(mx), optimizer="sgd", mesh=mesh,
                               optimizer_params={"momentum": 0.9},
                               clip_norm=0.5)
        state, val = step.fit(io.NDArrayIter(X, y, batch_size=32),
                              num_epoch=2, lr=0.1, arg_params=params,
                              aux_params=aux, checkpoint_prefix=prefix,
                              resume=False, eval_metric="acc")
        full = step._global_state(state)
        loaded = step._global_state(step.load_state(prefix + "_0001"))
        step.export(prefix + "_export", state,
                    {"data": X[:32], "softmax_label": y[:32]})
    out = {"p:" + k: _np(v) for k, v in full[0].items()}
    out["val"] = np.array(val)
    out["loaded_equal"] = np.array(all(
        torch.equal(full[0][k], loaded[0][k]) for k in full[0]) and all(
        torch.equal(a, b) for k in full[1]
        for a, b in zip(full[1][k], loaded[1][k])))
    return out


def _rank_cases(world):
    """name -> fn(inputs_dir) -> {key: array}, run in order on every
    rank of a ``world``-rank launch."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.executor import _graph_eval_fn
    from mxnet_tpu_torch.ops import _mesh_ctx
    from mxnet_tpu_torch.ops.attention import _flash_attention_op
    from mxnet_tpu_torch.parallel import (dist, make_mesh, moe_ffn,
                                          pipeline_apply,
                                          pipeline_from_symbol,
                                          ring_attention)
    from mxnet_tpu_torch.parallel import _comm
    from mxnet_tpu_torch.parallel.moe import _route
    import mxnet_tpu_torch as mx

    def rank_size(_):
        mesh = make_mesh({"data": -1})
        return {"rank": np.array(dist.rank()), "size": np.array(dist.size()),
                "mesh": np.array(mesh.size),
                "staged": np.array(telemetry.counter(
                    _comm.STAGED_BYTES).value)}

    def ring(_):
        mesh = make_mesh({"sp": world})
        out = {}
        for causal in (False, True):
            q, k, v = (torch.tensor(a, requires_grad=True)
                       for a in _qkv(1, 2, 8 * world, 8))
            o = ring_attention(q, k, v, mesh, "sp", causal=causal)
            cot = torch.tensor(_f32(o.shape, 9))
            grads = torch.autograd.grad(o, (q, k, v), cot)
            out["o%d" % causal] = _np(o)
            for n, g in zip("qkv", grads):
                out["d%s%d" % (n, causal)] = _np(g)
        return out

    def gqa_op(_):
        mesh = make_mesh({"sp": world})
        q, k, v = (torch.tensor(a) for a in _qkv(1, 4, 8 * world, 8, Hkv=2))
        with _mesh_ctx.use_mesh(mesh):
            o = _flash_attention_op(q, k, v, causal=True, seq_axis="sp")
        return {"o": _np(o)}

    def symbol_ring(_):
        mesh = make_mesh({"sp": world})
        q, k, v = (mx.sym.Variable(n) for n in "qkv")
        sym = mx.sym.contrib.FlashAttention(q, k, v, causal=True,
                                            seq_axis="sp")
        fn = _graph_eval_fn(sym, mesh=mesh)
        args = dict(zip("qkv", (torch.tensor(a)
                                for a in _qkv(2, 2, 8 * world, 8))))
        before = telemetry.counter(_comm.STAGED_BYTES).value
        return {"o": _np(fn(args, {}, 0, False)[0][0]),
                "staged": np.array(telemetry.counter(
                    _comm.STAGED_BYTES).value - before)}

    def ring_window(_):
        mesh = make_mesh({"sp": world})
        out = {}
        for window in (1, 5, 8, 13, 24):
            q, k, v = (torch.tensor(a, requires_grad=True)
                       for a in _qkv(1, 2, 8 * world, 8, seed=window))
            o = ring_attention(q, k, v, mesh, "sp", causal=True,
                               window=window)
            out["o%d" % window] = _np(o)
            if window in (5, 13):
                grads = torch.autograd.grad(o.sum(), (q, k, v))
                for n, g in zip("qkv", grads):
                    out["d%s%d" % (n, window)] = _np(g)
        return out

    def moe_oracle(_):
        mesh = make_mesh({"expert": world})
        n, E, D, H, T = world, 8, 16, 32, 64
        x, gw, w1, w2 = (torch.tensor(a, requires_grad=True) for a in (
            _f32((T, D), 0), _f32((D, E), 1, 0.5), _f32((E, D, H), 2, 0.2),
            _f32((E, H, D), 3, 0.2)))
        o = moe_ffn(x, gw, w1, w2, mesh)
        grads = torch.autograd.grad(o.square().sum(), (x, gw, w1, w2))
        ids = torch.cat([_route(c, gw, E, 1)[0]
                         for c in x.detach().chunk(n)])
        out = {"o": _np(o), "expert": ids.numpy()}
        out.update({"g%d" % i: _np(g) for i, g in enumerate(grads)})
        return out

    def pipe(_):
        mesh = make_mesh({"pipe": world})
        S, M, MB, D = world, 6, 4, 16
        Ws, bs, x = (torch.tensor(a) for a in (
            _f32((S, D, D), 0, 0.3), _f32((S, D), 1, 0.1),
            _f32((M, MB, D), 2)))
        o = pipeline_apply(lambda p, h: torch.tanh(h @ p[0] + p[1]),
                           (Ws, bs), x, mesh)
        return {"o": _np(o)}

    def pipe_grad(_):
        mesh = make_mesh({"pipe": world})
        S, M, MB, D = world, 4, 2, 8
        Ws, bs, x = (torch.tensor(a, requires_grad=True) for a in (
            _f32((S, D, D), 10, 0.3), _f32((S, D), 11, 0.1),
            _f32((M, MB, D), 12)))
        o = pipeline_apply(lambda p, h: torch.tanh(h @ p[0] + p[1]),
                           (Ws, bs), x, mesh)
        grads = torch.autograd.grad(o.square().sum(), (Ws, bs, x))
        return {"g%d" % i: _np(g) for i, g in enumerate(grads)}

    def pipe_symbol(inputs_dir):
        from mxnet_tpu_torch.models import transformer
        mesh = make_mesh({"pipe": world})
        blob = np.load(os.path.join(inputs_dir, "pipe_symbol.npz"))
        stacked = {k: torch.tensor(blob[k]) for k in blob.files
                   if k != "stream"}
        o = pipeline_from_symbol(transformer.get_stage_symbol(
            num_heads=2, dim=16), stacked, torch.tensor(blob["stream"]),
            mesh)
        return {"o": _np(o)}

    def train(name, axes, zero=None, compute_dtype=None, steps=None):
        def run(inputs_dir):
            mesh = make_mesh(axes)
            step, state, full, outs = _run_train(
                name, mesh, inputs_dir, zero=zero,
                compute_dtype=compute_dtype, steps=steps)
            out = {"p:" + k: _np(v) for k, v in full[0].items()}
            out.update({"a:" + k: _np(v) for k, v in full[2].items()})
            out.update({"out%d" % i: _np(o) for i, o in enumerate(outs)})
            out.update({"local:" + k: np.array(v.shape)
                        for k, v in state[0].items()})
            out.update({"olocal:" + k: np.array(v[0].shape)
                        for k, v in state[1].items() if v})
            if zero:
                # the replicated update on the same mesh, for bit-equality
                _, _, rep, _ = _run_train(name, mesh, inputs_dir,
                                          compute_dtype=compute_dtype,
                                          steps=steps)
                out.update({"rep:" + k: _np(v)
                            for k, v in rep[0].items()})
            return out
        return run

    def moe_data_expert_zero1(inputs_dir):
        """{'data': 2, 'expert': 2} with ZeRO-1: expert weights split over
        'expert' and their Adam state also over 'data'; 60 steps on the
        arithmetic corpus halve the loss (the JAX package's gate)."""
        from mxnet_tpu_torch.models import transformer
        from mxnet_tpu_torch.parallel import make_train_step
        from mxnet_tpu_torch.initializer import Xavier
        sys.path.insert(0, REPO)
        from tests._lm_utils import arith_corpus
        mesh = make_mesh({"data": 2, "expert": 2})
        vocab, T, B = 32, 16, 16
        sym = transformer.get_symbol(vocab, T, num_layers=1, num_heads=2,
                                     dim=32, num_experts=8,
                                     expert_axis="expert")
        with mx.cpu():
            step = make_train_step(sym, optimizer="adam", mesh=mesh,
                                   optimizer_sharding="zero1")
            mx.random.seed(0)
            state = step.init_state(Xavier(), {"data": (B, T),
                                               "softmax_label": (B, T)})
            toks, labels = arith_corpus(B, T, vocab)
            batch = step.place_batch({"data": toks,
                                      "softmax_label": labels})
            lab = batch["softmax_label"].numpy()
            nll = []
            for _ in range(61):
                state, outs = step(state, batch, 3e-3, 0)
                pr = outs[0].detach().numpy().reshape(-1, T, vocab)
                b, t = np.nonzero(lab >= 0)
                nll.append(-np.log(np.maximum(
                    pr[b, t, lab[b, t].astype(int)], 1e-9)).mean())
        w1 = "layer0_experts_w1_weight"
        return {"nll": np.array(nll),
                "w1_spec": np.array(step._pspec[w1] == ("expert",)),
                "m1_spec": np.array(step._ospec[w1] == ("expert", "data")),
                "w1_local": np.array(state[0][w1].shape),
                "m1_local": np.array(state[1][w1][0].shape)}

    def bn_routes(_):
        """The kernel route's plain twin (MXNET_BN_PALLAS) and the one-pass
        route of a training BatchNorm under data=2: each rank's rows of
        the output and of dx, the summed dgamma and dbeta, the moving
        stats."""
        from mxnet_tpu_torch import config
        from mxnet_tpu_torch.ops.nn import _batch_norm
        mesh = make_mesh({"data": world})
        x, cot = _f32(BN_SHAPE, 51, 1.5) + 0.3, _f32(BN_SHAPE, 52)
        C = BN_SHAPE[1]
        rows = BN_SHAPE[0] // world
        mine = slice(rows * dist.rank(), rows * (dist.rank() + 1))
        out = {}
        for route, knob, val in (("kernels", "MXNET_BN_PALLAS", True),
                                 ("onepass", "MXNET_BN_IMPL", "onepass")):
            config.set_override(knob, val)
            try:
                tx = torch.tensor(x[mine], requires_grad=True)
                tg = torch.tensor(np.abs(_f32((C,), 53)) + 0.5,
                                  requires_grad=True)
                tb = torch.tensor(_f32((C,), 54), requires_grad=True)
                with _mesh_ctx.use_mesh(mesh):
                    y, mm, mv = _batch_norm(
                        tx, tg, tb, torch.tensor(_f32((C,), 55)),
                        torch.tensor(np.abs(_f32((C,), 56)) + 0.5),
                        is_train=True, fix_gamma=False)
                    grads = torch.autograd.grad(
                        y, (tx, tg, tb), torch.tensor(cot[mine]))
            finally:
                config.set_override(knob, None)
            dg, db = grads[1].clone(), grads[2].clone()
            _comm.all_reduce_([dg, db], mesh, "data")
            out.update({route + "_y": _np(y), route + "_dx": _np(grads[0]),
                        route + "_dgamma": _np(dg),
                        route + "_dbeta": _np(db), route + "_mm": _np(mm),
                        route + "_mv": _np(mv)})
        return out

    def fit_dp(inputs_dir):
        """TrainStep.fit over data=2: the fused metric, the guardrail,
        clip_norm, a checkpoint each epoch (rank 0 writes) read back by
        load_state, and export."""
        return _run_fit(make_mesh({"data": world}), inputs_dir)

    if world == 2:
        return {"rank_size": rank_size, "ring": ring, "gqa_op": gqa_op,
                "fit_dp": fit_dp, "bn_routes": bn_routes,
                "symbol_ring": symbol_ring,
                "lm_sp": train("lm_sp", {"sp": 2}),
                "lm_expert": train("lm_expert", {"expert": 2}),
                "dp_mlp": train("dp_mlp", {"data": 2}),
                "dp_dropout": train("dp_dropout", {"data": 2}),
                "zero1": train("zero1", {"data": 2}, zero="zero1"),
                "bn_aux": train("bn_aux", {"data": 2}),
                "makeloss_batch": train("makeloss_batch", {"data": 2}),
                "makeloss_valid": train("makeloss_valid", {"data": 2})}
    return {"rank_size": rank_size, "ring_window": ring_window,
            "moe_oracle": moe_oracle, "pipe": pipe, "pipe_grad": pipe_grad,
            "pipe_symbol": pipe_symbol,
            "dp_sp_zero1": train("dp_sp_zero1", {"data": 2, "sp": 2},
                                 zero="zero1"),
            "lm_data_expert": train("lm_data_expert",
                                    {"data": 2, "expert": 2}, zero="zero1"),
            "moe_data_expert_zero1": moe_data_expert_zero1}


def _rank_main(rank, world, port, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from mxnet_tpu_torch.parallel import dist
    dist.init("127.0.0.1:%d" % port, world, rank, backend="gloo",
              timeout=COLLECTIVE_TIMEOUT_S)
    for name, fn in _rank_cases(world).items():
        base = os.path.join(out_dir, "%s.w%d.r%d" % (name, world, rank))
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
# the fixture: inputs, one launch of 2 ranks and one of 4
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_init(name):
    """The JAX package's init_state of a training case (seeded), as
    numpy params and aux."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.initializer import Xavier
    from mxnet_tpu.models import transformer
    from mxnet_tpu.parallel import make_train_step
    build, opt, opt_params, _, _ = TRAIN[name]
    step = make_train_step(build(jmx, transformer), optimizer=opt,
                           optimizer_params=opt_params)
    jmx.random.seed(7)
    np.random.seed(7)
    batch = _train_batch(name)
    state = step.init_state(Xavier(), {k: v.shape for k, v in
                                       batch.items()})
    return jax.tree_util.tree_map(np.asarray, state)


def _write_inputs(d):
    for name in TRAIN:
        params, _, aux = _jax_init(name)
        np.savez(os.path.join(d, name + ".npz"),
                 **{"p:" + k: v for k, v in params.items()},
                 **{"a:" + k: v for k, v in aux.items()})
    from mxnet_tpu.models import transformer
    stage = transformer.get_stage_symbol(num_heads=2, dim=16)
    shapes, _, _ = stage.infer_shape(data=(2, 8, 16))
    rng = np.random.RandomState(0)
    stacked = {n: (0.1 * rng.randn(4, *s)).astype(np.float32)
               for n, s in zip(stage.list_arguments(), shapes)
               if n != "data"}
    np.savez(os.path.join(d, "pipe_symbol.npz"),
             stream=rng.randn(4, 2, 8, 16).astype(np.float32), **stacked)


class _Ranks:
    def __init__(self, d):
        self.dir = d

    def get(self, name, world, rank=0):
        base = os.path.join(self.dir, "%s.w%d.r%d" % (name, world, rank))
        if os.path.exists(base + ".err"):
            with open(base + ".err") as f:
                pytest.fail("rank %d of %d failed %s:\n%s"
                            % (rank, world, name, f.read()))
        assert os.path.exists(base + ".npz"), \
            "rank %d of %d wrote no %s (see the launch log)" % (
                rank, world, name)
        with np.load(base + ".npz") as blob:
            return {k: blob[k] for k in blob.files}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_mesh"))
    _write_inputs(d)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("MXNET_DIST_BACKEND", None)
    procs = []
    for world in (2, 4):
        port = _free_port()
        for r in range(world):
            log = open(os.path.join(d, "launch.w%d.r%d.log" % (world, r)),
                       "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(r),
                 str(world), str(port), d], env=env, cwd=REPO,
                stdout=log, stderr=subprocess.STDOUT), log))
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
            failed.append((p.args[2:4], rc, log.name))
    for args, rc, name in failed:
        with open(name) as f:
            sys.stderr.write("rank %s exited %s:\n%s\n" % (args, rc,
                                                           f.read()[-4000:]))
    assert not failed, "rank launches failed: %r" % [
        (a, rc) for a, rc, _ in failed]
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


def _jax_train(name, mesh=None, steps=None):
    """The JAX step of a training case from its init: (params, aux,
    outputs) as numpy."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.models import transformer
    from mxnet_tpu.parallel import make_train_step
    build, opt, opt_params, lr, n = TRAIN[name]
    state = _jax_init(name)
    step = make_train_step(build(jmx, transformer), optimizer=opt,
                           optimizer_params=opt_params, mesh=mesh)
    state = step.init_state(None, {k: v.shape for k, v in
                                   _train_batch(name).items()},
                            arg_params=state[0], aux_params=state[2])
    batch = step.place_batch(_train_batch(name))
    for _ in range(steps or n):
        state, outs = step(state, batch, lr, jax.random.PRNGKey(0))
    return ({k: np.asarray(v) for k, v in state[0].items()},
            {k: np.asarray(v) for k, v in state[2].items()},
            [np.asarray(o, np.float32) for o in outs])


def _assert_grad(got, want, name=""):
    """rtol 1e-5, atol 1e-6 of the gradient's scale (its largest
    magnitude, at least 1): a float32 sum over many tokens rounds at
    that scale, not at the element's."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(want).max())),
        err_msg=name)


def _assert_params(got, want, tol=PARAMS):
    assert sorted(k[2:] for k in got if k.startswith("p:")) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["p:" + k], v, err_msg=k, **tol)


def _dense(q, k, v, causal, window=0):
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import _dense_with_lse
    B, H, T, D = q.shape
    r3 = lambda a: jnp.asarray(a).reshape(B * H, T, D)  # noqa: E731
    return np.asarray(_dense_with_lse(r3(q), r3(k), r3(v), D ** -0.5,
                                      causal, window)[0]).reshape(q.shape)


# ---------------------------------------------------------------------------
# tests: tests/test_parallel.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_rank_and_size(ranks, world):
    """dist.rank / dist.size on every rank; CPU tensors on gloo stage
    nothing."""
    for r in range(world):
        got = ranks.get("rank_size", world, r)
        assert int(got["rank"]) == r and int(got["size"]) == world
        assert int(got["mesh"]) == world and int(got["staged"]) == 0


def test_dist_rank_size_single_process():
    from mxnet_tpu_torch.parallel import dist
    assert dist.rank() == 0 and dist.size() == 1
    assert not dist.is_initialized()
    dist.init()               # a world of one: no group, no error
    assert not dist.is_initialized()


def test_train_step_dp_mesh_matches_single(ranks):
    """data=2 against the JAX single-device step of the global batch (the
    JAX mesh step's own reference): SGD, 5 steps."""
    want, _, _ = _jax_train("dp_mlp")
    for r in range(2):
        _assert_params(ranks.get("dp_mlp", 2, r), want)


def test_dropout_mask_is_the_global_batch_slice(ranks):
    """Dropout under data=2: each rank's mask is its rows of the mask the
    JAX package draws for the whole batch (the same parameters after two
    steps), and the ranks' outputs are the global outputs' rows."""
    want, _, outs = _jax_train("dp_dropout")
    got = [ranks.get("dp_dropout", 2, r) for r in range(2)]
    _assert_params(got[0], want)
    np.testing.assert_allclose(np.concatenate([g["out0"] for g in got]),
                               outs[0], **OUT)


def test_fit_on_a_data_mesh_matches_one_rank(ranks):
    """fit over data=2 (the device metric's sums and the guardrail's flag
    reduced over the axis, clip_norm on the summed gradients) against the
    same fit on one rank: the parameters and the epoch's accuracy; the
    checkpoint reads back bit for bit on the mesh, and the export holds
    the global arrays."""
    got = ranks.get("fit_dp", 2, 1)
    want = _run_fit(None, ranks.dir, tag="fit_single")
    _assert_params(got, {k[2:]: v for k, v in want.items()
                         if k.startswith("p:")})
    assert float(got["val"]) == float(want["val"])
    assert bool(got["loaded_equal"])
    with open(os.path.join(ranks.dir, "fit_export.train.meta.json")) as f:
        meta = json.load(f)
    blob = np.load(os.path.join(ranks.dir, "fit_export.state.npz"))
    assert blob["s%05d" % meta["param_names"].index("fc1_weight")].shape \
        == (32, 16)


def test_train_step_zero1_matches_replicated(ranks):
    """ZeRO-1 over data=2: bit for bit the replicated update (elementwise
    SGD-momentum update on each rank's slice), the momentum 1/2 a rank
    for the divisible parameters, and the JAX step's parameters."""
    got = ranks.get("zero1", 2, 0)
    for k in [k for k in got if k.startswith("rep:")]:
        np.testing.assert_array_equal(got["p:" + k[4:]], got[k], err_msg=k)
    assert tuple(got["olocal:fc1_weight"]) == (16, 16)
    assert tuple(got["local:fc1_weight"]) == (32, 16)
    assert tuple(got["olocal:fc2_bias"]) == (1,)
    want, _, _ = _jax_train("zero1")
    _assert_params(got, want)
    other = ranks.get("zero1", 2, 1)
    for k in want:
        np.testing.assert_array_equal(other["p:" + k], got["p:" + k])


def test_zero1_requires_data_axis():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import make_mesh, make_train_step
    with pytest.raises(ValueError, match="replica axis"):
        make_train_step(_mlp(mx), optimizer_sharding="zero1", ctx=mx.cpu())
    with pytest.raises(ValueError, match="replica axis"):
        make_train_step(_mlp(mx), optimizer_sharding="zero1", ctx=mx.cpu(),
                        mesh=make_mesh({"sp": 1}))
    with pytest.raises(ValueError):
        make_train_step(_mlp(mx), optimizer_sharding="bogus", ctx=mx.cpu())


def test_aux_state_threading_on_mesh(ranks):
    """BatchNorm under data=2: the whole batch's statistics (two-pass,
    summed over the axis) give the JAX step's parameters and moving
    stats, and the moving mean moved."""
    want, want_aux, _ = _jax_train("bn_aux")
    got = ranks.get("bn_aux", 2, 1)
    _assert_params(got, want)
    init = _jax_init("bn_aux")[2]["bn_moving_mean"]
    assert not np.allclose(init, got["a:bn_moving_mean"])
    for k, v in want_aux.items():
        np.testing.assert_allclose(got["a:" + k], v, err_msg=k, **PARAMS)


def test_bn_shifted_routes_refuse_a_data_axis(ranks):
    """The kernel and one-pass BatchNorm routes shift their sums, which
    ranks holding different rows would each take about their own first
    sample; under data=2 both take the global batch's first sample (data
    rank 0's) and all-reduce their shifted sums (ROADMAP Queue A item
    9b.2), so each rank's rows of y and dx, the summed dgamma and dbeta
    and the moving stats are the JAX BatchNorm's of the global batch."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg
    x, cot = _f32(BN_SHAPE, 51, 1.5) + 0.3, _f32(BN_SHAPE, 52)
    C = BN_SHAPE[1]
    gamma, beta = np.abs(_f32((C,), 53)) + 0.5, _f32((C,), 54)
    mm, mv = _f32((C,), 55), np.abs(_f32((C,), 56)) + 0.5
    jop = jreg.get_op("BatchNorm")
    jattrs = {**jreg.canon_attrs(jop, {"fix_gamma": False}),
              "is_train": True}
    (jy, jmm, jmv), vjp = jax.vjp(lambda a, g, b: jop.fn(
        a, g, b, jnp.asarray(mm), jnp.asarray(mv), **jattrs),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdg, jdb = vjp((jnp.asarray(cot), jnp.zeros(C), jnp.zeros(C)))
    got = [ranks.get("bn_routes", 2, r) for r in range(2)]
    for route in ("kernels", "onepass"):
        for key, want in (("y", jy), ("dx", jdx)):
            np.testing.assert_allclose(
                np.concatenate([g[route + "_" + key] for g in got]),
                np.asarray(want), rtol=1e-5, atol=1e-5,
                err_msg=route + " " + key)
        for g in got:
            for key, want in (("dgamma", jdg), ("dbeta", jdb),
                              ("mm", jmm), ("mv", jmv)):
                np.testing.assert_allclose(g[route + "_" + key],
                                           np.asarray(want), rtol=1e-5,
                                           atol=1e-5,
                                           err_msg=route + " " + key)


# ---------------------------------------------------------------------------
# tests: tests/test_attention.py
# ---------------------------------------------------------------------------

def _jax_ring(q, k, v, n, causal, window=0):
    from mxnet_tpu.parallel import ring_attention
    return ring_attention(q, k, v, _jmesh({"sp": n}), "sp", causal=causal,
                          window=window)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(ranks, causal):
    """The ring over sp=2 against the JAX ring on 2 devices, and its
    gradients against jax.grad through the JAX ring."""
    import jax
    import jax.numpy as jnp
    q, k, v = (jnp.asarray(a) for a in _qkv(1, 2, 16, 8))
    cot = jnp.asarray(_f32((1, 2, 16, 8), 9))
    o, grads = jax.jit(lambda a, b, c, ct: (lambda o, f: (o, f(ct)))(
        *jax.vjp(lambda x, y, z: _jax_ring(x, y, z, 2, causal), a, b, c)))(
            q, k, v, cot)
    for r in range(2):
        got = ranks.get("ring", 2, r)
        np.testing.assert_allclose(got["o%d" % causal], np.asarray(o),
                                   **OUT)
        np.testing.assert_allclose(got["o%d" % causal],
                                   _dense(q, k, v, causal), **OUT)
        for n, g in zip("qkv", grads):
            _assert_grad(got["d%s%d" % (n, causal)], g, n)


def test_gqa_through_flash_op_on_ring(ranks):
    """(B, 2, T, D) kv against (B, 4, T, D) q through the op over sp=2
    equals the dense GQA reference: the repeat happens before the
    ring."""
    q, k, v = _qkv(1, 4, 16, 8, Hkv=2)
    want = _dense(q, np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1),
                  True)
    for r in range(2):
        np.testing.assert_allclose(ranks.get("gqa_op", 2, r)["o"], want,
                                   **OUT)


def test_symbol_graph_rings_on_mesh(ranks):
    """FlashAttention(seq_axis='sp') in a graph evaluated over sp=2: the
    ring (the dense result), through the gloo transport of CPU tensors
    (nothing staged)."""
    q, k, v = _qkv(2, 2, 16, 8)
    got = ranks.get("symbol_ring", 2, 1)
    np.testing.assert_allclose(got["o"], _dense(q, k, v, True), **OUT)
    assert int(got["staged"]) == 0


def test_no_mesh_falls_back_to_flash():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.executor import _graph_eval_fn
    q, k, v = (mx.sym.Variable(n) for n in "qkv")
    sym = mx.sym.contrib.FlashAttention(q, k, v, causal=True, seq_axis="sp")
    qv, kv, vv = _qkv(1, 2, 32, 16)
    got = _graph_eval_fn(sym)({"q": torch.tensor(qv), "k": torch.tensor(kv),
                               "v": torch.tensor(vv)}, {}, 0, False)[0][0]
    np.testing.assert_allclose(_np(got), _dense(qv, kv, vv, True), **OUT)


def test_transformer_trains_sequence_parallel(ranks):
    """The LM with seq_axis over sp=2, one SGD step at lr 1 (w - w' is the
    gradient): the JAX step's parameters and probabilities."""
    want, _, outs = _jax_train("lm_sp")
    got = ranks.get("lm_sp", 2, 0)
    _assert_params(got, want)
    np.testing.assert_allclose(got["out0"], outs[0], **OUT)
    np.testing.assert_allclose(got["out0"].sum(axis=1), 1.0, rtol=1e-5)


def test_full_composition_dp_sp_zero1(ranks):
    """{'data': 2, 'sp': 2} with ZeRO-1, two SGD-momentum steps: the JAX
    step's parameters, and ZeRO-1 bit for bit the replicated update on
    the same mesh, on every rank."""
    want, _, _ = _jax_train("dp_sp_zero1")
    for r in range(4):
        got = ranks.get("dp_sp_zero1", 4, r)
        _assert_params(got, want)
        for k in want:
            np.testing.assert_array_equal(got["p:" + k], got["rep:" + k])
    assert tuple(got["olocal:layer0_qkv_weight"]) == (48, 32)


@pytest.mark.parametrize("window", [1, 5, 8, 13, 24])
def test_windowed_ring_matches_dense_banded(ranks, window):
    """The banded ring over sp=4 (blocks of 8 rows: a window under one
    block, one block, past one and past two) against the dense banded
    oracle; rows with no valid key in a far block weigh nothing."""
    q, k, v = _qkv(1, 2, 32, 8, seed=window)
    for r in (0, 3):
        np.testing.assert_allclose(
            ranks.get("ring_window", 4, r)["o%d" % window],
            _dense(q, k, v, True, window), **OUT)


@pytest.mark.parametrize("window", [5, 13])
def test_windowed_ring_gradients_match_dense_banded(ranks, window):
    import jax
    import jax.numpy as jnp
    q, k, v = (jnp.asarray(a) for a in _qkv(1, 2, 32, 8, seed=window))

    def dense(a, b, c):
        from mxnet_tpu.ops.attention import _dense_with_lse
        r3 = lambda x: x.reshape(2, 32, 8)  # noqa: E731
        return _dense_with_lse(r3(a), r3(b), r3(c), 8 ** -0.5, True,
                               window)[0].sum()

    want = jax.grad(dense, argnums=(0, 1, 2))(q, k, v)
    got = ranks.get("ring_window", 4, 2)
    for n, w in zip("qkv", want):
        _assert_grad(got["d%s%d" % (n, window)], w, n)


def test_window_requires_causal():
    from mxnet_tpu_torch.parallel import make_mesh, ring_attention
    q, k, v = (torch.tensor(a) for a in _qkv(1, 1, 16, 8))
    with pytest.raises(ValueError, match="causal"):
        ring_attention(q, k, v, make_mesh({"sp": 1}), "sp", causal=False,
                       window=4)


# ---------------------------------------------------------------------------
# tests: tests/test_pipeline_moe.py
# ---------------------------------------------------------------------------

def test_pipeline_matches_serial(ranks):
    """GPipe over pipe=4 against the JAX pipeline on 4 devices and the
    serial composition."""
    import jax.numpy as jnp
    from mxnet_tpu.parallel import pipeline_apply
    S, M, MB, D = 4, 6, 4, 16
    Ws, bs, x = _f32((S, D, D), 0, 0.3), _f32((S, D), 1, 0.1), \
        _f32((M, MB, D), 2)
    jout = pipeline_apply(lambda p, h: jnp.tanh(h @ p[0] + p[1]),
                          (jnp.asarray(Ws), jnp.asarray(bs)),
                          jnp.asarray(x), _jmesh({"pipe": 4}))
    ref = x
    for s in range(S):
        ref = np.tanh(ref @ Ws[s] + bs[s])
    for r in range(4):
        got = ranks.get("pipe", 4, r)["o"]
        np.testing.assert_allclose(got, np.asarray(jout), **OUT)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_pipeline_gradients_match_serial(ranks):
    import jax
    import jax.numpy as jnp
    S, M, MB, D = 4, 4, 2, 8
    params = (jnp.asarray(_f32((S, D, D), 10, 0.3)),
              jnp.asarray(_f32((S, D), 11, 0.1)))
    x = jnp.asarray(_f32((M, MB, D), 12))

    def serial(p, v):
        h = v
        for s in range(S):
            h = jnp.tanh(h @ p[0][s] + p[1][s])
        return jnp.sum(h ** 2)

    gp, gx = jax.grad(serial, argnums=(0, 1))(params, x)
    for r in (0, 3):
        got = ranks.get("pipe_grad", 4, r)
        for i, w in enumerate((gp[0], gp[1], gx)):
            _assert_grad(got["g%d" % i], w, str(i))


def test_moe_matches_routing_oracle(ranks):
    """moe_ffn over expert=4 (E 8, 64 tokens, per-rank capacity
    ceil(16 * 1.25 / 8) = 3): the JAX moe_ffn on 4 devices, the same
    expert ids, the replayed top-1 oracle of the JAX test, and the JAX
    gradients."""
    import math
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel import moe_ffn
    from mxnet_tpu.parallel.moe import _route
    n, E, D, H, T = 4, 8, 16, 32, 64
    args = [jnp.asarray(a) for a in (
        _f32((T, D), 0), _f32((D, E), 1, 0.5), _f32((E, D, H), 2, 0.2),
        _f32((E, H, D), 3, 0.2))]
    mesh = _jmesh({"expert": n})
    jout = jax.jit(lambda *a: moe_ffn(*a, mesh=mesh))(*args)
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(moe_ffn(*a, mesh=mesh) ** 2),
                              argnums=(0, 1, 2, 3)))(*args)
    x, gw, w1, w2 = (np.asarray(a) for a in args)
    Tl = T // n
    cap = max(1, int(math.ceil(Tl * 1.25 / E)))
    ref = np.zeros((T, D), np.float32)
    ids = []
    for d in range(n):
        e_ids = np.asarray(_route(args[0][d * Tl:(d + 1) * Tl], args[1], E,
                                  cap)[0])
        ids.append(e_ids)
        probs = np.asarray(jax.nn.softmax(args[0][d * Tl:(d + 1) * Tl]
                                          @ args[1], axis=-1))
        counts = {}
        for t in range(Tl):
            e = int(e_ids[t])
            counts[e] = counts.get(e, 0) + 1
            if counts[e] > cap:
                continue
            h = np.maximum(x[d * Tl + t] @ w1[e], 0)
            ref[d * Tl + t] = (h @ w2[e]) * probs[t].max()
    for r in (0, 2):
        got = ranks.get("moe_oracle", 4, r)
        np.testing.assert_array_equal(got["expert"], np.concatenate(ids))
        np.testing.assert_allclose(got["o"], np.asarray(jout), **OUT)
        np.testing.assert_allclose(got["o"], ref, rtol=2e-5, atol=2e-5)
        for i, w in enumerate(jgrads):
            _assert_grad(got["g%d" % i], w, str(i))


def test_moe_transformer_expert_axis_trains(ranks):
    """The MoE LM with expert_axis over expert=2 against the JAX step over
    a 2-device expert mesh (the same per-rank routing): one SGD step at
    lr 1; each rank holds 2 of the 4 experts' weights."""
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    import jax
    want, _, outs = _jax_train("lm_expert", mesh=jmake_mesh(
        {"expert": 2}, devices=jax.devices()[:2]))
    for r in range(2):
        got = ranks.get("lm_expert", 2, r)
        _assert_params(got, want)
        assert tuple(got["local:layer0_experts_w1_weight"]) == (2, 32, 128)
        np.testing.assert_allclose(got["out0"], outs[0], **OUT)


def test_pipeline_from_symbol_matches_sequential(ranks):
    """get_stage_symbol over pipe=4 against the four stages applied in
    turn by the JAX package's graph evaluator."""
    import jax
    from mxnet_tpu.executor import _graph_eval_fn
    from mxnet_tpu.models import transformer
    stage = transformer.get_stage_symbol(num_heads=2, dim=16)
    blob = np.load(os.path.join(ranks.dir, "pipe_symbol.npz"))
    eval_fn = _graph_eval_fn(stage)
    stream = blob["stream"]
    want = np.empty_like(stream)
    for m in range(stream.shape[0]):
        h = stream[m]
        for s in range(4):
            outs, _ = eval_fn({**{k: blob[k][s] for k in blob.files
                                  if k != "stream"}, "data": h}, {},
                              jax.random.PRNGKey(0), False)
            h = np.asarray(outs[0])
        want[m] = h
    for r in (0, 1):
        np.testing.assert_allclose(ranks.get("pipe_symbol", 4, r)["o"],
                                   want, rtol=1e-5, atol=1e-5)


def test_pipeline_from_symbol_validation():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import make_mesh, pipeline_from_symbol
    mesh = make_mesh({"pipe": 1})
    stage = transformer.get_stage_symbol(num_heads=2, dim=16)
    with pytest.raises(ValueError, match="missing"):
        pipeline_from_symbol(stage, {}, torch.zeros((2, 2, 8, 16)), mesh)
    bn = mx.sym.BatchNorm(mx.sym.Variable("data"), name="bn")
    with pytest.raises(ValueError, match="auxiliary"):
        pipeline_from_symbol(bn, {}, torch.zeros((2, 2, 8)), mesh)


def test_moe_lm_data_expert_zero1_matches_jax(ranks):
    """The MoE LM over {'data': 2, 'expert': 2} with ZeRO-1, two
    SGD-momentum steps, against the JAX step over the same mesh: every
    data rank routes the global tokens (JAX's in_specs=P('expert')), so
    the same tokens drop; the parameters, each data rank's rows of the
    outputs, and ZeRO-1 bit for bit the replicated update."""
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    import jax
    want, _, outs = _jax_train("lm_data_expert", mesh=jmake_mesh(
        {"data": 2, "expert": 2}, devices=jax.devices()[:4]))
    got = [ranks.get("lm_data_expert", 4, r) for r in range(4)]
    for g in got:
        _assert_params(g, want)
        for k in want:
            np.testing.assert_array_equal(g["p:" + k], g["rep:" + k])
        assert tuple(g["local:layer0_experts_w1_weight"]) == (2, 32, 128)
    # rank = 2 * data index + expert index
    np.testing.assert_allclose(np.concatenate([got[0]["out0"],
                                               got[2]["out0"]]),
                               outs[0], **OUT)


@pytest.mark.parametrize("normalization", ["batch", "valid"])
def test_makeloss_divides_by_the_whole_batch_on_a_data_mesh(
        ranks, normalization):
    """MakeLoss under data=2 takes its 'batch' and 'valid' divisors over
    the whole batch (a forward-time sum over the axis), so three SGD
    steps give the JAX single-device step's parameters."""
    name = "makeloss_" + normalization
    want, _, _ = _jax_train(name)
    for r in range(2):
        _assert_params(ranks.get(name, 2, r), want)


def test_moe_data_expert_zero1_composition(ranks):
    """{'data': 2, 'expert': 2} with ZeRO-1 (the JAX package's gate): the
    expert weights split over 'expert', their Adam state also over
    'data', and 60 steps halve the loss on every rank."""
    for r in range(4):
        got = ranks.get("moe_data_expert_zero1", 4, r)
        assert bool(got["w1_spec"]) and bool(got["m1_spec"])
        assert tuple(got["w1_local"]) == (4, 32, 128)
        assert tuple(got["m1_local"]) == (4, 16, 128)
        assert got["nll"][-1] < got["nll"][0] / 2, got["nll"][[0, -1]]


# ---------------------------------------------------------------------------
# one process: the mesh of one rank and the refusals
# ---------------------------------------------------------------------------

def test_one_rank_mesh_needs_no_group_and_checks_sizes():
    """A mesh whose axes multiply to 1 runs without a process group and
    its step is the plain step bit for bit; sizes that do not multiply
    to the world raise the actionable ValueError; the GSPMD axes (model,
    tp, fsdp), SpecLayout and dist.default_mesh() build one-rank meshes
    and layouts, and a compiled step over more ranks than one on CUDA
    raises naming NCCL."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.parallel import (SpecLayout, dist, make_mesh,
                                          make_train_step)
    mesh = make_mesh({"data": 1, "sp": -1})
    assert mesh.shape == {"data": 1, "sp": 1} and mesh.size == 1
    with pytest.raises(ValueError, match="multiply to the 1 ranks"):
        make_mesh({"data": 2})
    for axis in ("model", "tp", "fsdp"):
        m = make_mesh({axis: 1})
        assert m.shape == {axis: 1} and m.size == 1
    lay = SpecLayout(make_mesh({"data": 1, "fsdp": 1}), min_shard_size=0)
    assert lay.batch_axes == ("data", "fsdp")
    assert lay.spec_for("w", (4, 2)) == (("fsdp", None), "auto:fsdp@dim0")
    assert dist.default_mesh().shape == {"data": 1, "fsdp": 1}
    assert dist.default_mesh({"expert": 1}).shape == {"expert": 1}

    class TwoRanks:
        size = 2
        backend = "gloo"

    from mxnet_tpu_torch.parallel.trainer import CompiledTrainStep
    with pytest.raises(NotImplementedError, match="NCCL"):
        CompiledTrainStep.load("unused", ctx=mx.gpu(0), mesh=TwoRanks())
    X, y = _toy()
    res = []
    for m in (None, mesh):
        with mx.cpu():
            step = make_train_step(_mlp(mx), optimizer="adam", mesh=m)
            mx.random.seed(1)
            state = step.init_state(Xavier(), {"data": X.shape,
                                               "softmax_label": y.shape})
            state, _ = step(state, {"data": X, "softmax_label": y}, 0.1, 0)
            res.append(state[0])
    for k in res[0]:
        assert torch.equal(res[0][k], res[1][k]), k


def test_nccl_refuses_two_ranks_on_one_gpu_before_nccl_does():
    """dist.init with backend='nccl' on a host without CUDA raises and
    names gloo, before any group starts."""
    from mxnet_tpu_torch.parallel import dist
    if torch.cuda.is_available():
        pytest.skip("the refusal without CUDA is what runs here")
    with pytest.raises(ValueError, match="gloo"):
        dist.init("127.0.0.1:%d" % _free_port(), 2, 0, backend="nccl",
                  timeout=5)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
