"""The port's ``TrainStep.fit`` against the JAX package's, on the CPU.

A small LM (vocab 40, T 16, 2 layers, 2 heads, dim 32, batch 4, three
batches an epoch) and a toy MLP go through both packages' fit from one
state (the JAX ``init_state`` under one seed, adopted through
``arg_params``), the same ``NDArrayIter`` data and scheduler.
Tolerances: SGD-momentum weights within rtol 1e-4 / atol 1e-6 (float32;
only summation order differs) and the fused Perplexity within 1e-5
relative; with Adam, whose first steps move every weight by about +-lr
whatever the size of g (a g near 0 can change sign on rounding alone),
at most ADAM_OFF_FRACTION of the weights outside those float32
tolerances after six steps, and none by more than lr / 10.

The port's own contracts, after ``tests/test_hotloop.py`` and
``tests/test_guardrail.py``: the fused (device) and host metric paths
agree within 1e-5 and an epoch makes at most one blocking host sync a
step plus one a ``metric.get()``; ``nan@N`` masks the same steps as the
JAX fit, the masked step leaves every parameter and optimizer state bit
for bit as it was, and the metric's count drops that batch; static and
dynamic loss scaling; rollback, its exhaustion and the typed
divergence, the rollback lr factor; ``sigterm@N`` writes the boundary
checkpoint and a resumed fit lands on the uninterrupted run's weights
bit for bit; a torn checkpoint is skipped; a checkpoint written by either
package loads in the other (bf16 entries included); a mismatched one
fails loudly; ``remat=True`` equals ``remat=False``.
"""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import io as jio
from mxnet_tpu import lr_scheduler as jls
from mxnet_tpu import metric as jmetric
from mxnet_tpu.initializer import Xavier as JXavier
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.parallel import make_train_step as jmake_train_step
from mxnet_tpu.parallel.resilience import (
    FaultInjector as JFaultInjector,
    install_fault_injector as jinstall)

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import guardrail as tguardrail
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import lr_scheduler as tls
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import profiler as tprofiler
from mxnet_tpu_torch.initializer import Xavier as TXavier
from mxnet_tpu_torch.models import transformer as ttransformer
from mxnet_tpu_torch.parallel import make_train_step as tmake_train_step
from mxnet_tpu_torch.parallel.resilience import (
    FaultInjector as TFaultInjector,
    install_fault_injector as tinstall)

V, T, LAYERS, HEADS, DIM, B = 40, 16, 2, 2, 32, 4
F32 = dict(rtol=1e-4, atol=1e-6)
# Adam: the share of weights allowed outside F32 (measured: 0.31%,
# 90 of 28584; a beta1, beta2 or epsilon off by under 1% puts 97-99.9%
# outside)
ADAM_OFF_FRACTION = 0.01


@pytest.fixture(autouse=True)
def _clean():
    yield
    jinstall(None)
    tinstall(None)
    tconfig.clear_override()


def _lm_data(n_batches=3, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, V, (B * n_batches, T)).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


@pytest.fixture(scope="module")
def lm():
    """(JAX symbol, port symbol, initial params as numpy)."""
    jsym = jtransformer.get_symbol(V, T, num_layers=LAYERS,
                                   num_heads=HEADS, dim=DIM)
    tsym = ttransformer.get_symbol(V, T, num_layers=LAYERS,
                                   num_heads=HEADS, dim=DIM)
    jmx.random.seed(3)
    params = jmake_train_step(jsym, optimizer="sgd").init_state(
        JXavier(), {"data": (B, T), "softmax_label": (B, T)})[0]
    return jsym, tsym, {k: np.asarray(v) for k, v in params.items()}


def _np(x):
    if hasattr(x, "detach"):
        return x.detach().float().numpy().copy()
    return np.array(x, np.float32)


def _fit_both(lm, optimizer, opt_params, lr, epochs=2, fault=None):
    jsym, tsym, params = lm
    toks, labels = _lm_data()
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            step = jmake_train_step(jsym, optimizer=optimizer,
                                    optimizer_params=dict(opt_params))
            it = jio.NDArrayIter(toks, labels, batch_size=B)
            sched, m = jls.FactorScheduler(step=2, factor=0.5), \
                jmetric.Perplexity(ignore_label=-1)
            inj = jinstall(JFaultInjector(fault)) if fault else None
        else:
            step = tmake_train_step(tsym, optimizer=optimizer,
                                    optimizer_params=dict(opt_params),
                                    ctx=tmx.cpu())
            with tmx.cpu():
                it = tio.NDArrayIter(toks, labels, batch_size=B)
            sched, m = tls.FactorScheduler(step=2, factor=0.5), \
                tmetric.Perplexity(ignore_label=-1)
            inj = tinstall(TFaultInjector(fault)) if fault else None
        sched.base_lr = lr
        state, val = step.fit(it, num_epoch=epochs, lr=lr,
                              lr_scheduler=sched, eval_metric=m,
                              arg_params=params, seed=1)
        out.append({"params": {k: _np(v) for k, v in state[0].items()},
                    "val": val, "report": step.guard_report,
                    "num": float(np.asarray(m._dev_stats["num"])),
                    "fired": list(inj.fired) if inj else None})
    return out


def test_fit_lm_sgd_matches_jax(lm):
    j, t = _fit_both(lm, "sgd", {"momentum": 0.9, "wd": 1e-4}, 0.5)
    assert t["val"] == pytest.approx(j["val"], rel=1e-5)
    assert t["num"] == j["num"] == 3 * B * (T - 1)
    for n, w in j["params"].items():
        np.testing.assert_allclose(t["params"][n], w, err_msg=n, **F32)


def test_fit_lm_adam_matches_jax(lm):
    lr = 1e-2
    j, t = _fit_both(lm, "adam", {}, lr)
    assert t["val"] == pytest.approx(j["val"], rel=1e-4)
    want = np.concatenate([w.ravel() for w in j["params"].values()])
    got = np.concatenate([t["params"][n].ravel() for n in j["params"]])
    off = np.abs(got - want) > F32["atol"] + F32["rtol"] * np.abs(want)
    assert off.mean() <= ADAM_OFF_FRACTION, off.mean()
    np.testing.assert_allclose(got, want, rtol=0, atol=lr / 10)


def test_fit_lm_nan_masks_the_same_steps(lm):
    """nan@2 and nan@5 (one in each epoch): both fits mask the same
    steps, report them, and count only the unmasked batches."""
    j, t = _fit_both(lm, "sgd", {"momentum": 0.9}, 0.5,
                     fault="nan@2;nan@5")
    assert t["fired"] == j["fired"] == [("nan", 2, "nan"),
                                        ("nan", 5, "nan")]
    assert t["report"] == j["report"] == {"masked_steps": 2,
                                          "rollbacks": 0, "lr_mult": 1.0}
    assert t["num"] == j["num"] == 2 * B * (T - 1)
    assert t["val"] == pytest.approx(j["val"], rel=1e-5)
    for n, w in j["params"].items():
        np.testing.assert_allclose(t["params"][n], w, err_msg=n, **F32)


# ---------------------------------------------------------------------------
# the port's fit on a toy MLP (tests/test_hotloop.py, test_guardrail.py)
# ---------------------------------------------------------------------------

def _mlp(mx):
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, name="fc1", num_hidden=32)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=2)
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _toy(n=96, d=16, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X @ rng.standard_normal(d) > 0).astype(np.float32)
    return X, y


def _step(**kw):
    kw.setdefault("optimizer", "sgd")
    kw.setdefault("optimizer_params", {"rescale_grad": 1.0 / 32})
    return tmake_train_step(_mlp(tmx), ctx=tmx.cpu(), **kw)


def _train(X=None, y=None, batch_size=32):
    if X is None:
        X, y = _toy()
    with tmx.cpu():
        return tio.NDArrayIter(X, y, batch_size=batch_size)


def _snapshot(state):
    params, opt, aux = state
    return ({k: v.clone() for k, v in params.items()},
            {k: tuple(s.clone() for s in v) for k, v in opt.items()},
            {k: v.clone() for k, v in aux.items()})


def _bit_equal(a, b):
    pa, oa, xa = a
    pb, ob, xb = b
    return (all(torch.equal(pa[k], pb[k]) for k in pa)
            and all(torch.equal(x, y) for k in oa
                    for x, y in zip(oa[k], ob[k]))
            and all(torch.equal(xa[k], xb[k]) for k in xa))


def test_fused_and_host_metric_paths_agree_and_sync_budget():
    X, y = _toy()

    def run(fuse):
        tmx.random.seed(11)
        step = _step(optimizer_params={"momentum": 0.9,
                                       "rescale_grad": 1.0 / 32})
        _, acc = step.fit(_train(X, y), num_epoch=4,
                          initializer=TXavier(), lr=0.5, seed=3,
                          fuse_metric=fuse)
        return acc
    fused, host = run(True), run(False)
    assert abs(fused - host) <= 1e-5 and fused > 0.9
    # one epoch: at most one blocking host sync a step (the window's
    # wait) plus the epoch-end metric read; the same with a nan@2 step
    step = _step()
    state, _ = step.fit(_train(), num_epoch=1, initializer=TXavier(),
                        lr=0.1)
    counts = []
    for spec in (None, "nan@2"):
        if spec:
            tinstall(TFaultInjector(spec))
        base = tprofiler.host_sync_count()
        state, _ = step.fit(_train(), num_epoch=1, state=state, lr=0.1)
        counts.append(tprofiler.host_sync_count() - base)
    assert counts[0] == counts[1] <= 3 + 1, counts


def test_nan_step_leaves_state_bit_equal_and_metric_excludes():
    """nan@2 of 3: the masked step leaves params, optimizer state and aux
    bit for bit as they were (read through the batch-end callback's
    ``locals``), the weights stay finite, and the metric counts the two
    unmasked batches only."""
    inj = tinstall(TFaultInjector("nan@2"))
    m = tmetric.create("ce")
    step = _step(optimizer_params={"momentum": 0.9,
                                   "rescale_grad": 1.0 / 32})
    snaps = []
    state, _ = step.fit(_train(), num_epoch=1, initializer=TXavier(),
                        lr=0.5, eval_metric=m,
                        batch_end_callback=lambda p: snaps.append(
                            _snapshot(p.locals["state"])))
    assert inj.fired == [("nan", 2, "nan")]
    assert step.guard_report["masked_steps"] == 1
    assert _bit_equal(snaps[0], snaps[1])
    assert not _bit_equal(snaps[1], snaps[2])
    for name, p in state[0].items():
        assert torch.isfinite(p).all(), name
    assert float(m._dev_stats["num"]) == 64.0


def test_guardrail_off_restores_unguarded_loop():
    tconfig.set_override("MXNET_GUARDRAIL", False)
    step = _step()
    _, acc = step.fit(_train(), num_epoch=6, initializer=TXavier(),
                      lr=0.5)
    assert acc > 0.9 and step.guard_report == {}


def test_dynamic_loss_scaler_rule_and_env():
    s = tguardrail.DynamicLossScaler(init_scale=1024.0, window=2)
    scale, good = torch.tensor(1024.0), torch.tensor(0.0)
    ok, bad = torch.tensor(True), torch.tensor(False)
    scale, good = s.next_state(scale, good, bad)
    assert float(scale) == 512.0 and float(good) == 0.0
    scale, good = s.next_state(scale, good, ok)
    assert float(scale) == 512.0 and float(good) == 1.0
    scale, good = s.next_state(scale, good, ok)
    assert float(scale) == 1024.0 and float(good) == 0.0
    static = tguardrail.DynamicLossScaler(init_scale=8.0, dynamic=False)
    s2, g2 = static.next_state(scale, good, bad)
    assert s2 is scale and g2 is good
    assert tguardrail.DynamicLossScaler.from_env() is None
    tconfig.set_override("MXNET_LOSS_SCALE", "dynamic")
    assert tguardrail.DynamicLossScaler.from_env().dynamic
    tconfig.set_override("MXNET_LOSS_SCALE", "1000")
    snapped = tguardrail.DynamicLossScaler.from_env()
    assert not snapped.dynamic and snapped.init_scale == 1024.0


def test_static_loss_scale_parity():
    """A power-of-two static scale rides the head cotangent and unscales
    exactly: the weights equal the unscaled run's bit for bit."""
    X, y = _toy()

    def run(scale):
        tconfig.set_override("MXNET_LOSS_SCALE", scale)
        tmx.random.seed(11)
        step = _step()
        state, acc = step.fit(_train(X, y), num_epoch=3,
                              initializer=TXavier(), lr=0.5, seed=3)
        tconfig.clear_override("MXNET_LOSS_SCALE")
        return state, acc
    (s0, a0), (s1, a1) = run(None), run("1024")
    assert a0 == a1
    assert float(s1[2][tguardrail.SCALE_KEY]) == 1024.0
    for k in s0[0]:
        assert torch.equal(s0[0][k], s1[0][k]), k


def test_dynamic_scale_halves_on_overflow_like_jax(tmp_path):
    """nan@2 halves the dynamic scale in both packages; the scaler state
    rides the checkpoint and loads back."""
    X, y = _toy()
    scales = []
    for pkg in ("jax", "torch"):
        pfx = str(tmp_path / pkg)
        if pkg == "jax":
            from mxnet_tpu import config as jconfig
            jconfig.set_override("MXNET_LOSS_SCALE", "dynamic")
            jinstall(JFaultInjector("nan@2"))
            step = jmake_train_step(_mlp(jmx), optimizer="sgd",
                                    optimizer_params={"rescale_grad":
                                                      1.0 / 32})
            try:
                state, _ = step.fit(jio.NDArrayIter(X, y, batch_size=32),
                                    num_epoch=1, initializer=JXavier(),
                                    lr=0.5, checkpoint_prefix=pfx)
            finally:
                jconfig.clear_override("MXNET_LOSS_SCALE")
        else:
            tconfig.set_override("MXNET_LOSS_SCALE", "dynamic")
            tinstall(TFaultInjector("nan@2"))
            step = _step()
            state, _ = step.fit(_train(X, y), num_epoch=1,
                                initializer=TXavier(), lr=0.5,
                                checkpoint_prefix=pfx)
            loaded = step.load_state(pfx + "_0000")
            assert float(loaded[2][tguardrail.SCALE_KEY]) == 2.0 ** 15
        scales.append(float(np.asarray(state[2][tguardrail.SCALE_KEY])))
    assert scales == [2.0 ** 15, 2.0 ** 15]


def test_rollback_then_recovery_and_lr_factor_like_jax(tmp_path):
    """MXNET_MAX_BAD_STEPS 2 and nan@1x3 after two clean epochs: both
    packages roll back once to the newest checkpoint, apply the lr
    factor, recover, and report the same masked steps (the third
    poisoned step's flag is dropped with the window at the rollback)."""
    from mxnet_tpu import config as jconfig
    X, y = _toy()
    reports = []
    for pkg in ("jax", "torch"):
        pfx = str(tmp_path / pkg)
        cfg = jconfig if pkg == "jax" else tconfig
        cfg.set_override("MXNET_MAX_BAD_STEPS", 2)
        cfg.set_override("MXNET_ROLLBACK_LR_FACTOR", 0.5)
        try:
            if pkg == "jax":
                step = jmake_train_step(_mlp(jmx), optimizer="sgd",
                                        optimizer_params={"rescale_grad":
                                                          1.0 / 32})
                train = jio.NDArrayIter(X, y, batch_size=32)
                init, install, inj = JXavier(), jinstall, JFaultInjector
            else:
                step, train = _step(), _train(X, y)
                init, install, inj = TXavier(), tinstall, TFaultInjector
            step.fit(train, num_epoch=2, initializer=init, lr=0.5,
                     checkpoint_prefix=pfx)
            install(inj("nan@1x3"))
            state, acc = step.fit(train, num_epoch=4, lr=0.5,
                                  checkpoint_prefix=pfx)
            install(None)
        finally:
            cfg.clear_override("MXNET_MAX_BAD_STEPS")
            cfg.clear_override("MXNET_ROLLBACK_LR_FACTOR")
        assert acc is not None and np.isfinite(acc)
        for name, p in state[0].items():
            assert np.isfinite(_np(p)).all(), name
        reports.append(step.guard_report)
    assert reports[1] == reports[0]
    assert reports[1]["rollbacks"] == 1 and reports[1]["lr_mult"] == 0.5


def test_rollback_exhaustion_and_no_checkpoint_are_typed(tmp_path):
    tconfig.set_override("MXNET_MAX_BAD_STEPS", 2)
    tconfig.set_override("MXNET_MAX_ROLLBACKS", 1)
    pfx = str(tmp_path / "ck")
    step = _step()
    step.fit(_train(), num_epoch=1, initializer=TXavier(), lr=0.5,
             checkpoint_prefix=pfx)
    tinstall(TFaultInjector("nan@1x*"))
    with pytest.raises(tguardrail.NumericalDivergence):
        step.fit(_train(), num_epoch=3, lr=0.5, checkpoint_prefix=pfx)
    tinstall(TFaultInjector("nan@1x*"))
    with pytest.raises(tguardrail.NumericalDivergence,
                       match="no checkpoint"):
        _step().fit(_train(), num_epoch=2, initializer=TXavier(), lr=0.5)


def test_sigterm_boundary_checkpoint_and_resume(tmp_path):
    """sigterm@2 (a real signal through the chaining handler): fit exits
    EXIT_PREEMPTED with a boundary checkpoint recording the exact step;
    a rerun resumes there, runs exactly the remaining steps, and lands on
    the uninterrupted run's weights bit for bit."""
    X, y = _toy()
    tmx.random.seed(5)
    ref, _ = _step().fit(_train(X, y), num_epoch=3, initializer=TXavier(),
                         lr=0.5)
    pfx = str(tmp_path / "ck")
    tinstall(TFaultInjector("sigterm@2"))
    tmx.random.seed(5)
    with pytest.raises(SystemExit) as exc:
        _step().fit(_train(X, y), num_epoch=3, initializer=TXavier(),
                    lr=0.5, checkpoint_prefix=pfx)
    tinstall(None)
    assert exc.value.code == tguardrail.EXIT_PREEMPTED
    with open(pfx + "_0000.meta.json") as f:
        assert json.load(f) == {"n_update": 1, "epoch": 0, "nbatch": 1}
    state, acc = _step().fit(_train(X, y), num_epoch=3,
                             initializer=TXavier(), lr=0.5,
                             checkpoint_prefix=pfx)
    with open(pfx + "_0002.meta.json") as f:
        assert json.load(f)["n_update"] == 9
    assert acc is not None
    for k in ref[0]:
        assert torch.equal(ref[0][k], state[0][k]), k


def test_resume_skips_a_torn_checkpoint_and_mismatch_fails(tmp_path):
    pfx = str(tmp_path / "ck")
    step = _step()
    step.fit(_train(), num_epoch=2, initializer=TXavier(), lr=0.5,
             checkpoint_prefix=pfx)
    with open(pfx + "_0002.npz", "wb") as f:
        f.write(b"PK\x03\x04torn")
    resumed = []
    _step().fit(_train(), num_epoch=4, initializer=TXavier(), lr=0.5,
                checkpoint_prefix=pfx,
                epoch_end_callback=lambda e, s: resumed.append(e))
    assert resumed == [2, 3]
    assert _step().load_state(pfx + "_0002") is not None
    # another optimizer's slots, another model's params: loud failures
    with pytest.raises(ValueError, match="optimizer slots"):
        _step(optimizer="adam").load_state(pfx + "_0002")
    other = tmake_train_step(tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), name="zzz", num_hidden=2),
        name="softmax"), ctx=tmx.cpu())
    with pytest.raises(ValueError, match="params"):
        other.load_state(pfx + "_0002")


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_checkpoints_load_across_packages(tmp_path, dtype):
    """save_state of either package loads in the other with the same
    values (the scaler's aux keys ride along); bf16 state, which the JAX
    package writes as ml_dtypes bfloat16 (2-byte void in ``.npz``), loads
    in the port as the same bf16 bits."""
    X, y = _toy()
    shapes = {"data": X.shape, "softmax_label": y.shape}
    jstep = jmake_train_step(_mlp(jmx), optimizer="adam")
    tstep = tmake_train_step(_mlp(tmx), optimizer="adam", ctx=tmx.cpu())
    jmx.random.seed(2)
    jstate = jstep.init_state(JXavier(), shapes, dtype=dtype)
    jstate = (jstate[0], jstate[1],
              {**jstate[2], tguardrail.SCALE_KEY: np.float32(256.0)})
    jstep.save_state(str(tmp_path / "j"), jstate)
    got = tstep.load_state(str(tmp_path / "j"))
    want_dtype = torch.bfloat16 if dtype else torch.float32
    for k, v in jstate[0].items():
        assert got[0][k].dtype == want_dtype
        np.testing.assert_array_equal(got[0][k].float().numpy(),
                                      np.asarray(v, np.float32))
    assert float(got[2][tguardrail.SCALE_KEY]) == 256.0
    # the port's file back: the JAX package reads float32 state
    tmx.random.seed(4)
    tstate = tstep.init_state(TXavier(), shapes)
    tstep.save_state(str(tmp_path / "t"), tstate)
    back = jstep.load_state(str(tmp_path / "t"))
    for k, v in tstate[0].items():
        np.testing.assert_array_equal(np.asarray(back[0][k]), v.numpy())
        for a, b in zip(back[1][k], tstate[1][k]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # and the port's own bf16 file round-trips bit for bit
    if dtype:
        tstep.save_state(str(tmp_path / "tb"), got)
        again = tstep.load_state(str(tmp_path / "tb"))
        for k, v in got[0].items():
            assert torch.equal(again[0][k].view(torch.int16),
                               v.view(torch.int16))


def test_fit_defaults_match_jax():
    """fit's defaults: Uniform(0.01) init, eval_metric 'acc', rescale
    1/batch, donate: the port's first epoch from the same numpy stream
    lands where the JAX fit does."""
    X, y = _toy()
    jmx.random.seed(9)
    tmx.random.seed(9)
    jstate, jacc = jmake_train_step(_mlp(jmx)).fit(
        jio.NDArrayIter(X, y, batch_size=32), num_epoch=2)
    tstep = tmake_train_step(_mlp(tmx), ctx=tmx.cpu())
    tstate, tacc = tstep.fit(_train(X, y), num_epoch=2)
    assert tacc == pytest.approx(jacc, abs=1e-6)
    for k, v in jstate[0].items():
        np.testing.assert_allclose(tstate[0][k].numpy(), np.asarray(v),
                                   **F32)


def test_remat_equals_plain(lm):
    """remat=True recomputes the forward in the backward: the step's
    outputs and updated parameters equal the plain step's bit for bit."""
    _, tsym, params = lm
    toks, labels = _lm_data(1)
    batch = {"data": toks, "softmax_label": labels}
    out = []
    for remat in (False, True):
        step = tmake_train_step(tsym, optimizer="adam", remat=remat,
                                ctx=tmx.cpu())
        assert step.remat == remat
        state = step.init_state(TXavier(), {k: v.shape
                                            for k, v in batch.items()},
                                arg_params=params)
        state, outs = step(state, batch, 1e-2, 0)
        out.append((outs[0], state[0]))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
    tconfig.set_override("MXNET_BACKWARD_DO_MIRROR", True)
    assert tmake_train_step(tsym, ctx=tmx.cpu()).remat


def test_prefetching_placer_feeds_fit():
    X, y = _toy()
    step = _step()
    with tmx.cpu():
        pf = tio.PrefetchingIter(tio.NDArrayIter(X, y, batch_size=32),
                                 place_fn=step.make_placer())
    batch = next(pf)
    assert set(batch.placed) == {"data", "softmax_label"}
    pf.reset()
    _, acc = step.fit(pf, num_epoch=6, initializer=TXavier(), lr=0.5)
    assert acc > 0.9


def test_fit_telemetry_and_trace_spans(tmp_path):
    """With a journal and a tracer on, fit writes one step record a step
    and the train.step span with its data/window-wait children, and adds
    no host sync."""
    from mxnet_tpu_torch import telemetry, trace
    step = _step()
    state, _ = step.fit(_train(), num_epoch=1, initializer=TXavier(),
                        lr=0.1)
    telemetry.start_journal(str(tmp_path / "j.jsonl"))
    trace.start_tracing(str(tmp_path / "t.jsonl"))
    try:
        base = tprofiler.host_sync_count()
        step.fit(_train(), num_epoch=1, state=state, lr=0.1)
        assert tprofiler.host_sync_count() - base <= 3 + 1
    finally:
        trace.stop_tracing()
        telemetry.close_journal()
    steps = [json.loads(x) for x in open(tmp_path / "j.jsonl")
             if '"step"' in x and '"loop"' in x]
    assert len([s for s in steps if s.get("kind") == "step"
                or "wall_ms" in s]) >= 3
    names = [json.loads(x).get("name") for x in open(tmp_path / "t.jsonl")]
    for want in ("train.step", "step.data_wait", "step.window_wait"):
        assert want in names, names
    assert os.path.getsize(tmp_path / "t.jsonl") > 0


def test_fit_donate_false_keeps_caller_state():
    """donate=False holds for fit's step too: the state passed in stays
    as it was."""
    X, y = _toy()
    step = _step(donate=False)
    state0 = step.init_state(TXavier(), {"data": X.shape,
                                         "softmax_label": y.shape})
    before = state0[0]["fc1_weight"].clone()
    state1, _ = step.fit(_train(X, y), num_epoch=1, state=state0, lr=0.5)
    assert torch.equal(state0[0]["fc1_weight"], before)
    assert not torch.equal(state1[0]["fc1_weight"], before)


def test_dispatch_ahead_one_and_the_env_default():
    """dispatch_ahead=1 is synchronous stepping and still trains; the
    window's default is MXNET_DISPATCH_AHEAD (2)."""
    assert tconfig.get("MXNET_DISPATCH_AHEAD") == 2
    step = _step(optimizer_params={"momentum": 0.9,
                                   "rescale_grad": 1.0 / 32})
    _, acc = step.fit(_train(), num_epoch=10, initializer=TXavier(),
                      lr=0.5, dispatch_ahead=1)
    assert acc > 0.9


def test_composite_metric_fuses_and_callbacks_read_it_mid_epoch():
    """A composite metric accumulates on the device too, and a batch-end
    callback's get() (the Speedometer pattern) reads the live totals."""
    seen = []

    def cb(param):
        names, values = param.eval_metric.get()
        seen.append((param.nbatch, names, values))
    step = _step()
    step.fit(_train(), num_epoch=2, initializer=TXavier(), lr=0.5,
             eval_metric=["acc", "ce"], batch_end_callback=cb)
    assert len(seen) == 6
    assert seen[-1][1] == ["accuracy", "cross-entropy"]
    assert all(np.isfinite(v) for v in seen[-1][2])


def test_guardrail_device_helpers_match_jax():
    """all_finite, mask_stats and check_and_mask: the same flags and
    masked values as the JAX package's."""
    from mxnet_tpu import guardrail as jguardrail
    rng = np.random.RandomState(0)
    grads = [rng.randn(3, 4).astype(np.float32),
             rng.randn(5).astype(np.float32)]
    outs = [rng.rand(2, 3).astype(np.float32)]
    for plant in (None, np.nan, np.inf):
        g = [x.copy() for x in grads]
        if plant is not None:
            g[1][2] = plant
        jok, jg = jguardrail.check_and_mask(g, outs)
        tok, tg = tguardrail.check_and_mask([torch.from_numpy(x) for x in g],
                                            [torch.from_numpy(o)
                                             for o in outs])
        assert bool(tok) == bool(jok) == (plant is None)
        assert bool(tguardrail.all_finite([torch.from_numpy(x)
                                           for x in g])) == bool(jok)
        for a, b in zip(tg, jg):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    stats = {"sum": torch.tensor(3.0), "num": torch.tensor(2.0)}
    masked = tguardrail.mask_stats([stats], torch.tensor(False))
    assert float(masked[0]["sum"]) == 0.0 and float(masked[0]["num"]) == 0.0
    assert tguardrail.mask_stats(stats, torch.tensor(True)) == stats
