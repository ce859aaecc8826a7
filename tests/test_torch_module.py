"""The port's Module API against the JAX package's, on the CPU (after
``tests/test_module.py``, ``tests/test_train_real_data.py`` and the
Module cases of ``tests/test_guardrail.py``).

Each JAX Module and its port twin start from the same numpy weights (one
``mx.random.seed``, whose initializer stream both packages share) and
read the same batches (numpy's global shuffle, reseeded for each).
Tolerances: parameters after N SGD updates within rtol 1e-5 / atol 1e-6,
outputs and input gradients within rtol 1e-5 / atol 1e-6 (float32; only
summation order differs). A Module over four contexts on the CPU
equals the JAX package's over four devices within rtol 1e-4 / atol 1e-5
(tests/test_module.py's tolerance). The port's own contracts: contexts
on distinct CUDA devices raise the item-9b.6 ``NotImplementedError``; a
checkpoint written by either
package's ``Module.save_checkpoint`` loads in the other; after three
updates a Module on a small ResNet with BatchNorm equals a float32
``TrainStep``'s parameters and moving stats bit for bit; a training
forward drops the previous step's graph. The digits fixture's cases are
in ``tests/test_torch_module_digits.py``.
"""
import gc
import json
import os
import weakref

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import io as jio
from mxnet_tpu.parallel.resilience import (
    FaultInjector as JFaultInjector, install_fault_injector as jinstall)

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch.parallel.resilience import (
    FaultInjector as TFaultInjector, install_fault_injector as tinstall)

TOL = dict(rtol=1e-5, atol=1e-6)


def _mlp_sym(mx, num_hidden=32, num_classes=2):
    data = mx.sym.Variable("data")
    net = mx.sym.Flatten(data=data)
    net = mx.sym.FullyConnected(data=net, name="fc1",
                                num_hidden=num_hidden)
    net = mx.sym.Activation(data=net, act_type="relu")
    net = mx.sym.FullyConnected(data=net, name="fc2",
                                num_hidden=num_classes)
    return mx.sym.SoftmaxOutput(data=net, name="softmax")


def _toy_data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 1, 8, 8)).astype(np.float32)
    w = rng.standard_normal(64)
    y = (X.reshape(n, -1) @ w > 0).astype(np.float32)
    return X, y


def _np_params(mod):
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


def _assert_params_close(tmod, jmod, tol=TOL):
    (ta, tx), (ja, jx) = _np_params(tmod), _np_params(jmod)
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], err_msg=k, **tol)
    for k in jx:
        np.testing.assert_allclose(tx[k], jx[k], err_msg=k, **tol)


def _fit_both(X, y, batch_size=32, shuffle=False, seed=0, **fit_kw):
    """The same Module.fit in both packages from one seed."""
    mods = []
    for mx, io, ctx in ((jmx, jio, jmx.cpu()), (tmx, tio, tmx.cpu())):
        with ctx:
            mx.random.seed(seed)
            np.random.seed(seed)
            train = io.NDArrayIter(X, y, batch_size=batch_size,
                                   shuffle=shuffle)
            mod = mx.mod.Module(_mlp_sym(mx), context=ctx)
            mod.fit(train, **fit_kw)
        mods.append(mod)
    return mods


def test_module_input_names_validation():
    with pytest.raises(ValueError):
        tmx.mod.Module(_mlp_sym(tmx), data_names=["wrong_name"])


def test_module_bind_forward_shapes():
    outs = []
    for mx, io, ctx in ((jmx, jio, jmx.cpu()), (tmx, tio, tmx.cpu())):
        with ctx:
            mx.random.seed(1)
            mod = mx.mod.Module(_mlp_sym(mx), context=ctx)
            mod.bind(data_shapes=[("data", (4, 1, 8, 8))],
                     label_shapes=[("softmax_label", (4,))])
            mod.init_params()
            batch = io.DataBatch(data=[mx.nd.ones((4, 1, 8, 8))],
                                 label=[mx.nd.zeros((4,))])
            mod.forward(batch, is_train=False)
            outs.append(mod.get_outputs()[0].asnumpy())
    assert outs[1].shape == (4, 2)
    np.testing.assert_allclose(outs[1].sum(axis=1), np.ones(4), rtol=1e-5)
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_module_train_convergence_matches_jax():
    """The convergence gate (reference tests/python/train/test_mlp.py),
    and the port's weights after 40 updates within TOL of the JAX
    Module's."""
    X, y = _toy_data()
    jmod, tmod = _fit_both(X, y, shuffle=True, num_epoch=5,
                           optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5,
                                             "momentum": 0.9},
                           eval_metric="acc")
    _assert_params_close(tmod, jmod, dict(rtol=1e-5, atol=1e-5))
    with tmx.cpu():
        train = tio.NDArrayIter(X, y, batch_size=32)
        score = tmod.score(train, "acc")
    assert score[0][1] > 0.95, score


def test_module_multi_device_matches_jax():
    """A Module over four contexts (kvstore 'device') reaches the JAX
    package's result over four devices (tests/test_module.py's
    multi-device parity test) and the port's own one-context result:
    one executor computes the whole batch in both packages."""
    X, y = _toy_data(n=128)

    def run(mx, io, ctxs, kvstore):
        with mx.cpu():
            mx.random.seed(42)
            np.random.seed(42)
            train = io.NDArrayIter(X, y, batch_size=32)
            mod = mx.mod.Module(_mlp_sym(mx), context=ctxs)
            mod.fit(train, num_epoch=3, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.5},
                    kvstore=kvstore, eval_metric="acc",
                    initializer=mx.init.Xavier())
        return _np_params(mod)[0]

    jax_multi = run(jmx, jio, [jmx.cpu(i) for i in range(4)], "device")
    multi = run(tmx, tio, [tmx.cpu(i) for i in range(4)], "device")
    single = run(tmx, tio, tmx.cpu(), "local")
    for k in jax_multi:
        np.testing.assert_allclose(multi[k], jax_multi[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(multi[k], single[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_module_multi_device_raises_naming_item_9(monkeypatch):
    """Duplicate contexts and a batch the contexts do not divide raise
    MXNetError (as the JAX package's mesh does); contexts on distinct
    CUDA devices in one process raise NotImplementedError naming item
    9b.6 (a machine with several GPUs)."""
    X, y = _toy_data(n=64)
    with tmx.cpu():
        train = tio.NDArrayIter(X, y, batch_size=30)
        for ctxs, what in (([tmx.cpu(0), tmx.cpu(0)], "duplicate"),
                           ([tmx.cpu(i) for i in range(4)], "divisible")):
            mod = tmx.mod.Module(_mlp_sym(tmx), context=ctxs)
            with pytest.raises(tmx.MXNetError, match=what):
                mod.bind(train.provide_data, train.provide_label)
        import torch
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        mod = tmx.mod.Module(_mlp_sym(tmx),
                             context=[tmx.gpu(0), tmx.gpu(1)])
        with pytest.raises(NotImplementedError, match="item 9b.6"):
            mod.bind(train.provide_data, train.provide_label)
        monkeypatch.undo()
        with pytest.raises(TypeError, match="SpecLayout"):
            tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu(),
                           layout=object()).bind(train.provide_data,
                                                 train.provide_label)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_module_checkpoint_roundtrip_both_ways(tmp_path, writer):
    """A checkpoint (symbol, params, optimizer states) written by either
    package's Module.save_checkpoint loads in the other's Module.load
    with the same values."""
    X, y = _toy_data(n=64)
    jmod, tmod = _fit_both(X, y, num_epoch=1, optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
    prefix = str(tmp_path / "model")
    src = jmod if writer == "jax" else tmod
    src.save_checkpoint(prefix, 1, save_optimizer_states=writer == "port")
    assert os.path.exists(prefix + "-symbol.json")
    assert os.path.exists(prefix + "-0001.params")
    want, want_aux = _np_params(src)
    for mx, io, ctx in ((jmx, jio, jmx.cpu()), (tmx, tio, tmx.cpu())):
        with ctx:
            train = io.NDArrayIter(X, y, batch_size=32)
            mod = mx.mod.Module.load(prefix, 1, context=ctx)
            mod.bind(data_shapes=train.provide_data,
                     label_shapes=train.provide_label)
            got, got_aux = _np_params(mod)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if writer == "port":
        with tmx.cpu():
            mod = tmx.mod.Module.load(prefix, 1, context=tmx.cpu(),
                                      load_optimizer_states=True)
            train = tio.NDArrayIter(X, y, batch_size=32)
            mod.bind(train.provide_data, train.provide_label)
            mod.init_optimizer(optimizer="sgd")
            assert mod._preload_opt_states is None


def test_module_predict_and_score_match_jax():
    X, y = _toy_data(n=64)
    jmod, tmod = _fit_both(X, y, batch_size=16, num_epoch=1)
    res = []
    for mx, io, mod, ctx in ((jmx, jio, jmod, jmx.cpu()),
                             (tmx, tio, tmod, tmx.cpu())):
        with ctx:
            train = io.NDArrayIter(X, y, batch_size=16)
            preds = mod.predict(train)
            res.append((preds.asnumpy(), mod.score(train, ["acc", "ce"])))
    assert res[1][0].shape == (64, 2)
    np.testing.assert_allclose(res[1][0], res[0][0], **TOL)
    assert len(res[1][1]) == 2
    for (jn, jv), (tn, tv) in zip(res[0][1], res[1][1]):
        assert jn == tn
        np.testing.assert_allclose(tv, jv, rtol=1e-5)


def test_module_input_grads_match_jax():
    grads = []
    for mx, io, ctx in ((jmx, jio, jmx.cpu()), (tmx, tio, tmx.cpu())):
        with ctx:
            mx.random.seed(2)
            mod = mx.mod.Module(_mlp_sym(mx), context=ctx)
            mod.bind(data_shapes=[("data", (4, 1, 8, 8))],
                     label_shapes=[("softmax_label", (4,))],
                     inputs_need_grad=True)
            mod.init_params(mx.init.Uniform(0.5))
            batch = io.DataBatch(
                data=[mx.nd.array(_toy_data(n=4)[0])],
                label=[mx.nd.zeros((4,))])
            mod.forward(batch, is_train=True)
            mod.backward()
            grads.append(mod.get_input_grads()[0].asnumpy())
    assert grads[1].shape == (4, 1, 8, 8)
    assert np.abs(grads[1]).sum() > 0
    np.testing.assert_allclose(grads[1], grads[0], **TOL)


def test_module_batch_size_reshape_preserves_params():
    """A forward with another batch size rebinds (reference
    module.py:forward) and keeps the trained parameters."""
    with tmx.cpu():
        mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
        mod.bind(data_shapes=[("data", (4, 1, 8, 8))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(tmx.init.Uniform(0.5))
        before = _np_params(mod)[0]
        batch = tio.DataBatch(data=[tmx.nd.ones((2, 1, 8, 8))],
                              label=[tmx.nd.zeros((2,))])
        mod.forward(batch, is_train=False)
        out = mod.get_outputs()[0]
        assert out.shape == (2, 2) and np.abs(out.asnumpy()).sum() > 0
        after = _np_params(mod)[0]
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)


def test_sequential_module_matches_jax():
    outs = []
    for mx, io, ctx in ((jmx, jio, jmx.cpu()), (tmx, tio, tmx.cpu())):
        with ctx:
            mx.random.seed(4)
            net1 = mx.sym.FullyConnected(mx.sym.Variable("data"),
                                         name="fc1", num_hidden=8)
            net2 = mx.sym.SoftmaxOutput(
                mx.sym.FullyConnected(mx.sym.Variable("fc1_output"),
                                      name="fc2", num_hidden=2),
                name="softmax")
            seq = mx.mod.SequentialModule()
            seq.add(mx.mod.Module(net1, label_names=None, context=ctx),
                    auto_wiring=True)
            seq.add(mx.mod.Module(net2, data_names=["fc1_output"],
                                  context=ctx), take_labels=True,
                    auto_wiring=True)
            seq.bind(data_shapes=[("data", (4, 16))],
                     label_shapes=[("softmax_label", (4,))])
            seq.init_params(mx.init.Uniform(0.3))
            seq.init_optimizer(kvstore=None, optimizer_params={
                "learning_rate": 0.5})
            data = np.random.RandomState(0).standard_normal(
                (4, 16)).astype(np.float32)
            batch = io.DataBatch(data=[mx.nd.array(data)],
                                 label=[mx.nd.array([0., 1., 1., 0.])])
            for _ in range(3):
                seq.forward(batch, is_train=True)
                seq.backward()
                seq.update()
            seq.forward(batch, is_train=False)
            out = seq.get_outputs()[0]
            assert out.shape == (4, 2)
            outs.append((out.asnumpy(), {k: v.asnumpy() for k, v in
                                         seq.get_params()[0].items()}))
    np.testing.assert_allclose(outs[1][0], outs[0][0], **TOL)
    for k in outs[0][1]:
        np.testing.assert_allclose(outs[1][1][k], outs[0][1][k], err_msg=k,
                                   **TOL)


def test_module_fit_checkpoint_resume(tmp_path):
    """fit(checkpoint_prefix=...) writes prefix-NNNN.params each epoch;
    a rerun resumes after the newest readable checkpoint, past a torn
    one; with nothing left it trains no epoch and adopts the
    checkpoint's weights; resume=False starts at epoch 0."""
    X, y = _toy_data(n=64)
    prefix = str(tmp_path / "ck")
    with tmx.cpu():
        def make_iter():
            return tio.NDArrayIter(X, y, batch_size=32)

        mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
        mod.fit(make_iter(), num_epoch=2, checkpoint_prefix=prefix)
        assert os.path.exists(prefix + "-0001.params")
        assert os.path.exists(prefix + "-0002.params")
        with open(prefix + "-0003.params", "wb") as f:
            f.write(b"\x00torn-by-simulated-crash")
        epochs = []
        mod2 = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
        mod2.fit(make_iter(), num_epoch=4, checkpoint_prefix=prefix,
                 epoch_end_callback=lambda e, *_: epochs.append(e))
        assert epochs == [2, 3], epochs
        assert os.path.exists(prefix + "-0004.params")
        epochs3 = []
        mod3 = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
        mod3.fit(make_iter(), num_epoch=4, checkpoint_prefix=prefix,
                 epoch_end_callback=lambda e, *_: epochs3.append(e))
        assert epochs3 == []
        saved = {k.split(":", 1)[1]: v for k, v in
                 tmx.nd.load(prefix + "-0004.params").items()
                 if k.startswith("arg:")}
        arg3 = mod3.get_params()[0]
        for k, v in saved.items():
            np.testing.assert_array_equal(arg3[k].asnumpy(), v.asnumpy(),
                                          err_msg=k)
        epochs4 = []
        mod4 = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
        mod4.fit(make_iter(), num_epoch=1, checkpoint_prefix=prefix,
                 resume=False,
                 epoch_end_callback=lambda e, *_: epochs4.append(e))
        assert epochs4 == [0]


def test_module_sigterm_boundary_checkpoint_and_resume(tmp_path):
    """sigterm@2 writes the boundary checkpoint with its sidecar and exits
    EXIT_PREEMPTED; a rerun resumes at that batch."""
    from mxnet_tpu_torch import guardrail
    rng = np.random.default_rng(0)
    X = rng.standard_normal((96, 16)).astype(np.float32)
    y = (X @ rng.standard_normal(16) > 0).astype(np.float32)
    pfx = str(tmp_path / "mod")
    with tmx.cpu():
        mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
        tinstall(TFaultInjector("sigterm@2"))
        try:
            with pytest.raises(SystemExit) as exc:
                mod.fit(tio.NDArrayIter(X, y, batch_size=32), num_epoch=3,
                        optimizer="sgd",
                        optimizer_params={"learning_rate": 0.5},
                        checkpoint_prefix=pfx)
        finally:
            tinstall(None)
        assert exc.value.code == guardrail.EXIT_PREEMPTED
        with open(pfx + "-0000.resume.json") as f:
            assert json.load(f) == {"epoch": 0, "nbatch": 1}
        mod2 = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
        mod2.fit(tio.NDArrayIter(X, y, batch_size=32), num_epoch=3,
                 optimizer="sgd", optimizer_params={"learning_rate": 0.5},
                 checkpoint_prefix=pfx)
    assert os.path.exists(pfx + "-0003.params")
    assert np.isfinite(_np_params(mod2)[0]["fc1_weight"]).all()


def test_module_fit_nan_step_is_masked_as_in_jax():
    """nan@2: both packages' Module fits mask the same step and land on
    the same weights."""
    X, y = _toy_data(n=96)
    mods, fired = [], []
    for mx, io, ctx, install, inj in (
            (jmx, jio, jmx.cpu(), jinstall, JFaultInjector),
            (tmx, tio, tmx.cpu(), tinstall, TFaultInjector)):
        with ctx:
            mx.random.seed(5)
            injector = install(inj("nan@2"))
            try:
                mod = mx.mod.Module(_mlp_sym(mx), context=ctx)
                mod.fit(io.NDArrayIter(X, y, batch_size=32), num_epoch=2,
                        optimizer="sgd",
                        optimizer_params={"learning_rate": 0.5})
            finally:
                install(None)
        fired.append(injector.fired)
        mods.append(mod)
    assert fired[1] == fired[0] == [("nan", 2, "nan")]
    for name, arr in _np_params(mods[1])[0].items():
        assert np.isfinite(arr).all(), name
    _assert_params_close(mods[1], mods[0])


def test_module_equals_train_step_bit_for_bit():
    """A small ResNet (BatchNorm, SGD momentum, wd on every parameter as
    TrainStep applies it): after three updates through Module.fit (the
    guardrail on) the parameters and moving stats equal a float32
    TrainStep's from the same weights, bit for bit (chip_smoke's path A
    at a small size)."""
    import torch
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import make_train_step

    B = 4
    sym = resnet.get_symbol(num_classes=10, num_layers=8,
                            image_shape=(3, 16, 16))
    rng = np.random.RandomState(0)
    X = rng.standard_normal((3 * B, 3, 16, 16)).astype(np.float32)
    Y = rng.randint(0, 10, (3 * B,)).astype(np.float32)
    optp = {"momentum": 0.9, "wd": 1e-4, "rescale_grad": 1.0 / B}
    shapes = {"data": (B, 3, 16, 16), "softmax_label": (B,)}
    with tmx.cpu():
        ref = make_train_step(sym, optimizer="sgd", optimizer_params=optp)
        tmx.random.seed(0)
        init = ref.init_state(Xavier(factor_type="in", magnitude=2.0),
                              shapes)
        names = list(ref.param_names)
        opt = tmx.optimizer.create("sgd", learning_rate=0.1,
                                   param_idx2name=dict(enumerate(names)),
                                   **optp)
        opt.set_wd_mult({n: 1.0 for n in names})
        mod = tmx.mod.Module(sym, context=tmx.cpu())
        mod.fit(tio.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                optimizer=opt, kvstore="local",
                arg_params={k: tmx.nd.array(v) for k, v in init[0].items()},
                aux_params={k: tmx.nd.array(v) for k, v in init[2].items()})
        state = init
        for i in range(3):
            state, _ = ref(state, {"data": X[i * B:(i + 1) * B],
                                   "softmax_label": Y[i * B:(i + 1) * B]},
                           0.1, i)
    args, auxs = mod.get_params()
    for k, v in state[0].items():
        assert torch.equal(args[k]._data, v), k
    for k, v in state[2].items():
        assert torch.equal(auxs[k]._data, v), k


def test_training_forward_drops_the_previous_graph():
    """ROADMAP Queue C item 5: the Executor keeps a training forward's
    graph for backward(); the Module's next training forward drops it,
    so a step's memory does not hold the step before's."""
    import torch
    X, y = _toy_data(n=8)
    with tmx.cpu():
        mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
        mod.bind([("data", (4, 1, 8, 8))], [("softmax_label", (4,))])
        mod.init_params()
        mod.init_optimizer()
        b1 = tio.DataBatch(data=[tmx.nd.array(X[:4])],
                           label=[tmx.nd.array(y[:4])])
        mod.forward(b1, is_train=True)
        mod.backward()
        mod.update()
        exe = mod._exec_group.execs[0]
        outs, _ = exe._graph
        assert outs[0].grad_fn is not None
        ref = weakref.ref(outs[0])
        del outs
        gc.collect()
        assert ref() is not None          # kept for another backward()
        mod.forward(b1, is_train=True)
        gc.collect()
        assert ref() is None              # the next forward dropped it
        assert isinstance(exe._graph[0][0], torch.Tensor)


def test_bucketing_module_matches_jax():
    """Buckets of two lengths share one parameter set and the default
    bucket's optimizer; the port's weights after four updates within TOL
    of the JAX BucketingModule's."""
    def run(mx, io, ctx):
        def sym_gen(T):
            data = mx.sym.Variable("data")
            h = mx.sym.FullyConnected(mx.sym.Flatten(data), name="fc",
                                      num_hidden=4)
            h = mx.sym.Activation(h, act_type="tanh")
            out = mx.sym.FullyConnected(h, name="out", num_hidden=2)
            return mx.sym.SoftmaxOutput(out, name="softmax"), ("data",), \
                ("softmax_label",)

        def sym_gen_t(T):
            data = mx.sym.Variable("data")
            h = mx.sym.sum(data, axis=1)         # (B, 5): T-invariant
            h = mx.sym.FullyConnected(h, name="fc", num_hidden=4)
            h = mx.sym.Activation(h, act_type="tanh")
            out = mx.sym.FullyConnected(h, name="out", num_hidden=2)
            return mx.sym.SoftmaxOutput(out, name="softmax"), ("data",), \
                ("softmax_label",)
        del sym_gen
        with ctx:
            mx.random.seed(6)
            mod = mx.mod.BucketingModule(sym_gen_t, default_bucket_key=6,
                                         context=ctx)
            mod.bind([io.DataDesc("data", (4, 6, 5))],
                     [io.DataDesc("softmax_label", (4,))])
            mod.init_params(mx.init.Uniform(0.5))
            mod.init_optimizer(optimizer="sgd", optimizer_params={
                "learning_rate": 0.3, "momentum": 0.9})
            rng = np.random.RandomState(1)
            for T in (6, 3, 6, 3):
                batch = io.DataBatch(
                    data=[mx.nd.array(rng.standard_normal(
                        (4, T, 5)).astype(np.float32))],
                    label=[mx.nd.array(np.array([0., 1., 1., 0.],
                                                np.float32))],
                    bucket_key=T,
                    provide_data=[io.DataDesc("data", (4, T, 5))],
                    provide_label=[io.DataDesc("softmax_label", (4,))])
                mod.forward(batch, is_train=True)
                mod.backward()
                mod.update()
            assert sorted(mod._buckets) == [3, 6]
            return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    j = run(jmx, jio, jmx.cpu())
    t = run(tmx, tio, tmx.cpu())
    assert sorted(t) == sorted(j) == ["fc_bias", "fc_weight", "out_bias",
                                      "out_weight"]
    for k in j:
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **TOL)


def test_python_loss_module_matches_jax():
    """A SequentialModule of a symbolic Module and a PythonLossModule
    whose grad_func is softmax cross-entropy's gradient: the port's
    weights after three updates within TOL of the JAX chain's."""
    def grad(scores, labels):
        p = scores.asnumpy()
        p = np.exp(p - p.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        p[np.arange(len(p)), labels.asnumpy().astype(int)] -= 1
        return p / len(p)

    def run(mx, io, ctx):
        with ctx:
            mx.random.seed(7)
            net = mx.sym.FullyConnected(mx.sym.Variable("data"), name="fc",
                                        num_hidden=3)
            seq = mx.mod.SequentialModule()
            seq.add(mx.mod.Module(net, label_names=None, context=ctx))
            seq.add(mx.mod.PythonLossModule(data_names=("fc_output",),
                                            grad_func=grad),
                    take_labels=True, auto_wiring=True)
            seq.bind([("data", (6, 5))], [("softmax_label", (6,))])
            seq.init_params(mx.init.Uniform(0.5))
            seq.init_optimizer(optimizer_params={"learning_rate": 0.5})
            rng = np.random.RandomState(2)
            batch = io.DataBatch(
                data=[mx.nd.array(rng.standard_normal((6, 5)).astype(
                    np.float32))],
                label=[mx.nd.array(rng.randint(0, 3, 6).astype(
                    np.float32))])
            for _ in range(3):
                seq.forward(batch, is_train=True)
                seq.backward()
                seq.update()
            return {k: v.asnumpy() for k, v in seq.get_params()[0].items()}

    j = run(jmx, jio, jmx.cpu())
    t = run(tmx, tio, tmx.cpu())
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **TOL)


def test_feedforward_matches_jax(tmp_path):
    """The legacy FeedForward over Module: fit from numpy arrays,
    predict, score and save/load, the port within TOL of the JAX
    model."""
    X, y = _toy_data(n=64)
    res = []
    for mx, io, ctx in ((jmx, jio, jmx.cpu()), (tmx, tio, tmx.cpu())):
        with ctx:
            mx.random.seed(8)
            np.random.seed(8)
            model = mx.model.FeedForward(_mlp_sym(mx), ctx=ctx, num_epoch=2,
                                         numpy_batch_size=16,
                                         learning_rate=0.3, momentum=0.9)
            model.fit(X, y)
            preds = model.predict(X)
            acc = model.score(io.NDArrayIter(X, y, batch_size=16))
            prefix = str(tmp_path / ("ff_" + mx.__name__))
            model.save(prefix)
            loaded = mx.model.FeedForward.load(prefix, 2, ctx=ctx)
            assert loaded.begin_epoch == 2
            for k, v in model.arg_params.items():
                np.testing.assert_array_equal(
                    loaded.arg_params[k].asnumpy(), v.asnumpy())
        res.append((preds, acc, {k: v.asnumpy() for k, v in
                                 model.arg_params.items()}))
    # the model's own scopes restored the caller's
    assert tmx.current_context() == tmx.gpu(0)
    assert res[1][0].shape == (64, 2)
    np.testing.assert_allclose(res[1][0], res[0][0], **TOL)
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-6)
    for k in res[0][2]:
        np.testing.assert_allclose(res[1][2][k], res[0][2][k], err_msg=k,
                                   **TOL)


def test_monitor_reads_every_node_with_one_host_sync():
    """Module.install_monitor: on a due step every op output and (at
    toc) every argument is recorded, with one counted host sync."""
    from mxnet_tpu_torch import profiler
    with tmx.cpu():
        mon = tmx.Monitor(1, pattern=".*")
        mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
        mod.bind([("data", (4, 1, 8, 8))], [("softmax_label", (4,))])
        mod.init_params()
        mod.install_monitor(mon)
        batch = tio.DataBatch(data=[tmx.nd.ones((4, 1, 8, 8))],
                              label=[tmx.nd.zeros((4,))])
        mon.tic()
        mod.forward(batch, is_train=False)
        before = profiler.host_sync_count()
        rows = mon.toc()
        assert profiler.host_sync_count() - before == 1
    names = [r[1] for r in rows]
    for name in ("fc1", "fc2", "softmax", "fc1_weight", "fc2_bias", "data"):
        assert name in names, (name, names)
    for _, _, value in rows:
        assert np.isfinite(float(value.split()[0]))
