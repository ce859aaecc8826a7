"""The port's Gluon (``mxnet_tpu_torch.gluon``) against the JAX package's,
on the CPU: Parameter and Block, every nn layer eager and hybridized,
every loss, the Trainer, ``gluon.utils``, and the crossings to the
symbolic surfaces (``export`` -> ``model.load_checkpoint`` -> Module /
Predictor; ``SymbolBlock``; ``save_params``/``load_params`` both ways).

Each case builds the same block in both packages from one seed (the
initializers draw on the host from the same numpy stream, so the
parameters start equal) and feeds numpy inputs. Tolerances: forward
rtol 1e-5 / atol 1e-6; gradients, and parameters after Trainer steps,
rtol 1e-4 / atol 1e-5 (float32; summation order differs). A case that
needs more says why.
"""
import pickle

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
NORMAL_ULPS = 3     # tests/test_torch_random.py's bound for normal draws


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out]


def run_block(mx, make, arrays, hybrid, seed=0, init=None, train=True,
              int_inputs=(), calls=1):
    """Build ``make(mx)`` from ``seed``, call it on ``arrays`` (eager or
    hybridized) under ``record()``, backpropagate a fixed cotangent;
    (outputs, input gradients, parameter gradients, parameters after)
    keyed without the block's prefix."""
    with mx.cpu():
        mx.random.seed(seed)
        net = make(mx)
        net.initialize(init or mx.init.Xavier(), ctx=mx.cpu())
        if hybrid:
            net.hybridize()
        xs = [mx.nd.array(a) for a in arrays]
        for i, x in enumerate(xs):
            if i not in int_inputs:
                x.attach_grad()
        for _ in range(calls):
            with mx.autograd.record(train_mode=train):
                outs = _flat(net(*xs))
            cts = [mx.nd.array(np.random.RandomState(7 + i).randn(
                *o.shape).astype(np.float32)) for i, o in enumerate(outs)]
            mx.autograd.backward(outs, cts)
        k = len(net.prefix)
        params = net.collect_params()
        return ([o.asnumpy() for o in outs],
                [x.grad.asnumpy() for i, x in enumerate(xs)
                 if i not in int_inputs],
                {n[k:]: p.grad().asnumpy() for n, p in params.items()
                 if p.grad_req != "null"},
                {n[k:]: p.data().asnumpy() for n, p in params.items()})


def assert_block_parity(make, arrays, hybrid, fwd=FWD, grad=GRAD, **kw):
    j = run_block(jmx, make, arrays, hybrid, **kw)
    t = run_block(tmx, make, arrays, hybrid, **kw)
    assert len(j[0]) == len(t[0])
    for a, b in zip(t[0], j[0]):
        np.testing.assert_allclose(a, b, **fwd)
    for a, b in zip(t[1], j[1]):
        np.testing.assert_allclose(a, b, **grad)
    assert sorted(t[2]) == sorted(j[2]) and sorted(t[3]) == sorted(j[3])
    for n in j[2]:
        np.testing.assert_allclose(t[2][n], j[2][n], err_msg=n, **grad)
    for n in j[3]:
        np.testing.assert_allclose(t[3][n], j[3][n], err_msg=n, **grad)
    return t, j


_rng = np.random.RandomState(0)
X2 = _rng.randn(4, 6).astype(np.float32)
X3 = _rng.randn(2, 3, 7).astype(np.float32)
X4 = _rng.randn(2, 3, 6, 6).astype(np.float32)
X5 = _rng.randn(2, 2, 4, 5, 5).astype(np.float32)
IDX = np.array([[1, 3, 0], [2, 2, 4]], np.float32)

LAYERS = {
    "dense": (lambda mx: mx.gluon.nn.Dense(5, activation="tanh"), [X4]),
    "dense_noflatten": (lambda mx: mx.gluon.nn.Dense(
        4, flatten=False, use_bias=False, in_units=7), [X3]),
    "activation_relu": (lambda mx: mx.gluon.nn.Activation("relu"), [X2]),
    "activation_sigmoid": (lambda mx: mx.gluon.nn.Activation("sigmoid"),
                           [X2]),
    "activation_softrelu": (lambda mx: mx.gluon.nn.Activation("softrelu"),
                            [X2]),
    "dropout": (lambda mx: mx.gluon.nn.Dropout(0.5), [X4]),
    "batchnorm": (lambda mx: mx.gluon.nn.BatchNorm(momentum=0.8), [X4]),
    "batchnorm_noscale": (lambda mx: mx.gluon.nn.BatchNorm(
        scale=False, center=False, in_channels=3), [X4]),
    "leakyrelu": (lambda mx: mx.gluon.nn.LeakyReLU(0.1), [X2]),
    "flatten": (lambda mx: mx.gluon.nn.Flatten(), [X4]),
    "instancenorm": (lambda mx: mx.gluon.nn.InstanceNorm(scale=True), [X4]),
    "layernorm": (lambda mx: mx.gluon.nn.LayerNorm(), [X3]),
    "conv1d": (lambda mx: mx.gluon.nn.Conv1D(4, 3, strides=2, padding=1,
                                             activation="relu"), [X3]),
    "conv2d": (lambda mx: mx.gluon.nn.Conv2D(4, (3, 2), padding=(1, 0),
                                             dilation=(1, 2)), [X4]),
    "conv2d_groups": (lambda mx: mx.gluon.nn.Conv2D(
        6, 3, groups=3, use_bias=False), [X4]),
    "conv3d": (lambda mx: mx.gluon.nn.Conv3D(3, 2, strides=(1, 2, 2)),
               [X5]),
    "conv2d_transpose": (lambda mx: mx.gluon.nn.Conv2DTranspose(
        2, 3, strides=2, padding=1, output_padding=1), [X4]),
    "conv3d_transpose": (lambda mx: mx.gluon.nn.Conv3DTranspose(
        2, 2, strides=2), [X5]),
    "maxpool1d": (lambda mx: mx.gluon.nn.MaxPool1D(2), [X3]),
    "maxpool2d": (lambda mx: mx.gluon.nn.MaxPool2D(3, 2, 1), [X4]),
    "maxpool2d_ceil": (lambda mx: mx.gluon.nn.MaxPool2D(
        2, 2, ceil_mode=True), [X4[:, :, :5, :5]]),
    "maxpool3d": (lambda mx: mx.gluon.nn.MaxPool3D(2), [X5]),
    "avgpool1d": (lambda mx: mx.gluon.nn.AvgPool1D(3, 1, 1), [X3]),
    "avgpool2d": (lambda mx: mx.gluon.nn.AvgPool2D(2), [X4]),
    "avgpool3d": (lambda mx: mx.gluon.nn.AvgPool3D(2, 1), [X5]),
    "globalmaxpool1d": (lambda mx: mx.gluon.nn.GlobalMaxPool1D(), [X3]),
    "globalmaxpool2d": (lambda mx: mx.gluon.nn.GlobalMaxPool2D(), [X4]),
    "globalmaxpool3d": (lambda mx: mx.gluon.nn.GlobalMaxPool3D(), [X5]),
    "globalavgpool1d": (lambda mx: mx.gluon.nn.GlobalAvgPool1D(), [X3]),
    "globalavgpool2d": (lambda mx: mx.gluon.nn.GlobalAvgPool2D(), [X4]),
    "globalavgpool3d": (lambda mx: mx.gluon.nn.GlobalAvgPool3D(), [X5]),
}


def _hybrid_stack(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        # no bias before the BatchNorm: its gradient would be rounding
        # noise, which Adam's normalisation turns into a full step
        # (ROADMAP Queue C 19)
        net.add(mx.gluon.nn.Conv2D(4, 3, padding=1, use_bias=False),
                mx.gluon.nn.BatchNorm(), mx.gluon.nn.Activation("relu"),
                mx.gluon.nn.MaxPool2D(2), mx.gluon.nn.Dropout(0.3),
                mx.gluon.nn.Flatten(), mx.gluon.nn.Dense(3))
    return net


def _eager_stack(mx):
    net = mx.gluon.nn.Sequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(8, activation="relu"),
                mx.gluon.nn.Dense(3))
    return net


LAYERS["hybrid_sequential"] = (_hybrid_stack, [X4])
LAYERS["sequential"] = (_eager_stack, [X2])


# a Sequential is a Block: hybridize reaches only its HybridBlock children
LAYER_CASES = [(n, h) for n in sorted(LAYERS) for h in (False, True)
               if not (n == "sequential" and h)]


@pytest.mark.parametrize("name,hybrid", LAYER_CASES, ids=[
    "%s-%s" % (n, "hybrid" if h else "eager") for n, h in LAYER_CASES])
def test_layer_matches_jax(name, hybrid):
    """Forward, input and parameter gradients and the parameters after
    (BatchNorm's running stats from the training forward) equal the JAX
    layer's; Dropout's mask bits are the JAX package's (threefry)."""
    make, arrays = LAYERS[name]
    t, j = assert_block_parity(make, arrays, hybrid)
    if name == "batchnorm":
        # the moving stats moved off their initial 0 and 1
        assert not np.allclose(t[3]["running_mean"], 0)
    if name == "dropout":
        np.testing.assert_array_equal(t[0][0] == 0, j[0][0] == 0)


def test_embedding_matches_jax():
    for hybrid in (False, True):
        assert_block_parity(lambda mx: mx.gluon.nn.Embedding(5, 4), [IDX],
                            hybrid, int_inputs=(0,))


def test_conv1d_transpose_matches_torch():
    """Conv1DTranspose against torch's conv_transpose1d (the JAX
    package's layer fails its own shape inference for 1-D kernels)."""
    import torch
    for hybrid in (False, True):
        out, gin, grads, params = run_block(
            tmx, lambda mx: tmx.gluon.nn.Conv1DTranspose(2, 3, strides=2),
            [X3], hybrid)
        x = torch.from_numpy(X3).requires_grad_(True)
        w = torch.from_numpy(params["weight"]).requires_grad_(True)
        b = torch.from_numpy(params["bias"]).requires_grad_(True)
        y = torch.nn.functional.conv_transpose1d(x, w, b, stride=2)
        np.testing.assert_allclose(out[0], y.detach().numpy(), **FWD)
        ct = torch.from_numpy(np.random.RandomState(7).randn(
            *y.shape).astype(np.float32))
        y.backward(ct)
        np.testing.assert_allclose(gin[0], x.grad.numpy(), **GRAD)
        np.testing.assert_allclose(grads["weight"], w.grad.numpy(), **GRAD)
        np.testing.assert_allclose(grads["bias"], b.grad.numpy(), **GRAD)


def test_grouped_conv_with_known_in_channels():
    """Explicit in_channels gives a grouped weight the shape the deferred
    init infers, (out, in / groups, *k) and for the transpose (in,
    out / groups, *k), as the reference's layers do (the JAX package's
    layers take the whole in_channels there and fail)."""
    x = tmx.nd.array(X4, ctx=tmx.cpu())
    for cls, kw in ((tmx.gluon.nn.Conv2D, {}),
                    (tmx.gluon.nn.Conv2DTranspose, {"strides": 2})):
        outs = []
        for in_channels in (0, 3):
            tmx.random.seed(0)
            net = cls(6, 3, groups=3, in_channels=in_channels, **kw)
            net.initialize(ctx=tmx.cpu())
            outs.append((net(x).asnumpy(), net.weight.shape))
        assert outs[0][1] == outs[1][1] == ((6, 1, 3, 3) if not kw
                                            else (3, 2, 3, 3))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])


def _bn_stack(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, 3, padding=1),
                mx.gluon.nn.BatchNorm(), mx.gluon.nn.Activation("relu"),
                mx.gluon.nn.MaxPool2D(2), mx.gluon.nn.Dense(3))
    return net


def test_eager_and_hybrid_walks_are_bit_equal():
    """The port's hybridized graph runs the ops the eager path runs, in
    the same order: outputs and gradients equal bit for bit (without a
    Dropout: eager draws a key an op call, a graph one a call)."""
    e = run_block(tmx, _bn_stack, [X4], False)
    h = run_block(tmx, _bn_stack, [X4], True)
    np.testing.assert_array_equal(e[0][0], h[0][0])
    for n in e[2]:
        np.testing.assert_array_equal(e[2][n], h[2][n])


# ---------------------------------------------------------------------------
# Parameter and Block
# ---------------------------------------------------------------------------

def test_parameter_deferred_init_and_shape_inference():
    for mx in (jmx, tmx):
        with mx.cpu():
            net = mx.gluon.nn.Dense(3)
            net.initialize(ctx=mx.cpu())
            with pytest.raises(mx.gluon.DeferredInitializationError):
                net.weight.data()
            net(mx.nd.ones((2, 5)))
            assert net.weight.shape == (3, 5)
            assert net.weight.data().shape == (3, 5)
            assert net.weight.list_ctx() == [mx.cpu()]
    with tmx.cpu():
        p = tmx.gluon.Parameter("w", shape=(0, 3))
        with pytest.raises(ValueError, match="unknown shape"):
            p.initialize()


def test_parameter_sharing_and_naming():
    """Prefixes, name scopes and shared parameters come out as the JAX
    package's."""
    names = []
    for mx in (jmx, tmx):
        with mx.cpu(), mx.name.NameManager():
            net = mx.gluon.nn.HybridSequential(prefix="net_")
            with net.name_scope():
                a = mx.gluon.nn.Dense(4, in_units=3)
                b = mx.gluon.nn.Dense(4, in_units=3, params=a.params)
                net.add(a, b, mx.gluon.nn.BatchNorm(),
                        mx.gluon.nn.Dense(2, prefix="head_"))
            assert b.weight is a.weight
            names.append((list(net.collect_params().keys()), a.name,
                          net[2].prefix))
    assert names[0] == names[1]
    assert names[1][0][0] == "net_dense0_weight"


@pytest.mark.parametrize("kind", ["uniform", "normal", "xavier"])
def test_initialize_draws_match_jax(kind):
    """``initialize()`` under ``mx.random.seed`` draws the JAX package's
    values: uniform bit-equal, normal within NORMAL_ULPS."""
    vals = []
    for mx in (jmx, tmx):
        init = {"uniform": mx.init.Uniform(0.3),
                "normal": mx.init.Normal(0.2),
                "xavier": mx.init.Xavier(rnd_type="gaussian")}[kind]
        with mx.cpu():
            mx.random.seed(11)
            net = mx.gluon.nn.Dense(7, in_units=5, prefix="d_")
            net.initialize(init, ctx=mx.cpu())
            vals.append(net.weight.data().asnumpy())
    if kind == "uniform":
        np.testing.assert_array_equal(vals[1], vals[0])
    else:
        np.testing.assert_array_max_ulp(vals[1], vals[0], NORMAL_ULPS)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_params_across_packages(tmp_path, direction):
    src, dst = (jmx, tmx) if direction == "jax_to_port" else (tmx, jmx)
    f = str(tmp_path / "net.params")
    outs = []
    for mx, save in ((src, True), (dst, False)):
        with mx.cpu():
            mx.random.seed(1 if save else 2)
            net = _hybrid_stack(mx)
            net.initialize(mx.init.Xavier(), ctx=mx.cpu())
            x = mx.nd.array(X4)
            net(x)
            if save:
                net.save_params(f)
            else:
                net.load_params(f, ctx=mx.cpu())
            outs.append(net(x).asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], **FWD)


def test_cast_and_grad_req_add():
    """cast (float64: the JAX package runs without x64, so this half is
    held to numpy) and grad_req='add' (against the JAX package)."""
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(3, in_units=4)
        net.initialize(ctx=tmx.cpu())
        net.cast("float64")
        assert net.weight.data().dtype == np.float64
        x = np.random.RandomState(1).randn(2, 4)
        y = net(tmx.nd.array(x, dtype="float64"))
        assert y.dtype == np.float64
        np.testing.assert_allclose(
            y.asnumpy(), x @ net.weight.data().asnumpy().T +
            net.bias.data().asnumpy(), rtol=1e-12)
    got = []
    for mx in (jmx, tmx):
        with mx.cpu():
            mx.random.seed(0)
            net = mx.gluon.nn.Dense(3, in_units=4, prefix="d_")
            net.collect_params().setattr("grad_req", "add")
            net.initialize(ctx=mx.cpu())
            x = mx.nd.array(X2[:, :4])
            for _ in range(2):
                with mx.autograd.record():
                    y = net(x)
                y.backward()
            g2 = net.weight.grad().asnumpy()
            net.collect_params().zero_grad()
            with mx.autograd.record():
                y = net(x)
            y.backward()
            np.testing.assert_allclose(g2, 2 * net.weight.grad().asnumpy(),
                                       **GRAD)
            got.append(g2)
    np.testing.assert_allclose(got[1], got[0], **GRAD)
    with tmx.cpu():
        # the port's setter also re-marks an initialized parameter
        net = tmx.gluon.nn.Dense(3, in_units=4)
        net.initialize(ctx=tmx.cpu())
        net.weight.grad_req = "add"
        x = tmx.nd.array(X2[:, :4])
        for _ in range(2):
            with tmx.autograd.record():
                y = net(x)
            y.backward()
        np.testing.assert_allclose(net.weight.grad().asnumpy(), got[1],
                                   **GRAD)
        net.weight.grad_req = "null"
        with pytest.raises(RuntimeError, match="grad_req='null'"):
            net.weight.grad()


def test_parameter_lands_on_its_context():
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=tmx.cpu(1))
    assert net.weight.data().handle.device.type == "cpu"
    assert net.weight.list_ctx() == [tmx.cpu(1)]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

P = _rng.randn(4, 5).astype(np.float32)
SPARSE = np.array([0, 3, 1, 4], np.float32)
DENSE = np.abs(_rng.randn(4, 5)).astype(np.float32)
SIGNED = np.sign(_rng.randn(4, 5)).astype(np.float32)
BINARY = (SIGNED > 0).astype(np.float32)
SW = _rng.rand(4, 1).astype(np.float32)

LOSSES = {
    "l2": ("L2Loss", {}, [P, DENSE]),
    "l1": ("L1Loss", {}, [P, DENSE]),
    "sigmoid_bce": ("SigmoidBCELoss", {}, [P, BINARY]),
    "sigmoid_bce_from_sigmoid": ("SigmoidBinaryCrossEntropyLoss",
                                 {"from_sigmoid": True},
                                 [1 / (1 + np.exp(-P)), BINARY]),
    "softmax_ce": ("SoftmaxCrossEntropyLoss", {}, [P, SPARSE]),
    "softmax_ce_dense": ("SoftmaxCELoss", {"sparse_label": False},
                         [P, DENSE / DENSE.sum(1, keepdims=True)]),
    "softmax_ce_logits": ("SoftmaxCrossEntropyLoss", {"from_logits": True},
                          [P, SPARSE]),
    "kldiv": ("KLDivLoss", {}, [P, DENSE]),
    "kldiv_probs": ("KLDivLoss", {"from_logits": False}, [P, DENSE]),
    "huber": ("HuberLoss", {"rho": 0.7}, [P, DENSE]),
    "hinge": ("HingeLoss", {}, [P, SIGNED]),
    "squared_hinge": ("SquaredHingeLoss", {"margin": 2}, [P, SIGNED]),
    "logistic": ("LogisticLoss", {}, [P, SIGNED]),
    "logistic_binary": ("LogisticLoss", {"label_format": "binary"},
                        [P, BINARY]),
    "triplet": ("TripletLoss", {"margin": 0.5}, [P, DENSE, SIGNED]),
}


# the losses whose hybrid_forward traces: the others reshape the label
# to the prediction's shape, which a Symbol does not carry (in the JAX
# package too)
HYBRID_LOSSES = ("kldiv", "kldiv_probs", "softmax_ce", "softmax_ce_logits")


def _loss_parity(name, weighting, hybrid):
    cls, kw, arrays = LOSSES[name]
    if weighting == "weight":
        kw = dict(kw, weight=1.7)
    inputs = list(arrays) + ([SW] if weighting == "sample_weight" else [])
    assert_block_parity(lambda mx: getattr(mx.gluon.loss, cls)(**kw),
                        inputs, hybrid,
                        int_inputs=tuple(range(1, len(inputs))))


@pytest.mark.parametrize("weighting", ["plain", "weight", "sample_weight"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name, weighting):
    """Every loss but CTCLoss, forward and the gradient in its
    prediction, with a scalar ``weight`` and a per-sample
    ``sample_weight``."""
    _loss_parity(name, weighting, False)


@pytest.mark.parametrize("weighting", ["plain", "weight", "sample_weight"])
@pytest.mark.parametrize("name", HYBRID_LOSSES)
def test_hybridized_loss_matches_jax(name, weighting):
    _loss_parity(name, weighting, True)


def test_ctc_loss_is_not_ported_yet():
    """CTCLoss is ported now (its op, ops/ctc.py): it builds and gives
    the JAX package's loss; tests/test_torch_ctc.py holds it in full."""
    pred = np.random.RandomState(4).randn(2, 6, 5).astype(np.float32)
    label = np.array([[1, 3, 2], [4, 1, 0]], np.float32)
    want = jmx.gluon.loss.CTCLoss()(jmx.nd.array(pred),
                                    jmx.nd.array(label)).asnumpy()
    with tmx.cpu():
        got = tmx.gluon.loss.CTCLoss()(tmx.nd.array(pred),
                                       tmx.nd.array(label)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Trainer and utils
# ---------------------------------------------------------------------------

def _trainer_run(mx, opt, opt_params, steps=3, save=None, load=None):
    with mx.cpu():
        mx.random.seed(5)
        net = _hybrid_stack(mx)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        net.hybridize()
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = mx.gluon.Trainer(net.collect_params(), opt, opt_params)
        rng = np.random.RandomState(3)
        for i in range(steps):
            x = mx.nd.array(rng.randn(*X4.shape).astype(np.float32))
            y = mx.nd.array(rng.randint(0, 3, 2).astype(np.float32))
            with mx.autograd.record():
                L = loss(net(x), y)
            L.backward()
            trainer.step(2)
            if save is not None and i == 0:
                trainer.save_states(save)
        k = len(net.prefix)
        return {n[k:]: p.data().asnumpy()
                for n, p in net.collect_params().items()}, trainer


@pytest.mark.parametrize("opt,opt_params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-4}),
], ids=["sgd_momentum", "adam"])
def test_trainer_steps_match_jax(opt, opt_params):
    """3 steps of the hybridized stack (Conv, BatchNorm, Dropout, Dense)
    through gluon.Trainer: parameters and running stats equal the JAX
    Trainer's."""
    j, _ = _trainer_run(jmx, opt, opt_params)
    t, trainer = _trainer_run(tmx, opt, opt_params)
    assert sorted(t) == sorted(j)
    for n in j:
        np.testing.assert_allclose(t[n], j[n], err_msg=n, **GRAD)
    assert trainer.learning_rate == opt_params["learning_rate"]
    trainer.set_learning_rate(0.5)
    assert trainer.learning_rate == 0.5


def test_trainer_states_round_trip_and_refuse_jax_pickles(tmp_path):
    """save_states -> load_states continues the momentum where it was;
    a JAX Trainer's states file is refused."""
    f = str(tmp_path / "t.states")
    opt = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    _, trainer = _trainer_run(tmx, *opt, steps=1, save=f)
    before = {k: v.asnumpy() for k, v in trainer._updater.states.items()
              if v is not None}
    trainer._updater.states = {}
    trainer.load_states(f)
    for k, v in before.items():
        np.testing.assert_array_equal(
            np.asarray(trainer._updater.states[k]), v)
    assert trainer._optimizer.momentum == 0.9
    assert trainer._optimizer.param_dict[0] is trainer._params[0]
    jf = str(tmp_path / "j.states")
    _trainer_run(jmx, *opt, steps=1, save=jf)
    with pytest.raises(pickle.UnpicklingError, match="mxnet_tpu"):
        trainer.load_states(jf)


def test_clip_global_norm_matches_jax():
    arrs = [_rng.randn(3, 4).astype(np.float32),
            _rng.randn(5).astype(np.float32)]
    out = []
    for mx in (jmx, tmx):
        with mx.cpu():
            nds = [mx.nd.array(a) for a in arrs]
            total = mx.gluon.utils.clip_global_norm(nds, 1.0)
            out.append((total, [a.asnumpy() for a in nds]))
            nds = [mx.nd.array(a) for a in arrs]
            assert mx.gluon.utils.clip_global_norm(nds, 1e3) == \
                pytest.approx(total)
            np.testing.assert_array_equal(nds[0].asnumpy(), arrs[0])
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-6)
    for a, b in zip(out[1][1], out[0][1]):
        np.testing.assert_allclose(a, b, **FWD)


def test_split_and_load_on_two_cpu_contexts():
    data = np.arange(24, dtype=np.float32).reshape(6, 4)
    ctxs = [tmx.cpu(0), tmx.cpu(1)]
    parts = tmx.gluon.utils.split_and_load(data, ctxs)
    assert [p.handle.device.type for p in parts] == ["cpu", "cpu"]
    with jmx.cpu():
        want = jmx.gluon.utils.split_and_load(data, [jmx.cpu(0),
                                                     jmx.cpu(1)])
    for p, w in zip(parts, want):
        np.testing.assert_array_equal(p.asnumpy(), w.asnumpy())
    with tmx.cpu():
        cols = tmx.gluon.utils.split_data(tmx.nd.array(data), 2,
                                          batch_axis=1)
    assert [c.shape for c in cols] == [(6, 2), (6, 2)]
    with pytest.raises(ValueError, match="even_split"):
        tmx.gluon.utils.split_and_load(data[:5], ctxs)
    odd = tmx.gluon.utils.split_and_load(data[:5], ctxs, even_split=False)
    assert [p.shape[0] for p in odd] == [2, 3]


# ---------------------------------------------------------------------------
# the symbolic crossings
# ---------------------------------------------------------------------------

def _export(mx, prefix, seed=4):
    with mx.cpu():
        mx.random.seed(seed)
        net = _hybrid_stack(mx)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        net.hybridize()
        x = mx.nd.array(X4)
        with mx.autograd.record():     # moves the running stats
            net(x)
        want = net(x).asnumpy()        # predict mode
        net.export(prefix)
        return want


@pytest.mark.parametrize("src", ["port", "jax"])
def test_export_loads_into_module_predictor_and_symbolblock(tmp_path, src):
    """Hybridize -> export (either package) -> the port's
    model.load_checkpoint -> Module and Predictor, and SymbolBlock over
    the loaded symbol: the exported net's predict-mode outputs."""
    prefix = str(tmp_path / "net")
    want = _export(tmx if src == "port" else jmx, prefix)
    with tmx.cpu():
        sym, args, aux = tmx.model.load_checkpoint(prefix, 0)
        mod = tmx.mod.Module(sym, data_names=("data",), label_names=None,
                             context=tmx.cpu())
        mod.bind(data_shapes=[("data", X4.shape)], for_training=False)
        mod.set_params(args, aux)
        mod.forward(tmx.io.DataBatch([tmx.nd.array(X4)]), is_train=False)
        np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), want,
                                   **FWD)
        pred = tmx.Predictor(sym, args, aux, data_names=("data",),
                             ctx=tmx.cpu())
        np.testing.assert_allclose(pred.forward(data=X4)[0].asnumpy(),
                                   want, **FWD)
        # the checkpoint's arrays under their own names: a Gluon file
        tmx.nd.save(prefix + ".gluon", {**args, **aux})
        block = tmx.gluon.SymbolBlock(sym, tmx.sym.var("data"))
        block.collect_params().load(prefix + ".gluon", ctx=tmx.cpu())
        np.testing.assert_allclose(block(tmx.nd.array(X4)).asnumpy(), want,
                                   **FWD)


def test_symbolblock_nests_in_a_hybridized_parent(tmp_path):
    prefix = str(tmp_path / "inner")
    _export(jmx, prefix)
    with tmx.cpu():
        sym, args, aux = tmx.model.load_checkpoint(prefix, 0)
        tmx.nd.save(prefix + ".gluon", {**args, **aux})
        inner = tmx.gluon.SymbolBlock(sym, tmx.sym.var("data"))
        inner.collect_params().load(prefix + ".gluon", ctx=tmx.cpu())
        outer = tmx.gluon.nn.HybridSequential()
        outer.add(inner, tmx.gluon.nn.Dense(2))
        outer.initialize(ctx=tmx.cpu())
        x = tmx.nd.array(X4)
        eager = outer(x).asnumpy()
        outer.hybridize()
        np.testing.assert_allclose(outer(x).asnumpy(), eager, **FWD)
