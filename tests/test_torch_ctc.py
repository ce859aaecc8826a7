"""The port's ``CTCLoss`` op (``mxnet_tpu_torch/ops/ctc.py``: optax's
log-space alpha recursion in plain torch) and ``gluon.loss.CTCLoss``
against the JAX package's (``optax.ctc_loss``), on the CPU, from numpy
seeds: blank first and last with their padding values, data lengths,
label lengths and both, repeated labels, an impossible alignment (the
same large finite loss, not inf), the gradient in the activations, the
symbol's arguments under ``use_*_lengths``, and a few SGD steps. Losses
within rtol 1e-5 / atol 1e-5 (the recursion sums T log-terms of
magnitude up to 1e5 on an impossible alignment); gradients within rtol
1e-4 / atol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import ctc as jctc
from mxnet_tpu_torch.ops import ctc as tctc

LOSS = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
T, B, C = 8, 4, 6

# label rows: first blank (padding 0), last blank (padding -1); a repeat
# (3, 3) needs a blank between its two frames
LABELS = {
    "first": np.array([[1, 3, 3, 2], [4, 1, 0, 0], [5, 0, 0, 0],
                       [2, 2, 2, 0]], np.float32),
    "last": np.array([[0, 3, 3, 2], [4, 1, -1, -1], [4, -1, -1, -1],
                      [2, 2, 2, -1]], np.float32),
}
DATA_LENGTHS = np.array([8, 5, 3, 7], np.float32)
LABEL_LENGTHS = np.array([4, 1, 1, 2], np.float32)
CASES = [(blank, dl, ll) for blank in ("first", "last")
         for dl in (False, True) for ll in (False, True)]


def _data(seed=0, t=T):
    return np.random.RandomState(seed).randn(t, B, C).astype(np.float32)


def _args(blank, dl, ll, data=None, labels=None):
    data = _data() if data is None else data
    args = [data, LABELS[blank] if labels is None else labels]
    if dl:
        args.append(DATA_LENGTHS)
    if ll:
        args.append(LABEL_LENGTHS)
    attrs = dict(use_data_lengths=dl, use_label_lengths=ll,
                 blank_label=blank)
    return args, attrs


def _jax(args, attrs):
    ins = [jnp.asarray(a) for a in args]

    def f(x):
        return jctc._ctc_loss(x, *ins[1:], **attrs)
    loss, vjp = jax.vjp(f, ins[0])
    cot = np.linspace(0.5, 1.5, loss.shape[0]).astype(np.float32)
    return np.asarray(loss), np.asarray(vjp(jnp.asarray(cot))[0])


def _torch(args, attrs):
    x = torch.tensor(args[0], requires_grad=True)
    loss = tctc._ctc_loss(x, *[torch.from_numpy(a) for a in args[1:]],
                          **attrs)
    cot = np.linspace(0.5, 1.5, loss.shape[0]).astype(np.float32)
    loss.backward(torch.from_numpy(cot))
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("blank,data_lengths,label_lengths", CASES)
def test_ctc_loss_and_gradient_match_jax(blank, data_lengths,
                                         label_lengths):
    args, attrs = _args(blank, data_lengths, label_lengths)
    (l_t, g_t), (l_j, g_j) = _torch(args, attrs), _jax(args, attrs)
    assert l_t.shape == (B,) and l_t.dtype == np.float32
    np.testing.assert_allclose(l_t, l_j, **LOSS)
    np.testing.assert_allclose(g_t, g_j, **GRAD)


@pytest.mark.parametrize("blank", ["first", "last"])
def test_impossible_alignment_gives_the_same_finite_loss(blank):
    """Three frames cannot emit 1 1 2 2 (a repeat needs a blank between):
    log(0) is -1e5, so the loss is large and finite, as optax's."""
    labels = LABELS[blank].copy()
    labels[0] = [1, 1, 2, 2]
    args, attrs = _args(blank, False, False, data=_data(1, t=3),
                        labels=labels)
    (l_t, g_t), (l_j, g_j) = _torch(args, attrs), _jax(args, attrs)
    assert np.all(np.isfinite(l_t)) and l_t[0] > 1e4
    np.testing.assert_allclose(l_t, l_j, **LOSS)
    np.testing.assert_allclose(g_t, g_j, **GRAD)


@pytest.mark.parametrize("blank,data_lengths,label_lengths", CASES[:4])
def test_nd_and_symbol_surface_match_jax(blank, data_lengths,
                                         label_lengths):
    """mx.nd.CTCLoss and its aliases, and mx.sym.CTCLoss's arguments
    (the length inputs only under their flags) and bound forward."""
    args, attrs = _args(blank, data_lengths, label_lengths)
    want = jmx.nd.CTCLoss(*[jmx.nd.array(a) for a in args],
                          **attrs).asnumpy()
    with tmx.cpu():
        nds = [tmx.nd.array(a) for a in args]
        for name in ("CTCLoss", "ctc_loss", "_contrib_CTCLoss",
                     "_contrib_ctc_loss"):
            got = getattr(tmx.nd, name)(*nds, **attrs).asnumpy()
            np.testing.assert_allclose(got, want, **LOSS)
        assert tmx.nd.contrib.CTCLoss(*nds, **attrs).shape == (B,)
    names = ["data", "label", "data_lengths", "label_lengths"]
    res = []
    for mx in (jmx, tmx):
        syms = [mx.sym.Variable(n) for n in names]
        kw = dict(zip(names, syms))
        if not data_lengths:
            kw.pop("data_lengths")
        if not label_lengths:
            kw.pop("label_lengths")
        net = mx.sym.CTCLoss(**kw, **attrs)
        feed = dict(zip(net.list_arguments(), args))
        ctx = {"ctx": tmx.cpu()} if mx is tmx else {}
        ex = net.simple_bind(**ctx, **{k: v.shape for k, v in feed.items()})
        res.append((net.list_arguments(), len(net.list_outputs()),
                    ex.forward(**feed)[0].asnumpy()))
    assert res[1][:2] == res[0][:2]
    np.testing.assert_allclose(res[1][2], res[0][2], **LOSS)


@pytest.mark.parametrize("layout,label_layout,lengths", [
    ("NTC", "NT", False), ("TNC", "TN", True), ("NTC", "NT", True)])
def test_gluon_ctc_loss_matches_jax(layout, label_layout, lengths):
    """gluon.loss.CTCLoss, eager and hybridized, with a weight and a
    sample_weight, and the gradient in its prediction."""
    data = _data(2)
    pred = data.transpose(1, 0, 2) if layout == "NTC" else data
    label = LABELS["first"] if label_layout == "NT" \
        else LABELS["first"].T.copy()
    # a hybridized block takes no None input: sample_weight comes after
    # the lengths
    sw = np.linspace(0.5, 2.0, B).astype(np.float32) \
        if lengths and layout == "NTC" else None
    res = []
    for mx in (jmx, tmx):
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            out = []
            for hybrid in (False, True):
                loss = mx.gluon.loss.CTCLoss(layout, label_layout,
                                             weight=0.7)
                if hybrid:
                    loss.hybridize()
                p = mx.nd.array(pred)
                p.attach_grad()
                extra = [mx.nd.array(DATA_LENGTHS),
                         mx.nd.array(LABEL_LENGTHS)] if lengths else []
                if sw is not None:
                    extra.append(mx.nd.array(sw))
                with mx.autograd.record():
                    val = loss(p, mx.nd.array(label), *extra)
                val.backward()
                out.append((val.asnumpy(), p.grad.asnumpy()))
            res.append(out)
    for (l_t, g_t), (l_j, g_j) in zip(res[1], res[0]):
        assert l_t.shape == (B,)
        np.testing.assert_allclose(l_t, l_j, **LOSS)
        np.testing.assert_allclose(g_t, g_j, **GRAD)


def test_sgd_on_ctc_descends_as_jax():
    """Ten SGD steps on the activations through nd.CTCLoss under
    autograd.record: the same losses as the JAX package's."""
    x0 = _data(5)
    label = LABELS["first"]
    traj = []
    for mx in (jmx, tmx):
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            x = mx.nd.array(x0)
            lab = mx.nd.array(label)
            losses = []
            for _ in range(10):
                x.attach_grad()
                with mx.autograd.record():
                    loss = mx.nd.CTCLoss(x, lab).sum()
                loss.backward()
                losses.append(float(loss.asnumpy().reshape(-1)[0]))
                x = x - 0.5 * x.grad
            traj.append(losses)
    np.testing.assert_allclose(traj[1], traj[0], rtol=1e-4)
    assert traj[1][-1] < 0.6 * traj[1][0], traj[1]


OCR = dict(frames=12, feat=8, hidden=8, label=3, digits=5, batch=8, n=32)


def _ocr_data(seed=0):
    """upstream example/warpctc/lstm_ocr.py's task, shrunk as the JAX
    package's examples/ctc_ocr.py renders it: each digit lights its own
    feature band over consecutive frames of noise."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(1, OCR["digits"] + 1,
                         (OCR["n"], OCR["label"])).astype(np.float32)
    x = rng.randn(OCR["n"], OCR["frames"], OCR["feat"]).astype(
        np.float32) * 0.3
    for i, seq in enumerate(labels):
        for j, d in enumerate(seq):
            x[i, 1 + 3 * j:3 + 3 * j, int(d) - 1] += 2.0
    return x, labels


def _ocr_net(mx):
    """Two unrolled LSTMCell layers, a per-frame classifier (blank first)
    and MakeLoss(CTCLoss) over (T, N, C) activations."""
    h, frames = OCR["hidden"], OCR["frames"]
    stack = mx.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(mx.rnn.LSTMCell(h, prefix="lstm%d_" % i))
    outs, _ = stack.unroll(frames, mx.sym.Variable("data"),
                           merge_outputs=True)
    pred = mx.sym.FullyConnected(mx.sym.Reshape(outs, shape=(-1, h)),
                                 num_hidden=OCR["digits"] + 1, name="cls")
    act = mx.sym.transpose(mx.sym.Reshape(
        pred, shape=(-1, frames, OCR["digits"] + 1)), axes=(1, 0, 2))
    return mx.sym.MakeLoss(mx.sym.CTCLoss(act, mx.sym.Variable("label"),
                                          name="ctc"))


def test_lstm_ctc_module_fit_matches_jax():
    """LSTM + CTC trained through Module.fit (Adam, 3 epochs): the
    parameters within rtol 1e-4 / atol 1e-5 of the JAX package's, and the
    loss falls."""
    x, labels = _ocr_data()
    res = []
    for mx in (jmx, tmx):
        mx.random.seed(11)
        np.random.seed(11)
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            it = mx.io.NDArrayIter({"data": x}, {"label": labels},
                                   batch_size=OCR["batch"], shuffle=True,
                                   label_name="label")
        mod = mx.mod.Module(_ocr_net(mx), data_names=("data",),
                            label_names=("label",),
                            **({"context": tmx.cpu()} if mx is tmx
                               else {}))
        losses = []

        def log(param, losses=losses):
            losses.append(float(mod.get_outputs()[0].asnumpy().mean()))
        mod.fit(it, num_epoch=3, eval_metric=mx.metric.Loss(),
                initializer=mx.init.Xavier(), optimizer="adam",
                optimizer_params={"learning_rate": 1e-2},
                batch_end_callback=log)
        res.append(({k: v.asnumpy() for k, v in
                     mod.get_params()[0].items()}, losses))
    (pj, lj), (pt, lt) = res
    assert sorted(pt) == sorted(pj)
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    steps = OCR["n"] // OCR["batch"]
    assert np.mean(lt[-steps:]) < np.mean(lt[:steps]), lt
