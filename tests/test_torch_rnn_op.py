"""The port's fused ``RNN`` op (``mxnet_tpu_torch/ops/rnn_op.py``: torch's
fused recurrence over views of the blob) against the JAX package's
(``mxnet_tpu/ops/rnn_op.py``: one ``lax.scan`` a layer and direction), on
the CPU: every mode, one and two layers, one and two directions, with
``state_outputs``, initial states of batch 1 on the two-layer cases, and
inter-layer dropout under training (the threefry masks bit-equal).
Outputs within rtol 1e-5 / atol 1e-6; the gradients of the data, the
blob and the initial states within rtol 1e-4 / atol 1e-6. The plain
per-step loop ``_rnn_reference`` is held to the route at the same
tolerances, and the op's symbol surface (arguments, shapes, outputs) to
the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import rnn_op as jrnn
from mxnet_tpu_torch import _threefry
from mxnet_tpu_torch.ops import rnn_op as trnn

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
T, N, I, H = 5, 3, 4, 6
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
CASES = [(m, layers, bidir) for m in MODES for layers in (1, 2)
         for bidir in (False, True)]
SEED_KEY = 7


def _inputs(mode, layers, bidir, seed=0):
    """data, blob, state (and state_cell for lstm) from one numpy seed;
    the two-layer cases start from states of batch 1."""
    rng = np.random.RandomState(seed)
    dirs = 2 if bidir else 1
    sb = 1 if layers == 2 else N
    ins = [rng.randn(T, N, I).astype(np.float32),
           (0.3 * rng.randn(jrnn.rnn_param_size(
               mode, I, H, layers, bidir))).astype(np.float32),
           rng.randn(layers * dirs, sb, H).astype(np.float32)]
    if mode == "lstm":
        ins.append(rng.randn(layers * dirs, sb, H).astype(np.float32))
    return ins


def _attrs(mode, layers, bidir, p=0.0, is_train=False):
    return dict(state_size=H, num_layers=layers, bidirectional=bidir,
                mode=mode, p=p, state_outputs=True, is_train=is_train)


def _cotangents(outs_shapes, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in outs_shapes]


def _jax_run(ins, attrs):
    key = jax.random.PRNGKey(SEED_KEY)

    def f(*args):
        return jrnn._rnn_op(*args, rng=key, **attrs)
    outs, vjp = jax.vjp(f, *[jnp.asarray(a) for a in ins])
    cot = _cotangents([o.shape for o in outs])
    grads = vjp(tuple(jnp.asarray(c) for c in cot))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _torch_run(fn, ins, attrs):
    args = [torch.tensor(a, requires_grad=True) for a in ins]
    outs = fn(*args, rng=_threefry.PRNGKey(SEED_KEY), **attrs)
    cot = _cotangents([tuple(o.shape) for o in outs])
    torch.autograd.backward(list(outs), [torch.from_numpy(c) for c in cot])
    return ([o.detach().numpy() for o in outs],
            [a.grad.numpy() for a in args])


def _check(got, want):
    (o_got, g_got), (o_want, g_want) = got, want
    assert len(o_got) == len(o_want) and len(g_got) == len(g_want)
    for a, b in zip(o_got, o_want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **FWD)
    for a, b in zip(g_got, g_want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD)


@pytest.mark.parametrize("mode,layers,bidir", CASES)
def test_rnn_op_matches_jax(mode, layers, bidir):
    ins = _inputs(mode, layers, bidir)
    attrs = _attrs(mode, layers, bidir)
    _check(_torch_run(trnn._rnn_op, ins, attrs), _jax_run(ins, attrs))


@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_dropout_matches_jax(mode):
    """Two bidirectional layers under training with p = 0.4: the
    inter-layer mask is the JAX package's threefry draw, so outputs and
    gradients agree as without dropout."""
    ins = _inputs(mode, 2, True)
    attrs = _attrs(mode, 2, True, p=0.4, is_train=True)
    _check(_torch_run(trnn._rnn_op, ins, attrs), _jax_run(ins, attrs))


def test_dropout_mask_is_bit_equal_to_jax():
    shape = (T, N, 2 * H)
    for layer in (0, 1):
        want = np.asarray(jax.random.bernoulli(jax.random.fold_in(
            jax.random.PRNGKey(SEED_KEY), layer), 0.6, shape))
        x = torch.ones(shape)
        got = trnn._dropout(x, 0.4, _threefry.PRNGKey(SEED_KEY), layer)
        np.testing.assert_array_equal(got.numpy() != 0, want)
        np.testing.assert_array_equal(got.numpy()[want],
                                      np.float32(1 / 0.6))


@pytest.mark.parametrize("mode,layers,bidir,p",
                         [c + (0.0,) for c in CASES]
                         + [(m, 2, True, 0.4) for m in MODES])
def test_reference_loop_matches_route(mode, layers, bidir, p):
    """``_rnn_reference`` (the plain per-step loop) against the fused
    route, forward and gradients, dropout under training where p > 0."""
    ins = _inputs(mode, layers, bidir, seed=3)
    attrs = _attrs(mode, layers, bidir, p=p, is_train=p > 0)
    _check(_torch_run(trnn._rnn_reference, ins, attrs),
           _torch_run(trnn._rnn_op, ins, attrs))


@pytest.mark.parametrize("mode", MODES)
def test_param_size_and_layout_match_jax(mode):
    for layers, bidir in ((1, False), (3, True)):
        assert trnn.rnn_param_size(mode, 7, 5, layers, bidir) == \
            jrnn.rnn_param_size(mode, 7, 5, layers, bidir)
        assert trnn._layer_param_sizes(mode, 7, 5, layers, bidir) == \
            jrnn._layer_param_sizes(mode, 7, 5, layers, bidir)
        n = trnn.rnn_param_size(mode, 7, 5, layers, bidir)
        blob = np.arange(n, dtype=np.float32)
        got = trnn._unpack_params(torch.from_numpy(blob), mode, 7, 5,
                                  layers, bidir)
        want = jrnn._unpack_params(jnp.asarray(blob), mode, 7, 5, layers,
                                   bidir)
        assert sorted(got) == sorted(want)
        for ld in want:
            for kind in want[ld]:
                np.testing.assert_array_equal(got[ld][kind].numpy(),
                                              np.asarray(want[ld][kind]))


def test_bad_blob_size_raises():
    ins = _inputs("gru", 1, False)
    with pytest.raises(tmx.MXNetError, match="parameter blob"):
        trnn._rnn_op(torch.tensor(ins[0]), torch.tensor(ins[1][:-1]),
                     torch.tensor(ins[2]), state_size=H, mode="gru")


@pytest.mark.parametrize("mode,state_outputs", [
    ("lstm", True), ("lstm", False), ("gru", True), ("rnn_relu", False)])
def test_symbol_surface_matches_jax(mode, state_outputs):
    """mx.sym.RNN's arguments, inferred shapes and visible outputs; the
    bound graph's forward equal to the JAX package's; lstm_state_clip_*
    accepted and ignored."""
    res = []
    for mx in (jmx, tmx):
        data = mx.sym.Variable("data")
        net = mx.sym.RNN(data, state_size=H, num_layers=2, mode=mode,
                         bidirectional=True, state_outputs=state_outputs,
                         lstm_state_clip_min=-1.0, lstm_state_clip_max=1.0,
                         name="r")
        args, outs, aux = net.infer_shape(data=(T, N, I))
        kw = {"ctx": tmx.cpu()} if mx is tmx else {}
        ex = net.simple_bind(data=(T, N, I), **kw)
        rng = np.random.RandomState(5)
        feed = {name: (0.3 * rng.randn(*shape)).astype(np.float32)
                for name, shape in zip(net.list_arguments(), args)}
        got = [o.asnumpy() for o in ex.forward(**feed)]
        res.append((net.list_arguments(), args, outs, aux,
                    len(net.list_outputs()), got))
    (ja, js, jo, jx, jn, jv), (ta, ts, to, tx, tn, tv) = res
    assert (ta, ts, to, tx, tn) == (ja, js, jo, jx, jn)
    assert tn == (1 if not state_outputs else 3 if mode == "lstm" else 2)
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, **FWD)


def test_nd_rnn_records_gradient_into_the_blob():
    """mx.nd.RNN under autograd.record on the CPU: the blob's gradient
    equals the plain loop's."""
    ins = _inputs("lstm", 2, False)
    with tmx.cpu():
        arrs = [tmx.nd.array(a) for a in ins]
        arrs[1].attach_grad()
        with tmx.autograd.record():
            out = tmx.nd.RNN(*arrs, state_size=H, num_layers=2,
                             mode="lstm")
            loss = (out * out).sum()
        loss.backward()
    blob = torch.tensor(ins[1], requires_grad=True)
    ref = trnn._rnn_reference(torch.tensor(ins[0]), blob,
                              torch.tensor(ins[2]), torch.tensor(ins[3]),
                              state_size=H, num_layers=2, mode="lstm")
    (ref * ref).sum().backward()
    np.testing.assert_allclose(out.asnumpy(), ref.detach().numpy(), **FWD)
    np.testing.assert_allclose(arrs[1].grad.asnumpy(), blob.grad.numpy(),
                               **GRAD)
