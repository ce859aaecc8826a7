"""The port's ``gluon.rnn`` against the JAX package's, on the CPU: every
cell's ``unroll`` (merged and per-step outputs, NTC and TNC), eager and
for the gated cells hybridized, and the RNN / LSTM / GRU layers
(multi-layer, bidirectional, with dropout), outputs, states and
gradients from one seed. Dropout and Zoneout masks come from the
threefry stream in both packages, so they agree bit for bit. Forward
rtol 1e-5 / atol 1e-6; gradients rtol 1e-4 / atol 1e-5."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_gluon import FWD, GRAD, _flat

T, N, C, H = 3, 2, 4, 5
X_NTC = np.random.RandomState(0).randn(N, T, C).astype(np.float32)


def _cells(mx):
    r = mx.gluon.rnn
    return {
        "rnn_tanh": lambda: r.RNNCell(H),
        "rnn_relu": lambda: r.RNNCell(H, activation="relu"),
        "lstm": lambda: r.LSTMCell(H),
        "gru": lambda: r.GRUCell(H),
        "sequential": lambda: _stack(mx),
        "dropout": lambda: r.DropoutCell(0.5),
        "zoneout": lambda: r.ZoneoutCell(r.LSTMCell(H), 0.3, 0.2),
        "residual": lambda: r.ResidualCell(r.GRUCell(C)),
        "bidirectional": lambda: r.BidirectionalCell(r.LSTMCell(H),
                                                     r.GRUCell(H)),
    }


def _stack(mx):
    cell = mx.gluon.rnn.SequentialRNNCell()
    with cell.name_scope():
        cell.add(mx.gluon.rnn.LSTMCell(H))
        cell.add(mx.gluon.rnn.DropoutCell(0.4))
        cell.add(mx.gluon.rnn.GRUCell(H))
    return cell


def run_cell(mx, name, layout, merge, hybrid):
    """Unroll cell ``name`` over X_NTC (as ``layout``) under record(),
    backpropagate fixed cotangents into every output and final state."""
    x = X_NTC if layout == "NTC" else X_NTC.transpose(1, 0, 2)
    with mx.cpu():
        mx.random.seed(3)
        cell = _cells(mx)[name]()
        cell.collect_params().initialize(mx.init.Xavier(), ctx=mx.cpu())
        if hybrid:
            cell.hybridize()
        X = mx.nd.array(x)
        X.attach_grad()
        with mx.autograd.record():
            outs, states = cell.unroll(T, X, layout=layout,
                                       merge_outputs=merge)
        flat = _flat([outs, states])
        cts = [mx.nd.array(np.random.RandomState(5 + i).randn(
            *o.shape).astype(np.float32)) for i, o in enumerate(flat)]
        mx.autograd.backward(flat, cts)
        k = len(cell.prefix)
        return ([o.asnumpy() for o in flat], X.grad.asnumpy(),
                {n[k:]: p.grad().asnumpy()
                 for n, p in cell.collect_params().items()})


def _assert_same(t, j):
    assert len(t[0]) == len(j[0])
    for a, b in zip(t[0], j[0]):
        np.testing.assert_allclose(a, b, **FWD)
    np.testing.assert_allclose(t[1], j[1], **GRAD)
    assert sorted(t[2]) == sorted(j[2])
    for n in j[2]:
        np.testing.assert_allclose(t[2][n], j[2][n], err_msg=n, **GRAD)


CELL_CASES = [(n, layout, merge, False)
              for n in ("rnn_tanh", "rnn_relu", "lstm", "gru", "sequential",
                        "dropout", "zoneout", "residual", "bidirectional")
              for layout, merge in (("NTC", True), ("TNC", False))] + [
    (n, "NTC", None, True) for n in ("lstm", "gru", "rnn_tanh")] + [
    ("lstm", "TNC", True, False), ("bidirectional", "NTC", None, False)]


@pytest.mark.parametrize("name,layout,merge,hybrid", CELL_CASES, ids=[
    "%s-%s-merge%s-%s" % (n, lay, m, "hybrid" if h else "eager")
    for n, lay, m, h in CELL_CASES])
def test_cell_unroll_matches_jax(name, layout, merge, hybrid):
    _assert_same(run_cell(tmx, name, layout, merge, hybrid),
                 run_cell(jmx, name, layout, merge, hybrid))


def run_layer(mx, kind, kw, with_states, layout):
    x = X_NTC.transpose(1, 0, 2) if layout == "TNC" else X_NTC
    with mx.cpu():
        mx.random.seed(4)
        layer = getattr(mx.gluon.rnn, kind)(H, layout=layout, **kw)
        layer.collect_params().initialize(mx.init.Xavier(), ctx=mx.cpu())
        X = mx.nd.array(x)
        X.attach_grad()
        with mx.autograd.record():
            if with_states:
                states = layer.begin_state(N, func=mx.nd.ones)
                out = layer(X, states)
            else:
                out = layer(X)
        flat = _flat(out)
        cts = [mx.nd.array(np.random.RandomState(9 + i).randn(
            *o.shape).astype(np.float32)) for i, o in enumerate(flat)]
        mx.autograd.backward(flat, cts)
        k = len(layer.prefix)
        return ([o.asnumpy() for o in flat], X.grad.asnumpy(),
                {n[k:]: p.grad().asnumpy()
                 for n, p in layer.collect_params().items()})


LAYER_CASES = [
    ("RNN", {"num_layers": 2, "activation": "tanh"}, False, "TNC"),
    ("RNN", {"activation": "relu", "bidirectional": True}, True, "NTC"),
    ("LSTM", {"num_layers": 2, "dropout": 0.3, "bidirectional": True}, True,
     "TNC"),
    ("LSTM", {"input_size": C}, False, "NTC"),
    ("GRU", {"num_layers": 2, "dropout": 0.5}, True, "TNC"),
    ("GRU", {"bidirectional": True}, False, "NTC"),
]


@pytest.mark.parametrize("kind,kw,with_states,layout", LAYER_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(LAYER_CASES)])
def test_layer_matches_jax(kind, kw, with_states, layout):
    t = run_layer(tmx, kind, kw, with_states, layout)
    j = run_layer(jmx, kind, kw, with_states, layout)
    _assert_same(t, j)
    ndir = 2 if kw.get("bidirectional") else 1
    assert t[0][0].shape == ((T, N, H * ndir) if layout == "TNC"
                             else (N, T, H * ndir))
