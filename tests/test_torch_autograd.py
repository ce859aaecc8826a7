"""The port's imperative autograd against the JAX package's.

Every test of ``tests/test_autograd.py`` is mirrored: the same user code
runs on ``mxnet_tpu`` and on ``mxnet_tpu_torch`` (under ``with
mx.cpu():``) from the same numpy inputs, and the values and gradients it
returns must agree within rtol 1e-5 / atol 1e-6 (float32 on the CPU,
different summation orders), beside the reference's own expectations.
Added: ``autograd.grad``, a second ``backward`` on one graph, a marked
variable used as a head, ``Function`` with two outputs, the ``grad_req``
rules across and within calls, in-place writes to variables, and
``_contrib_FlashAttention`` under ``record()`` against the JAX op run as
``tests/test_attention.py`` runs it on the CPU (its Pallas kernel in
interpret mode).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def both(fn, atol=ATOL):
    """fn(mx) -> list of arrays/NDArrays, run on each package; returns
    (jax results, port results) as numpy lists and checks they agree."""
    j = [np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)
         for x in fn(jmx)]
    with tmx.cpu():
        t = [np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)
             for x in fn(tmx)]
    assert len(j) == len(t)
    for n, (a, b) in enumerate(zip(j, t)):
        assert a.shape == b.shape, (n, a.shape, b.shape)
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=atol,
                                   err_msg="result %d" % n)
    return j, t


# -- mirrors of tests/test_autograd.py ----------------------------------------

def test_simple_grad():
    def run(mx):
        x = mx.nd.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
        y.backward()
        return [y, x.grad]
    _, (y, g) = both(run)
    np.testing.assert_allclose(g, [2, 4, 6])


def test_chain():
    def run(mx):
        x = mx.nd.array([[1.0, 2.0], [3.0, 4.0]])
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.exp(x) * 2
            z = y.sum()
        z.backward()
        return [z, x.grad]
    _, (_, g) = both(run)
    np.testing.assert_allclose(g, 2 * np.exp([[1, 2], [3, 4]]), rtol=1e-5)


def test_multi_input():
    def run(mx):
        a = mx.nd.array([1.0, 2.0])
        b = mx.nd.array([3.0, 4.0])
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            c = a * b + a
        c.backward()
        return [a.grad, b.grad]
    _, (ga, gb) = both(run)
    np.testing.assert_allclose(ga, [4, 5])
    np.testing.assert_allclose(gb, [1, 2])


@pytest.mark.parametrize("kind", ["ndarray", "numpy", "none"])
def test_head_grads(kind):
    def run(mx):
        x = mx.nd.array([1.0, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = 3 * x
        hg = {"ndarray": mx.nd.array([10.0, 100.0]),
              "numpy": np.array([10.0, 100.0], np.float32),
              "none": None}[kind]
        mx.autograd.backward([y], [hg] if hg is not None else None)
        return [x.grad]
    _, (g,) = both(run)
    np.testing.assert_allclose(g, [3, 3] if kind == "none" else [30, 300])


def test_grad_req_add():
    def run(mx):
        x = mx.nd.array([1.0])
        x.attach_grad(grad_req="add")
        for _ in range(3):
            with mx.autograd.record():
                y = 2 * x
            y.backward()
        return [x.grad]
    _, (g,) = both(run)
    np.testing.assert_allclose(g, [6.0])


def test_pause():
    def run(mx):
        x = mx.nd.array([1.0, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
            with mx.autograd.pause():
                z = y * 2  # not recorded
            w = y + 1
        w.backward()
        return [x.grad, z]
    _, (g, _z) = both(run)
    np.testing.assert_allclose(g, [2, 4])


def test_training_modes():
    for mx in (jmx, tmx):
        ag = mx.autograd
        assert not ag.is_training()
        with ag.record():
            assert ag.is_training() and ag.is_recording()
            with ag.predict_mode():
                assert not ag.is_training()
        assert not ag.is_recording()
        with ag.train_mode():
            assert ag.is_training()
        with ag.record(train_mode=False):
            assert ag.is_recording() and not ag.is_training()
        assert ag.set_recording(True) is False
        assert ag.set_recording(False) is True
        assert ag.set_training(True) is False
        assert ag.set_training(False) is True


def test_detach():
    def run(mx):
        x = mx.nd.array([2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
            z = y.detach() * x
        z.backward()
        return [x.grad]
    _, (g,) = both(run)
    np.testing.assert_allclose(g, [4.0])  # y treated as a constant


def test_matmul_grad():
    a_np, w_np = _rand(3, 4), _rand(5, 4, seed=1)

    def run(mx):
        a = mx.nd.array(a_np)
        w = mx.nd.array(w_np)
        w.attach_grad()
        with mx.autograd.record():
            out = mx.nd.FullyConnected(a, w, no_bias=True, num_hidden=5)
            loss = out.sum()
        loss.backward()
        return [loss, w.grad]
    _, (_, g) = both(run)
    np.testing.assert_allclose(g, np.ones((3, 5)).T @ a_np, rtol=1e-5)


def test_softmax_output_grad():
    d_np = _rand(4, 3)

    def run(mx):
        data = mx.nd.array(d_np)
        label = mx.nd.array([0.0, 1.0, 2.0, 1.0])
        data.attach_grad()
        with mx.autograd.record():
            out = mx.nd.SoftmaxOutput(data, label)
        out.backward()
        return [out, data.grad, label]
    _, (_, g, _l) = both(run)
    p = np.exp(d_np)
    p /= p.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(g, p - np.eye(3)[[0, 1, 2, 1]], rtol=1e-5,
                               atol=1e-6)


def test_mark_variables():
    def run(mx):
        x = mx.nd.array([1.0, 2.0])
        g = mx.nd.zeros((2,))
        mx.autograd.mark_variables([x], [g])
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
        return [g]
    _, (g,) = both(run)
    np.testing.assert_allclose(g, [2, 4])


def test_grad_function():
    def run(mx):
        class Sigmoid(mx.autograd.Function):
            def forward(self, x):
                y = 1 / (1 + mx.nd.exp(-x))
                self.save = y
                return y

            def backward(self, dy):
                y = self.save
                return dy * y * (1 - y)

        inp = mx.nd.array([0.0, 1.5, -2.0])
        inp.attach_grad()
        with mx.autograd.record():
            out = Sigmoid()(inp)
        out.backward()
        return [out, inp.grad]
    _, (_, g) = both(run)
    np.testing.assert_allclose(g[0], 0.25, rtol=1e-5)


def test_numeric_gradient():
    """The mirror of test_numeric_gradient_helper without test_utils
    (not ported yet): central differences in float64 on the host against
    the port's gradient, and both packages' gradients against each
    other."""
    x_np = _rand(3, 2)

    def f(x):
        return (x * x + 2 * x).sum()

    def run(mx):
        x = mx.nd.array(x_np)
        x.attach_grad()
        with mx.autograd.record():
            y = f(x)
        y.backward()
        return [x.grad]
    _, (g,) = both(run)
    eps = 1e-3
    num = np.zeros_like(x_np, np.float64)
    for i in np.ndindex(x_np.shape):
        hi, lo = x_np.astype(np.float64), x_np.astype(np.float64)
        hi[i] += eps
        lo[i] -= eps
        num[i] = ((hi * hi + 2 * hi).sum() - (lo * lo + 2 * lo).sum()) / (
            2 * eps)
    np.testing.assert_allclose(g, num, rtol=1e-3, atol=1e-3)


def test_batchnorm_aux_update():
    d_np = _rand(4, 3, 2, 2) + 5

    def run(mx):
        data = mx.nd.array(d_np)
        gamma, beta = mx.nd.ones((3,)), mx.nd.zeros((3,))
        mm, mv = mx.nd.zeros((3,)), mx.nd.ones((3,))
        with mx.autograd.record():
            out = mx.nd.BatchNorm(data, gamma, beta, mm, mv,
                                  fix_gamma=False, momentum=0.9)
        return [out, mm, mv]
    # atol 1e-5: the inputs sit at 5 +- 0.5, so the batch variance is a
    # difference of large numbers and the two packages' summation orders
    # move the normalised output by ~2e-6
    _, (out, mm, _mv) = both(run, atol=1e-5)
    assert mm.mean() > 0.1           # moving stats moved toward the batch's
    assert abs(out.mean()) < 1e-3    # and the output is normalised


def test_batchnorm_gradients_and_writeback_under_record():
    rng = np.random.RandomState(4)
    d_np, w_np = (rng.randn(4, 3, 2, 2).astype(np.float32) for _ in range(2))

    def run(mx):
        data = mx.nd.array(d_np)
        gamma, beta = mx.nd.array([1.0, 0.5, 2.0]), mx.nd.zeros((3,))
        mm, mv = mx.nd.zeros((3,)), mx.nd.ones((3,))
        for a in (data, gamma, beta):
            a.attach_grad()
        with mx.autograd.record():
            out = mx.nd.BatchNorm(data, gamma, beta, mm, mv,
                                  fix_gamma=False, momentum=0.9)
            y = out * mx.nd.array(w_np)
        y.backward()
        return [out, mm, mv, data.grad, gamma.grad, beta.grad]
    _, (_o, mm, _mv, _gd, _gg, _gb) = both(run)
    assert mm.any()


# -- beyond the reference's tests -----------------------------------------------

def test_autograd_grad_leaves_buffers():
    def run(mx):
        x = mx.nd.array([1.0, 2.0, 3.0])
        w = mx.nd.array([0.5, -1.0, 2.0])
        x.attach_grad()
        w.attach_grad()
        with mx.autograd.record():
            y = (x * x * w).sum()
        gx, gw = mx.autograd.grad(y, [x, w])
        return [gx, gw, x.grad, w.grad]
    _, (gx, gw, bx, bw) = both(run)
    np.testing.assert_allclose(gx, [1, -4, 12])
    np.testing.assert_allclose(gw, [1, 4, 9])
    assert not bx.any() and not bw.any()   # buffers untouched


def test_second_backward_on_one_graph():
    """The graph survives a backward: a second one gives the same
    gradient (write) or doubles it (add), as the reference's tape."""
    def run(mx):
        x = mx.nd.array([1.0, -2.0])
        x.attach_grad()
        a = mx.nd.array([1.0, 2.0])
        a.attach_grad(grad_req="add")
        with mx.autograd.record():
            y = mx.nd.sin(x) * x
            z = (a * a).sum()
        y.backward()
        first = x.grad.copy()
        y.backward()
        z.backward()
        z.backward()
        return [first, x.grad, a.grad]
    _, (first, second, ga) = both(run)
    np.testing.assert_array_equal(first, second)
    np.testing.assert_allclose(ga, [4, 8])


def test_write_overwrites_across_calls_and_sums_within():
    def run(mx):
        x = mx.nd.array([1.0, 2.0])
        x.attach_grad()
        outs = []
        for k in (1.0, 3.0):
            with mx.autograd.record():
                y = x * k + x * x        # x used twice: summed
            y.backward()
            outs.append(x.grad.copy())
        return outs
    _, (g1, g2) = both(run)
    np.testing.assert_allclose(g1, [3, 5])
    np.testing.assert_allclose(g2, [5, 7])


def test_variable_as_head_and_null_req():
    def run(mx):
        x = mx.nd.array([1.0, 2.0])
        x.attach_grad()
        n = mx.nd.array([3.0, 4.0])
        n.attach_grad(grad_req="null")
        with mx.autograd.record():
            y = x * n
        mx.autograd.backward([x, y], [mx.nd.array([10.0, 20.0]), None])
        return [x.grad]
    _, (g,) = both(run)
    np.testing.assert_allclose(g, [13, 24])   # 10 + n, 20 + n


def test_unreached_variable_keeps_its_buffer():
    def run(mx):
        x = mx.nd.array([1.0])
        u = mx.nd.array([5.0])
        x.attach_grad()
        u.attach_grad()
        u.grad[:] = 7.0
        with mx.autograd.record():
            y = x * 2
        y.backward()
        return [x.grad, u.grad]
    _, (gx, gu) = both(run)
    np.testing.assert_allclose(gu, [7.0])


def test_function_with_two_outputs():
    def run(mx):
        class SinCos(mx.autograd.Function):
            def forward(self, x):
                self.x = x
                return mx.nd.sin(x), mx.nd.cos(x)

            def backward(self, ds, dc):
                return ds * mx.nd.cos(self.x) - dc * mx.nd.sin(self.x)

        x = mx.nd.array([0.3, -1.2, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            s, c = SinCos()(x)
            y = (s * 2 + c * 3).sum()
        y.backward()
        return [s, c, x.grad]
    _, (s, c, g) = both(run)
    x = np.array([0.3, -1.2, 2.0])
    np.testing.assert_allclose(g, 2 * np.cos(x) - 3 * np.sin(x), rtol=1e-5)


def test_nondiff_ops_and_inputs_build_no_graph():
    """Comparisons, argmax, round and topk give no gradient; an index
    input (take's) never receives one; outside record() a variable
    builds no graph at all."""
    with tmx.cpu():
        nd, ag = tmx.nd, tmx.autograd
        x = nd.array([[0.5, -1.5], [2.0, 0.25]])
        idx = nd.array([1.0, 0.0])
        x.attach_grad()
        idx.attach_grad()
        y = x * 2
        assert y.handle.grad_fn is None and not y.handle.requires_grad
        with ag.record():
            for out in ((x > 0), x.argmax(axis=1), nd.round(x),
                        nd.topk(x, k=1), x.argsort()):
                assert out.handle.grad_fn is None
            z = (nd.take(x, idx) * (x > 0)).sum()
        z.backward()
        # take swaps the rows: row 0 of x meets mask row 1, and so on
        np.testing.assert_allclose(x.grad.asnumpy(),
                                   [[1.0, 1.0], [1.0, 0.0]])
        assert not idx.grad.asnumpy().any()


def test_inplace_writes_keep_a_variable():
    """sgd_update(out=p), x += 1 and BatchNorm's writeback leave the
    arrays variables of the next record(), in both packages."""
    def run(mx):
        p = mx.nd.array([1.0, 2.0])
        p.attach_grad()
        res = []
        for _ in range(2):
            with mx.autograd.record():
                loss = (p * p).sum()
            loss.backward()
            mx.nd.sgd_update(p, p.grad, lr=0.1, out=p)
            res += [p.copy(), p.grad.copy()]
        x = mx.nd.array([1.0, 3.0])
        x.attach_grad()
        x += 1
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
        return res + [x, x.grad]
    _, out = both(run)
    np.testing.assert_allclose(out[-1], [4, 8])


def test_setitem_guard_under_record():
    for mx in (jmx, tmx):
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            x = mx.nd.array([1.0, 2.0])
            x.attach_grad()
            with mx.autograd.record():
                y = x * 2
                with pytest.raises(mx.base.MXNetError, match="in-place"):
                    y[0] = 5.0
                z = mx.nd.zeros((2,))
                z[0] = 1.0        # not a recorded array: allowed


def test_get_symbol_raises():
    with pytest.raises(NotImplementedError):
        tmx.autograd.get_symbol(None)


def test_backward_without_a_recorded_head_raises():
    with tmx.cpu():
        x = tmx.nd.array([1.0])
        with pytest.raises(ValueError, match="no head"):
            (x * 2).backward()


def test_flash_attention_under_record_matches_jax():
    """_contrib_FlashAttention on the eager tape: forward and the
    gradients of q, k, v against the JAX op (its Pallas kernel in
    interpret mode on the CPU), causal, f32."""
    rng = np.random.default_rng(3)
    q_np, k_np, v_np = (rng.standard_normal((1, 2, 32, 8), np.float32)
                        for _ in range(3))
    cot = rng.standard_normal((1, 2, 32, 8), np.float32)

    def run(mx):
        q, k, v = (mx.nd.array(a) for a in (q_np, k_np, v_np))
        for a in (q, k, v):
            a.attach_grad()
        with mx.autograd.record():
            o = mx.nd.contrib.FlashAttention(q, k, v, causal=True,
                                             block_q=16, block_k=16)
        o.backward(mx.nd.array(cot))
        return [o, q.grad, k.grad, v.grad]

    _, t = both(run)
    assert all(np.isfinite(x).all() for x in t)


def test_eager_calls_go_through_the_flash_wrapper(monkeypatch):
    """The eager op reaches the kernel entry (flash_fwd/flash_bwd) once
    each for a forward and a backward."""
    from mxnet_tpu_torch.ops import attention as att
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = att.flash_fwd, att.flash_bwd

    def cfwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def cbwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(att, "flash_fwd", cfwd)
    monkeypatch.setattr(att, "flash_bwd", cbwd)
    with tmx.cpu():
        q = tmx.nd.array(np.ones((1, 1, 8, 8), np.float32))
        q.attach_grad()
        y = tmx.nd.contrib.FlashAttention(q, q, q, causal=True)
        assert calls == {"fwd": 1, "bwd": 0}   # outside record: no lse
        with tmx.autograd.record():
            y = tmx.nd.contrib.FlashAttention(q, q, q, causal=True)
        y.backward()
    assert calls == {"fwd": 2, "bwd": 1}


def test_eager_mlp_recipe_matches_jax():
    """The imperative recipe of the repository's verify notes, with numpy
    initialisation (nd.random_normal waits for the PRNG decision): the
    loss after each of 20 epochs, and the final weights, in both
    packages; the loss falls."""
    def run(mx):
        nd, ag = mx.nd, mx.autograd
        rng = np.random.RandomState(0)
        N = 256
        X = rng.randn(N, 20).astype(np.float32)
        y = (X @ rng.randn(20, 1).astype(np.float32) > 0).astype(
            np.float32).ravel()
        w1, b1 = nd.array(rng.randn(64, 20) * .1), nd.zeros((64,))
        w2, b2 = nd.array(rng.randn(2, 64) * .1), nd.zeros((2,))
        ps = [w1, b1, w2, b2]
        for p in ps:
            p.attach_grad()
        d, lab = nd.array(X), nd.array(y)
        losses = []
        for _ in range(20):
            with ag.record():
                h = nd.relu(nd.FullyConnected(d, w1, b1, num_hidden=64))
                loss = nd.softmax_cross_entropy(
                    nd.FullyConnected(h, w2, b2, num_hidden=2), lab)
            loss.backward()
            for p in ps:
                nd.sgd_update(p, p.grad, lr=.1, rescale_grad=1. / N, out=p)
            losses.append(float(loss.asscalar()) / N)
        return [np.array(losses, np.float32)] + ps
    _, (losses, *_ps) = both(run, atol=1e-5)
    assert losses[-1] < 0.8 * losses[0]
