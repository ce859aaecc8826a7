"""The warp ops, linalg, fft/ifft, count_sketch and the quantize pair in
the port against the JAX package, on the CPU — the cases of
``tests/test_warp_and_predict.py`` (its LibSVMIter cases are sparse
storage, not ported) and ``tests/test_rcnn_contrib_ops.py``'s contrib
tail, each run through ``mx.nd`` in both packages from the same numpy
inputs, with the JAX tests' own expectations checked on the port:

* forward within rtol 1e-5 / atol 1e-6 (quantized integers equal), and
  the gradients of the differentiable ones within rtol 1e-4 / atol 1e-5
  of the JAX package's through ``autograd.record()``;
* ``gelqf``: Q and L within rtol 1e-4 / atol 1e-5 of JAX's (both LAPACK
  Householder on the CPU) and L.Q = A, Q.Q^T = I within 1e-5;
* a JAX checkpoint served by the port's ``load_checkpoint_predictor`` and
  by its export reloaded headless, within rtol 1e-6 of the JAX
  predictor.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _f32(*shape, seed=0, lo=None, hi=None):
    rs = np.random.RandomState(seed)
    if lo is not None:
        return rs.uniform(lo, hi, shape).astype(np.float32)
    return rs.randn(*shape).astype(np.float32)


def _both(fn, inputs, grad=()):
    """fn(mx, *nd_inputs) in both packages -> [(outputs, grads)] as
    numpy; the inputs listed in ``grad`` are attach_grad'ed and the sum
    of the first output is differentiated."""
    res = []
    for mx, of in ((jmx, jmx.nd.array),
                   (tmx, lambda v: tmx.nd.array(v, ctx=tmx.cpu(),
                                                dtype=v.dtype))):
        with (tmx.cpu() if mx is tmx else _nullcontext()):
            xs = [of(x) for x in inputs]
            for i in grad:
                xs[i].attach_grad()
            with mx.autograd.record():
                out = fn(mx, *xs)
                outs = list(out) if isinstance(out, (list, tuple)) \
                    else [out]
                head = (outs[0] * outs[0]).sum()
            if grad:
                head.backward()
            res.append(([np.asarray(o.asnumpy()) for o in outs],
                        [np.asarray(xs[i].grad.asnumpy()) for i in grad]))
    return res


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _check(res, fwd=FWD):
    (jo, jg), (to, tg) = res
    for t, j in zip(to, jo):
        assert t.shape == j.shape and t.dtype == j.dtype
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(t, j, **fwd)
        else:
            np.testing.assert_array_equal(t, j)
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t, j, **GRAD)
    return to, tg


# ---------------------------------------------------------------------------
# warp ops (tests/test_warp_and_predict.py)
# ---------------------------------------------------------------------------

def test_grid_generator_identity_affine():
    to, _ = _check(_both(lambda mx, t: mx.nd.GridGenerator(
        t, transform_type="affine", target_shape=(3, 4)),
        [np.array([[1, 0, 0, 0, 1, 0]], np.float32)], grad=(0,)))
    np.testing.assert_allclose(to[0][0, 0, 0], [-1, -1 / 3, 1 / 3, 1],
                               atol=1e-6)
    np.testing.assert_allclose(to[0][0, 1, :, 0], [-1, 0, 1], atol=1e-6)


def test_grid_generator_warp_zero_flow():
    to, _ = _check(_both(lambda mx, f: mx.nd.GridGenerator(
        f, transform_type="warp"), [np.zeros((1, 2, 3, 3), np.float32)],
        grad=(0,)))
    np.testing.assert_allclose(to[0][0, 0, 0], [-1, 0, 1], atol=1e-6)


def test_bilinear_identity_grid_reproduces_input():
    data = _f32(2, 3, 5, 4)
    theta = np.tile(np.array([[1, 0, 0, 0, 1, 0]], np.float32), (2, 1))
    to, _ = _check(_both(lambda mx, d, t: mx.nd.BilinearSampler(
        d, mx.nd.GridGenerator(t, transform_type="affine",
                               target_shape=(5, 4))), [data, theta],
        grad=(0,)))
    # (the samples land on pixel centres, where the gradient in the grid
    # has a kink: each package's linspace rounds to its own side of it)
    np.testing.assert_allclose(to[0], data, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grid,want", [
    (np.full((1, 2, 2, 2), 5.0, np.float32), 0.0),       # outside: zero
    (np.zeros((1, 2, 1, 1), np.float32), 1.5)])          # the centre
def test_bilinear_boundary_and_midpoint(grid, want):
    data = np.array([[[[0., 1.], [2., 3.]]]], np.float32)
    to, _ = _check(_both(lambda mx, d, g: mx.nd.BilinearSampler(d, g),
                         [data, grid], grad=(0,)))
    assert np.all(to[0] == want)


def test_bilinear_gradients_match_jax():
    _t, tg = _check(_both(lambda mx, d, g: mx.nd.BilinearSampler(d, g),
                          [_f32(1, 2, 4, 4, seed=1),
                           _f32(1, 2, 3, 3, seed=2, lo=-0.9, hi=0.9)],
                          grad=(0, 1)))
    assert np.abs(tg[0]).sum() > 0 and np.abs(tg[1]).sum() > 0


def test_spatial_transformer_is_grid_plus_sampler():
    data, theta = _f32(2, 3, 6, 6, seed=1), _f32(2, 6, seed=2, lo=-1, hi=1)
    st, _ = _check(_both(lambda mx, d, t: mx.nd.SpatialTransformer(
        d, t, target_shape=(4, 5), transform_type="affine",
        sampler_type="bilinear"), [data, theta], grad=(0, 1)))
    with tmx.cpu():
        grid = tmx.nd.GridGenerator(tmx.nd.array(theta),
                                    transform_type="affine",
                                    target_shape=(4, 5))
        two = tmx.nd.BilinearSampler(tmx.nd.array(data), grid).asnumpy()
    np.testing.assert_allclose(st[0], two, rtol=1e-6)


def test_correlation_zero_displacement_is_mean_square():
    a = _f32(1, 4, 6, 6, seed=2)
    to, _ = _check(_both(lambda mx, x, y: mx.nd.Correlation(
        x, y, kernel_size=1, max_displacement=1, stride1=1, stride2=1,
        pad_size=1), [a, a], grad=(0, 1)))
    assert to[0].shape == (1, 9, 6, 6)
    np.testing.assert_allclose(to[0][0, 4], (a[0] ** 2).mean(0), rtol=1e-5)


def test_correlation_displacement_picks_up_shift():
    a = np.zeros((1, 1, 5, 5), np.float32)
    b = np.zeros((1, 1, 5, 5), np.float32)
    a[0, 0, 2, 2] = 1.0
    b[0, 0, 2, 3] = 1.0
    to, _ = _check(_both(lambda mx, x, y: mx.nd.Correlation(
        x, y, kernel_size=1, max_displacement=1, pad_size=1), [a, b]))
    assert to[0][0, 5, 2, 2] == 1.0 and to[0][0, 4].max() == 0.0


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------

_SPD = (lambda m: (m @ m.T + 4 * np.eye(4)).astype(np.float32))(
    _f32(4, 4, seed=7))
_TRI = (np.tril(_f32(4, 4, seed=8)) + 3 * np.eye(4)).astype(np.float32)


def test_potrf_potri_invert():
    to, _ = _check(_both(lambda mx, a: mx.nd.linalg_potri(
        mx.nd.linalg_potrf(a)), [_SPD], grad=(0,)))
    np.testing.assert_allclose(to[0] @ _SPD, np.eye(4), atol=1e-4)


@pytest.mark.parametrize("transpose,rightside", [(False, False),
                                                 (True, False),
                                                 (False, True),
                                                 (True, True)])
def test_trsm_solves_and_trmm_inverts(transpose, rightside):
    B = _f32(*((3, 4) if rightside else (4, 3)), seed=9)
    kw = dict(transpose=transpose, rightside=rightside)
    to, _ = _check(_both(lambda mx, a, b: mx.nd.linalg_trmm(
        a, mx.nd.linalg_trsm(a, b, alpha=2.0, **kw), **kw),
        [_TRI, B], grad=(0, 1)))
    np.testing.assert_allclose(to[0], 2 * B, rtol=1e-4, atol=1e-4)


def test_gemm_syrk_sumlogdiag():
    A, Bm, C = _f32(2, 3, 4), _f32(2, 5, 4, seed=1), _f32(2, 3, 5, seed=2)
    to, _ = _check(_both(lambda mx, a, b, c: mx.nd.linalg_gemm(
        a, b, c, transpose_b=True, alpha=0.5, beta=2.0), [A, Bm, C],
        grad=(0, 1, 2)))
    np.testing.assert_allclose(to[0], 0.5 * A @ Bm.transpose(0, 2, 1) +
                               2 * C, rtol=1e-5, atol=1e-5)
    _check(_both(lambda mx, a: mx.nd.linalg_syrk(a, alpha=0.5),
                 [_f32(3, 5)], grad=(0,)))
    to, _ = _check(_both(lambda mx, a: mx.nd.linalg_sumlogdiag(a), [_TRI],
                         grad=(0,)))
    np.testing.assert_allclose(to[0], np.log(np.diag(_TRI)).sum(),
                               rtol=1e-6)


def test_gelqf_matches_jax_and_factors():
    A = _f32(3, 5, seed=4)
    to, _ = _check(_both(lambda mx, a: mx.nd.linalg_gelqf(a), [A],
                         grad=(0,)), fwd=dict(rtol=1e-4, atol=1e-5))
    q, l = (x.astype(np.float64) for x in to)
    np.testing.assert_allclose(l @ q, A, atol=1e-5)
    np.testing.assert_allclose(q @ q.T, np.eye(3), atol=1e-5)
    assert np.allclose(np.triu(l, 1), 0)


def test_khatri_rao_columns():
    a, b = _f32(2, 3), _f32(4, 3, seed=1)
    to, _ = _check(_both(lambda mx, x, y: mx.nd.khatri_rao(x, y), [a, b],
                         grad=(0, 1)))
    for k in range(3):
        np.testing.assert_allclose(to[0][:, k], np.kron(a[:, k], b[:, k]),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# fft, count_sketch, quantize (tests/test_rcnn_contrib_ops.py)
# ---------------------------------------------------------------------------

def test_fft_matches_numpy_and_ifft_is_unnormalized():
    x = _f32(3, 8)
    to, _ = _check(_both(lambda mx, v: mx.nd.contrib.fft(v), [x],
                         grad=(0,)), fwd=dict(rtol=1e-5, atol=1e-5))
    ref = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(to[0], np.stack([ref.real, ref.imag], -1)
                               .reshape(3, 16), rtol=1e-4, atol=1e-4)
    to, _ = _check(_both(lambda mx, v: mx.nd.contrib.ifft(
        mx.nd.contrib.fft(v)), [x], grad=(0,)),
        fwd=dict(rtol=1e-5, atol=1e-5))
    np.testing.assert_allclose(to[0], x * 8, rtol=1e-4, atol=1e-4)


def test_count_sketch_matches_numpy():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 10).astype(np.float32)
    h = rng.randint(0, 6, (1, 10)).astype(np.float32)
    s = rng.choice([-1.0, 1.0], (1, 10)).astype(np.float32)
    to, _ = _check(_both(lambda mx, a, hh, ss: mx.nd.contrib.count_sketch(
        a, hh, ss, out_dim=6), [x, h, s], grad=(0,)))
    ref = np.zeros((4, 6), np.float32)
    for j in range(10):
        ref[:, int(h[0, j])] += s[0, j] * x[:, j]
    np.testing.assert_allclose(to[0], ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_type,lo,hi,levels", [("uint8", -2.0, 3.0, 255),
                                                   ("int8", -2.0, 3.0, 254)])
def test_quantize_roundtrip(out_type, lo, hi, levels):
    x = _f32(4, 5, seed=3, lo=-2, hi=3)
    to, _ = _check(_both(lambda mx, v, a, b: mx.nd.contrib.dequantize(
        *mx.nd.contrib.quantize(v, a, b, out_type=out_type),
        out_type="float32"), [x, np.array([lo], np.float32),
                              np.array([hi], np.float32)]))
    np.testing.assert_allclose(to[0], x, atol=(hi - lo) / levels + 1e-6)
    q, _ = _check(_both(lambda mx, v, a, b: mx.nd.contrib.quantize(
        v, a, b, out_type=out_type)[0], [x, np.array([lo], np.float32),
                                         np.array([hi], np.float32)]))
    assert q[0].dtype == np.dtype(out_type)


# ---------------------------------------------------------------------------
# the predict path (tests/test_warp_and_predict.py's TestPredictor)
# ---------------------------------------------------------------------------

def test_jax_checkpoint_served_by_the_port(tmp_path):
    np.random.seed(0)
    X = np.random.randn(64, 6).astype(np.float32)
    y = (X.sum(1) > 0).astype(np.float32)
    net = jmx.sym.SoftmaxOutput(jmx.sym.FullyConnected(
        jmx.sym.Variable("data"), num_hidden=2, name="fc"), name="softmax")
    mod = jmx.mod.Module(net, ("data",), ("softmax_label",))
    mod.fit(jmx.io.NDArrayIter(X, y, batch_size=16), num_epoch=2,
            optimizer="sgd", optimizer_params={"learning_rate": 0.5})
    prefix = str(tmp_path / "m")
    mod.save_checkpoint(prefix, 1)
    want = np.asarray(jmx.predictor.load_checkpoint_predictor(prefix, 1)
                      .forward(data=X[:8])[0].asnumpy())
    with tmx.cpu():
        pred = tmx.predictor.load_checkpoint_predictor(prefix, 1)
    got = pred.forward(data=X[:8])[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got.sum(1), np.ones(8), rtol=1e-5)
    art = pred.export(str(tmp_path / "deploy"), {"data": (8, 6)})
    assert os.path.exists(art)
    loaded = tmx.predictor.CompiledPredictor.load(str(tmp_path / "deploy"),
                                                  ctx=tmx.cpu())
    np.testing.assert_allclose(loaded.forward(data=X[:8])[0].asnumpy(),
                               want, rtol=1e-6)
    assert loaded.output_names == ["softmax_output"]
