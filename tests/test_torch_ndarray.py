"""The port's NDArray surface and generated ``mx.nd`` namespace against
the JAX package's.

``tests/test_ndarray.py``'s cases are mirrored (all but the random ops,
which wait for the PRNG decision): the same user code runs on both
packages (the port under ``with mx.cpu():``) and the values it returns
must agree — float32 within rtol 1e-5 / atol 1e-6, ints exactly, dtypes
equal — beside the reference's own expectations. Added: the
``__setitem__`` guard under ``record()``, writes that never reach a
view's base, the Python protocol (iteration, truth, pickling), the free
functions, positional and keyword argument mapping of the generated
functions, ``out=``, the scalar-dtype rules, and the error an op the
port does not register yet raises.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x)


def both(fn):
    """fn(mx) -> list of results, run on each package; checks they agree
    and returns the port's as numpy."""
    j = [_np(x) for x in fn(jmx)]
    with tmx.cpu():
        t = [_np(x) for x in fn(tmx)]
    assert len(j) == len(t)
    for n, (a, b) in enumerate(zip(j, t)):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (n, a.shape, b.shape, a.dtype, b.dtype)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg="result %d" % n)
        else:
            np.testing.assert_array_equal(b, a, err_msg="result %d" % n)
    return t


# -- mirrors of tests/test_ndarray.py -------------------------------------------

def test_creation():
    def run(mx):
        nd = mx.nd
        return [nd.zeros((3, 4)), nd.ones((2, 2), dtype="int32"),
                nd.full((2,), 7.5), nd.array([[1, 2], [3, 4]]),
                nd.arange(0, 10, 2), nd.empty((2, 3)),
                nd.arange(3, repeat=2), nd.arange(1, 2.2, 0.3)]
    z, o, f, d, e, _em, r, a = both(run)
    assert z.dtype == np.float32 and z.sum() == 0
    assert o.dtype == np.int32 and o.sum() == 4
    np.testing.assert_allclose(f, [7.5, 7.5])
    assert d.dtype == np.float32 and d.shape == (2, 2)
    np.testing.assert_allclose(e, [0, 2, 4, 6, 8])
    np.testing.assert_allclose(r, [0, 0, 1, 1, 2, 2])


def test_arithmetic():
    a_np = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    b_np = a_np * 10

    def run(mx):
        a, b = mx.nd.array(a_np), mx.nd.array(b_np)
        return [a + b, b - a, a * b, b / a, a + 1, 1 + a, a - 1, 10 - a,
                a * 2, a / 2, 2 / a, a ** 2, -a, abs(-a), a % 3, 7 % a,
                2 ** a, a ** b / 1e10, a + a_np, a * np.float32(3)]
    out = both(run)
    np.testing.assert_allclose(out[7], [[9, 8], [7, 6]])
    np.testing.assert_allclose(out[10], [[2, 1], [2 / 3, 0.5]], rtol=1e-6)


def test_inplace_arithmetic():
    def run(mx):
        a = mx.nd.ones((2, 2))
        outs = []
        for op in ("+=", "*=", "-=", "/="):
            if op == "+=":
                a += 1
            elif op == "*=":
                a *= 3
            elif op == "-=":
                a -= 2
            else:
                a /= 4
            outs.append(a.copy())
        return outs
    out = both(run)
    np.testing.assert_allclose(out[-1], np.ones((2, 2)))


def test_comparisons():
    def run(mx):
        a = mx.nd.array([1.0, 2.0, 3.0])
        b = mx.nd.array([3.0, 2.0, 1.0])
        return [a == b, a != b, a > b, a >= b, a < b, a <= b, a > 1.5,
                a == 2, a <= 2]
    out = both(run)
    np.testing.assert_allclose(out[0], [0, 1, 0])
    np.testing.assert_allclose(out[5], [1, 1, 0])


def test_indexing():
    src = np.arange(24, dtype=np.float32).reshape(2, 3, 4)

    def run(mx):
        a = mx.nd.array(src)
        return [a[0], a[1, 2], a[:, 1], a[0, 1:3], a[..., ::-2], a[None, 1],
                a[mx.nd.array([1, 0])], a[mx.nd.array([1, 1, 0])],
                a[-1, ::-1, 2]]
    out = both(run)
    np.testing.assert_allclose(out[4], src[..., ::-2])
    np.testing.assert_allclose(out[6], src[[1, 0]])


def test_indexing_under_record_is_differentiable():
    src = np.arange(12, dtype=np.float32).reshape(3, 4)

    def run(mx):
        a = mx.nd.array(src)
        a.attach_grad()
        with mx.autograd.record():
            y = (a[1:, ::-1] * a[0] + a[mx.nd.array([2, 2])].sum()).sum()
        y.backward()
        return [y, a.grad]
    both(run)


def test_boolean_mask_raises():
    with tmx.cpu():
        a = tmx.nd.array([1.0, 2.0])
        with pytest.raises(NotImplementedError, match="boolean"):
            a[np.array([True, False])]


def test_setitem():
    def run(mx):
        a = mx.nd.zeros((3, 3))
        a[1] = 5.0
        first = a.copy()
        a[:] = 1.0
        second = a.copy()
        a[0, 1] = 9
        a[2] = mx.nd.array([1.0, 2.0, 3.0])
        a[:, 0] = np.array([7.0, 8.0, 9.0], np.float32)
        a[::-1, 2] = mx.nd.array([4.0, 5.0, 6.0])     # a negative step
        a[1, ::-2] = -1.0
        return [first, second, a]
    first, _second, a = both(run)
    expected = np.zeros((3, 3))
    expected[1] = 5
    np.testing.assert_allclose(first, expected)
    assert a[0, 1] == 9


def test_setitem_guard_under_record():
    for mx in (jmx, tmx):
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            x = mx.nd.array([1.0, 2.0])
            x.attach_grad()
            with mx.autograd.record():
                y = x * 2
                with pytest.raises(mx.base.MXNetError,
                                   match="in-place assignment"):
                    y[0] = 5.0
            y[0] = 5.0     # outside record(): allowed
            assert y.asnumpy()[0] == 5.0


def test_writes_never_reach_a_view_base():
    """A reshape shares storage in torch; the port's writes give the
    array a new tensor, so the other array keeps its values, as the JAX
    package's immutable arrays do."""
    def run(mx):
        a = mx.nd.array(np.arange(6, dtype=np.float32))
        b = a.reshape((2, 3))
        b[0, 0] = 100.0
        c = a.reshape((3, 2))
        c += 1
        return [a, b, c]
    a, _b, _c = both(run)
    np.testing.assert_allclose(a, np.arange(6))


def test_reshape_transpose():
    src = np.arange(12, dtype=np.float32).reshape(3, 4)

    def run(mx):
        a = mx.nd.array(src)
        return [a.reshape(4, 3), a.reshape((2, 6)), a.reshape(-1),
                a.reshape(0, -1), a.T, a.reshape(shape=(6, 2)),
                a.reshape_like(mx.nd.zeros((2, 6))), a.expand_dims(1),
                a.broadcast_to((2, 3, 4)), a.transpose(axes=(1, 0))]
    out = both(run)
    assert out[0].shape == (4, 3) and out[2].shape == (12,)
    np.testing.assert_allclose(out[4], src.T)


def test_reduce_methods():
    src = np.arange(12, dtype=np.float32).reshape(3, 4)

    def run(mx):
        a = mx.nd.array(src)
        return [a.sum(), a.sum(axis=0), a.mean(axis=1), a.max(), a.min(),
                a.argmax(axis=1), a.sum(1), a.norm(), a.prod(axis=0),
                a.clip(2, 9), a.topk(k=2), a.sort(axis=0, is_ascend=False)]
    out = both(run)
    assert out[0].item() == 66 and out[3].item() == 11
    np.testing.assert_allclose(out[5], [3, 3, 3])


def test_dot():
    a_np, b_np = (np.random.RandomState(s).rand(*sh).astype(np.float32)
                  for s, sh in ((0, (3, 4)), (1, (4, 5))))

    def run(mx):
        a, b = mx.nd.array(a_np), mx.nd.array(b_np)
        return [mx.nd.dot(a, b), mx.nd.dot(b, a, transpose_a=True,
                                           transpose_b=True),
                mx.nd.batch_dot(a.reshape(1, 3, 4), b.reshape(1, 4, 5))]
    out = both(run)
    np.testing.assert_allclose(out[0], a_np @ b_np, rtol=1e-5)


def test_conversion():
    for mx in (jmx, tmx):
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            nd = mx.nd
            a = nd.array([3.5])
            assert a.asscalar() == 3.5 and a.item() == 3.5
            assert float(a) == 3.5
            assert int(nd.array([7])) == 7
            assert len(nd.zeros((5, 2))) == 5
            assert nd.zeros((2, 3)).size == 6
            assert nd.zeros((2, 3)).ndim == 2
            assert nd.array([[1, 2]]).tolist() == [[1.0, 2.0]]
            assert bool(nd.array([1.0])) and not bool(nd.array([0.0]))
            with pytest.raises(ValueError):
                bool(nd.zeros((2,)))
            rows = [r.asnumpy().tolist() for r in nd.array([[1, 2],
                                                            [3, 4]])]
            assert rows == [[1.0, 2.0], [3.0, 4.0]]
            np.testing.assert_array_equal(np.asarray(nd.array([1, 2])),
                                          [1, 2])
            nd.waitall()
            a.wait_to_read()


def test_astype_copy():
    def run(mx):
        a = mx.nd.array([1.5, 2.5, -1.5])
        b = a.astype("int32")
        c = a.copy()
        c[:] = 0.0
        d = a.astype("float16")
        return [a, b, c, d]
    _a, b, c, _d = both(run)
    assert b.dtype == np.int32 and not c.any()


def test_context():
    with tmx.cpu():
        a = tmx.nd.zeros((2, 2), ctx=tmx.cpu(0))
        assert a.context == tmx.cpu(0) and a.ctx == tmx.cpu(0)
        b = a.as_in_context(tmx.cpu(0))
        assert b is a
        c = a.copyto(tmx.cpu(0))
        assert c is not a and c.shape == (2, 2)
        d = tmx.nd.ones((2, 2))
        a.copyto(d)
        assert not d.asnumpy().any()


def test_broadcast_ops():
    def run(mx):
        a = mx.nd.array(np.ones((2, 1, 3), np.float32))
        b = mx.nd.array(np.ones((1, 4, 3), np.float32))
        return [a + b, mx.nd.broadcast_to(mx.nd.array([[1.0], [2.0]]),
                                          shape=(2, 3)),
                mx.nd.broadcast_axis(a, axis=1, size=4),
                a.broadcast_like(mx.nd.zeros((2, 5, 3)))]
    out = both(run)
    assert out[0].shape == (2, 4, 3)
    np.testing.assert_allclose(out[1], [[1, 1, 1], [2, 2, 2]])


def test_concat_split_stack():
    def run(mx):
        nd = mx.nd
        a, b = nd.ones((2, 3)), nd.zeros((2, 3))
        parts = nd.split(nd.array(np.arange(12).reshape(2, 6)),
                         num_outputs=2, axis=1)
        return [nd.concat(a, b, dim=0), parts[0], parts[1],
                nd.stack(a, b, axis=0), nd.concatenate([a, b], axis=1),
                nd.add_n(a, b, a), nd.Concat(*[a, b], dim=1)]
    out = both(run)
    assert out[0].shape == (4, 3) and out[1].shape == (2, 3)
    assert out[3].shape == (2, 2, 3)


def test_save_load_across_packages(tmp_path):
    """Each package loads what the other saved, dict and list."""
    fname = str(tmp_path / "arrays")
    data = {"w": np.array([1.0, 2.0], np.float32),
            "i": np.arange(4, dtype=np.int32)}
    with tmx.cpu():
        tmx.nd.save(fname, {k: tmx.nd.array(v) for k, v in data.items()})
        loaded = jmx.nd.load(fname)
        for k, v in data.items():
            np.testing.assert_array_equal(loaded[k].asnumpy(), v)
        jmx.nd.save(fname, [jmx.nd.ones((2,)), jmx.nd.zeros((3,))])
        lst = tmx.nd.load(fname)
        assert isinstance(lst, list) and len(lst) == 2
        np.testing.assert_array_equal(lst[0].asnumpy(), [1, 1])


def test_unary_method_fallback():
    def run(mx):
        a = mx.nd.array([[0.5, 1.0]])
        return [a.exp(), a.log(), a.sqrt(), a.relu(), a.sigmoid(),
                a.square(), a.softmax(), a.log_softmax(axis=1)]
    out = both(run)
    np.testing.assert_allclose(out[0], np.exp([[0.5, 1.0]]), rtol=1e-6)


def test_take_embedding():
    w_np = np.arange(12, dtype=np.float32).reshape(4, 3)

    def run(mx):
        w = mx.nd.array(w_np)
        idx = mx.nd.array([0, 2])
        return [mx.nd.Embedding(idx, w, input_dim=4, output_dim=3),
                mx.nd.take(w, idx), mx.nd.pick(w, mx.nd.array([0, 1, 2, 0])),
                mx.nd.batch_take(w, mx.nd.array([2, 1, 0, 2]))]
    out = both(run)
    np.testing.assert_allclose(out[0], w_np[[0, 2]])


def test_onehot():
    def run(mx):
        out = mx.nd.zeros((2, 3))
        mx.nd.onehot_encode(mx.nd.array([0, 2]), out)
        return [mx.nd.one_hot(mx.nd.array([0, 2]), depth=3), out]
    a, b = both(run)
    np.testing.assert_allclose(a, [[1, 0, 0], [0, 0, 1]])
    np.testing.assert_allclose(b, a)


# -- beyond the reference's tests -----------------------------------------------

def test_free_functions():
    src = np.arange(24, dtype=np.float32).reshape(2, 3, 4)

    def run(mx):
        nd = mx.nd
        a = nd.array(src)
        return [nd.zeros_like(a), nd.ones_like(a), nd.moveaxis(a, 0, 2),
                nd.full((2, 2), 3, dtype="int32"),
                nd.array(np.arange(3, dtype=np.int64)),
                nd.array(np.ones(2, np.float64)),
                nd.array(src, dtype="float16")]
    out = both(run)
    assert out[2].shape == (3, 4, 2) and out[4].dtype == np.int32


def test_generated_functions_map_arguments():
    """Positional scalars are attrs in parameter order, keyword tensors
    land in their active_args slot, ``out=`` writes the given array."""
    x_np = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    w_np = np.random.RandomState(1).randn(3, 5).astype(np.float32)

    def run(mx):
        nd = mx.nd
        x, w = nd.array(x_np), nd.array(w_np)
        b = nd.array([0.5, -1.0, 2.0])
        fc = nd.FullyConnected(data=x, weight=w, bias=b, num_hidden=3)
        fc2 = nd.FullyConnected(x, w, no_bias=True, num_hidden=3)
        dst = nd.zeros((4, 5))
        r = nd.clip(x, -0.5, 0.5, out=dst)
        return [fc, fc2, nd.sum(x, 1), nd.topk(x, 1, 2), dst, r,
                nd.slice_axis(x, 1, 1, 3), nd.where(x > 0, x, -x)]
    out = both(run)
    np.testing.assert_allclose(out[4], np.clip(x_np, -0.5, 0.5))


def test_scalar_dtype_rules():
    """A scalar takes the array's dtype first: _rdiv_scalar on an int
    array divides ints (into float32), x ** 0.5 on bf16 stays bf16."""
    i_np = np.array([1, 2, 4, 7], np.int32)
    f_np = np.array([0.25, 2.0, 9.0, 1e-3], np.float32)

    def run(mx):
        i = mx.nd.array(i_np, dtype="int32")
        b = mx.nd.array(f_np).astype("bfloat16")
        return [2.5 / i, i / 2.5, i * 1.5, i + 0.7, i ** 2,
                (b ** 0.5).astype("float32"), (3 - b).astype("float32")]
    out = both(run)
    assert out[0].dtype == np.float32 and out[2].dtype == np.int32
    with tmx.cpu():
        b = tmx.nd.array(f_np).astype("bfloat16")
        assert (b ** 0.5).handle.dtype == torch.bfloat16


def test_pickle_round_trip():
    with tmx.cpu():
        a = tmx.nd.array([[1.0, 2.0], [3.0, 4.0]])
        b = pickle.loads(pickle.dumps(a))
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
        h = tmx.nd.array([1.5, 2.5]).astype("bfloat16")
        h2 = pickle.loads(pickle.dumps(h))
        assert h2.handle.dtype == torch.bfloat16
        np.testing.assert_array_equal(h2.asnumpy(), h.asnumpy())


def test_nd_namespace_covers_the_registry():
    """Every registered name is an nd function and a symbol (contrib
    under its short name too), and the port registers every name the JAX
    package registers; an unknown name is an AttributeError."""
    nd = tmx.nd
    for name in treg.list_ops():
        assert callable(getattr(nd, name)), name
        assert callable(getattr(tmx.sym, name)), name
    assert nd.contrib.FlashAttention is nd._contrib_FlashAttention
    assert set(treg.list_ops()) == set(jreg.list_ops())
    assert callable(nd.cast_storage) and callable(nd._sparse_retain)
    assert callable(nd.ROIPooling) and nd.contrib.fft is nd._contrib_fft
    with pytest.raises(AttributeError):
        nd.no_such_op
    with pytest.raises(AttributeError):
        tmx.sym.no_such_op
    assert not hasattr(treg, "OpNotPorted")


def test_eager_and_symbol_share_the_registry():
    """An nd function and the mx.sym node of the same op run the same
    registry entry: one graph of the new ops, evaluated by the Executor,
    equals the same calls made eagerly."""
    x_np = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    with tmx.cpu():
        S, nd = tmx.sym, tmx.nd
        x = S.Variable("x")
        y = S.sum(S.clip(S.exp(x) - 1, 0.1, 2.0) * x, axis=1) / 3
        eager = nd.sum(nd.clip(nd.exp(nd.array(x_np)) - 1, 0.1, 2.0)
                       * nd.array(x_np), axis=1) / 3
        out = y.eval(tmx.cpu(), x=nd.array(x_np))[0]
        np.testing.assert_array_equal(out.asnumpy(), eager.asnumpy())
        assert y.infer_shape(x=(3, 4))[1] == [(3,)]


def test_base_names_match_jax(monkeypatch):
    """base's dtype tables, type tuples, env_flag and check_name, as the
    JAX package has them."""
    from mxnet_tpu import base as jbase
    from mxnet_tpu_torch import base as tbase
    assert tbase.DTYPE_NP_TO_MX == jbase.DTYPE_NP_TO_MX
    assert tbase.DTYPE_MX_TO_NP == jbase.DTYPE_MX_TO_NP
    assert tbase.mx_real_t is jbase.mx_real_t is np.float32
    assert tbase.mx_uint is jbase.mx_uint is int
    assert tbase.integer_types == jbase.integer_types
    assert isinstance(np.int64(3), tbase.integer_types)
    assert not isinstance(3.0, tbase.integer_types)
    for name in ("conv1_weight", "a.b-c_0", None):
        assert tbase.check_name(name) == jbase.check_name(name)
    for bad in ("has space", "semi;colon", "", "ü"):
        for b in (tbase, jbase):
            with pytest.raises(ValueError, match="invalid name"):
                b.check_name(bad)
    # a declared knob (override > environment > default) and an unknown
    # name (a raw environment read) resolve alike in both packages
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "yes")
    monkeypatch.setenv("MXNET_SOME_UNDECLARED_FLAG", "On")
    for name in ("MXNET_BACKWARD_DO_MIRROR", "MXNET_SOME_UNDECLARED_FLAG",
                 "MXNET_NOT_SET_ANYWHERE"):
        assert tbase.env_flag(name) == jbase.env_flag(name), name
    assert tbase.env_flag("MXNET_BACKWARD_DO_MIRROR") is True
    assert tbase.env_flag("MXNET_NOT_SET_ANYWHERE", default="1") is True
    tmx.config.set_override("MXNET_BACKWARD_DO_MIRROR", False)
    try:
        assert tbase.env_flag("MXNET_BACKWARD_DO_MIRROR") is False
    finally:
        tmx.config.set_override("MXNET_BACKWARD_DO_MIRROR", None)


def test_num_gpus_counts_cuda_devices():
    assert tmx.context.num_gpus() == torch.cuda.device_count()
    assert tmx.context.num_tpus is tmx.context.num_gpus
    # the JAX package counts its accelerators: none on this CPU backend
    assert jmx.context.num_gpus() == 0 == tmx.context.num_gpus()


IMRESIZE_CASES = [((37, 50, 3), (20, 31)),      # shrink both axes
                  ((10, 12, 3), (25, 30)),      # grow both axes
                  ((8, 8, 3), (8, 5)),          # one axis only
                  ((9, 6), (4, 11)),            # 2-d, shrink and grow
                  ((5, 7, 2), (1, 1))]


@pytest.mark.parametrize("shape, hw", IMRESIZE_CASES)
def test_imresize_matches_jax(shape, hw):
    """nd.imresize(src, w, h): bilinear with jax.image.resize's rules
    (antialiased when shrinking, half-pixel centres), float32 inside,
    the source's dtype out."""
    h, w = hw
    x = np.random.RandomState(3).uniform(0, 255, shape).astype(np.float32)
    want = jmx.nd.imresize(jmx.nd.array(x), w, h).asnumpy()
    with tmx.cpu():
        got = tmx.nd.imresize(tmx.nd.array(x), w, h)
    assert got.shape == want.shape == (h, w) + shape[2:]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    xu = x.astype(np.uint8)
    with tmx.cpu():
        gu = tmx.nd.imresize(tmx.nd.array(xu, dtype=np.uint8), w, h)
    wu = jmx.nd.imresize(jmx.nd.array(xu, dtype=np.uint8), w, h).asnumpy()
    assert gu.dtype == wu.dtype == np.uint8
    # truncation of values within float32 rounding of an integer may
    # land one apart
    assert np.abs(gu.asnumpy().astype(int) - wu).max() <= 1


def test_imresize_at_a_photo_size_is_the_float64_contraction():
    """At 300 x 500 -> 224 x 224 the port lies within 1e-6 of the range
    from the float64 contraction of jax.image.resize's own weights; the
    JAX package's jitted resize lies 1.1e-5 of the range from it there,
    so the two packages are held to that contraction, not to each
    other."""
    import jax
    import jax._src.image.scale as jscale
    x = np.random.RandomState(0).uniform(0, 255, (300, 500, 3)).astype(
        np.float32)
    kernel = jscale._kernels[jscale.ResizeMethod.LINEAR]
    wh = np.asarray(jscale.compute_weight_mat(300, 224, 224 / 300, 0.0,
                                              kernel, True), np.float64)
    ww = np.asarray(jscale.compute_weight_mat(500, 224, 224 / 500, 0.0,
                                              kernel, True), np.float64)
    exact = np.einsum("kwc,wl->klc",
                      np.einsum("hwc,hk->kwc", x.astype(np.float64), wh), ww)
    with tmx.cpu():
        got = tmx.nd.imresize(tmx.nd.array(x), 224, 224).asnumpy()
    want = np.asarray(jax.image.resize(x, (224, 224, 3), "bilinear"))
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6 * 255)
    np.testing.assert_allclose(want, exact, rtol=0, atol=1.1e-5 * 255)
