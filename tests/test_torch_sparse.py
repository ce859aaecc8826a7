"""Sparse storage in the port against the JAX package, on the CPU: the
classes of ``tests/test_sparse.py`` (representation, kernels, lazy
optimizer updates, the embedding gradient path, dispatch edges, the
KVStore, serialization), each case run in both packages from the same
seeded numpy inputs. Values are held within rtol 1e-5 / atol 1e-6;
indices, indptr and nnz must be equal.

Also: the fixed-order segment sum (``ops/_segment.py``) against
``jax.ops.segment_sum``, ``io.LibSVMIter`` against the JAX iterator on a
seeded file, ``test_utils.rand_ndarray`` in both sparse types from one
seed, and files saved by either package loaded by the other. The card's
cases (bit-equal reruns) are in ``tests/test_torch_sparse_card.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import test_utils as jtu
from mxnet_tpu.ndarray import sparse as jsparse

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import test_utils as ttu
from mxnet_tpu_torch.ndarray import sparse as tsparse
from mxnet_tpu_torch.ops._segment import segment_sum

TOL = dict(rtol=1e-5, atol=1e-6)
PKGS = {"jax": (jmx, jnd, jsparse), "port": (tmx, tnd, tsparse)}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand_rs(rows, cols, nnz_rows, seed=0):
    rng = np.random.RandomState(seed)
    idx = np.sort(rng.choice(rows, nnz_rows, replace=False))
    vals = rng.randn(nnz_rows, cols).astype("float32")
    return idx, vals


def _both(fn):
    """fn(mx, nd, sparse) in each package: {"jax": ..., "port": ...}."""
    return {k: fn(*mods) for k, mods in PKGS.items()}


def _same(t, j, tol=TOL):
    """A port array against a JAX one: storage type, shape, nnz, indices
    and indptr exactly; values and the dense view within ``tol``."""
    assert t.stype == j.stype
    assert tuple(t.shape) == tuple(j.shape)
    if t.stype != "default":
        assert t.nnz == j.nnz
        np.testing.assert_array_equal(t.indices.asnumpy(),
                                      j.indices.asnumpy())
        if t.stype == "csr":
            np.testing.assert_array_equal(t.indptr.asnumpy(),
                                          j.indptr.asnumpy())
        np.testing.assert_allclose(t.data.asnumpy(), j.data.asnumpy(),
                                   **tol)
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **tol)


def _sparse_matrix(rows, cols, keep, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(rows, cols).astype("float32")
    a[rng.rand(rows, cols) >= keep] = 0
    return a


# ---------------------------------------------------------------------------
# the fixed-order segment sum
# ---------------------------------------------------------------------------

def _segment_ids(kind, n, segments, rng):
    if kind == "sorted":
        return np.sort(rng.randint(0, segments, n))
    if kind == "unsorted":
        return rng.randint(0, segments, n)
    if kind == "empty_segments":      # every other segment empty
        return rng.randint(0, segments // 2, n) * 2
    return rng.randint(-3, segments + 3, n)     # "out_of_range": dropped


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "empty_segments",
                                  "out_of_range"])
@pytest.mark.parametrize("tail", [(), (3,), (2, 4)], ids=["1d", "2d", "3d"])
def test_segment_sum_matches_jax(kind, tail):
    rng = np.random.RandomState(len(tail) * 7 + len(kind))
    n, segments = 200, 17
    vals = rng.standard_normal((n,) + tail).astype(np.float32)
    ids = _segment_ids(kind, n, segments, rng)
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(vals), jnp.asarray(ids), num_segments=segments))
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(ids),
                      segments, ids_sorted=kind == "sorted").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    if kind == "empty_segments":
        assert not got[1::2].any()


def test_segment_sum_adds_in_arrival_order():
    """Each segment is the left-to-right sum of its rows: 1e8 + 1 - 1e8
    is 0 in float32 that way, not 1."""
    vals = torch.tensor([1e8, 1.0, -1e8, 5.0, 2.0])
    ids = torch.tensor([1, 1, 1, 0, 0])
    got = segment_sum(vals, ids, 3)
    assert got.tolist() == [7.0, 0.0, 0.0]
    assert segment_sum(vals[:0], ids[:0], 2).tolist() == [0.0, 0.0]


# ---------------------------------------------------------------------------
# representation
# ---------------------------------------------------------------------------

class TestRepresentation:
    def test_row_sparse_carries_indices(self):
        idx, vals = _rand_rs(100, 4, 5)
        r = _both(lambda mx, nd, sp: sp.row_sparse_array(
            (vals, idx), shape=(100, 4)))
        t = r["port"]
        assert t.stype == "row_sparse" and t.shape == (100, 4)
        assert t.data.shape == (5, 4) and t.nnz == 5
        assert t.indices.asnumpy().dtype == np.int32
        assert t.context == tmx.cpu() and t._indices.device.type == "cpu"
        _same(t, r["jax"])

    def test_csr_carries_structure(self):
        a = np.array([[0, 1, 0], [2, 0, 3], [0, 0, 0]], "float32")
        r = _both(lambda mx, nd, sp: sp.csr_matrix(a))
        _same(r["port"], r["jax"])
        np.testing.assert_array_equal(r["port"].indptr.asnumpy(),
                                      [0, 1, 3, 3])

    @pytest.mark.parametrize("shape", [(2, 3), None])
    def test_csr_from_components(self, shape):
        r = _both(lambda mx, nd, sp: sp.csr_matrix(
            ([1., 2.], [0, 1], [0, 1, 2]), shape=shape))
        _same(r["port"], r["jax"])

    def test_cast_storage_roundtrip(self):
        rng = np.random.RandomState(0)
        a = rng.randn(6, 3).astype("float32")
        a[[0, 2, 5]] = 0
        a[3, 1] = 0
        for stype in ("row_sparse", "csr"):
            r = _both(lambda mx, nd, sp: nd.array(a).tostype(stype))
            _same(r["port"], r["jax"])
            back = _both(lambda mx, nd, sp: nd.array(a).tostype(
                stype).tostype("default"))
            _same(back["port"], back["jax"])
        r = _both(lambda mx, nd, sp: nd.cast_storage(nd.array(a),
                                                      stype="row_sparse"))
        _same(r["port"], r["jax"])
        assert r["port"].nnz == 3

    def test_row_sparse_of_3d_rows(self):
        a = np.random.RandomState(1).randn(5, 2, 3).astype("float32")
        a[[1, 4]] = 0
        r = _both(lambda mx, nd, sp: sp.row_sparse_array(a))
        _same(r["port"], r["jax"])

    def test_unsorted_indices_canonicalized(self):
        vals = np.array([[2.], [1.], [3.]], "float32")
        r = _both(lambda mx, nd, sp: sp.row_sparse_array(
            (vals, [5, 1, 3]), shape=(8, 1)))
        _same(r["port"], r["jax"])
        np.testing.assert_array_equal(r["port"].indices.asnumpy(),
                                      [1, 3, 5])

    @pytest.mark.parametrize("rows", [slice(1, 3), slice(0, 4),
                                      slice(2, 2)])
    def test_csr_row_slice(self, rows):
        a = np.array([[0, 1, 0], [2, 0, 3], [4, 0, 0], [0, 0, 5]],
                     "float32")
        r = _both(lambda mx, nd, sp: sp.csr_matrix(a)[rows])
        _same(r["port"], r["jax"])

    def test_zeros_and_scalar_math(self):
        for stype, shape in (("row_sparse", (10, 2)), ("csr", (4, 3))):
            z = _both(lambda mx, nd, sp: sp.zeros(stype, shape))
            _same(z["port"], z["jax"])
            z = _both(lambda mx, nd, sp: nd.zeros(shape, stype=stype))
            _same(z["port"], z["jax"])
        idx, vals = _rand_rs(10, 2, 3)
        for op in (lambda x: x * 2.0, lambda x: 3 * x, lambda x: x / 4.0,
                   lambda x: -x, lambda x: x.copy(),
                   lambda x: x.astype("float32")):
            r = _both(lambda mx, nd, sp: op(sp.row_sparse_array(
                (vals, idx), shape=(10, 2))))
            _same(r["port"], r["jax"])
        csr = _both(lambda mx, nd, sp: sp.array(sp.csr_matrix(np.eye(
            3, dtype="float32")) * 2.0))
        _same(csr["port"], csr["jax"])

    def test_dense_ops_refused(self):
        idx, vals = _rand_rs(10, 2, 3)
        for name, (mx, nd, sp) in PKGS.items():
            rs = sp.row_sparse_array((vals, idx), shape=(10, 2))
            for bad in (lambda: rs[0], lambda: rs + nd.zeros((10, 2)),
                        lambda: rs * nd.ones((10, 2)), rs.attach_grad,
                        lambda: list(rs)):
                with pytest.raises(TypeError, match="tostype"):
                    bad()
            with pytest.raises(ValueError):
                sp.array(nd.ones((2,)))
        assert "RowSparseNDArray 10x2 @cpu(0)" in repr(
            tsparse.row_sparse_array((vals, idx), shape=(10, 2)))


# ---------------------------------------------------------------------------
# the sparse kernels
# ---------------------------------------------------------------------------

class TestKernels:
    @pytest.mark.parametrize("rows,cols,rhs_cols,keep", [
        (5, 7, 3, 0.4), (64, 200, 1, 0.05), (9, 4, 5, 0.0), (6, 6, 2, 1.0)])
    @pytest.mark.parametrize("transpose_a", [False, True])
    def test_csr_dot_dense(self, rows, cols, rhs_cols, keep, transpose_a):
        a = _sparse_matrix(rows, cols, keep, rows + cols)
        a[1] = 0                                    # an empty row
        b = np.random.RandomState(rhs_cols).randn(
            rows if transpose_a else cols, rhs_cols).astype("float32")
        r = _both(lambda mx, nd, sp: nd.dot(sp.csr_matrix(a), nd.array(b),
                                            transpose_a=transpose_a))
        _same(r["port"], r["jax"])
        np.testing.assert_allclose(r["port"].asnumpy(),
                                   (a.T if transpose_a else a) @ b,
                                   rtol=1e-5, atol=1e-5)

    def test_csr_dot_vector_and_refusals(self):
        a = _sparse_matrix(6, 5, 0.5, 3)
        v = np.arange(5, dtype=np.float32)
        r = _both(lambda mx, nd, sp: sp.dot(sp.csr_matrix(a), nd.array(v)))
        _same(r["port"], r["jax"])
        for mx, nd, sp in PKGS.values():
            csr = sp.csr_matrix(a)
            with pytest.raises(TypeError):
                sp.dot(nd.ones((2, 6)), nd.ones((6, 1)))
            with pytest.raises(NotImplementedError):
                sp.dot(csr, nd.ones((1, 5)), transpose_b=True)

    def test_retain(self):
        idx, vals = _rand_rs(50, 3, 8, seed=3)
        keep = np.array([int(idx[-1]), 17, int(idx[0])])
        assert 17 not in idx
        for via_op in (False, True):
            def fn(mx, nd, sp):
                rs = sp.row_sparse_array((vals, idx), shape=(50, 3))
                if via_op:
                    return nd._sparse_retain(rs, nd.array(keep))
                return rs.retain(keep)
            r = _both(fn)
            _same(r["port"], r["jax"])
            np.testing.assert_array_equal(r["port"].indices.asnumpy(),
                                          np.sort(keep))
        r = _both(lambda mx, nd, sp: sp.zeros("row_sparse", (6, 2)).retain(
            [1, 4]))
        _same(r["port"], r["jax"])

    @pytest.mark.parametrize("left,right", [([0, 3], [3, 5]), ([], [2]),
                                            ([1, 2], [1, 2]), ([4], [])])
    def test_rs_add_union(self, left, right):
        def make(sp, ids, seed):
            vals = np.random.RandomState(seed).randn(len(ids), 2).astype(
                "float32")
            return sp.row_sparse_array((vals, np.array(ids, np.int64)),
                                       shape=(6, 2))
        r = _both(lambda mx, nd, sp: make(sp, left, 1) + make(sp, right, 2))
        _same(r["port"], r["jax"])
        r = _both(lambda mx, nd, sp: nd.elemwise_add(make(sp, left, 1),
                                                     make(sp, right, 2)))
        _same(r["port"], r["jax"])
        for mx, nd, sp in PKGS.values():
            with pytest.raises(ValueError):
                sp.add(make(sp, left, 1), sp.zeros("row_sparse", (7, 2)))

    def test_square_sum(self):
        idx, vals = _rand_rs(20, 4, 5, seed=4)
        r = _both(lambda mx, nd, sp: nd._square_sum(sp.row_sparse_array(
            (vals, idx), shape=(20, 4))))
        _same(r["port"], r["jax"])
        r = _both(lambda mx, nd, sp: nd._square_sum(
            sp.csr_matrix(_sparse_matrix(4, 5, 0.5, 9))))
        _same(r["port"], r["jax"])


# ---------------------------------------------------------------------------
# lazy optimizer updates
# ---------------------------------------------------------------------------

def _updated(update, rows, cols, nnz, seed, **attrs):
    """(weight and states after the update, gradient ids) in each
    package from the same weight, states and row-sparse gradient."""
    rng = np.random.RandomState(seed)
    w = rng.randn(rows, cols).astype("float32")
    states = [rng.rand(rows, cols).astype("float32") for _ in range(2)]
    idx, gvals = _rand_rs(rows, cols, nnz, seed + 1)

    def fn(mx, nd, sp):
        weight = nd.array(w)
        grad = sp.row_sparse_array((gvals, idx), shape=(rows, cols))
        st = [nd.array(s) for s in states]
        if update == "sgd_update":
            nd.sgd_update(weight, grad, out=weight, **attrs)
            st = []
        elif update == "sgd_mom_update":
            nd.sgd_mom_update(weight, grad, st[0], out=weight, **attrs)
            st = st[:1]
        else:
            nd.adam_update(weight, grad, st[0], st[1], out=weight, **attrs)
        return [weight] + st
    return _both(fn), w, states, idx


class TestOptimizerUpdates:
    @pytest.mark.parametrize("update,attrs", [
        ("sgd_update", dict(lr=0.5, wd=0.1)),
        ("sgd_update", dict(lr=0.5, rescale_grad=0.5, clip_gradient=0.3)),
        ("sgd_mom_update", dict(lr=0.1, momentum=0.9, wd=0.01)),
        ("adam_update", dict(lr=0.1, wd=0.01, beta1=0.8)),
        ("adam_update", dict(lr=0.05, clip_gradient=0.5,
                             rescale_grad=2.0))])
    def test_lazy_update_matches_jax(self, update, attrs):
        r, w, states, idx = _updated(update, 40, 4, 6, 5, **attrs)
        untouched = np.setdiff1d(np.arange(40), idx)
        for i, (t, j) in enumerate(zip(r["port"], r["jax"])):
            _same(t, j)
            before = w if i == 0 else states[i - 1]
            # untouched rows saw neither gradient, weight decay nor state
            np.testing.assert_array_equal(t.asnumpy()[untouched],
                                          before[untouched])
        assert not np.array_equal(r["port"][0].asnumpy()[idx], w[idx])

    @pytest.mark.parametrize("opt,kwargs", [
        ("SGD", dict(learning_rate=0.5, momentum=0.9, wd=0.01)),
        ("SGD", dict(learning_rate=0.5)),
        ("Adam", dict(learning_rate=0.1, wd=0.01))])
    def test_optimizer_class_routes_sparse(self, opt, kwargs):
        idx, gvals = _rand_rs(20, 3, 4, seed=9)

        def fn(mx, nd, sp):
            o = getattr(mx.optimizer, opt)(rescale_grad=1.0, **kwargs)
            w = nd.ones((20, 3))
            state = o.create_state(0, w)
            for _ in range(2):
                o.update(0, w, sp.row_sparse_array((gvals, idx),
                                                   shape=(20, 3)), state)
            return w
        r = _both(fn)
        _same(r["port"], r["jax"])
        untouched = np.setdiff1d(np.arange(20), idx)
        assert np.all(r["port"].asnumpy()[untouched] == 1)
        assert np.all(r["port"].asnumpy()[idx] != 1)


# ---------------------------------------------------------------------------
# the embedding gradient path
# ---------------------------------------------------------------------------

class TestEmbeddingGradientPath:
    def test_take_grad_matches_jax(self):
        rng = np.random.RandomState(10)
        vocab, dim = 50, 8
        tokens = rng.randint(0, vocab, size=(4, 6))
        ograd = rng.randn(4, 6, dim).astype("float32")
        r = _both(lambda mx, nd, sp: sp.take_grad(tokens, nd.array(ograd),
                                                  vocab))
        _same(r["port"], r["jax"])
        dense = np.zeros((vocab, dim), "float32")
        np.add.at(dense, tokens.ravel(), ograd.reshape(-1, dim))
        np.testing.assert_allclose(r["port"].asnumpy(), dense, **TOL)

    def test_never_densifies(self):
        """A big vocabulary's gradient and lazy update stay O(nnz): the
        values are n_unique x dim, three orders below vocab x dim."""
        vocab, dim = 200_000, 32
        tokens = np.random.RandomState(11).randint(0, vocab, size=256)
        rs = tsparse.take_grad(tokens, tnd.ones((256, dim)), vocab)
        n_unique = len(np.unique(tokens))
        assert rs.nnz == n_unique and rs.shape == (vocab, dim)
        nbytes = rs._data.numel() * 4 + rs._indices.numel() * 4
        assert nbytes == n_unique * (dim + 1) * 4
        assert nbytes < vocab * dim * 4 / 500
        weight = tnd.zeros((vocab, dim))
        tnd.sgd_update(weight, rs, out=weight, lr=1.0)
        assert np.all(weight.asnumpy()[np.unique(tokens)] != 0)

    def test_end_to_end_embedding_training_step(self):
        """Forward take, take_grad, lazy Adam: the row-sparse embedding
        recipe, in both packages."""
        vocab, dim = 1000, 4
        rng = np.random.RandomState(12)
        table = rng.randn(vocab, dim).astype("float32")
        tokens = np.array([3, 99, 3, 512])
        ograd = rng.randn(4, dim).astype("float32")

        def fn(mx, nd, sp):
            weight = nd.array(table)
            mean, var = nd.zeros((vocab, dim)), nd.zeros((vocab, dim))
            emb = nd.take(weight, nd.array(tokens.astype("float32")))
            gw = sp.take_grad(tokens, nd.array(ograd), vocab)
            nd.adam_update(weight, gw, mean, var, out=weight, lr=0.1)
            return emb, weight, mean, var
        r = _both(fn)
        for t, j in zip(r["port"], r["jax"]):
            _same(t, j)
        after = r["port"][1].asnumpy()
        other = np.setdiff1d(np.arange(vocab), tokens)
        np.testing.assert_array_equal(after[other], table[other])
        assert not r["port"][2].asnumpy()[other].any()


# ---------------------------------------------------------------------------
# dispatch edges
# ---------------------------------------------------------------------------

class TestDispatchEdges:
    def test_cast_storage_dense_out_kwarg(self):
        def fn(mx, nd, sp):
            o = nd.zeros((2, 2))
            got = nd.cast_storage(nd.ones((2, 2)), stype="default", out=o)
            return o, got
        r = _both(fn)
        _same(r["port"][0], r["jax"][0])
        assert r["port"][1] is r["port"][0]

    def test_cast_storage_sparse_with_out(self):
        src = np.array([[1, 1], [0, 0], [2, 2]], "float32")

        def fn(mx, nd, sp):
            o = sp.zeros("row_sparse", (3, 2))
            nd.cast_storage(nd.array(src), stype="row_sparse", out=o)
            o2 = sp.zeros("csr", (3, 2))
            nd.cast_storage(nd.array(src), "csr", out=o2)
            return o, o2
        r = _both(fn)
        for t, j in zip(r["port"], r["jax"]):
            _same(t, j)

    def test_unrouted_dense_op_rejects_sparse(self):
        a = np.array([[1, 2, 3], [0, 0, 0]], "float32")
        for mx, nd, sp in PKGS.values():
            csr = sp.csr_matrix(a)
            with pytest.raises(TypeError):
                nd.dot(nd.ones((2, 2)), csr)       # sparse rhs: no route
            with pytest.raises(TypeError, match="tostype"):
                nd.broadcast_add(csr, nd.ones((2, 3)))
            with pytest.raises(TypeError, match="tostype"):
                nd.ones((2, 3)) + csr
            with pytest.raises(TypeError, match="tostype"):
                nd.relu(sp.row_sparse_array(a))

    def test_elemwise_add_mixed(self):
        def fn(mx, nd, sp):
            rs = sp.row_sparse_array((np.ones((1, 2), "float32"), [1]),
                                     shape=(3, 2))
            dense = nd.ones((3, 2))
            return nd.elemwise_add(rs, dense), nd.elemwise_add(dense, rs), \
                nd.elemwise_add(dense, dense)
        r = _both(fn)
        for t, j in zip(r["port"], r["jax"]):
            _same(t, j)
            assert t.stype == "default"

    def test_sparse_routes_honour_out(self):
        def fn(mx, nd, sp):
            rs = sp.row_sparse_array((np.ones((1, 2), "float32"), [1]),
                                     shape=(3, 2))
            o = nd.zeros((3, 2))
            assert nd.elemwise_add(rs, nd.ones((3, 2)), out=o) is o
            o2 = nd.zeros((3, 2))
            nd.dot(sp.csr_matrix(np.eye(3, dtype="float32")),
                   nd.ones((3, 2)), out=o2)
            o3 = sp.zeros("row_sparse", (3, 2))
            nd.elemwise_add(rs, rs, out=o3)
            return o, o2, o3
        r = _both(fn)
        for t, j in zip(r["port"], r["jax"]):
            _same(t, j)

    def test_mismatched_copyto_refused(self):
        for mx, nd, sp in PKGS.values():
            rs = sp.row_sparse_array((np.ones((1, 2), "float32"), [1]),
                                     shape=(3, 2))
            csr = sp.csr_matrix(np.eye(2, dtype="float32"))
            with pytest.raises(TypeError):
                rs.copyto(csr)
            with pytest.raises(TypeError):
                csr.copyto(rs)
            with pytest.raises(TypeError, match="tostype"):
                nd.ones((3, 2)).copyto(rs)
        d = tnd.zeros((3, 2))
        tsparse.row_sparse_array((np.ones((1, 2), "float32"), [1]),
                                 shape=(3, 2)).copyto(d)
        np.testing.assert_array_equal(d.asnumpy(), [[0, 0], [1, 1], [0, 0]])


# ---------------------------------------------------------------------------
# the KVStore
# ---------------------------------------------------------------------------

class TestKVStore:
    def test_plain_pull_densifies_sparse_store(self):
        def fn(mx, nd, sp):
            kv = mx.kv.create("local")
            kv.init("w", nd.zeros((4, 2)))
            kv.push("w", sp.row_sparse_array(
                (np.ones((1, 2), "float32"), [2]), shape=(4, 2)))
            outs = [nd.zeros((4, 2)), nd.zeros((4, 2))]
            kv.pull("w", out=outs)
            return outs
        r = _both(fn)
        for t, j in zip(r["port"], r["jax"]):
            _same(t, j)

    def test_row_sparse_pull_dense_out_from_sparse_store(self):
        def fn(mx, nd, sp):
            kv = mx.kv.create("local")
            kv.init("w", sp.row_sparse_array(
                (np.full((2, 2), 3.0, "float32"), [1, 3]), shape=(5, 2)))
            out = nd.zeros((2, 2))
            kv.row_sparse_pull("w", out=out,
                               row_ids=nd.array(np.array([3., 0.])))
            rs = sp.zeros("row_sparse", (5, 2))
            kv.row_sparse_pull("w", out=rs, row_ids=nd.array(
                np.array([3., 2.])))
            return out, rs
        r = _both(fn)
        for t, j in zip(r["port"], r["jax"]):
            _same(t, j)

    def test_row_sparse_pull_from_dense(self):
        w = np.random.RandomState(13).randn(30, 4).astype("float32")

        def fn(mx, nd, sp):
            kv = mx.kv.create("local")
            kv.init("emb", nd.array(w))
            rows = nd.array(np.array([19., 2., 7.]))
            outs = [sp.zeros("row_sparse", (30, 4)), nd.zeros((3, 4))]
            kv.row_sparse_pull("emb", out=outs, row_ids=rows)
            return outs
        r = _both(fn)
        for t, j in zip(r["port"], r["jax"]):
            _same(t, j)
        assert r["port"][0].nnz == 3

    def test_sparse_push_reduces_union(self):
        def fn(mx, nd, sp):
            kv = mx.kv.create("local")
            kv.init("g", sp.zeros("row_sparse", (10, 2)))
            parts = [sp.row_sparse_array((np.full((1, 2), v, "float32"),
                                          [i]), shape=(10, 2))
                     for v, i in ((1.0, 1), (2.0, 1), (5.0, 4))]
            kv.push("g", parts)
            out = sp.zeros("row_sparse", (10, 2))
            kv.row_sparse_pull("g", out=out, row_ids=nd.array(
                np.array([1., 4.])))
            whole = sp.zeros("row_sparse", (10, 2))
            kv.pull("g", out=whole)
            return out, whole
        r = _both(fn)
        for t, j in zip(r["port"], r["jax"]):
            _same(t, j)
        assert r["port"][1].nnz == 2

    def test_push_with_updater_is_lazy(self):
        idx, gvals = _rand_rs(12, 3, 3, seed=14)

        def fn(mx, nd, sp):
            kv = mx.kv.create("local")
            kv.init(0, nd.ones((12, 3)))
            kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5,
                                              momentum=0.9, wd=0.1,
                                              rescale_grad=1.0))
            for _ in range(2):
                kv.push(0, [sp.row_sparse_array((gvals, idx),
                                                shape=(12, 3))] * 2)
            out = nd.zeros((12, 3))
            kv.pull(0, out=out)
            return out
        r = _both(fn)
        _same(r["port"], r["jax"])
        untouched = np.setdiff1d(np.arange(12), idx)
        assert np.all(r["port"].asnumpy()[untouched] == 1)

    def test_dist_store_refuses_sparse(self):
        kv = tmx.kv.create("dist_sync")
        rs = tsparse.zeros("row_sparse", (3, 2))
        kv.init("w", tnd.zeros((3, 2)))
        assert kv._world() == 1
        kv.push("w", rs)           # one worker: the local reduce
        kv._world = lambda: 2      # a second worker: no sparse collective
        with pytest.raises(NotImplementedError, match="dist_sync, "
                           "dist_device_sync, dist_async, dist"):
            kv.push("w", rs)


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

def _mixed_payload(sp, nd):
    idx, vals = _rand_rs(20, 3, 4, seed=20)
    return {"rs": sp.row_sparse_array((vals, idx), shape=(20, 3)),
            "csr": sp.csr_matrix(np.array([[0, 1.5], [2.5, 0]], "float32")),
            "w": nd.ones((2, 2))}


class TestSerialization:
    def test_save_load_preserves_sparse(self, tmp_path):
        path = str(tmp_path / "mixed.npz")
        saved = _mixed_payload(tsparse, tnd)
        tnd.save(path, saved)
        back = tnd.load(path)
        for k, v in saved.items():
            assert back[k].stype == v.stype
            np.testing.assert_array_equal(back[k].asnumpy(), v.asnumpy())
        assert back["rs"].nnz == 4

    def test_save_load_sparse_list(self, tmp_path):
        path = str(tmp_path / "list.npz")
        idx, vals = _rand_rs(10, 2, 3, seed=21)
        tnd.save(path, [tsparse.row_sparse_array((vals, idx),
                                                 shape=(10, 2)),
                        tnd.zeros((2,))])
        back = tnd.load(path)
        assert back[0].stype == "row_sparse" and back[0].nnz == 3
        assert back[1].shape == (2,)

    def test_reserved_suffix_keys_roundtrip(self, tmp_path):
        path = str(tmp_path / "edge.npz")
        tnd.save(path, {"emb:data": tnd.ones((2, 2)),
                        "foo:stype": tnd.zeros((1,)),
                        "arg:indptr": tnd.ones((3,))})
        back = tnd.load(path)
        assert set(back) == {"emb:data", "foo:stype", "arg:indptr"}

    def test_reserved_namespace_rejected(self, tmp_path):
        with pytest.raises(ValueError):
            tnd.save(str(tmp_path / "x.npz"),
                     {"__mx_sparse__.0.data": tnd.ones((1,))})

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_files_cross_between_packages(self, tmp_path, writer):
        """A file saved by one package loads in the other, sparse entries
        as their storage types, components bit for bit."""
        path = str(tmp_path / ("from_%s.npz" % writer))
        reader = "port" if writer == "jax" else "jax"
        mx, nd, sp = PKGS[writer]
        saved = _mixed_payload(sp, nd)
        nd.save(path, saved)
        back = PKGS[reader][1].load(path)
        assert set(back) == set(saved)
        for k, v in saved.items():
            t, j = (back[k], v) if reader == "port" else (v, back[k])
            _same(t, j, tol=dict(rtol=0, atol=0))


# ---------------------------------------------------------------------------
# LibSVMIter and rand_ndarray
# ---------------------------------------------------------------------------

def _write_libsvm(path, rows, dim, seed, max_nnz=6):
    """A seeded LibSVM file: a 0/1 label, then 0..max_nnz-1 sorted
    ``col:value`` pairs a row; one blank line, which the reader skips."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for r in range(rows):
            nnz = rng.randint(0, max_nnz)
            cols = np.sort(rng.choice(dim, nnz, replace=False))
            f.write("%d %s\n" % (r % 2, " ".join(
                "%d:%.6f" % (c, v) for c, v in zip(cols, rng.randn(nnz)))))
            if r == 3:
                f.write("\n")


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("labels", ["scalar", "label_libsvm"])
def test_libsvm_iter_matches_jax(tmp_path, round_batch, labels):
    data = str(tmp_path / "data.libsvm")
    _write_libsvm(data, 23, 40, 1)
    kw = dict(data_libsvm=data, data_shape=(40,), batch_size=5,
              round_batch=round_batch)
    if labels == "label_libsvm":
        lab = str(tmp_path / "label.libsvm")
        _write_libsvm(lab, 23, 6, 2, max_nnz=4)
        kw.update(label_libsvm=lab, label_shape=(2, 3))
    its = {"jax": jmx.io.LibSVMIter(**kw), "port": tmx.io.LibSVMIter(**kw)}
    assert its["port"].provide_data == its["jax"].provide_data
    assert its["port"].provide_label == its["jax"].provide_label
    for epoch in range(2):
        batches = {k: list(it) for k, it in its.items()}
        assert len(batches["port"]) == len(batches["jax"]) == (
            5 if round_batch else 4)
        for t, j in zip(batches["port"], batches["jax"]):
            assert t.pad == j.pad
            _same(t.data[0], j.data[0], tol=dict(rtol=0, atol=0))
            np.testing.assert_array_equal(t.label[0].asnumpy(),
                                          j.label[0].asnumpy())
        for it in its.values():
            it.reset()
    with pytest.raises(ValueError, match="label_libsvm"):
        tmx.io.LibSVMIter(data, (40,), 5, label_shape=(2,))


@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
@pytest.mark.parametrize("density", [None, 0.3])
def test_rand_ndarray_sparse_from_one_seed(stype, density):
    ttu._rng.seed(8)
    jtu._rng.seed(8)
    t = ttu.rand_ndarray((7, 4), stype=stype, density=density)
    j = jtu.rand_ndarray((7, 4), stype=stype, density=density)
    _same(t, j, tol=dict(rtol=0, atol=0))
    assert ttu._rng.uniform() == jtu._rng.uniform()
