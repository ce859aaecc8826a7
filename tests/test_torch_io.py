"""The port's ``io.py`` against the JAX package's, on the CPU: NDArrayIter's
batches (data, label, pad) equal in every last-batch mode over two
epochs, shuffle drawing the same permutation from numpy's global stream,
named and listed inputs, ResizeIter and PrefetchingIter (with a
``place_fn``). Every value is exact: the iterators only slice and stitch.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import io as jio

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io as tio


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        it.reset()
        out.append([([d.asnumpy() for d in b.data],
                     [lb.asnumpy() for lb in b.label] if b.label else None,
                     b.pad) for b in it])
    return out


def _same(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for (da, la, pa), (db, lb, pb) in zip(ea, eb):
            assert pa == pb
            for x, y in zip(da, db):
                np.testing.assert_array_equal(x, y)
            assert (la is None) == (lb is None)
            for x, y in zip(la or [], lb or []):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarrayiter_matches_jax(handle, shuffle):
    data = np.arange(33, dtype=np.float32).reshape(11, 3)
    label = np.arange(11, dtype=np.float32)

    def make(io, ctx=None):
        np.random.seed(7)          # shuffle draws numpy's global stream
        if ctx is None:
            return io.NDArrayIter(data, label, batch_size=4,
                                  shuffle=shuffle, last_batch_handle=handle)
        with ctx:
            return io.NDArrayIter(data, label, batch_size=4,
                                  shuffle=shuffle, last_batch_handle=handle)
    jit, tit = make(jio), make(tio, tmx.cpu())
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    assert [tuple(d) for d in tit.provide_label] == \
        [tuple(d) for d in jit.provide_label]
    _same(_epochs(tit, 3), _epochs(jit, 3))


def test_named_and_listed_inputs_and_hard_reset():
    rng = np.random.RandomState(0)
    a, b = rng.rand(6, 2).astype(np.float32), rng.rand(6).astype(np.float32)
    for inputs in ({"x": a, "y": b}, [a, b]):
        jit = jio.NDArrayIter(inputs, None, batch_size=3)
        with tmx.cpu():
            tit = tio.NDArrayIter(inputs, None, batch_size=3)
        assert [d.name for d in tit.provide_data] == \
            [d.name for d in jit.provide_data]
        _same(_epochs(tit), _epochs(jit))
    with tmx.cpu():
        it = tio.NDArrayIter(a, b, batch_size=4,
                             last_batch_handle="roll_over")
        list(it)
        it.hard_reset()
        assert next(iter(it)).data[0].asnumpy().tolist() == a[:4].tolist()
        with pytest.raises(ValueError, match="exceeds"):
            tio.NDArrayIter(a, b, batch_size=7)
        with pytest.raises(TypeError):
            tio.NDArrayIter(object(), None)


def test_resize_iter_matches_jax():
    data = np.arange(10, dtype=np.float32).reshape(5, 2)
    jit = jio.ResizeIter(jio.NDArrayIter(data, None, batch_size=2), 5)
    with tmx.cpu():
        tit = tio.ResizeIter(tio.NDArrayIter(data, None, batch_size=2), 5)
    _same(_epochs(tit), _epochs(jit))


def test_prefetching_iter_with_place_fn():
    data = np.arange(24, dtype=np.float32).reshape(8, 3)
    label = np.arange(8, dtype=np.float32)
    with tmx.cpu():
        inner = tio.NDArrayIter(data, label, batch_size=4)
        pf = tio.PrefetchingIter(
            inner, place_fn=lambda b: {"data": b.data[0].handle})
        batches = list(pf)
        assert len(batches) == 2
        np.testing.assert_array_equal(batches[1].placed["data"].numpy(),
                                      data[4:])
        pf.reset()
        assert len(list(pf)) == 2
        renamed = tio.PrefetchingIter(
            tio.NDArrayIter(data, label, batch_size=4),
            rename_data=[{"data": "x"}], rename_label=[{"softmax_label":
                                                        "y"}])
        assert [d.name for d in renamed.provide_data] == ["x"]
        assert [d.name for d in renamed.provide_label] == ["y"]

        def boom(_batch):
            raise RuntimeError("placement exploded")
        bad = tio.PrefetchingIter(tio.NDArrayIter(data, label,
                                                  batch_size=4),
                                  place_fn=boom)
        with pytest.raises(RuntimeError, match="placement exploded"):
            next(bad)


def test_data_desc_and_batch():
    d = tio.DataDesc("data", (2, 3, 4, 5), layout="NHWC")
    assert d == ("data", (2, 3, 4, 5)) and d.layout == "NHWC"
    assert tio.DataDesc.get_batch_axis("TNC") == 1
    assert tio.DataDesc.get_list([("a", (1,))], [("a", np.int32)])[0] \
        .dtype == np.int32
    with pytest.raises(TypeError):
        tio.DataBatch(np.zeros(3))
    assert "data" in str(tio.DataBatch([tmx.nd.zeros((1,), ctx=tmx.cpu())]))
