"""Sparse storage on the card against the port's CPU, without the JAX
package: importable where only PyTorch is installed, as on the card's
machine, where

    python -m pytest --noconftest tests/test_torch_sparse_card.py

runs every case. The tests are marked ``cuda`` and skip on machines
without a card (the CPU routes are held to the JAX package in
``tests/test_torch_sparse.py``).

* The fixed-order segment sum (``ops/_segment.py``) and ``sparse.dot``
  in both directions: card against CPU within rtol 1e-5 / atol 1e-5, and
  two card runs equal bit for bit.
* The lazy Adam update and ``take_grad`` on the card: rows outside the
  gradient and their state unchanged bit for bit, the rest within rtol
  1e-5 / atol 1e-6 of the CPU.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ndarray import sparse
from mxnet_tpu_torch.ops._segment import segment_sum

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CPU routes are tested "
                    "against the JAX package)")
    return torch.device("cuda", 0)


def _csr(rows, cols, per_row, seed, ctx):
    rs = np.random.RandomState(seed)
    indptr = np.arange(rows + 1) * per_row
    indices = np.concatenate([np.sort(rs.choice(cols, per_row,
                                                replace=False))
                              for _ in range(rows)])
    vals = rs.standard_normal(rows * per_row).astype(np.float32)
    return sparse.CSRNDArray(vals, indices, indptr, (rows, cols), ctx=ctx)


@pytest.mark.cuda
@pytest.mark.parametrize("sorted_ids", [False, True])
def test_segment_sum_card_equals_cpu_and_repeats(cuda_device, sorted_ids):
    rs = np.random.RandomState(0)
    n, segments = 200_000, 5000
    vals = torch.from_numpy(rs.standard_normal((n, 8)).astype(np.float32))
    ids = rs.randint(0, segments, n)
    if sorted_ids:
        ids = np.sort(ids)
    ids = torch.from_numpy(ids)
    want = segment_sum(vals, ids, segments, ids_sorted=sorted_ids)
    runs = [segment_sum(vals.to(cuda_device), ids.to(cuda_device), segments,
                        ids_sorted=sorted_ids) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    np.testing.assert_allclose(runs[0].cpu().numpy(), want.numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_a", [False, True])
def test_sparse_dot_card_equals_cpu_and_repeats(cuda_device, transpose_a):
    rows, cols, per_row = 4096, 100_000, 15
    rhs = np.random.RandomState(1).standard_normal(
        (rows if transpose_a else cols, 1)).astype(np.float32)
    got = []
    for ctx in (tmx.gpu(0), tmx.gpu(0), tmx.cpu()):
        x = _csr(rows, cols, per_row, 2, ctx)
        got.append(nd.dot(x, nd.array(rhs, ctx=ctx),
                          transpose_a=transpose_a).asnumpy())
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], got[2], **TOL)


@pytest.mark.cuda
def test_lazy_adam_and_take_grad_on_card(cuda_device):
    vocab, dim, batch = 5000, 16, 512
    rs = np.random.RandomState(3)
    table = rs.standard_normal((vocab, dim)).astype(np.float32)
    tokens = rs.randint(0, vocab, batch)
    ograd = rs.standard_normal((batch, dim)).astype(np.float32)
    outs = []
    for ctx in (tmx.gpu(0), tmx.cpu()):
        w = nd.array(table, ctx=ctx)
        m, v = nd.zeros((vocab, dim), ctx=ctx), nd.zeros((vocab, dim),
                                                         ctx=ctx)
        g = sparse.take_grad(tokens, nd.array(ograd, ctx=ctx), vocab)
        assert g._indices.device == w._data.device
        nd.adam_update(w, g, m, v, out=w, lr=0.01)
        outs.append([a.asnumpy() for a in (w, m, v)])
    other = np.setdiff1d(np.arange(vocab), tokens)
    card, cpu = outs
    np.testing.assert_array_equal(card[0][other], table[other])
    assert not card[1][other].any() and not card[2][other].any()
    for c, h in zip(card, cpu):
        np.testing.assert_allclose(c, h, rtol=1e-5, atol=1e-6)
