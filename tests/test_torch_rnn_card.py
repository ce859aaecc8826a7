"""The fused ``RNN`` op's card route (cuDNN through ``torch._VF``) against
its plain per-step loop ``_rnn_reference`` on the card, and ``CTCLoss`` on
the card against the CPU, without the JAX package: importable where only
PyTorch is installed, as on the card's machine, where

    python -m pytest --noconftest tests/test_torch_rnn_card.py

runs every case. The tests are marked ``cuda`` and skip on machines
without a card (the CPU route is held to the JAX package in
``tests/test_torch_rnn_op.py``). Float32 with TF32 off (the port's
default ``MXNET_MATMUL_PRECISION=highest``): every output and gradient
within 1e-4 of the loop's, relative in norm, and element by element
within rtol 1e-3 / atol 1e-3. The two orders of summation part element
by element: the tanh recurrence at these weights (0.2 x N(0, 1), the
usual 1/sqrt(H) scale) expands a rounding step by step (its gradients
4.8e-4 apart at magnitudes up to 11 on the card), and the blob's gradient
sums T x N products. A TF32 product (a 10-bit mantissa) would miss the
norm bound by an order of magnitude."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _threefry
from mxnet_tpu_torch.ops import ctc as tctc
from mxnet_tpu_torch.ops import rnn_op as trnn

ELEMENT = dict(rtol=1e-3, atol=1e-3)
NORM = 1e-4
T, N, I, H = 12, 4, 16, 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the RNN op's card route is cuDNN "
                    "(its CPU route is tested against the JAX package)")
    return torch.device("cuda", 0)


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **ELEMENT)
    assert np.linalg.norm(got - want) <= NORM * np.linalg.norm(want)


def _run(fn, ins, device, attrs):
    args = [torch.tensor(a, device=device, requires_grad=True) for a in ins]
    outs = fn(*args, rng=_threefry.PRNGKey(3), **attrs)
    rng = np.random.RandomState(1)
    cot = [torch.tensor(rng.randn(*o.shape).astype(np.float32),
                        device=device) for o in outs]
    torch.autograd.backward(list(outs), cot)
    return ([o.detach().cpu().numpy() for o in outs],
            [a.grad.cpu().numpy() for a in args])


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_card_route_matches_reference(cuda_device, mode, p):
    """Two bidirectional layers, states of batch 1, state_outputs, and
    inter-layer dropout under training where p > 0 (one cuDNN call a
    layer, the threefry mask between)."""
    assert torch.backends.cudnn.allow_tf32 is False
    rng = np.random.RandomState(0)
    ins = [rng.randn(T, N, I).astype(np.float32),
           (0.2 * rng.randn(trnn.rnn_param_size(mode, I, H, 2, True))
            ).astype(np.float32),
           rng.randn(4, 1, H).astype(np.float32)]
    if mode == "lstm":
        ins.append(rng.randn(4, 1, H).astype(np.float32))
    attrs = dict(state_size=H, num_layers=2, bidirectional=True, mode=mode,
                 p=p, state_outputs=True, is_train=p > 0)
    (o_k, g_k), (o_r, g_r) = (_run(fn, ins, cuda_device, attrs) for fn in
                              (trnn._rnn_op, trnn._rnn_reference))
    for a, b in zip(o_k + g_k, o_r + g_r):
        _close(a, b)
    # the same route on the CPU
    o_c, _ = _run(trnn._rnn_op, ins, torch.device("cpu"), attrs)
    for a, b in zip(o_k, o_c):
        _close(a, b)


@pytest.mark.cuda
def test_card_route_refuses_without_cudnn(cuda_device):
    x = torch.zeros(T, N, I, device=cuda_device)
    blob = torch.zeros(trnn.rnn_param_size("gru", I, H, 1, False),
                       device=cuda_device)
    h = torch.zeros(1, N, H, device=cuda_device)
    with torch.backends.cudnn.flags(enabled=False):
        with pytest.raises(tmx.MXNetError, match="cuDNN"):
            trnn._rnn_op(x, blob, h, state_size=H, mode="gru")


@pytest.mark.cuda
def test_ctc_on_card_matches_cpu(cuda_device):
    rng = np.random.RandomState(2)
    data = rng.randn(20, 6, 11).astype(np.float32)
    label = rng.randint(1, 11, (6, 4)).astype(np.float32)
    label[1, 2:] = 0
    got = []
    for dev in (cuda_device, torch.device("cpu")):
        x = torch.tensor(data, device=dev, requires_grad=True)
        loss = tctc._ctc_loss(x, torch.tensor(label, device=dev))
        loss.sum().backward()
        got.append((loss.detach().cpu().numpy(), x.grad.cpu().numpy()))
    _close(got[0][0], got[1][0])
    _close(got[0][1], got[1][1])
