"""The port's flash kernels (forward, dq, dk/dv) and their wrappers,
without the JAX package: importable where only PyTorch is installed, as
on the card's machine, where

    python -m pytest --noconftest tests/test_torch_kernels.py

runs every case, the CUDA ones included. Tests marked ``cuda`` hold each
kernel against its plain version (``_flash_fwd_reference``,
``_flash_dq_reference``, ``_flash_dkv_reference``; bf16 within 2e-2,
compared in f32; f32 within rtol 1e-4 / atol 1e-5; lse within 1e-4) and
skip on machines without a card; the rest pin the wrappers' contract and
the plain versions' own rules.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch  # noqa: F401
from mxnet_tpu_torch.ops import attention as tatt


def _arrays(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def test_result_does_not_depend_on_block_attrs():
    q, k, v = (torch.from_numpy(x) for x in _arrays(*[(2, 33, 8)] * 3))
    a = tatt.flash_attention(q, k, v, causal=True, block_q=8, block_k=16)
    b = tatt.flash_attention(q, k, v, causal=True, block_q=512,
                             block_k=512)
    assert torch.equal(a, b)


def test_fully_masked_rows_give_zero_and_finite_lse():
    """A row with no valid column (band_offset < 0 puts the first rows
    before every key) gives o = 0 through max(l, 1e-30), and a finite
    lse — the port's rule for rows the TPU kernel leaves undefined."""
    q, k, v = (torch.from_numpy(x) for x in _arrays(*[(1, 12, 8)] * 3))
    o, lse = tatt.flash_attention_with_lse(q, k, v, causal=True,
                                           band_offset=-5)
    assert torch.equal(o[0, :5], torch.zeros(5, 8))
    assert torch.isfinite(lse).all() and (lse[0, :5] < -1e29).all()
    assert (o[0, 5:].abs().sum(-1) > 0).all()


def test_meta_tensors_give_shapes():
    """Shape inference runs the plain version on meta tensors."""
    q = torch.empty((3, 10, 16), device="meta")
    k = torch.empty((3, 14, 16), device="meta")
    o, lse = tatt.flash_fwd(q, k, k, 0.25, True, want_lse=True)
    assert o.shape == (3, 10, 16) and lse.shape == (3, 10)
    assert o.device.type == "meta"


@pytest.mark.parametrize("shape_q,shape_k,dtype,match", [
    ((2, 8, 12), (2, 8, 12), torch.float32, "head dim 12"),
    ((2, 8, 136), (2, 8, 136), torch.float32, "head dim 136"),
    ((2, 8, 16), (2, 8, 16), torch.float16, "float32 or bfloat16"),
    ((2, 8, 16), (3, 8, 16), torch.float32, "do not agree"),
    ((1, 2, 8, 16), (1, 2, 8, 16), torch.float32, r"\(BH, T, D\)"),
    ((2, 8, 16), (2, 8, 16), torch.float32, "CUDA device"),
])
def test_kernel_wrapper_validates_inputs(shape_q, shape_k, dtype, match):
    """The CUDA wrapper raises on what the kernel does not take — before
    any build or launch, so this runs on machines without a card."""
    q = torch.zeros(shape_q, dtype=dtype)
    k = torch.zeros(shape_k, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        tatt.flash_fwd_cuda(q, k, k, 0.25, True)


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel is CUDA-only "
                    "(its plain version is tested above)")
    return torch.device("cuda", 0)


# (id, BH, T, Tk, D, dtype, causal, window, band_offset)
KERNEL_CASES = [
    ("bf16_causal", 4, 256, 256, 128, torch.bfloat16, True, 0, 0),
    ("bf16_ragged", 3, 200, 333, 64, torch.bfloat16, True, 0, 0),
    ("bf16_full_d16", 2, 100, 130, 16, torch.bfloat16, False, 0, 0),
    ("bf16_window_offset", 2, 256, 320, 64, torch.bfloat16, True, 64, 32),
    ("bf16_negative_offset", 2, 128, 128, 32, torch.bfloat16, True, 0,
     -20),
    ("f32_causal", 2, 130, 130, 64, torch.float32, True, 0, 0),
    ("f32_full_d128", 2, 70, 90, 128, torch.float32, False, 0, 0),
    ("f32_window", 2, 256, 256, 8, torch.float32, True, 40, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("BH,T,Tk,D,dtype,causal,window,band_offset",
                         [c[1:] for c in KERNEL_CASES],
                         ids=[c[0] for c in KERNEL_CASES])
def test_cuda_kernel_matches_plain_version(cuda_device, BH, T, Tk, D, dtype,
                                           causal, window, band_offset):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((BH, n, D), generator=gen, device=cuda_device)
               .to(dtype) for n in (T, Tk, Tk))
    before = tatt.flash_fwd_cuda.launches
    o, lse = tatt.flash_fwd(q, k, v, D ** -0.5, causal, window,
                            band_offset, want_lse=True)
    torch.cuda.synchronize()
    assert tatt.flash_fwd_cuda.launches == before + 1
    ro, rlse = tatt._flash_fwd_reference(q, k, v, D ** -0.5, causal,
                                         window, band_offset)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)


def _bwd_inputs(BH, T, Tk, D, dtype, causal, window, band_offset, device,
                dlse=False):
    """q, k, v, do and the forward's lse and delta (through the plain
    forward), from one seeded generator."""
    gen = torch.Generator(device=device).manual_seed(1)
    q, k, v = (torch.randn((BH, n, D), generator=gen, device=device)
               .to(dtype) for n in (T, Tk, Tk))
    do = torch.randn((BH, T, D), generator=gen, device=device).to(dtype)
    o, lse = tatt._flash_fwd_reference(q, k, v, D ** -0.5, causal, window,
                                       band_offset)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    if dlse:
        delta = delta - torch.randn((BH, T), generator=gen, device=device)
    return q, k, v, do, lse, delta


@pytest.mark.cuda
@pytest.mark.parametrize("BH,T,Tk,D,dtype,causal,window,band_offset",
                         [c[1:] for c in KERNEL_CASES],
                         ids=[c[0] for c in KERNEL_CASES])
@pytest.mark.parametrize("dlse", [False, True], ids=["delta", "dlse"])
def test_cuda_bwd_kernels_match_plain_versions(cuda_device, BH, T, Tk, D,
                                                dtype, causal, window,
                                                band_offset, dlse):
    args = _bwd_inputs(BH, T, Tk, D, dtype, causal, window, band_offset,
                       cuda_device, dlse)
    attrs = (D ** -0.5, causal, window, band_offset)
    n_dq, n_dkv = tatt.flash_dq_cuda.launches, tatt.flash_dkv_cuda.launches
    dq = tatt.flash_dq(*args, *attrs)
    dk, dv = tatt.flash_dkv(*args, *attrs)
    torch.cuda.synchronize()
    assert tatt.flash_dq_cuda.launches == n_dq + 1
    assert tatt.flash_dkv_cuda.launches == n_dkv + 1
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dq.float(), tatt._flash_dq_reference(
        *args, *attrs).float(), **tol)
    rdk, rdv = tatt._flash_dkv_reference(*args, *attrs)
    torch.testing.assert_close(dk.float(), rdk.float(), **tol)
    torch.testing.assert_close(dv.float(), rdv.float(), **tol)


@pytest.mark.parametrize("name", ["flash_dq_cuda", "flash_dkv_cuda"])
@pytest.mark.parametrize("bad,match", [
    ("do_shape", "do must match q"),
    ("lse_dtype", "lse must be float32"),
    ("delta_shape", "delta must be float32"),
    ("cpu", "CUDA device"),
])
def test_bwd_kernel_wrappers_validate_inputs(name, bad, match):
    """The backward wrappers raise on what the kernels do not take —
    before any build or launch, so this runs without a card."""
    q = k = v = do = torch.zeros((2, 8, 16))
    lse = delta = torch.zeros((2, 8))
    if bad == "do_shape":
        do = torch.zeros((2, 9, 16))
    elif bad == "lse_dtype":
        lse = torch.zeros((2, 8), dtype=torch.float64)
    elif bad == "delta_shape":
        delta = torch.zeros((2, 9))
    with pytest.raises(ValueError, match=match):
        getattr(tatt, name)(q, k, v, do, lse, delta, 0.25, True)


def test_backward_plain_versions_on_meta_give_shapes():
    q = torch.empty((3, 10, 16), device="meta")
    k = torch.empty((3, 14, 16), device="meta")
    lse = torch.empty((3, 10), device="meta")
    dq = tatt.flash_dq(q, k, k, q, lse, lse, 0.25, True)
    dk, dv = tatt.flash_dkv(q, k, k, q, lse, lse, 0.25, True)
    assert dq.shape == (3, 10, 16) and dk.shape == dv.shape == (3, 14, 16)


def test_fully_masked_rows_get_zero_gradient():
    """Rows with no valid column (lse ~ -1e30) contribute nothing to any
    gradient: the select comes before exp(s - lse) could overflow."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _arrays(*[(1, 12, 8)] * 3))
    o, lse = tatt.flash_attention_with_lse(q, k, v, causal=True,
                                           band_offset=-5)
    dq, dk, dv = torch.autograd.grad((o.sum(), lse[0, 5:].sum()),
                                     (q, k, v))
    assert torch.equal(dq[0, :5], torch.zeros(5, 8))
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))
