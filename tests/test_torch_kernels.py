"""The port's CUDA kernels (flash forward; the fused flash backward,
``flash_bwd_cuda``; the four BatchNorm training kernels; greedy NMS; the
multi-tensor optimizer update and gradient reduction) and their
wrappers, without the JAX package:
importable where only PyTorch is installed, as on the card's machine,
where

    python -m pytest --noconftest tests/test_torch_kernels.py

runs every case, the CUDA ones included. Tests marked ``cuda`` hold each
kernel against its plain version (``_flash_fwd_reference``,
``_flash_dq_reference``, ``_flash_dkv_reference``; bf16 within 2e-2,
compared in f32; f32 within rtol 1e-4 / atol 1e-5; lse within 1e-4;
the forward and backward of each dtype also bit-equal across two
launches; head dims 4 and 12 through the wrappers' zero-padding; the
exact-f32 kernels' 64-row tile edges) and skip on machines without a
card; the rest pin the wrappers' contract (the backward's scratch through
a fake kernel library) and the plain versions' own rules. The BatchNorm kernels are held to their
plain versions (``_stats_reference`` ...): the elementwise ones within
rtol/atol 1e-6 in f32 and one bf16 step (rtol 1e-2) in bf16, the f32
sums within 1e-4 of the sum of the terms' magnitudes per channel. The
NMS kernel's keep masks equal its plain version's (``_nms_reference``)
flag for flag, in ``chip_smoke.py``'s cases. The threefry PRNG's bits and
Dropout masks on the card equal its CPU draws, and both reproduce
``chip_smoke.PRNG_DIGESTS``. ``test_utils.check_consistency`` holds
LRN and Deconvolution on the card to their CPU runs. The multi-tensor
update equals its plain version (the registry op parameter by parameter)
bit for bit in ``chip_smoke.MT_UPDATE_CASES`` (float32 and bfloat16, and
lists of more than ``MAX_TENSORS`` tensors), and a numpy float32
emulation of its arithmetic (rounded to bfloat16 after each operation
for bfloat16) equals the registry op on the CPU; the reduction's finite
flag is exact and its sum within ``chip_smoke.MT_SUM_RTOL`` in
``chip_smoke.MT_NORM_CASES``; each wrapper counts the kernels it
launched.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch  # noqa: F401
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import bn_kernels as tbn
from mxnet_tpu_torch.ops import nms_kernels as tnms
from mxnet_tpu_torch.ops.registry import get_op

import chip_smoke


# lse tolerance of the kernels against their plain versions (as
# chip_smoke.py holds them)
LSE_TOL = dict(chip_smoke.LSE_TOL)


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
    ((2, 8, 256), (2, 8, 256), torch.float32, "head dim 256"),
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


@pytest.mark.parametrize("D", [4, 12, 20])
def test_padded_head_dim_route_is_exact(D):
    """The wrappers' pad/slice helper around the plain versions: q, k, v
    (and do) zero-padded to the next multiple of 8, the outputs cut back
    to D, equal to the unpadded plain versions (o and the lse, dq, dk,
    dv; f32, only the summation order differs) and of the same shape."""
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(
        (2, 20, D), (2, 27, D), (2, 27, D), (2, 20, D), seed=D))
    attrs = (D ** -0.5, True, 9, 4)
    widths = []

    def fwd(q, k, v):
        widths.append(q.shape[-1])
        return tatt._flash_fwd_reference(q, k, v, *attrs)

    o, lse = tatt._on_padded_head_dim(fwd, q, k, v)
    ro, rlse = tatt._flash_fwd_reference(q, k, v, *attrs)
    assert widths == [-(-D // 8) * 8] and o.shape == (2, 20, D)
    torch.testing.assert_close(o, ro, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(lse, rlse, rtol=1e-6, atol=1e-6)
    delta = torch.sum(do * o, dim=-1)

    def bwd(q, k, v, do):
        widths.append(q.shape[-1])
        args = (q, k, v, do, lse, delta, *attrs)
        return (tatt._flash_dq_reference(*args),
                *tatt._flash_dkv_reference(*args))

    grads = tatt._on_padded_head_dim(bwd, q, k, v, do)
    args = (q, k, v, do, lse, delta, *attrs)
    want = (tatt._flash_dq_reference(*args),
            *tatt._flash_dkv_reference(*args))
    assert widths[-1] == widths[0]
    for got, ref in zip(grads, want):
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7)


def test_aligned_head_dim_is_not_padded():
    q = torch.zeros((1, 4, 16))
    seen = []
    out = tatt._on_padded_head_dim(lambda x: seen.append(x) or (x,), q)
    assert seen[0] is q and out[0] is q


def test_library_path_hashes_every_header(tmp_path, monkeypatch):
    """A kernel library's build path changes when a header under csrc/
    changes, not only its own source, so an edited header rebuilds every
    library that may include it."""
    from mxnet_tpu_torch import _kernels
    before = {n: _kernels._lib_path(n) for n in _kernels.SOURCES}
    for src in _kernels.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh", ".h"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    assert {n: _kernels._lib_path(n) for n in _kernels.SOURCES} == before
    header = tmp_path / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    after = {n: _kernels._lib_path(n) for n in _kernels.SOURCES}
    assert all(after[n] != before[n] for n in _kernels.SOURCES)
    (tmp_path / "extra.h").write_text("// a new header\n")
    assert _kernels._lib_path("nms") != after["nms"]


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
    ("bf16_d32", 2, 300, 300, 32, torch.bfloat16, True, 0, 0),
    ("bf16_d4", 2, 256, 256, 4, torch.bfloat16, True, 0, 0),
    ("bf16_d12_ragged", 2, 200, 333, 12, torch.bfloat16, True, 0, 0),
    ("f32_d12", 2, 130, 97, 12, torch.float32, False, 0, 0),
    ("bf16_window_tiles", 2, 1000, 1000, 128, torch.bfloat16, True, 200,
     0),
    ("bf16_band_offset", 2, 256, 320, 128, torch.bfloat16, True, 100, 64),
    ("bf16_negative_offset_d128", 2, 256, 256, 128, torch.bfloat16, True,
     0, -40),
    ("bf16_noncausal_d128", 3, 640, 640, 128, torch.bfloat16, False, 0, 0),
    # the exact-f32 kernels' tile edges (64-row q tiles, 64-key tiles)
    ("f32_t_gt_tk", 2, 333, 200, 128, torch.float32, True, 0, 0),
    ("f32_t_lt_tk", 2, 130, 300, 128, torch.float32, True, 0, 0),
    ("f32_short", 2, 40, 40, 128, torch.float32, True, 0, 0),
    ("f32_window_ragged", 2, 300, 300, 128, torch.float32, True, 100, 0),
    ("f32_negative_offset", 2, 256, 256, 64, torch.float32, True, 0, -40),
    ("f32_d4", 2, 256, 256, 4, torch.float32, True, 0, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("BH,T,Tk,D,dtype,causal,window,band_offset",
                         [c[1:] for c in KERNEL_CASES],
                         ids=[c[0] for c in KERNEL_CASES])
@pytest.mark.parametrize("want_lse", [True, False], ids=["lse", "no_lse"])
def test_cuda_kernel_matches_plain_version(cuda_device, BH, T, Tk, D, dtype,
                                           causal, window, band_offset,
                                           want_lse):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((BH, n, D), generator=gen, device=cuda_device)
               .to(dtype) for n in (T, Tk, Tk))
    before = tatt.flash_fwd_cuda.launches
    o, lse = tatt.flash_fwd(q, k, v, D ** -0.5, causal, window,
                            band_offset, want_lse=want_lse)
    torch.cuda.synchronize()
    assert tatt.flash_fwd_cuda.launches == before + 1
    assert o.shape == q.shape and (lse is not None) == want_lse
    ro, rlse = tatt._flash_fwd_reference(q, k, v, D ** -0.5, causal,
                                         window, band_offset)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    if want_lse:
        torch.testing.assert_close(lse, rlse, **LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_cuda_bf16_kernel_takes_any_scale(cuda_device, scale):
    """The bf16 kernel folds a positive scale into its softmax; the
    wrapper gives it the same scores for a negative or zero one."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn((2, 150, 64), generator=gen, device=cuda_device)
               .bfloat16() for _ in range(3))
    o, lse = tatt.flash_fwd(q, k, v, scale, True, want_lse=True)
    ro, rlse = tatt._flash_fwd_reference(q, k, v, scale, True)
    torch.testing.assert_close(o.float(), ro.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, rlse, **LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,T,Tk,D,causal,window,band_offset", [
    (8, 1024, 1024, 128, True, 0, 0),
    (4, 1000, 1000, 128, True, 200, 0),
    (4, 256, 256, 128, True, 0, -40),
    (4, 300, 333, 12, False, 0, 0),
], ids=["causal", "window", "negative_offset", "d12_noncausal"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_fwd_kernel_is_deterministic(cuda_device, BH, T, Tk, D, causal,
                                          window, band_offset, dtype):
    """Two launches on the same inputs give the same bits: every output
    row has one owner."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn((BH, n, D), generator=gen, device=cuda_device)
               .to(dtype) for n in (T, Tk, Tk))
    args = (q, k, v, D ** -0.5, causal, window, band_offset)
    first = tatt.flash_fwd_cuda(*args, want_lse=True)
    second = tatt.flash_fwd_cuda(*args, want_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
def test_cuda_bwd_kernel_matches_plain_versions(cuda_device, BH, T, Tk, D,
                                                dtype, causal, window,
                                                band_offset, dlse):
    args = _bwd_inputs(BH, T, Tk, D, dtype, causal, window, band_offset,
                       cuda_device, dlse)
    attrs = (D ** -0.5, causal, window, band_offset)
    before = tatt.flash_bwd_cuda.launches
    dq, dk, dv = tatt.flash_bwd(*args, *attrs)
    torch.cuda.synchronize()
    assert tatt.flash_bwd_cuda.launches == before + 1
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dq.float(), tatt._flash_dq_reference(
        *args, *attrs).float(), **tol)
    rdk, rdv = tatt._flash_dkv_reference(*args, *attrs)
    torch.testing.assert_close(dk.float(), rdk.float(), **tol)
    torch.testing.assert_close(dv.float(), rdv.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,T,Tk,D,causal,window,band_offset", [
    (6, 640, 640, 128, False, 0, 0),
    (4, 1000, 1000, 128, True, 200, 0),
    (4, 300, 333, 64, True, 0, -40),
], ids=["noncausal", "window", "negative_offset"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_bwd_kernel_is_deterministic(cuda_device, BH, T, Tk, D, causal,
                                          window, band_offset, dtype):
    """Two launches on the same inputs give the same bits: dq is summed
    in a fixed order, without float atomics."""
    args = _bwd_inputs(BH, T, Tk, D, dtype, causal, window, band_offset,
                       cuda_device, True)
    attrs = (D ** -0.5, causal, window, band_offset)
    first = tatt.flash_bwd_cuda(*args, *attrs)
    second = tatt.flash_bwd_cuda(*args, *attrs)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


class _FakeBwdLibrary:
    """Stands in for the flash_bwd kernel library: records each call's
    arguments and what the scratch held when the kernel would start."""

    def __init__(self):
        self.calls = []

    def flash_bwd(self, q, k, v, do, lse, delta, dq, dk, dv, dq_acc, turns,
                  bh, t, tk, d, scale, causal, window, off, dtype, stream):
        import ctypes
        nq = -(-t // 64)
        dq_now = np.ctypeslib.as_array(
            (ctypes.c_float * (bh * t * d)).from_address(dq)).copy()
        turns_now = np.ctypeslib.as_array(
            (ctypes.c_int32 * (bh * nq)).from_address(turns)).copy()
        self.calls.append(dict(dq_acc=dq_acc, dtype=dtype, shape=(bh, t, tk, d),
                               dq=dq_now, turns=turns_now, nq=nq))
        return 0


@pytest.mark.parametrize("T", [40, 64, 130])
def test_launch_bwd_float32_scratch(monkeypatch, T):
    """_launch_bwd hands the float32 kernel dq zero-filled and int32 turn
    counters of (BH, ceil(T / 64)), zeroed, and no dq_acc; one launch a
    call. Runs on the CPU through a fake kernel library."""
    import contextlib
    import types
    from mxnet_tpu_torch import _kernels
    fake = _FakeBwdLibrary()
    monkeypatch.setattr(_kernels, "load", lambda name: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(
        (3, T, 16), (3, 50, 16), (3, 50, 16), (3, T, 16), seed=T))
    lse, delta = (torch.from_numpy(x) for x in _arrays((3, T), (3, T),
                                                       seed=T + 1))
    for n in (1, 2):
        dq, dk, dv = tatt._launch_bwd(q, k, v, do, lse, delta, 0.25, True,
                                      0, 0)
        assert len(fake.calls) == n
    call = fake.calls[-1]
    assert call["dq_acc"] is None and call["dtype"] == 0
    assert call["shape"] == (3, T, 50, 16)
    assert call["nq"] == -(-T // tatt._BWD_BLOCK_Q)
    assert not call["dq"].any() and not call["turns"].any()
    assert dq.shape == q.shape and dq.dtype == torch.float32
    assert dk.shape == dv.shape == k.shape


@pytest.mark.parametrize("bad,match", [
    ("do_shape", "do must match q"),
    ("do_dtype", "do must match q"),
    ("lse_dtype", "lse must be float32"),
    ("delta_shape", "delta must be float32"),
    ("kv_shape", "do not agree"),
    ("head_dim_136", "head dim 136"),
    ("rank4", r"\(BH, T, D\)"),
    ("cpu", "CUDA device"),
])
def test_bwd_kernel_wrapper_validates_inputs(bad, match):
    """The backward wrapper raises on what the kernel does not take —
    before any build or launch, so this runs without a card."""
    shape = {"head_dim_136": (2, 8, 136), "rank4": (1, 2, 8, 16)}.get(
        bad, (2, 8, 16))
    q = k = v = do = torch.zeros(shape)
    lse = delta = torch.zeros(shape[:2])
    if bad == "do_shape":
        do = torch.zeros((2, 9, 16))
    elif bad == "do_dtype":
        do = torch.zeros(shape, dtype=torch.bfloat16)
    elif bad == "lse_dtype":
        lse = torch.zeros((2, 8), dtype=torch.float64)
    elif bad == "delta_shape":
        delta = torch.zeros((2, 9))
    elif bad == "kv_shape":
        v = torch.zeros((2, 9, 16))
    with pytest.raises((ValueError, TypeError), match=match):
        tatt.flash_bwd_cuda(q, k, v, do, lse, delta, 0.25, True)


def test_bwd_dispatch_runs_the_plain_versions_on_cpu():
    """flash_bwd on CPU tensors returns exactly the plain versions'
    tensors, and launches nothing."""
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(
        (2, 20, 16), (2, 24, 16), (2, 24, 16), (2, 20, 16), seed=5))
    lse, delta = (torch.from_numpy(x) for x in _arrays((2, 20), (2, 20),
                                                       seed=6))
    args = (q, k, v, do, lse, delta, 0.25, True, 8, 3)
    before = tatt.flash_bwd_cuda.launches
    dq, dk, dv = tatt.flash_bwd(*args)
    assert tatt.flash_bwd_cuda.launches == before
    rdk, rdv = tatt._flash_dkv_reference(*args)
    assert torch.equal(dq, tatt._flash_dq_reference(*args))
    assert torch.equal(dk, rdk) and torch.equal(dv, rdv)


def test_backward_plain_versions_on_meta_give_shapes():
    q = torch.empty((3, 10, 16), device="meta")
    k = torch.empty((3, 14, 16), device="meta")
    lse = torch.empty((3, 10), device="meta")
    dq, dk, dv = tatt.flash_bwd(q, k, k, q, lse, lse, 0.25, True)
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


# ---------------------------------------------------------------------------
# the BatchNorm kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------

# (id, N, C, HW, dtype, scale, shift): 16-byte rows (HW % 8 == 0 in bf16,
# % 4 in f32) and rows that are not (HW 49, 196 in bf16, 1), N = 1, odd C,
# and |mean| / std = 1e3
BN_CASES = [
    ("bf16_56x56", 8, 64, 3136, torch.bfloat16, 1.0, 0.0),
    ("bf16_14x14", 16, 96, 196, torch.bfloat16, 1.0, 0.5),
    ("bf16_7x7", 8, 160, 49, torch.bfloat16, 2.0, 0.0),
    ("bf16_n1_c3_hw49", 1, 3, 49, torch.bfloat16, 1.0, 0.0),
    ("bf16_hw1", 64, 5, 1, torch.bfloat16, 1.0, 1.0),
    ("f32_14x14", 4, 33, 196, torch.float32, 1.0, 0.0),
    ("f32_7x7", 3, 7, 49, torch.float32, 1.0, 0.0),
    ("f32_large_mean", 8, 4, 64, torch.float32, 1e-2, 10.0),
    ("bf16_large_mean", 8, 4, 64, torch.bfloat16, 1.0, 1e3),
]


def _bn_inputs(N, C, HW, dtype, scale, shift, device):
    gen = torch.Generator(device=device).manual_seed(2)
    x = (torch.randn((N, C, HW), generator=gen, device=device) * scale
         + shift).to(dtype)
    dy = torch.randn((N, C, HW), generator=gen, device=device).to(dtype)
    chans = [torch.randn(C, generator=gen, device=device) for _ in range(3)]
    return x, dy, chans


def _assert_sums_close(got, want, magnitude):
    """Per channel, |got - want| within 1e-4 of the sum of the terms'
    magnitudes (f32 sums in another order)."""
    for g, w, m in zip(got, want, magnitude):
        assert torch.all((g - w).abs() <= 1e-4 * m + 1e-6), \
            ((g - w).abs().max().item(), m.max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,HW,dtype,scale,shift",
                         [c[1:] for c in BN_CASES],
                         ids=[c[0] for c in BN_CASES])
def test_cuda_bn_kernels_match_plain_versions(cuda_device, N, C, HW, dtype,
                                              scale, shift):
    x, dy, (a, c2, b) = _bn_inputs(N, C, HW, dtype, scale, shift,
                                   cuda_device)
    c = x[0].float().mean(dim=1)             # the shift, as the op takes it
    mean = x.float().mean(dim=(0, 2))
    counts = {f: f.launches for f in (tbn.bn_stats_cuda, tbn.bn_apply_cuda,
                                      tbn.bn_bwd_reduce_cuda,
                                      tbn.bn_bwd_dx_cuda)}
    s = tbn.bn_stats(x, c)
    y = tbn.bn_apply(x, a, b)
    r = tbn.bn_bwd_reduce(dy, x, mean)
    dx = tbn.bn_bwd_dx(dy, x, a, c2, b, mean)
    torch.cuda.synchronize()
    assert all(f.launches == n + 1 for f, n in counts.items())
    xc = x.float() - c[:, None]
    _assert_sums_close(s, tbn._stats_reference(x, c),
                       (xc.abs().sum(dim=(0, 2)),
                        (xc * xc).sum(dim=(0, 2))))
    dyf, xm = dy.float(), x.float() - mean[:, None]
    _assert_sums_close(r, tbn._bwd_reduce_reference(dy, x, mean),
                       (dyf.abs().sum(dim=(0, 2)),
                        (dyf * xm).abs().sum(dim=(0, 2))))
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-6, atol=1e-6)
    assert y.dtype == dx.dtype == dtype
    torch.testing.assert_close(y.float(), tbn._apply_reference(
        x, a, b).float(), **tol)
    torch.testing.assert_close(dx.float(), tbn._bwd_dx_reference(
        dy, x, a, c2, b, mean).float(), **tol)


@pytest.mark.cuda
def test_cuda_bn_train_kernels_match_plain_route(cuda_device):
    """bn_train_kernels on the card against the same Function on the
    CPU (the plain versions): outputs and gradients, f32."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 6, 7, 7), generator=gen) * 2 + 1
    g, b = torch.rand(6, generator=gen) + 0.5, torch.randn(6, generator=gen)
    dy = torch.randn((4, 6, 7, 7), generator=gen)
    outs = []
    for dev in ("cpu", cuda_device):
        xs = [t.to(dev).requires_grad_() for t in (x, g, b)]
        y, mean, var = tbn.bn_train_kernels(*xs, 1e-3)
        grads = torch.autograd.grad((y * dy.to(dev)).sum() + mean.sum()
                                    + var.sum(), xs)
        outs.append([t.detach().cpu() for t in (y, mean, var, *grads)])
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the NMS kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad,match", [
    ("rank", r"\(B, A, 4\)"),
    ("dtype", "float32"),
    ("cpu", "CUDA device"),
    ("cls_shape", "cls_ids must be"),
    ("valid_dtype", "valid must be"),
])
def test_nms_kernel_wrapper_validates_inputs(bad, match):
    """The NMS wrapper raises on what the kernel does not take — before
    any build or launch, so this runs without a card."""
    boxes, cls = torch.zeros((2, 10, 4)), torch.zeros((2, 10))
    valid = torch.ones((2, 10), dtype=torch.bool)
    if bad == "rank":
        boxes = boxes[0]
    elif bad == "dtype":
        boxes = boxes.double()
    elif bad == "cls_shape":
        cls = cls[:, :5]
    elif bad == "valid_dtype":
        valid = valid.float()
    with pytest.raises((ValueError, TypeError), match=match):
        tnms.nms_keep_cuda(boxes, cls, valid, 0.45)


def test_nms_dispatch_runs_the_plain_version_on_cpu():
    boxes = torch.tensor([[[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 0.5],
                           [2.0, 2.0, 3.0, 3.0]]])
    before = tnms.nms_keep_cuda.launches
    keep = tnms.nms_keep(boxes, torch.zeros((1, 3)),
                         torch.ones((1, 3), dtype=torch.bool), 0.5)
    assert keep.tolist() == [[True, False, True]]
    assert tnms.nms_keep_cuda.launches == before


def test_nms_bound_counts_the_pairs_greedy_nms_needs():
    """chip_smoke.nms_bound on a hand case: rows 0-2 valid, 0 and 2 kept;
    pairs (kept i, valid j > i) are (0, 1) and (0, 2), only (0, 1) of one
    class; 2 bytes a row and 20 more a valid row."""
    cls = torch.tensor([[0.0, 0.0, 1.0, 0.0]])
    valid = torch.tensor([[True, True, True, False]])
    keep = torch.tensor([[True, False, True, False]])
    bound, by, counts = chip_smoke.nms_bound(cls, valid, keep, False)
    assert counts == {"kept_valid_pairs": 2, "iou_tests": 1,
                      "operations": 14 + 2, "bytes": 2 * 4 + 20 * 3}
    assert by == "bytes"
    assert bound == pytest.approx(68 / chip_smoke.PEAK_BYTES_PER_S * 1e3)
    _, _, counts = chip_smoke.nms_bound(cls, valid, keep, True)
    assert counts["iou_tests"] == 2 and counts["operations"] == 28


@pytest.mark.parametrize("force", [False, True])
def test_nms_bound_matches_a_pair_by_pair_count(force):
    rng = np.random.RandomState(9)
    B, A = 3, 50
    cls = torch.from_numpy(rng.randint(0, 4, (B, A)).astype(np.float32))
    valid = torch.from_numpy(rng.rand(B, A) < 0.7)
    keep = valid & torch.from_numpy(rng.rand(B, A) < 0.5)
    pairs = same = 0
    for b in range(B):
        for i in range(A):
            for j in range(i + 1, A):
                if keep[b, i] and valid[b, j]:
                    pairs += 1
                    same += bool(force or cls[b, i] == cls[b, j])
    bound, by, counts = chip_smoke.nms_bound(cls, valid, keep, force)
    assert counts["kept_valid_pairs"] == pairs
    assert counts["iou_tests"] == same
    assert counts["operations"] == 14 * same + (0 if force else pairs)
    assert counts["bytes"] == 2 * B * A + 20 * int(valid.sum())


def test_nms_cases_are_unique_and_within_the_kernel_limit():
    """chip_smoke.NMS_CASES (also the card tests' cases): unique labels,
    every A within MAX_ANCHORS, at most A valid rows, a known kind."""
    labels = [c[0] for c in chip_smoke.NMS_CASES]
    assert len(labels) == len(set(labels))
    kinds = {"ssd", "scattered", "degenerate", "identical", "at_threshold"}
    for label, B, A, n_valid, force, kind in chip_smoke.NMS_CASES:
        assert B >= 1 and 1 <= A <= tnms.MAX_ANCHORS, label
        assert 0 <= n_valid <= A and kind in kinds, label
    assert max(c[2] for c in chip_smoke.NMS_CASES) == tnms.MAX_ANCHORS


@pytest.mark.cuda
@pytest.mark.parametrize("label,B,A,n_valid,force,kind",
                         chip_smoke.NMS_CASES,
                         ids=[c[0] for c in chip_smoke.NMS_CASES])
def test_cuda_nms_kernel_matches_plain_version(cuda_device, label, B, A,
                                               n_valid, force, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    boxes, cls, valid = chip_smoke.nms_inputs(B, A, n_valid, kind, gen)
    thr = 0.5 if kind == "at_threshold" else 0.45
    before = tnms.nms_keep_cuda.launches
    keep = tnms.nms_keep(boxes, cls, valid, thr, force)
    torch.cuda.synchronize()
    assert tnms.nms_keep_cuda.launches == before + 1
    assert torch.equal(keep, tnms._nms_reference(boxes, cls, valid, thr,
                                                 force))


@pytest.mark.cuda
@pytest.mark.parametrize("attrs", [
    dict(nms_threshold=0.45, nms_topk=400),
    dict(nms_threshold=0.45, force_suppress=True, threshold=0.05),
    dict(nms_threshold=0.5, background_id=3, nms_topk=100),
], ids=["topk", "force", "background_id"])
def test_cuda_multibox_detection_routes_agree(cuda_device, attrs):
    """MultiBoxDetection on the card: the kernel route equals the dense
    route bit for bit, and the CPU's detections of the same heads."""
    rng = np.random.RandomState(6)
    B, C, A = 3, 6, 8732
    cls_prob = rng.rand(B, C, A).astype(np.float32)
    cls_prob /= cls_prob.sum(1, keepdims=True)
    loc = (rng.randn(B, A * 4) * 0.5).astype(np.float32)
    anchors = chip_smoke.ssd_anchors()[None].numpy()
    op = get_op("_contrib_MultiBoxDetection")
    heads = [torch.from_numpy(v) for v in (cls_prob, loc, anchors)]

    def run(device, impl):
        return op.fn(*[h.to(device) for h in heads],
                     **{**op.defaults, **attrs, "impl": impl}).cpu()

    kernel = run(cuda_device, "pallas")
    assert torch.equal(kernel, run(cuda_device, "xla"))
    assert torch.equal(kernel, run(cuda_device, "auto"))
    cpu = run("cpu", "auto")
    assert torch.equal(kernel[..., 0], cpu[..., 0])
    torch.testing.assert_close(kernel, cpu, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the threefry PRNG: card bits against CPU bits (no JAX here; the JAX
# comparison is tests/test_torch_random.py)
# ---------------------------------------------------------------------------

def test_prng_digests_on_the_cpu_match_the_table():
    """The port's CPU draws reproduce chip_smoke.PRNG_DIGESTS (JAX's own
    draws, recomputed from JAX by tests/test_torch_random.py)."""
    import mxnet_tpu_torch as mx
    assert chip_smoke.prng_digests(mx, mx.cpu()) == chip_smoke.PRNG_DIGESTS


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 4096), (70001,), ()], ids=str)
@pytest.mark.parametrize("width", [8, 16, 32, 64])
def test_cuda_random_bits_equal_cpu_bits(cuda_device, shape, width):
    from mxnet_tpu_torch import _threefry as tf
    key = tf.fold_in(tf.PRNGKey(0), 17)
    assert torch.equal(tf.random_bits(key, shape, width, cuda_device).cpu(),
                       tf.random_bits(key, shape, width, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dropout_mask_equals_cpu_mask(cuda_device, dtype):
    """Dropout on the card keeps exactly the CPU mask's elements."""
    from mxnet_tpu_torch import _threefry as tf
    key = tf.PRNGKey(3)
    x = torch.randn(512, 4096).to(getattr(torch, dtype))
    out = get_op("Dropout").fn(x.to(cuda_device), p=0.5, is_train=True,
                               rng=key).cpu()
    mask = tf.bernoulli(key, 0.5, (512, 4096), "cpu")
    assert torch.equal(out, torch.where(mask, x / 0.5, 0.0).to(x.dtype))


@pytest.mark.cuda
def test_cuda_prng_digests_match_the_table(cuda_device):
    import mxnet_tpu_torch as mx
    assert chip_smoke.prng_digests(mx, mx.gpu(0)) == chip_smoke.PRNG_DIGESTS


# ---------------------------------------------------------------------------
# test_utils.check_consistency: the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_check_consistency_holds_the_card_to_the_cpu(cuda_device):
    """AlexNet's LRN and a Deconvolution run on gpu(0) inputs agree with
    their CPU runs (and in bf16); a function that differs between the two
    devices is caught."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import test_utils as ttu
    x, w = _arrays((2, 8, 9, 9), (8, 4, 3, 3), seed=4)
    inputs = [mx.nd.array(x, ctx=mx.gpu(0)), mx.nd.array(w, ctx=mx.gpu(0))]

    def net(a, k):
        h = mx.nd.LRN(a, nsize=5, alpha=1e-4, beta=0.75)
        return mx.nd.Deconvolution(h, k, kernel=(3, 3), stride=(2, 2),
                                   num_filter=4, no_bias=True)
    out = ttu.check_consistency(net, inputs, dtypes=["bfloat16"])
    assert out.context == mx.gpu(0) and out.shape == (2, 4, 19, 19)

    def skewed(a, k):
        return net(a, k) + (1e-3 if a.context == mx.gpu(0) else 0.0)
    with pytest.raises(AssertionError, match="inconsistent on the CPU"):
        ttu.check_consistency(skewed, inputs)


# ---------------------------------------------------------------------------
# the multi-tensor optimizer update and gradient reduction
# (csrc/multi_tensor.cu, ops/optimizer_kernels.py)
# ---------------------------------------------------------------------------

from mxnet_tpu_torch.ops import optimizer_kernels as tmt  # noqa: E402

MT_UPDATE_CASES = chip_smoke.MT_UPDATE_CASES
MT_NORM_CASES = chip_smoke.MT_NORM_CASES
_mt_operands = chip_smoke.mt_operands
_mt_scalars = chip_smoke.mt_scalars
_bits = chip_smoke._int_bits


def test_multi_tensor_wrappers_refuse_cpu_tensors():
    ws, gs, ss = _mt_operands("adam_update", (3,), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tmt.multi_tensor_opt_update_cuda("adam_update", ws, gs, ss, 0.1,
                                         {})
    with pytest.raises(ValueError, match="CUDA"):
        tmt.multi_tensor_norm_finite_cuda(gs)
    with pytest.raises(ValueError, match="not one of"):
        tmt.multi_tensor_opt_update_cuda("rmsprop_update", ws, gs, ss, 0.1,
                                         {})


@pytest.mark.cuda
def test_cuda_multi_tensor_update_refuses_other_dtypes(cuda_device):
    """float16 and mixed float32/bfloat16 lists raise; nothing falls back
    to the per-parameter route."""
    ws, gs, ss = _mt_operands("adam_update", (3, 5), cuda_device)
    with pytest.raises(TypeError, match="share one dtype"):
        tmt.opt_update("adam_update", ws, [g.bfloat16() for g in gs], ss,
                       0.1, {})
    half = [w.half() for w in ws]
    with pytest.raises(TypeError, match="must be"):
        tmt.opt_update("adam_update", half, [g.half() for g in gs],
                       [tuple(x.half() for x in s) for s in ss], 0.1, {})


def _emulate_update(op, w, g, s, lr, attrs, inv=1.0, gscale=1.0,
                    dtype="float32"):
    """The kernel's arithmetic (csrc/multi_tensor.cu update_one) in numpy
    float32, one rounding an operation, with the kernel's host scalars;
    for bfloat16 each result is rounded to bfloat16 (``r``) and so are
    clamp's bounds. The square root is PyTorch's: on the CPU it is not
    correctly rounded (it differs from numpy's in the last bit), while on
    the card both torch.sqrt and the kernel's __fsqrt_rn are."""
    f = np.float32
    if dtype == "bfloat16":
        def r(x):
            return torch.from_numpy(np.asarray(x, f)).bfloat16().float(
                ).numpy()
    else:
        def r(x):
            return x
    lr_, rescale, clip, wd, a, b, c, d, eps = (
        f(x) for x in tmt._hyper(op, lr, attrs))
    g = r(g * f(inv))
    g = r(g * f(gscale))
    g = r(g * rescale)
    if clip > 0:
        cb = r(clip)
        g = np.where(np.isnan(g), g, np.minimum(np.maximum(g, -cb), cb))
    g = r(g + r(w * wd))
    if op == "adam_update":
        m1 = r(r(s[0] * a) + r(g * b))
        v1 = r(r(s[1] * c) + r(r(g * g) * d))
        root = r(torch.sqrt(torch.from_numpy(v1)).numpy())
        return r(w - r(r(m1 * lr_) / r(root + eps))), (m1, v1)
    m1 = r(r(s[0] * a) - r(g * lr_))
    return r(w + m1), (m1,)


@pytest.mark.parametrize("case", MT_UPDATE_CASES, ids=lambda c: c[0])
def test_multi_tensor_arithmetic_equals_the_registry_op(case):
    """The kernel's per-element arithmetic, emulated in numpy float32,
    equals the registry op (and the plain version) bit for bit on the
    CPU: the order of operations and the host-rounded scalars."""
    _, op, sizes, attrs, flag, gscale, inv, donate, dtype = case
    sizes = tuple(min(n, 5000) for n in sizes)
    ws, gs, ss = _mt_operands(op, sizes, "cpu", seed=1, dtype=dtype)
    lr = 0.0123

    def host(t):
        return t.float().numpy().copy()
    np_args = [(host(w), host(g), tuple(host(x) for x in s))
               for w, g, s in zip(ws, gs, ss)]
    fl, gsc, inv_t = _mt_scalars("cpu", flag, gscale, inv)
    new_w, new_s = tmt._opt_update_reference(
        op, ws, gs, ss, lr, attrs, flag=fl, gscale=gsc, inv_scale=inv_t,
        donate=donate)
    with np.errstate(invalid="ignore", over="ignore"):
        for (w, g, s), nw, ns in zip(np_args, new_w, new_s):
            ew, es = _emulate_update(op, w, g, s, lr, attrs,
                                     1.0 if inv is None else inv,
                                     1.0 if gscale is None else gscale,
                                     dtype)
            if flag is False:
                ew, es = w, s
            assert np.array_equal(host(nw).view(np.int32),
                                  ew.view(np.int32))
            for x, y in zip(ns, es):
                assert np.array_equal(host(x).view(np.int32),
                                      y.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", MT_UPDATE_CASES, ids=lambda c: c[0])
def test_cuda_multi_tensor_update_is_bit_equal(cuda_device, case):
    _, op, sizes, attrs, flag, gscale, inv, donate, dtype = case
    ws, gs, ss = _mt_operands(op, sizes, cuda_device, dtype=dtype)
    ref = [[t.clone() for t in ws], [t.clone() for t in gs],
           [tuple(x.clone() for x in s) for s in ss]]
    before = [t.clone() for t in ws]
    fl, gsc, inv_t = _mt_scalars(cuda_device, flag, gscale, inv)
    launches = tmt.multi_tensor_opt_update_cuda.launches
    kw, ks = tmt.multi_tensor_opt_update_cuda(
        op, ws, gs, ss, 0.0123, attrs, flag=fl, gscale=gsc,
        inv_scale=inv_t, donate=donate)
    torch.cuda.synchronize()
    assert tmt.multi_tensor_opt_update_cuda.launches == (
        launches + chip_smoke.mt_launches(len(sizes)))
    rw, rs = tmt._opt_update_reference(op, *ref, 0.0123, attrs, flag=fl,
                                       gscale=gsc, inv_scale=inv_t,
                                       donate=donate)
    for a, b, w, w0 in zip(kw, rw, ws, before):
        assert a.dtype == getattr(torch, dtype)
        assert torch.equal(_bits(a), _bits(b))
        assert (a is w) == donate
        if not donate:
            assert torch.equal(w, w0)
    for sa, sb in zip(ks, rs):
        for a, b in zip(sa, sb):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", MT_NORM_CASES, ids=lambda c: c[0])
def test_cuda_multi_tensor_norm_finite(cuda_device, case):
    """Sum of squares within 1e-6 relative of the plain version's, the
    finite flag exact (NaN and Inf planted), gscale within 1e-6."""
    _, sizes, outs, plant, inject, inv, clip = case
    grads, out_t, inv_t = chip_smoke.mt_norm_operands(case, cuda_device)
    launches = tmt.multi_tensor_norm_finite_cuda.launches
    s, ok, gs = tmt.multi_tensor_norm_finite_cuda(
        grads, out_t, inject=inject, inv_scale=inv_t, rescale=0.125,
        clip_norm=clip)
    torch.cuda.synchronize()
    assert tmt.multi_tensor_norm_finite_cuda.launches == (
        launches + chip_smoke.mt_launches(len(sizes) + len(outs), True))
    rs, rok, rgs = tmt._norm_finite_reference(
        grads, out_t, inject=inject, inv_scale=inv_t, rescale=0.125,
        clip_norm=clip)
    assert bool(ok) == bool(rok) == (plant is None and inject == 1.0)
    if bool(rok):
        rtol = chip_smoke.MT_SUM_RTOL
        torch.testing.assert_close(s, rs, rtol=rtol, atol=0)
        torch.testing.assert_close(gs, rgs, rtol=rtol, atol=0)
        if clip is None:
            assert float(gs) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", MT_UPDATE_CASES, ids=lambda c: c[0])
def test_cuda_multi_tensor_update_reads_lr_on_the_device(cuda_device, case):
    """With lr a 0-d float32 tensor on the card (a captured step's), the
    update equals its plain version with the host float lr bit for
    bit."""
    _, op, sizes, attrs, flag, gscale, inv, donate, dtype = case
    ws, gs, ss = _mt_operands(op, sizes, cuda_device, dtype=dtype)
    ref = [[t.clone() for t in ws], [t.clone() for t in gs],
           [tuple(x.clone() for x in s) for s in ss]]
    fl, gsc, inv_t = _mt_scalars(cuda_device, flag, gscale, inv)
    lr = torch.full((), 0.0123, dtype=torch.float32, device=cuda_device)
    kw, ks = tmt.multi_tensor_opt_update_cuda(
        op, ws, gs, ss, lr, attrs, flag=fl, gscale=gsc, inv_scale=inv_t,
        donate=donate)
    rw, rs = tmt._opt_update_reference(op, *ref, 0.0123, attrs, flag=fl,
                                       gscale=gsc, inv_scale=inv_t,
                                       donate=donate)
    torch.cuda.synchronize()
    for a, b in zip(kw, rw):
        assert torch.equal(_bits(a), _bits(b))
    for sa, sb in zip(ks, rs):
        for a, b in zip(sa, sb):
            assert torch.equal(_bits(a), _bits(b))
    with pytest.raises(ValueError, match="device scalar"):
        tmt.multi_tensor_opt_update_cuda(
            op, ws, gs, ss, lr.double(), attrs)


def _captured_nets():
    """(id, symbol, data shape, classes, compute dtype, optimizer): an
    MLP with a Dropout (the seed path) and a small conv net on the
    BatchNorm kernels."""
    import mxnet_tpu_torch as mx
    sym = mx.sym
    h = sym.Activation(sym.FullyConnected(sym.Variable("data"),
                                          num_hidden=64, name="fc1"),
                       act_type="relu")
    h = sym.Dropout(h, p=0.5, name="drop")
    mlp = sym.SoftmaxOutput(sym.FullyConnected(h, num_hidden=10,
                                               name="fc2"), name="softmax")
    x = sym.Convolution(sym.Variable("data"), num_filter=16, kernel=(3, 3),
                        pad=(1, 1), name="conv1")
    x = sym.Activation(sym.BatchNorm(x, name="bn1"), act_type="relu")
    x = sym.Pooling(x, global_pool=True, kernel=(2, 2), pool_type="avg")
    conv = sym.SoftmaxOutput(sym.FullyConnected(sym.Flatten(x),
                                                num_hidden=10, name="fc"),
                             name="softmax")
    return [("mlp_dropout_f32_sgd", mlp, (32, 20), None, "sgd"),
            ("conv_bn_bf16_adam", conv, (8, 3, 16, 16), "bfloat16",
             "adam")]


@pytest.mark.cuda
@pytest.mark.parametrize("net", range(2), ids=["mlp_dropout_f32_sgd",
                                                "conv_bn_bf16_adam"])
def test_cuda_captured_step_equals_eager_steps(cuda_device, net, tmp_path,
                                               monkeypatch):
    """TrainStep.export -> CompiledTrainStep.load on the card: the first
    step warms up and captures the CUDA graph, five more replay it, each
    with its own lr and the default seed; the state equals six direct
    TrainStep steps with the same lrs and PRNGKey(i), bit for bit, under
    torch.use_deterministic_algorithms(True)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.parallel import make_train_step
    from mxnet_tpu_torch.parallel.trainer import CompiledTrainStep

    _, sym, shape, cdt, opt = _captured_nets()[net]
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    config.set_override("MXNET_BN_PALLAS", True)
    torch.use_deterministic_algorithms(True)
    try:
        step = make_train_step(sym, optimizer=opt, compute_dtype=cdt,
                               optimizer_params={"momentum": 0.9}
                               if opt == "sgd" else {}, ctx=mx.gpu(0))
        B = shape[0]
        mx.random.seed(0)
        state = step.init_state(Xavier(), {"data": shape,
                                           "softmax_label": (B,)})
        rng = np.random.RandomState(0)
        batches = [{"data": rng.standard_normal(shape).astype(np.float32),
                    "softmax_label": rng.randint(0, 10, (B,)).astype(
                        np.float32)} for _ in range(3)]
        prefix = str(tmp_path / "net")
        step.export(prefix, state, batches[0])
        ct = CompiledTrainStep.load(prefix, ctx=mx.gpu(0))
        lrs = [0.05 / (i + 1) for i in range(6)]
        outs = [ct.step(batches[i % 3], lrs[i]) for i in range(6)]
        assert ct.capture_ms is not None and ct.capture_ms > 0
        for i in range(6):
            state, o = step(state, batches[i % 3], lrs[i],
                            mx.random.PRNGKey(i))
            assert np.array_equal(outs[i][0], o[0].float().cpu().numpy())
        got = ct._unflat()
        for a, b in zip(got, state):
            for k in b:
                x = b[k] if isinstance(b[k], tuple) else (b[k],)
                y = a[k] if isinstance(a[k], tuple) else (a[k],)
                for u, v in zip(x, y):
                    assert torch.equal(u, v), k
    finally:
        torch.use_deterministic_algorithms(False)
        config.set_override("MXNET_BN_PALLAS", None)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [
    {}, dict(block_type=("attention", "ssm"), pos_encoding="rope")],
    ids=["learned", "hybrid_rope"])
def test_cuda_captured_generation_loops_equal_eager_loops(cuda_device,
                                                           arch):
    """Generator on the card, a small bf16 LM: generate_on_device (the
    decode step captured as one CUDA graph; twice, the second run
    replaying the first's graph), greedy and sampled, equals generate;
    beam_search_on_device equals beam_search; the captured speculative
    rounds equal generate (float32, a truncated draft)."""
    from mxnet_tpu_torch.generation import Generator
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import make_train_step

    V, ML, B = 50, 32, 2
    kw = dict(num_layers=2, num_heads=4, dim=32, **arch)
    sym = transformer.get_symbol(V, ML, **kw)
    params = make_train_step(sym, optimizer="sgd").init_state(
        Xavier(magnitude=6.0), {"data": (B, ML), "softmax_label": (B, ML)})[0]
    prompt = np.random.RandomState(0).randint(0, V, (B, 5))
    gen = Generator(params, V, ML, batch_size=B, dtype="bfloat16", **kw)
    for skw in ({}, dict(temperature=0.9, top_k=8, seed=4)):
        want = gen.generate(prompt, 12, **skw)
        for _ in range(2):
            np.testing.assert_array_equal(
                gen.generate_on_device(prompt, 12, **skw), want)
    assert gen._loop_cache[(5, 12, 0.0, 0, 0.0, None)].graph is not None
    if "block_type" in arch:
        return
    np.testing.assert_array_equal(
        gen.beam_search_on_device(prompt, 6, beam_size=3),
        gen.beam_search(prompt, 6, beam_size=3))
    f32 = Generator(params, V, ML, batch_size=B, **kw)
    draft = f32.truncated_draft(1)
    for _ in range(2):
        np.testing.assert_array_equal(
            f32.generate_speculative_on_device(draft, prompt, 12,
                                               lookahead=3),
            f32.generate(prompt, 12))


@pytest.mark.cuda
def test_captured_bucket_graph_equals_eager(cuda_device, tmp_path):
    """Predictor.export -> CompiledPredictor on the card: the forward
    captured as one CUDA graph (the flash kernel in a bf16 LM, the NMS
    kernel in MultiBoxDetection) replays to the eager Predictor's output
    bit for bit, twice, with new inputs each time; the wrappers ran in the
    warm-up and the capture only."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.predictor import CompiledPredictor

    V, T, B = 64, 128, 2
    lm = transformer.get_symbol(V, T, num_layers=2, num_heads=2, dim=64)
    rng = np.random.RandomState(0)
    shapes, _, _ = lm.infer_shape(data=(B, T), softmax_label=(B, T))
    w = {n: torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.3)
         .to(cuda_device, torch.bfloat16)
         for n, s in zip(lm.list_arguments(), shapes)
         if n not in ("data", "softmax_label")}
    names = ("data", "softmax_label")
    det = mx.sym.contrib.MultiBoxDetection(
        mx.sym.Variable("cls_prob"), mx.sym.Variable("loc_pred"),
        mx.sym.Variable("anchor"), nms_threshold=0.45, nms_topk=400)
    A, C = 600, 5
    anchors = np.sort(rng.rand(1, A, 2, 2), axis=2).reshape(1, A, 4)
    cases = [
        (lm, w, names, tatt.flash_fwd_cuda, 2,
         lambda i: [np.random.RandomState(i).randint(0, V, (B, T))
                    .astype(np.float32), np.zeros((B, T), np.float32)]),
        (det, {}, ("cls_prob", "loc_pred", "anchor"), tnms.nms_keep_cuda, 1,
         lambda i: [np.random.RandomState(i).dirichlet(
             np.ones(C), (B, A)).transpose(0, 2, 1).astype(np.float32),
             np.random.RandomState(i + 1).randn(B, A * 4).astype(
                 np.float32) * 0.1, anchors.astype(np.float32)])]
    for k, (sym, params, names, wrapper, per_fwd, inputs) in enumerate(cases):
        pred = mx.Predictor(sym, params, data_names=names)
        prefix = str(tmp_path / ("m%d" % k))
        first = inputs(0)
        pred.export(prefix, {n: a.shape for n, a in zip(names, first)})
        before = wrapper.launches
        cp = CompiledPredictor.load(prefix)
        assert cp._graph is not None
        assert wrapper.launches == before + 2 * per_fwd
        for i in range(2):
            xs = inputs(10 + i)
            got = cp.forward(*xs)[0].handle
            want = pred.forward(*xs)[0].handle
            assert torch.equal(got, want)
