"""Fused scaled-dot-product attention over the hand-written Hopper flash
kernels — the PyTorch twin of ``mxnet_tpu/ops/attention.py``'s flash
path, forward and backward.

``flash_fwd`` and ``flash_bwd`` are the entries to the kernels
(``csrc/flash_fwd.cu``, the port of the TPU's ``_flash_fwd_kernel``;
``csrc/flash_bwd.cu``, one fused pass that replaces
``_flash_dq_kernel`` and ``_flash_dkv_kernel``); each source holds one
kernel for bf16 (wgmma, TMA) and one for float32 (exact FFMA on the CUDA
cores, register-tiled). On a CUDA tensor each
launches its kernel or raises; on a CPU (or meta) tensor it runs the
plain versions (``_flash_fwd_reference``; ``_flash_dq_reference`` and
``_flash_dkv_reference``): dense f32 math with the same masking,
rounding and lse rules. Nothing falls back from one to the other.

``flash_attention`` / ``flash_attention_with_lse`` and the
``_contrib_FlashAttention`` op keep the JAX package's signatures. Their
gradients are the autograd Functions ``_Flash`` and ``_FlashLse``, the
twins of the custom VJPs ``_flash`` and ``_flash_lse``: the forward
emits the lse only when a gradient is needed, and the backward computes
delta = rowsum(do * o) - dlse in plain torch, then launches the
backward kernel once. The ``block_q`` / ``block_k`` attrs are accepted for
graph and JSON parity; the kernels pick their own tiling, and results do
not depend on them beyond rounding. The decode-cache ops come with
generation (ROADMAP Queue A item 7).
"""
from __future__ import annotations

import torch

from .. import _kernels
from .registry import register

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _band_mask(T, Tk, causal, window, band_offset, device):
    """(T, Tk) validity of each score: _band_valid over global positions
    (row r sits at r + band_offset), all-true without causal."""
    if not causal:
        return torch.ones((T, Tk), dtype=torch.bool, device=device)
    rows = torch.arange(T, device=device)[:, None] + band_offset
    cols = torch.arange(Tk, device=device)[None, :]
    valid = rows >= cols
    if window:
        valid = valid & (rows - cols < window)
    return valid


def _flash_fwd_reference(q, k, v, scale, causal, window=0, band_offset=0):
    """Plain PyTorch version of the flash forward kernel: (o, lse) over
    (BH, T, D) inputs. Scores in f32; masked scores are -1e30 and give
    p = 0; p is rounded to V's dtype before the PV product, while the
    denominator sums the unrounded p; a row with no valid column gives
    o = 0 through max(l, 1e-30); lse = m + log(max(l, 1e-30))."""
    T, Tk = q.shape[1], k.shape[1]
    valid = _band_mask(T, Tk, causal, window, band_offset, q.device)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / denom
    return o.to(q.dtype), (m + torch.log(denom)).squeeze(-1)


def _flash_bwd_terms(q, k, v, do, lse, delta, scale, causal, window=0,
                     band_offset=0):
    """(p, ds) of the flash backward over (BH, T, Tk), in f32: p =
    exp(scale q.k - lse) and ds = p (do.v - delta) scale on the valid
    pairs, 0 elsewhere — selected, never multiplied, since a row with no
    valid column carries lse ~ -1e30."""
    T, Tk = q.shape[1], k.shape[1]
    valid = _band_mask(T, Tk, causal, window, band_offset, q.device)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = torch.where(valid, p * (dp - delta[..., None]) * scale, 0.0)
    return p, ds


def _flash_dq_reference(q, k, v, do, lse, delta, scale, causal, window=0,
                        band_offset=0):
    """Plain PyTorch version of the flash dq kernel: dq = ds k, with ds
    rounded to k's dtype before the product and dq cast to q's dtype."""
    _, ds = _flash_bwd_terms(q, k, v, do, lse, delta, scale, causal,
                             window, band_offset)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def _flash_dkv_reference(q, k, v, do, lse, delta, scale, causal, window=0,
                         band_offset=0):
    """Plain PyTorch version of the flash dk/dv kernel: (dk, dv) =
    (ds^T q, p^T do), with p rounded to do's dtype and ds to q's before
    the products, and the results cast to k's and v's dtypes."""
    p, ds = _flash_bwd_terms(q, k, v, do, lse, delta, scale, causal,
                             window, band_offset)
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(1, 2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(q, k, v, what="flash_fwd_cuda"):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 3:
            raise ValueError("%s: %s must be (BH, T, D), got shape %r"
                             % (what, name, tuple(x.shape)))
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError("%s: q, k, v must share one dtype of float32 or "
                        "bfloat16, got %s/%s/%s"
                        % (what, q.dtype, k.dtype, v.dtype))
    BH, T, D = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != D:
        raise ValueError("%s: shapes q %r, k %r, v %r do not agree"
                         % (what, tuple(q.shape), tuple(k.shape),
                            tuple(v.shape)))
    if D > 128:
        raise ValueError("%s: head dim %d unsupported (the kernels take up "
                         "to 128; there is no DP = 256 instance yet)"
                         % (what, D))
    if T < 1 or k.shape[1] < 1:
        raise ValueError("%s: empty sequence" % what)
    if q.device.type != "cuda" or not (q.device == k.device == v.device):
        raise ValueError("%s: q, k, v must be on one CUDA device, got "
                         "%s/%s/%s" % (what, q.device, k.device, v.device))


def _check_bwd_inputs(q, k, v, do, lse, delta, what):
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("%s: do must match q (shape %r, %s, %s), got "
                         "%r, %s, %s" % (what, tuple(q.shape), q.dtype,
                                         q.device, tuple(do.shape),
                                         do.dtype, do.device))
    for name, x in (("lse", lse), ("delta", delta)):
        if (tuple(x.shape) != tuple(q.shape[:2])
                or x.dtype != torch.float32 or x.device != q.device):
            raise ValueError("%s: %s must be float32 of shape %r on %s, "
                             "got %r, %s, %s" % (
                                 what, name, tuple(q.shape[:2]), q.device,
                                 tuple(x.shape), x.dtype, x.device))
    _check_kernel_inputs(q, k, v, what)


def _kernel_operand(x):
    """Contiguous and 16-byte aligned, as the kernel's vector loads need."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


# the kernels' TMA maps need rows of a multiple of 16 bytes
_HEAD_DIM_ALIGN = 8


def _on_padded_head_dim(fn, *xs):
    """``fn(*xs)`` on (BH, T, D) operands zero-padded along D up to the
    next multiple of 8, with every (BH, T, Dp) output cut back to D (other
    outputs, like the (BH, T) lse, pass as they are). Exact: the zero head
    dims add exact zeros to each q.k and do.v, give zero columns of o, dq,
    dk and dv, and leave delta = rowsum(do * o) as it was; the caller
    passes ``scale`` explicitly, so it stays D ** -0.5 of the real D."""
    D = xs[0].shape[-1]
    Dp = -(-D // _HEAD_DIM_ALIGN) * _HEAD_DIM_ALIGN
    if Dp == D:
        return fn(*xs)
    outs = fn(*(torch.nn.functional.pad(x, (0, Dp - D)) for x in xs))
    return tuple(o[..., :D].contiguous()
                 if o is not None and o.dim() == 3 and o.shape[-1] == Dp
                 else o for o in outs)


def _launch_fwd(q, k, v, scale, causal, window, band_offset, want_lse):
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    BH, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device) \
        if want_lse else None
    lib = _kernels.load("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(),
                           lse.data_ptr() if lse is not None else None,
                           BH, T, k.shape[1], D, float(scale),
                           int(bool(causal)), int(window or 0),
                           int(band_offset or 0), _DTYPE_CODE[q.dtype],
                           stream)
    _kernels.check(lib, rc, "flash_fwd")
    return o, lse


def flash_fwd_cuda(q, k, v, scale, causal, window=0, band_offset=0,
                   want_lse=False):
    """Launch the Hopper flash forward kernel on CUDA tensors, any head
    dim up to 128 (padded to a multiple of 8 for the kernel). Returns
    (o, lse or None). ``flash_fwd_cuda.launches`` counts the launches,
    ``flash_fwd_cuda.launches_f32`` those of the exact-f32 kernel."""
    _check_kernel_inputs(q, k, v)
    scale = float(scale)
    if q.dtype == torch.bfloat16 and scale <= 0:
        # the bf16 kernel folds a positive scale into its softmax; the same
        # scores, exactly: (q.-k) (-scale), or q.0 times any scale
        k, scale = (-k, -scale) if scale < 0 else (torch.zeros_like(k), 1.0)
    o, lse = _on_padded_head_dim(
        lambda q, k, v: _launch_fwd(q, k, v, scale, causal, window,
                                    band_offset, want_lse), q, k, v)
    flash_fwd_cuda.launches += 1
    flash_fwd_cuda.launches_f32 += q.dtype == torch.float32
    return o, lse


flash_fwd_cuda.launches = 0
flash_fwd_cuda.launches_f32 = 0


def flash_fwd(q, k, v, scale, causal, window=0, band_offset=0,
              want_lse=False):
    """(o, lse or None) over (BH, T, D) tensors: the kernel on CUDA
    tensors, its plain version on CPU (and meta, for shape inference)."""
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, scale, causal, window, band_offset,
                              want_lse)
    if q.device.type in ("cpu", "meta"):
        o, lse = _flash_fwd_reference(q, k, v, scale, causal, window,
                                      band_offset)
        return o, (lse if want_lse else None)
    raise ValueError("flash attention has no implementation for device "
                     "%s" % (q.device,))


# q rows per tile of the fused backward kernels (both dtypes): one turn
# counter each
_BWD_BLOCK_Q = 64


def _launch_bwd(q, k, v, do, lse, delta, scale, causal, window,
                band_offset):
    q, k, v, do, lse, delta = (_kernel_operand(x)
                               for x in (q, k, v, do, lse, delta))
    BH, T, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # q tiles that no kv tile meets keep these zeros
    dq = torch.zeros_like(q)
    turns = torch.zeros((BH, -(-T // _BWD_BLOCK_Q)), dtype=torch.int32,
                        device=q.device)
    # the bf16 kernel sums dq in f32 scratch; the f32 one in dq itself
    dq_acc = torch.empty((BH, T, D), dtype=torch.float32, device=q.device) \
        if q.dtype == torch.bfloat16 else None
    lib = _kernels.load("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dq_acc.data_ptr() if dq_acc is not None else None,
            turns.data_ptr(), BH, T, k.shape[1], D, float(scale),
            int(bool(causal)), int(window or 0), int(band_offset or 0),
            _DTYPE_CODE[q.dtype], stream)
    _kernels.check(lib, rc, "flash_bwd")
    return dq, dk, dv


def flash_bwd_cuda(q, k, v, do, lse, delta, scale, causal, window=0,
                   band_offset=0):
    """Launch the Hopper flash backward on CUDA tensors: one fused,
    deterministic kernel for each dtype (bf16 on the tensor cores, dq
    summed in f32 scratch; float32 exactly on the CUDA cores, dq summed in
    place), dq added in a fixed kv-tile order under per-q-tile turn
    counters; any head dim up to 128 (padded to a multiple of 8 for the
    kernels). Returns (dq, dk, dv). ``flash_bwd_cuda.launches`` counts the
    calls, ``flash_bwd_cuda.launches_f32`` those of the exact-f32
    kernel."""
    _check_bwd_inputs(q, k, v, do, lse, delta, "flash_bwd_cuda")
    grads = _on_padded_head_dim(
        lambda q, k, v, do: _launch_bwd(q, k, v, do, lse, delta, scale,
                                        causal, window, band_offset),
        q, k, v, do)
    flash_bwd_cuda.launches += 1
    flash_bwd_cuda.launches_f32 += q.dtype == torch.float32
    return grads


flash_bwd_cuda.launches = 0
flash_bwd_cuda.launches_f32 = 0


def flash_bwd(q, k, v, do, lse, delta, scale, causal, window=0,
              band_offset=0):
    """(dq, dk, dv) over (BH, T, D) tensors: the kernel on CUDA tensors,
    its plain versions on CPU (and meta) tensors."""
    args = (q, k, v, do, lse, delta, scale, causal, window, band_offset)
    if q.device.type == "cuda":
        return flash_bwd_cuda(*args)
    if q.device.type in ("cpu", "meta"):
        return (_flash_dq_reference(*args), *_flash_dkv_reference(*args))
    raise ValueError("flash attention has no implementation for device "
                     "%s" % (q.device,))


def _flash_backward(q, k, v, o, lse, do, scale, causal, window,
                    band_offset, dlse=None):
    """(dq, dk, dv). delta = rowsum(do * o) in f32, a cheap elementwise
    pass outside the kernel as in the JAX package; an lse cotangent
    folds into it (ds = p (dp - delta + dlse), since d lse / d s = p), so
    the kernel takes one delta and never sees dlse."""
    delta = torch.sum(do.float() * o.float(), dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return flash_bwd(q, k, v, do, lse, delta, scale, causal, window,
                     band_offset)


class _Flash(torch.autograd.Function):
    """Flash attention over (BH, T, D) tensors with the FA-2 backward:
    the twin of the JAX package's custom VJP ``_flash``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        o, lse = flash_fwd(q, k, v, scale, causal, window, 0,
                           want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attrs = (scale, causal, window, 0)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, o, lse, do, *ctx.attrs)
        return dq, dk, dv, None, None, None


class _FlashLse(torch.autograd.Function):
    """(o, lse) with gradients through both outputs: the twin of the JAX
    package's custom VJP ``_flash_lse``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, band_offset):
        o, lse = flash_fwd(q, k, v, scale, causal, window, band_offset,
                           want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attrs = (scale, causal, window, band_offset)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, o, lse, do, *ctx.attrs,
                                     dlse=dlse)
        return dq, dk, dv, None, None, None, None


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention_with_lse(query, key, value, scale=None,
                             causal=False, block_q=512, block_k=512,
                             window=0, band_offset=0):
    """(o, lse) over (BH, T, D) inputs, both differentiable; lse is
    (BH, T) float32. window/band_offset select a banded mask over global
    positions (q row r sits at r + band_offset); both apply under causal
    only."""
    del block_q, block_k              # the kernels pick their own tiling
    if scale is None:
        scale = query.shape[-1] ** -0.5
    args = (float(scale), bool(causal), int(window or 0),
            int(band_offset or 0))
    if _needs_grad(query, key, value):
        return _FlashLse.apply(query, key, value, *args)
    return flash_fwd(query, key, value, *args, want_lse=True)


def flash_attention(query, key, value, scale=None, causal=False,
                    block_q=512, block_k=512, window=None):
    """Fused attention over (B, H, T, D) or (BH, T, D) inputs.

    window: sliding-window width W (causal only): row t attends
    [t-W+1, t]."""
    del block_q, block_k              # the kernels pick their own tiling
    if window and not causal:
        raise ValueError("window attention requires causal=True")
    q4 = query.dim() == 4
    if q4:
        B, H, T, D = query.shape
        query = query.reshape(B * H, T, D)
        key = key.reshape(B * H, key.shape[2], D)
        value = value.reshape(B * H, value.shape[2], D)
    if scale is None:
        scale = query.shape[-1] ** -0.5
    args = (float(scale), bool(causal), int(window or 0))
    if _needs_grad(query, key, value):
        out = _Flash.apply(query, key, value, *args)
    else:                             # forward only: no lse output
        out, _ = flash_fwd(query, key, value, *args)
    if q4:
        out = out.reshape(B, H, T, D)
    return out


@register("_contrib_FlashAttention",
          arg_names=("query", "key", "value"),
          aliases=("_contrib_flash_attention",),
          defaults={"scale": None, "causal": False, "block_q": 512,
                    "block_k": 512, "seq_axis": None, "window": 0})
def _flash_attention_op(query, key, value, scale=None, causal=False,
                        block_q=512, block_k=512, seq_axis=None,
                        window=0, **_):
    """(B, H, T, D) fused attention; returns the same shape.

    Grouped-query attention: k/v may carry FEWER heads than q (Hkv
    dividing H); they are repeated to the q-head count here, before the
    kernel. seq_axis names a mesh axis for ring attention; the port has
    no device mesh yet (ROADMAP Queue A item 9), so — as in the JAX
    package without a mesh carrying that axis — the op runs the
    single-device kernel."""
    if query.dim() == 4 and key.shape[1] != query.shape[1]:
        H, Hkv = query.shape[1], key.shape[1]
        if H % Hkv:
            raise ValueError("query heads (%d) must be a multiple of "
                             "kv heads (%d)" % (H, Hkv))
        key = torch.repeat_interleave(key, H // Hkv, dim=1)
        value = torch.repeat_interleave(value, H // Hkv, dim=1)
    return flash_attention(query, key, value, scale=scale, causal=causal,
                           block_q=block_q, block_k=block_k,
                           window=int(window or 0) or None)
