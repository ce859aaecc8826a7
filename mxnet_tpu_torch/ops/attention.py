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
not depend on them beyond rounding.

RoPE and the decode-cache ops (``cached_attention`` and its per-row,
rolling and int8 forms) are plain PyTorch, as they are plain jnp in the
JAX package: decode reads one (Tnew, Tmax) strip a head, so cuBLAS
products and torch's softmax carry it. A cache op writes its new rows
in place (``index_copy_``/``scatter_``) and returns the same tensors, so
a decode step captured as a CUDA graph keeps its caches at fixed
addresses. A tensor ``pos`` stays on its device: the write starts at
``clamp(pos, 0, Tmax - Tnew)``, as ``dynamic_update_slice`` clamps under
jit, and the mask reads the unclamped pos; only a host pos (an int or a
numpy array) is checked for overrun, as the JAX op checks a concrete one.
"""
from __future__ import annotations

import numpy as np
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
    kernel (and before the ring, so GQA trains sequence-parallel).

    seq_axis: a mesh axis to sequence-parallelize over. When the graph is
    evaluated over a mesh carrying that axis with more than one rank
    (``_mesh_ctx.active_mesh_axis``), the op keeps this rank's T/n rows
    of its replicated inputs, runs ring attention
    (``parallel/ring.py``) and gathers the output; otherwise it is the
    single-device kernel."""
    if query.dim() == 4 and key.shape[1] != query.shape[1]:
        H, Hkv = query.shape[1], key.shape[1]
        if H % Hkv:
            raise ValueError("query heads (%d) must be a multiple of "
                             "kv heads (%d)" % (H, Hkv))
        key = torch.repeat_interleave(key, H // Hkv, dim=1)
        value = torch.repeat_interleave(value, H // Hkv, dim=1)
    if seq_axis:
        from ._mesh_ctx import active_mesh_axis
        mesh = active_mesh_axis(seq_axis)
        if mesh is not None:
            if query.dim() != 4:
                raise ValueError(
                    "seq_axis ring attention needs (B, H, T, D) inputs, "
                    "got ndim=%d" % query.dim())
            from ..parallel.ring import ring_attention
            return ring_attention(query, key, value, mesh, seq_axis,
                                  causal=bool(causal), scale=scale,
                                  window=int(window or 0))
    return flash_attention(query, key, value, scale=scale, causal=causal,
                           block_q=block_q, block_k=block_k,
                           window=int(window or 0) or None)


# ---------------------------------------------------------------------------
# RoPE and the decode caches (plain PyTorch, as plain jnp in the JAX package)
# ---------------------------------------------------------------------------

def rope(x, positions, base=10000.0):
    """Rotary position embedding over (B, H, T, hd).

    positions: (T,) ids shared across the batch, or (B, T) per-row ids.
    HALF-SPLIT pairing (GPT-NeoX): (x[i], x[i + hd/2]) rotate together by
    pos * base^(-i/(hd/2)), not the interleaved (x[2i], x[2i+1]) layout;
    a checkpoint crossing to an interleaved implementation must repack.
    The angles and the rotation are float32, the result in x's dtype."""
    B, H, T, D = x.shape
    half = D // 2
    dev = x.device
    expo = -torch.arange(0, half, dtype=torch.float32, device=dev) / half
    freqs = torch.pow(torch.full((), float(base), dtype=torch.float32,
                                 device=dev), expo)
    ang = positions.to(device=dev, dtype=torch.float32)[..., None] * freqs
    if ang.dim() == 2:                        # shared (T, half)
        cos, sin = torch.cos(ang)[None, None], torch.sin(ang)[None, None]
    else:                                     # per-row (B, T, half)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@register("_contrib_RoPE", arg_names=("data", "positions"),
          nondiff_inputs=(1,), defaults={"base": 10000.0})
def _rope_op(data, positions, base=10000.0, **_):
    """(B, H, T, hd) rotary position embedding; positions (T,)."""
    return rope(data, positions, base=float(base))


def _matmul_t_f32(a, b):
    """a (..., M, K) @ b (..., N, K)^T in float32: the operands' products
    summed in float32 (the JAX einsum's ``preferred_element_type=
    float32``). A bf16 pair on the card goes to cuBLAS with a float32
    output; elsewhere both operands are widened first, which is exact."""
    bt = b.transpose(-1, -2)
    if a.dtype == b.dtype == torch.bfloat16 and a.device.type == "cuda":
        s = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                      bt.reshape(-1, *bt.shape[-2:]),
                      out_dtype=torch.float32)
        return s.reshape(*a.shape[:-1], s.shape[-1])
    return torch.matmul(a.float(), bt.float())


def _gqa_groups(H, Hkv):
    if H % Hkv:
        raise ValueError(
            "query heads (%d) must be a multiple of cache kv heads (%d) — "
            "grouped-query attention groups q heads over kv heads"
            % (H, Hkv))
    return H // Hkv


def _pos_tensor(pos, device):
    """pos (a tensor, an int or an array) as a flat int64 tensor on
    ``device``; float ids truncate toward zero, as ``astype`` does."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(-1).to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(pos, dtype=np.float64).reshape(-1)
                           .astype(np.int64), device=device)


def _check_host_overrun(what, pos, Tn, C):
    """Raise for a host pos (int or array) whose rows pass the capacity;
    a tensor pos is device data and is never read back (its writes
    clamp)."""
    if isinstance(pos, torch.Tensor):
        return
    worst = int(np.asarray(pos, dtype=np.float64).max())
    if worst + Tn > C:
        raise ValueError(
            "%s overrun: pos (%d) + Tnew (%d) exceeds cache capacity "
            "Tmax=%d — the write would clamp and silently corrupt the "
            "cache" % (what, worst, Tn, C))


def _write_rows(cache, new, start):
    """Write ``new`` (B, Hkv, Tn, ...) into ``cache`` (B, Hkv, C, ...) in
    place, rows [start, start + Tn) of dim 2; ``start`` is a 0-d (shared)
    or (B,) (per-row) int64 tensor. Returns ``cache``."""
    Tn = new.shape[2]
    rows = torch.arange(Tn, device=cache.device)
    new = new.to(cache.dtype)
    if start.dim() == 0:
        return cache.index_copy_(2, start + rows, new)
    idx = (start[:, None] + rows).reshape(
        (start.shape[0], 1, Tn) + (1,) * (cache.dim() - 3))
    return cache.scatter_(2, idx.expand(new.shape), new)


def _clamped(p, Tn, C):
    """The start ``dynamic_update_slice`` writes at: clamp(p, 0, C - Tn)."""
    return torch.clamp(p, 0, C - Tn)


def _decode_valid(p, Tn, C, window):
    """Validity of the (Tn, C) scores (with a (B, 1, 1) ``p``: (B, Tn, C)):
    cache column c is seen by new row r iff c <= p + r, and, with a
    window, p + r - c < window."""
    cols = torch.arange(C, device=p.device)
    rows = torch.arange(Tn, device=p.device)[:, None]
    valid = cols <= p + rows
    if window:
        valid = valid & (p + rows - cols < window)
    return valid


def _attend(query, k_cache, v_cache, valid, scale, pv_dtype):
    """Grouped decode attention over full caches: softmax of the float32
    scores (masked with -1e30 where ``valid`` is false, ``valid``
    broadcasting over (B, Hkv, G, Tn, C)), then p, cast to ``pv_dtype``,
    against v. Each cache head is read once for its q-head group."""
    B, H, Tn, D = query.shape
    Hkv, C = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = query.reshape(B, Hkv, G * Tn, D)
    s = _matmul_t_f32(qg, k_cache).reshape(B, Hkv, G, Tn, C) * scale
    s = torch.where(valid, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(pv_dtype).reshape(B, Hkv, G * Tn, C), v_cache)
    return out.reshape(B, H, Tn, D).to(query.dtype)


def cached_attention(query, key, value, k_cache, v_cache, pos, scale=None,
                     window=0):
    """Incremental-decode attention over a KV cache.

    query/key/value: (B, H, Tnew, hd) projections of the tokens being
    appended (the prompt at prefill, one a step after); k_cache/v_cache:
    (B, Hkv, Tmax, hd). pos: (1,) tokens already cached — the new keys
    land at [pos, pos + Tnew) and query row r attends cache columns
    <= pos + r — or (B,), one position a batch row (continuous batching;
    ``_cached_attention_per_row``). Capacity: pos + Tnew <= Tmax; past it
    a tensor pos's write clamps, as ``dynamic_update_slice`` does under
    jit, and a host pos raises. The caches are written in place and
    returned: (out, k_cache, v_cache)."""
    B, H, Tn, D = query.shape
    _gqa_groups(H, k_cache.shape[1])
    C = k_cache.shape[2]
    if scale is None:
        scale = D ** -0.5
    pt = _pos_tensor(pos, query.device)
    if pt.numel() > 1:
        if pt.numel() != B:
            raise ValueError("per-row pos must have one entry per batch "
                             "row: got %r for batch %d"
                             % (tuple(np.shape(pos)), B))
        return _cached_attention_per_row(query, key, value, k_cache,
                                         v_cache, pos, pt, float(scale),
                                         int(window or 0))
    _check_host_overrun("cached_attention", pos, Tn, C)
    p0 = pt.reshape(())
    _write_rows(k_cache, key, _clamped(p0, Tn, C))
    _write_rows(v_cache, value, _clamped(p0, Tn, C))
    valid = _decode_valid(p0, Tn, C, int(window or 0))
    return (_attend(query, k_cache, v_cache, valid, scale, v_cache.dtype),
            k_cache, v_cache)


def _cached_attention_per_row(query, key, value, k_cache, v_cache, pos,
                              pb, scale, window):
    """cached_attention's per-row core: pb (B,) — row b's new tokens land
    at [pb[b], pb[b] + Tn) (each start clamped on its own) and mask
    against pb[b]."""
    Tn, C = query.shape[2], k_cache.shape[2]
    _check_host_overrun("cached_attention", pos, Tn, C)
    _write_rows(k_cache, key, _clamped(pb, Tn, C))
    _write_rows(v_cache, value, _clamped(pb, Tn, C))
    valid = _decode_valid(pb[:, None, None], Tn, C, window)[:, None, None]
    return (_attend(query, k_cache, v_cache, valid, scale, v_cache.dtype),
            k_cache, v_cache)


def rolling_cached_attention(query, key, value, k_cache, v_cache, pos,
                             window, scale=None):
    """Sliding-window decode attention over a CIRCULAR cache of capacity
    C = k_cache.shape[2]: position p lives in slot p % C, so memory stays
    O(C) however long generation runs. Needs C >= window + Tnew - 1.
    After appending through pos_end, slot s holds the absolute position
    p_s = pos_end - ((pos_end - s) mod C); row r sees it iff
    0 <= p_s <= p0 + r and p0 + r - p_s < window."""
    B, H, Tn, D = query.shape
    _gqa_groups(H, k_cache.shape[1])
    C = k_cache.shape[2]
    if scale is None:
        scale = D ** -0.5
    p0 = _pos_tensor(pos, query.device).reshape(())
    slots = (p0 + torch.arange(Tn, device=query.device)) % C
    k_cache.index_copy_(2, slots, key.to(k_cache.dtype))
    v_cache.index_copy_(2, slots, value.to(v_cache.dtype))
    pos_end = p0 + Tn - 1
    p_s = pos_end - ((pos_end - torch.arange(C, device=query.device)) % C)
    rows = p0 + torch.arange(Tn, device=query.device)[:, None]
    valid = (p_s >= 0) & (p_s <= rows) & (rows - p_s < window)
    return (_attend(query, k_cache, v_cache, valid, scale, v_cache.dtype),
            k_cache, v_cache)


def _on_local_heads(fn, query, key, value, k_cache, *rest, **kw):
    """``fn(query, key, value, k_cache, *rest)`` on this rank's heads when
    a ``model`` mesh axis splits the caches' kv heads (``Generator(mesh=)``):
    the rank's q heads and kv heads (a contiguous block each, so GQA
    groups stay whole), then the heads' outputs all-gathered. Otherwise
    ``fn`` on everything."""
    from ._mesh_ctx import active_mesh_axis
    mesh = active_mesh_axis("model")
    if mesh is None or k_cache.shape[1] == key.shape[1]:
        return fn(query, key, value, k_cache, *rest, **kw)
    m, r = mesh.shape["model"], mesh.axis_index("model")
    hk, hq = k_cache.shape[1], query.shape[1] // m
    if hk * m != key.shape[1] or hq * m != query.shape[1]:
        raise ValueError(
            "cached attention over a 'model' axis of %d ranks: the cache "
            "holds %d of %d kv heads and the query has %d heads"
            % (m, hk, key.shape[1], query.shape[1]))
    out = fn(query.narrow(1, r * hq, hq), key.narrow(1, r * hk, hk),
             value.narrow(1, r * hk, hk), k_cache, *rest, **kw)
    from ..parallel._comm import gather_local
    return (gather_local(out[0], (None, "model"), mesh),) + tuple(out[1:])


@register("_contrib_RollingCachedAttention",
          arg_names=("query", "key", "value", "k_cache", "v_cache", "pos"),
          state_inputs=(3, 4), nondiff_inputs=(5,), differentiable=False,
          defaults={"scale": None, "max_len": 0, "window": 0})
def _rolling_cached_attention_op(query, key, value, k_cache, v_cache, pos,
                                 scale=None, window=0, **_):
    """Circular-buffer twin of _contrib_CachedAttention for sliding-window
    models; max_len is the cache CAPACITY here."""
    if not window:
        raise ValueError("_contrib_RollingCachedAttention needs window > 0")
    return _on_local_heads(rolling_cached_attention, query, key, value,
                           k_cache, v_cache, pos, int(window), scale=scale)


@register("_contrib_CachedAttention",
          arg_names=("query", "key", "value", "k_cache", "v_cache", "pos"),
          state_inputs=(3, 4), nondiff_inputs=(5,), differentiable=False,
          defaults={"scale": None, "max_len": 0, "window": 0})
def _cached_attention_op(query, key, value, k_cache, v_cache, pos,
                         scale=None, window=0, **_):
    """(B, H, Tnew, hd) decode attention; k_cache/v_cache are aux states
    the executor threads (written in place)."""
    return _on_local_heads(cached_attention, query, key, value, k_cache,
                           v_cache, pos, scale=scale,
                           window=int(window or 0))


def _q8_quantize(x):
    """Per-token-per-head symmetric int8: absmax/127 scale over the head
    dim, clamped at 1e-8 so an all-zero row stores zeros. The one rule
    both cache writers use, so a row's stored entry does not depend on
    which wrote it."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    return torch.round(xf / s[..., None]).to(torch.int8), s


def cached_attention_q8(query, key, value, k_cache, v_cache, k_scale,
                        v_scale, pos, scale=None, window=0):
    """cached_attention over INT8 caches: k_cache/v_cache (B, Hkv, Tmax,
    hd) int8, k_scale/v_scale (B, Hkv, Tmax) float32, each token's rows
    quantized once when they enter (``_q8_quantize``). The caches are
    dequantized to float32 (a materialized copy here, where XLA fuses it
    into the product's reads) and the attention runs in float32. pos
    (1,) or (B,) as in cached_attention. Returns (out, k_cache, v_cache,
    k_scale, v_scale), all caches written in place."""
    B, H, Tn, D = query.shape
    _gqa_groups(H, k_cache.shape[1])
    C = k_cache.shape[2]
    if scale is None:
        scale = D ** -0.5
    pt = _pos_tensor(pos, query.device)
    if pt.numel() > 1:
        if pt.numel() != B:
            raise ValueError("per-row pos must have one entry per batch "
                             "row: got %r for batch %d"
                             % (tuple(np.shape(pos)), B))
        start = pt
        p = pt[:, None, None]
    else:
        start = p = pt.reshape(())
    _check_host_overrun("cached_attention_q8", pos, Tn, C)
    kq, ks = _q8_quantize(key)
    vq, vs = _q8_quantize(value)
    at = _clamped(start, Tn, C)
    for cache, new in ((k_cache, kq), (v_cache, vq), (k_scale, ks),
                       (v_scale, vs)):
        _write_rows(cache, new, at)
    valid = _decode_valid(p, Tn, C, int(window or 0))
    if pt.numel() > 1:
        valid = valid[:, None, None]
    kf = k_cache.float() * k_scale[..., None]
    vf = v_cache.float() * v_scale[..., None]
    out = _attend(query.float(), kf, vf, valid, scale, torch.float32)
    return out.to(query.dtype), k_cache, v_cache, k_scale, v_scale


@register("_contrib_CachedAttentionQ8",
          arg_names=("query", "key", "value", "k_cache", "v_cache",
                     "k_scale", "v_scale", "pos"),
          state_inputs=(3, 4, 5, 6), nondiff_inputs=(7,),
          differentiable=False,
          defaults={"scale": None, "max_len": 0, "window": 0})
def _cached_attention_q8_op(query, key, value, k_cache, v_cache, k_scale,
                            v_scale, pos, scale=None, window=0, **_):
    """Int8-cache decode attention; the caches and their per-token scales
    are aux states threaded by the executor."""
    return _on_local_heads(cached_attention_q8, query, key, value, k_cache,
                           v_cache, k_scale, v_scale, pos, scale=scale,
                           window=int(window or 0))
