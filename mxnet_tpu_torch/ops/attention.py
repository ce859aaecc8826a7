"""Fused scaled-dot-product attention over the hand-written Hopper flash
kernel — the PyTorch twin of ``mxnet_tpu/ops/attention.py``'s forward.

``flash_fwd`` is the one entry to the kernel (``csrc/flash_fwd.cu``, the
port of the TPU's ``_flash_fwd_kernel``). On a CUDA tensor it launches
the kernel or raises; on a CPU (or meta) tensor it runs the kernel's
plain version, ``_flash_fwd_reference``, a dense masked softmax in f32
with the same masking, p-rounding and lse rules. Nothing falls back from
one to the other.

``flash_attention`` / ``flash_attention_with_lse`` and the
``_contrib_FlashAttention`` op keep the JAX package's signatures. The
``block_q`` / ``block_k`` attrs are accepted for graph and JSON parity;
the kernel picks its own tiling, and results do not depend on them
beyond rounding. The backward (the FA-2 dq and dk/dv kernels) and the
decode-cache ops come in later slices (ROADMAP Queue B item 2, Queue A
item 7).
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


def _check_kernel_inputs(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 3:
            raise ValueError("flash_fwd_cuda: %s must be (BH, T, D), got "
                             "shape %r" % (name, tuple(x.shape)))
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_fwd_cuda: q, k, v must share one dtype of "
                        "float32 or bfloat16, got %s/%s/%s"
                        % (q.dtype, k.dtype, v.dtype))
    BH, T, D = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != D:
        raise ValueError("flash_fwd_cuda: shapes q %r, k %r, v %r do not "
                         "agree" % (tuple(q.shape), tuple(k.shape),
                                    tuple(v.shape)))
    if D > 128 or D % 8:
        raise ValueError("flash_fwd_cuda: head dim %d unsupported (the "
                         "kernel takes multiples of 8 up to 128)" % D)
    if T < 1 or k.shape[1] < 1:
        raise ValueError("flash_fwd_cuda: empty sequence")
    if q.device.type != "cuda" or not (q.device == k.device == v.device):
        raise ValueError("flash_fwd_cuda: q, k, v must be on one CUDA "
                         "device, got %s/%s/%s"
                         % (q.device, k.device, v.device))


def _kernel_operand(x):
    """Contiguous and 16-byte aligned, as the kernel's vector loads need."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_fwd_cuda(q, k, v, scale, causal, window=0, band_offset=0,
                   want_lse=False):
    """Launch the Hopper flash forward kernel on CUDA tensors. Returns
    (o, lse or None). ``flash_fwd_cuda.launches`` counts the launches."""
    _check_kernel_inputs(q, k, v)
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
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


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


def flash_attention_with_lse(query, key, value, scale=None,
                             causal=False, block_q=512, block_k=512,
                             window=0, band_offset=0):
    """(o, lse) over (BH, T, D) inputs; lse is (BH, T) float32.
    window/band_offset select a banded mask over global positions (q row
    r sits at r + band_offset); both apply under causal only."""
    del block_q, block_k              # the kernel picks its own tiling
    if scale is None:
        scale = query.shape[-1] ** -0.5
    return flash_fwd(query, key, value, float(scale), bool(causal),
                     int(window or 0), int(band_offset or 0),
                     want_lse=True)


def flash_attention(query, key, value, scale=None, causal=False,
                    block_q=512, block_k=512, window=None):
    """Fused attention over (B, H, T, D) or (BH, T, D) inputs.

    window: sliding-window width W (causal only): row t attends
    [t-W+1, t]."""
    del block_q, block_k              # the kernel picks its own tiling
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
    out, _ = flash_fwd(query, key, value, float(scale), bool(causal),
                       int(window or 0))
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
