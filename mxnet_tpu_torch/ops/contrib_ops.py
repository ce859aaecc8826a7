"""The ops of ``mxnet_tpu/ops/contrib_ops.py``: fft/ifft, count_sketch,
the affine quantize/dequantize pair (reference: src/operator/contrib/
{fft,ifft,count_sketch,quantize,dequantize}-inl.h), the weight-only int8
ops (``_contrib_QuantizedFullyConnected`` and
``_contrib_QuantizedEmbedding``, the decode side of
``Generator(quantize="int8")``) and the MoE FFN (``_contrib_MoEFFN``,
over ``parallel/moe.py``).

All plain PyTorch. fft's output interleaves [re, im] along the last
axis, and ifft is not normalised (ifft(fft(x)) = d·x), as cuFFT's
inverse in the reference. count_sketch adds with ``index_add``: on CUDA
its float additions land in no fixed order, so two runs (and the card
against the CPU) agree to the rounding of the sums, not bit for bit.
The int8 weights are dequantized to the compute dtype before the product
(a materialized copy, where XLA fuses the convert into the product's
operand reads), so a bf16 step reads more bytes than bf16 weights would;
a fused int8 GEMM is later work.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .attention import _matmul_t_f32
from .indexing import _gather_rows
from .detection_ops import _weak
from .registry import register


@register("_contrib_fft", arg_names=("data",),
          aliases=("fft",), defaults={"compute_size": 128})
def _fft(data, **_):
    """Real input (..., d) -> (..., 2d) interleaved [re, im] along the
    last axis (reference fft-inl.h layout)."""
    out = torch.fft.fft(data.to(torch.float32), dim=-1)
    inter = torch.stack([out.real, out.imag], dim=-1)
    return inter.reshape(data.shape[:-1] + (2 * data.shape[-1],)) \
        .to(data.dtype)


@register("_contrib_ifft", arg_names=("data",),
          aliases=("ifft",), defaults={"compute_size": 128})
def _ifft(data, **_):
    """Interleaved (..., 2d) -> real (..., d). Like the reference (cuFFT
    inverse), the result is NOT normalized: ifft(fft(x)) == d * x."""
    d = data.shape[-1] // 2
    pairs = data.reshape(data.shape[:-1] + (d, 2)).to(torch.float32)
    comp = torch.complex(pairs[..., 0], pairs[..., 1])
    real = torch.fft.ifft(comp, dim=-1).real
    return (real * d).to(data.dtype)


@register("_contrib_count_sketch", arg_names=("data", "h", "s"),
          nondiff_inputs=(1, 2),
          defaults={"out_dim": 0, "processing_batch_size": 32})
def _count_sketch(data, h, s, out_dim=0, **_):
    """Count-sketch projection (reference count_sketch-inl.h):
    out[..., h[j]] += s[j] * in[..., j]; h (1, in_dim) hash buckets,
    s (1, in_dim) signs."""
    in_dim = data.shape[-1]
    hh = h.detach().reshape(-1)[:in_dim].to(torch.int64)
    ss = s.detach().reshape(-1)[:in_dim].to(data.dtype)
    flat = data.reshape(-1, in_dim)
    contrib = flat * ss[None, :]
    out = flat.new_zeros((flat.shape[0], int(out_dim))).index_add(
        1, hh, contrib)
    return out.reshape(data.shape[:-1] + (int(out_dim),))


@register("_contrib_quantize", arg_names=("data", "min_range", "max_range"),
          differentiable=False, aliases=("quantize",),
          defaults={"out_type": "uint8"})
def _quantize(data, min_range, max_range, out_type="uint8", **_):
    """Affine quantization to uint8/int8 (reference quantize-inl.h):
    out = (in - min) * (limit_range / (max - min)) + 0.5; min/max pass
    through as outputs 1/2."""
    lo, hi = (0.0, 255.0) if out_type == "uint8" else (-127.0, 127.0)
    dt = torch.uint8 if out_type == "uint8" else torch.int8
    # a true division (torch takes scalar / tensor as a reciprocal product)
    scale = _weak(max_range, hi - lo) / (max_range - min_range)
    # floor(v + 0.5): round-half-up on both signs (int8 negatives would
    # truncate toward zero under a bare cast)
    q = torch.floor((data - min_range) * scale + lo + 0.5)
    return (torch.clamp(q, lo, hi).to(dt),
            min_range.reshape(()).to(torch.float32),
            max_range.reshape(()).to(torch.float32))


@register("_contrib_dequantize", arg_names=("data", "min_range",
                                            "max_range"),
          differentiable=False, aliases=("dequantize",),
          defaults={"out_type": "float32"})
def _dequantize(data, min_range, max_range, out_type="float32", **_):
    """Inverse of quantize (reference dequantize-inl.h): for uint8,
    out = in * ((max - min) / 255) + min."""
    lo, hi = (0.0, 255.0) if data.dtype == torch.uint8 else (-127.0, 127.0)
    scale = (max_range - min_range) / _weak(max_range, hi - lo)
    return ((data.to(torch.float32) - lo) * scale + min_range) \
        .to(torch_dtype(out_type))


@register("_contrib_QuantizedFullyConnected",
          arg_names=("data", "weight", "scale", "bias"),
          differentiable=False,
          defaults={"num_hidden": 0, "no_bias": False, "flatten": True})
def _quantized_fc(data, weight, scale, bias=None, num_hidden=0,
                  no_bias=False, flatten=True, **_):
    """Weight-only int8 FullyConnected: weight int8 (num_hidden, in),
    per-output-channel symmetric, with w ~= weight * scale[:, None]. The
    int8 weight is cast to the compute dtype (exact), the product summed
    in float32, multiplied by the scale in float32 and only then rounded
    to the compute dtype, as the JAX op does; the bias is added in the
    compute dtype. Inference only."""
    cdt = data.dtype
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    lead = data.shape[:-1]
    y = _matmul_t_f32(data.reshape(-1, data.shape[-1]), weight.to(cdt))
    y = y.reshape(*lead, weight.shape[0])
    y = (y * scale.float()).to(cdt)
    if not no_bias and bias is not None:
        y = y + bias.to(cdt)
    return y


@register("_contrib_QuantizedEmbedding",
          arg_names=("data", "weight", "scale"),
          differentiable=False,
          defaults={"input_dim": 0, "output_dim": 0, "dtype": "float32"})
def _quantized_embedding(data, weight, scale, dtype="float32", **_):
    """Weight-only int8 Embedding: weight int8 (V, D) with per-row scales
    (V,); a lookup reads one int8 row and its scale, in float32, and
    casts to ``dtype``. Ids follow the Embedding's index rule."""
    ids = data.to(torch.int32).long()
    flat = ids.reshape(-1)
    rows = _gather_rows(weight, flat).float()
    out = rows * _gather_rows(scale.reshape(-1, 1), flat)
    return out.reshape(tuple(ids.shape) + (weight.shape[1],)).to(
        torch_dtype(dtype))


@register("_contrib_MoEFFN",
          arg_names=("data", "gate_weight", "expert_w1", "expert_w2"),
          aliases=("_contrib_moe_ffn",),
          defaults={"capacity_factor": 1.25, "expert_axis": None})
def _moe_ffn_op(data, gate_weight, expert_w1, expert_w2,
                capacity_factor=1.25, expert_axis=None, **_):
    """Switch-style top-1 mixture-of-experts FFN.

    data (B, T, D) or (N, D); gate_weight (D, E); expert_w1 (E, D, H);
    expert_w2 (E, H, D). Tokens beyond an expert's capacity
    (ceil(N * capacity_factor / E)) output zero — pair with a residual.

    expert_axis: a mesh axis for expert parallelism. When the graph is
    evaluated over a mesh carrying that axis with more than one rank,
    the expert weights hold this rank's E/n experts and tokens exchange
    through all_to_all (``parallel.moe.moe_ffn``); a ``data`` axis beside
    it all-gathers the tokens first, so every data rank routes the global
    tokens as the JAX op does, and keeps its own rows of the result.
    Otherwise it is
    ``dense_moe`` — over the global token order when a ``data`` axis
    splits the batch (``dense_moe_over_data``), as the JAX package's one
    global program routes it."""
    from ..parallel import moe
    from ._mesh_ctx import active_mesh_axis, replica
    orig_shape = data.shape
    x = data.reshape(-1, orig_shape[-1])
    rep = replica()
    if expert_axis:
        mesh = active_mesh_axis(expert_axis)
        if mesh is not None:
            from ..parallel import _comm
            # the replica axes split the batch: every rank of them routes
            # the GLOBAL tokens, as the JAX op's in_specs=P(expert_axis)
            # replicates them over 'data'
            shape = tuple(orig_shape)
            if rep is not None:
                x = _comm.all_gather_axes(x, rep.mesh, rep.axes, 0)
                shape = (shape[0] * rep.n,) + shape[1:]
            n = mesh.shape[expert_axis]
            if x.shape[0] % n:
                raise ValueError(
                    "expert_axis=%r: token count %d (=prod of %r[:-1]) "
                    "must divide over the %d devices of that mesh axis"
                    % (expert_axis, x.shape[0], shape, n))
            if gate_weight.shape[1] % n:
                raise ValueError(
                    "expert_axis=%r: num_experts %d must divide over "
                    "the %d devices of that mesh axis"
                    % (expert_axis, gate_weight.shape[1], n))
            out = moe.moe_ffn(x, gate_weight, expert_w1, expert_w2, mesh,
                              axis_name=expert_axis,
                              capacity_factor=float(capacity_factor))
            if rep is not None:
                out = _comm.take_from_axes(out, rep.mesh, rep.axes, 0)
            return out.to(data.dtype).reshape(orig_shape)
    if rep is not None:
        out = moe.dense_moe_over_data(
            x, gate_weight, expert_w1, expert_w2, rep.mesh, rep.axes,
            capacity_factor=float(capacity_factor))
    else:
        out = moe.dense_moe(x, gate_weight, expert_w1, expert_w2,
                            capacity_factor=float(capacity_factor))
    return out.to(data.dtype).reshape(orig_shape)
