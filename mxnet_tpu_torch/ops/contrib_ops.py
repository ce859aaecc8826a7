"""The weight-only int8 ops of ``mxnet_tpu/ops/contrib_ops.py``:
``_contrib_QuantizedFullyConnected`` and ``_contrib_QuantizedEmbedding``,
the decode side of ``Generator(quantize="int8")``. The module's other
ops (fft, count_sketch, the affine quantize pair, MoE) wait for ROADMAP
Queue A items 9 and 10.

Both are plain PyTorch. The weights are dequantized to the compute dtype
before the product (a materialized copy, where XLA fuses the convert
into the product's operand reads), so a bf16 step reads more bytes than
bf16 weights would; a fused int8 GEMM is later work.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .attention import _matmul_t_f32
from .indexing import _gather_rows
from .registry import register


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
