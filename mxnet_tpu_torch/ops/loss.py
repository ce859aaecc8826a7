"""``SoftmaxOutput``, forward only, with the semantics of
``mxnet_tpu/ops/loss.py``: the softmax is taken in float32 and cast back
to the input dtype. Its cross-entropy backward (and the head-grad
scaling contract) comes with training (ROADMAP Queue A item 4); the
other loss heads with the op-catalog slice.
"""
from __future__ import annotations

import torch

from .registry import register


@register("SoftmaxOutput", arg_names=("data", "label"), nondiff_inputs=(1,),
          aliases=("Softmax",),
          defaults={"grad_scale": 1.0, "ignore_label": -1.0,
                    "multi_output": False, "use_ignore": False,
                    "preserve_shape": False, "normalization": "null",
                    "out_grad": False, "smooth_alpha": 0.0})
def _softmax_output(data, label, multi_output=False, **_):
    # softmax statistics always in f32 (bf16 inputs would lose
    # probability mass); output back in the input dtype. The label only
    # shapes the backward.
    axis = 1 if multi_output else -1
    return torch.softmax(data.float(), dim=axis).to(data.dtype)
