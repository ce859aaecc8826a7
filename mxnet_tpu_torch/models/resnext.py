"""ResNeXt (Xie et al. 2016) in the symbol API — the PyTorch twin of
``mxnet_tpu/models/resnext.py`` (same graph and names): bottleneck blocks
with grouped 3x3 convolutions (cardinality).

Reference counterpart: example/image-classification/symbols/resnext.py
(the reference's accuracy table lists resnext-101-64x4d at 0.7911)."""
from __future__ import annotations

from .. import symbol as sym

_STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _block(x, name, mid, out_ch, stride, cardinality, match):
    """Grouped bottleneck: 1x1 reduce -> grouped 3x3 -> 1x1 expand."""
    b = sym.Convolution(x, num_filter=mid, kernel=(1, 1), no_bias=True,
                        name=name + "_conv1")
    b = sym.BatchNorm(b, name=name + "_bn1")
    b = sym.Activation(b, act_type="relu")
    b = sym.Convolution(b, num_filter=mid, kernel=(3, 3), pad=(1, 1),
                        stride=stride, num_group=cardinality,
                        no_bias=True, name=name + "_conv2")
    b = sym.BatchNorm(b, name=name + "_bn2")
    b = sym.Activation(b, act_type="relu")
    b = sym.Convolution(b, num_filter=out_ch, kernel=(1, 1),
                        no_bias=True, name=name + "_conv3")
    b = sym.BatchNorm(b, name=name + "_bn3")
    if match:
        sc = sym.Convolution(x, num_filter=out_ch, kernel=(1, 1),
                             stride=stride, no_bias=True,
                             name=name + "_sc")
        x = sym.BatchNorm(sc, name=name + "_sc_bn")
    return sym.Activation(x + b, act_type="relu")


def get_symbol(num_classes=1000, num_layers=50, cardinality=32,
               bottleneck_width=4, **_):
    if num_layers not in _STAGES:
        raise ValueError("ResNeXt depth must be one of %s"
                         % sorted(_STAGES))
    data = sym.Variable("data")
    x = sym.Convolution(data, num_filter=64, kernel=(7, 7),
                        stride=(2, 2), pad=(3, 3), no_bias=True,
                        name="conv0")
    x = sym.BatchNorm(x, name="bn0")
    x = sym.Activation(x, act_type="relu")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")

    mid = cardinality * bottleneck_width
    out_ch = 256
    for stage, reps in enumerate(_STAGES[num_layers]):
        for r in range(reps):
            stride = (2, 2) if stage > 0 and r == 0 else (1, 1)
            x = _block(x, "stage%d_unit%d" % (stage + 1, r + 1), mid,
                       out_ch, stride, cardinality,
                       match=(r == 0))
        mid *= 2
        out_ch *= 2

    x = sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(1, 1))
    x = sym.Flatten(x)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")
