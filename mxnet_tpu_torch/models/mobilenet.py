"""MobileNet v1 (Howard et al. 2017) in the symbol API — the
PyTorch twin of ``mxnet_tpu/models/mobilenet.py`` (same graph and names).

Reference counterpart: example/image-classification/symbols/mobilenet.py.
Depthwise convolutions express as grouped Convolution (num_group ==
channels), which cuDNN runs as a grouped convolution."""
from __future__ import annotations

from .. import symbol as sym


def _conv_bn(x, name, num_filter, kernel, stride=(1, 1), pad=(0, 0),
             num_group=1):
    x = sym.Convolution(x, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, num_group=num_group,
                        no_bias=True, name=name)
    x = sym.BatchNorm(x, name=name + "_bn")
    return sym.Activation(x, act_type="relu")


def _dw_sep(x, name, in_ch, out_ch, stride):
    """depthwise 3x3 + pointwise 1x1 (the MobileNet block)."""
    x = _conv_bn(x, name + "_dw", in_ch, (3, 3), stride=stride,
                 pad=(1, 1), num_group=in_ch)
    return _conv_bn(x, name + "_pw", out_ch, (1, 1))


# (output channels, stride) schedule after the stem
_SCHEDULE = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
             (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
             (1024, 2), (1024, 1)]


def get_symbol(num_classes=1000, multiplier=1.0, **_):
    scale = lambda c: max(8, int(c * multiplier))
    data = sym.Variable("data")
    x = _conv_bn(data, "conv1", scale(32), (3, 3), stride=(2, 2),
                 pad=(1, 1))
    in_ch = scale(32)
    for i, (out, s) in enumerate(_SCHEDULE, start=2):
        out = scale(out)
        x = _dw_sep(x, "conv%d" % i, in_ch, out, (s, s))
        in_ch = out
    x = sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(1, 1))
    x = sym.Flatten(x)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")
