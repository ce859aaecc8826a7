"""AlexNet (Krizhevsky et al. 2012) in the symbol API — the PyTorch twin
of ``mxnet_tpu/models/alexnet.py`` (same graph and parameter names).

Reference counterpart: example/image-classification/symbols/alexnet.py
(behavioral parity — same layer schedule; this is the one-tower variant
the reference uses)."""
from __future__ import annotations

from .. import symbol as sym


def _conv_relu(x, name, num_filter, kernel, stride=(1, 1), pad=(0, 0)):
    c = sym.Convolution(x, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name=name)
    return sym.Activation(c, act_type="relu")


def get_symbol(num_classes=1000, dtype="float32", **_):
    data = sym.Variable("data")

    x = _conv_relu(data, "conv1", 96, (11, 11), stride=(4, 4))
    x = sym.LRN(x, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")

    x = _conv_relu(x, "conv2", 256, (5, 5), pad=(2, 2))
    x = sym.LRN(x, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")

    x = _conv_relu(x, "conv3", 384, (3, 3), pad=(1, 1))
    x = _conv_relu(x, "conv4", 384, (3, 3), pad=(1, 1))
    x = _conv_relu(x, "conv5", 256, (3, 3), pad=(1, 1))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")

    x = sym.Flatten(x)
    for i, width in ((6, 4096), (7, 4096)):
        x = sym.FullyConnected(x, num_hidden=width, name="fc%d" % i)
        x = sym.Activation(x, act_type="relu")
        x = sym.Dropout(x, p=0.5)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(x, name="softmax")
