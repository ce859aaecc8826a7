"""Inception-BN / GoogLeNet-v2 (Ioffe & Szegedy 2015) in the symbol API —
the PyTorch twin of ``mxnet_tpu/models/inception_bn.py`` (same graph
and names).

Reference counterpart: example/image-classification/symbols/inception-bn.py
(the reference's 152 img/s K80 baseline model)."""
from __future__ import annotations

from .. import symbol as sym


def _conv(x, name, num_filter, kernel, stride=(1, 1), pad=(0, 0)):
    x = sym.Convolution(x, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True, name=name)
    x = sym.BatchNorm(x, name=name + "_bn")
    return sym.Activation(x, act_type="relu")


def _tower(x, name, specs):
    """A chain of convs: specs = [(suffix, filters, kernel, stride,
    pad), ...]."""
    for suffix, f, k, s, p in specs:
        x = _conv(x, name + suffix, f, k, s, p)
    return x


def _inception(x, name, f1, f3r, f3, d3r, d3, pool_type, fp):
    """Four parallel towers concatenated on channels; fp==0 with
    pool_type='max' marks a stride-2 (grid reduction) unit."""
    stride = (2, 2) if fp == 0 else (1, 1)
    towers = []
    if f1 > 0:
        towers.append(_conv(x, name + "_1x1", f1, (1, 1)))
    towers.append(_tower(x, name, [
        ("_3x3r", f3r, (1, 1), (1, 1), (0, 0)),
        ("_3x3", f3, (3, 3), stride, (1, 1))]))
    towers.append(_tower(x, name, [
        ("_d3x3r", d3r, (1, 1), (1, 1), (0, 0)),
        ("_d3x3a", d3, (3, 3), (1, 1), (1, 1)),
        ("_d3x3b", d3, (3, 3), stride, (1, 1))]))
    pool = sym.Pooling(x, kernel=(3, 3), stride=stride, pad=(1, 1),
                       pool_type=pool_type)
    if fp > 0:
        pool = _conv(pool, name + "_proj", fp, (1, 1))
    towers.append(pool)
    return sym.Concat(*towers, dim=1)


def get_symbol(num_classes=1000, **_):
    data = sym.Variable("data")
    x = _conv(data, "conv1", 64, (7, 7), stride=(2, 2), pad=(3, 3))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    x = _conv(x, "conv2r", 64, (1, 1))
    x = _conv(x, "conv2", 192, (3, 3), pad=(1, 1))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")

    x = _inception(x, "in3a", 64, 64, 64, 64, 96, "avg", 32)
    x = _inception(x, "in3b", 64, 64, 96, 64, 96, "avg", 64)
    x = _inception(x, "in3c", 0, 128, 160, 64, 96, "max", 0)
    x = _inception(x, "in4a", 224, 64, 96, 96, 128, "avg", 128)
    x = _inception(x, "in4b", 192, 96, 128, 96, 128, "avg", 128)
    x = _inception(x, "in4c", 160, 128, 160, 128, 160, "avg", 128)
    x = _inception(x, "in4d", 96, 128, 192, 160, 192, "avg", 128)
    x = _inception(x, "in4e", 0, 128, 192, 192, 256, "max", 0)
    x = _inception(x, "in5a", 352, 192, 320, 160, 224, "avg", 128)
    x = _inception(x, "in5b", 352, 192, 320, 192, 224, "max", 128)

    x = sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(1, 1))
    x = sym.Flatten(x)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")
