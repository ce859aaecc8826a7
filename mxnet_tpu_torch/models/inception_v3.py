"""Inception-v3 (Szegedy et al. 2015) in the symbol API — the PyTorch twin
of ``mxnet_tpu/models/inception_v3.py`` (same graph and names).

Reference counterpart: example/image-classification/symbols/inception-v3.py
(the model in the reference's 256-GPU scaling table, 30.4 img/s/K80).
Expects 299x299 inputs like the reference."""
from __future__ import annotations

from .. import symbol as sym


def _conv(x, name, nf, kernel, stride=(1, 1), pad=(0, 0), act=True):
    """conv+BN(+relu) — shared by the inception family builders."""
    x = sym.Convolution(x, num_filter=nf, kernel=kernel, stride=stride,
                        pad=pad, no_bias=True, name=name)
    x = sym.BatchNorm(x, eps=2e-5, name=name + "_bn")
    return sym.Activation(x, act_type="relu") if act else x


def _pool(x, kind, kernel=(3, 3), stride=(1, 1), pad=(1, 1)):
    return sym.Pooling(x, kernel=kernel, stride=stride, pad=pad,
                       pool_type=kind)


def _module_a(x, name, pool_proj):
    """35x35 module: 1x1 / 5x5 / double-3x3 / pool towers."""
    t1 = _conv(x, name + "_1x1", 64, (1, 1))
    t5 = _conv(x, name + "_5x5r", 48, (1, 1))
    t5 = _conv(t5, name + "_5x5", 64, (5, 5), pad=(2, 2))
    t3 = _conv(x, name + "_d3r", 64, (1, 1))
    t3 = _conv(t3, name + "_d3a", 96, (3, 3), pad=(1, 1))
    t3 = _conv(t3, name + "_d3b", 96, (3, 3), pad=(1, 1))
    tp = _conv(_pool(x, "avg"), name + "_proj", pool_proj, (1, 1))
    return sym.Concat(t1, t5, t3, tp, dim=1)


def _grid_reduce_a(x, name):
    """35x35 -> 17x17."""
    t3 = _conv(x, name + "_3x3", 384, (3, 3), stride=(2, 2))
    td = _conv(x, name + "_d3r", 64, (1, 1))
    td = _conv(td, name + "_d3a", 96, (3, 3), pad=(1, 1))
    td = _conv(td, name + "_d3b", 96, (3, 3), stride=(2, 2))
    tp = _pool(x, "max", stride=(2, 2), pad=(0, 0))
    return sym.Concat(t3, td, tp, dim=1)


def _module_b(x, name, c7):
    """17x17 module with factorized 7x7 (1x7 + 7x1) towers."""
    t1 = _conv(x, name + "_1x1", 192, (1, 1))
    t7 = _conv(x, name + "_7r", c7, (1, 1))
    t7 = _conv(t7, name + "_7a", c7, (1, 7), pad=(0, 3))
    t7 = _conv(t7, name + "_7b", 192, (7, 1), pad=(3, 0))
    td = _conv(x, name + "_d7r", c7, (1, 1))
    td = _conv(td, name + "_d7a", c7, (7, 1), pad=(3, 0))
    td = _conv(td, name + "_d7b", c7, (1, 7), pad=(0, 3))
    td = _conv(td, name + "_d7c", c7, (7, 1), pad=(3, 0))
    td = _conv(td, name + "_d7d", 192, (1, 7), pad=(0, 3))
    tp = _conv(_pool(x, "avg"), name + "_proj", 192, (1, 1))
    return sym.Concat(t1, t7, td, tp, dim=1)


def _grid_reduce_b(x, name):
    """17x17 -> 8x8."""
    t3 = _conv(x, name + "_3r", 192, (1, 1))
    t3 = _conv(t3, name + "_3", 320, (3, 3), stride=(2, 2))
    t7 = _conv(x, name + "_7r", 192, (1, 1))
    t7 = _conv(t7, name + "_7a", 192, (1, 7), pad=(0, 3))
    t7 = _conv(t7, name + "_7b", 192, (7, 1), pad=(3, 0))
    t7 = _conv(t7, name + "_7c", 192, (3, 3), stride=(2, 2))
    tp = _pool(x, "max", stride=(2, 2), pad=(0, 0))
    return sym.Concat(t3, t7, tp, dim=1)


def _module_c(x, name, pool_kind):
    """8x8 module with split 3x3 (1x3 | 3x1) towers. The reference uses
    an avg pool tower in the first of these modules and max in the
    second."""
    t1 = _conv(x, name + "_1x1", 320, (1, 1))
    t3 = _conv(x, name + "_3r", 384, (1, 1))
    t3a = _conv(t3, name + "_3a", 384, (1, 3), pad=(0, 1))
    t3b = _conv(t3, name + "_3b", 384, (3, 1), pad=(1, 0))
    td = _conv(x, name + "_d3r", 448, (1, 1))
    td = _conv(td, name + "_d3", 384, (3, 3), pad=(1, 1))
    tda = _conv(td, name + "_d3a", 384, (1, 3), pad=(0, 1))
    tdb = _conv(td, name + "_d3b", 384, (3, 1), pad=(1, 0))
    tp = _conv(_pool(x, pool_kind), name + "_proj", 192, (1, 1))
    return sym.Concat(t1, t3a, t3b, tda, tdb, tp, dim=1)


def get_symbol(num_classes=1000, **_):
    data = sym.Variable("data")
    x = _conv(data, "conv0", 32, (3, 3), stride=(2, 2))
    x = _conv(x, "conv1", 32, (3, 3))
    x = _conv(x, "conv2", 64, (3, 3), pad=(1, 1))
    x = _pool(x, "max", stride=(2, 2), pad=(0, 0))
    x = _conv(x, "conv3", 80, (1, 1))
    x = _conv(x, "conv4", 192, (3, 3))
    x = _pool(x, "max", stride=(2, 2), pad=(0, 0))

    x = _module_a(x, "mixed0", 32)
    x = _module_a(x, "mixed1", 64)
    x = _module_a(x, "mixed2", 64)
    x = _grid_reduce_a(x, "mixed3")
    x = _module_b(x, "mixed4", 128)
    x = _module_b(x, "mixed5", 160)
    x = _module_b(x, "mixed6", 160)
    x = _module_b(x, "mixed7", 192)
    x = _grid_reduce_b(x, "mixed8")
    x = _module_c(x, "mixed9", "avg")
    x = _module_c(x, "mixed10", "max")

    x = sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(1, 1))
    x = sym.Flatten(x)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")
