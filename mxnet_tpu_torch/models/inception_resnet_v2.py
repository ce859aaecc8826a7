"""Inception-ResNet-v2 (Szegedy et al. 2016) in the symbol API — the
PyTorch twin of ``mxnet_tpu/models/inception_resnet_v2.py`` (same graph
and names).

Reference counterpart:
example/image-classification/symbols/inception-resnet-v2.py (same tower
widths, incl. its 129-filter quirk in block17). Expects 299x299 inputs.

Residual inception: each block computes a multi-tower mix, projects it
back to the trunk width with a linear 1x1, and adds it scaled into the
trunk (net += scale * mix) — the residual formulation that lets these
very deep inception stacks train without aux heads.
"""
from __future__ import annotations

from .. import symbol as sym
from .inception_v3 import _conv


def _chain(x, name, steps):
    """steps: ((filters, kernel, stride, pad), ...) conv chain."""
    for i, (nf, k, stride, pad) in enumerate(steps):
        x = _conv(x, "%s_%d" % (name, i), nf, k, stride, pad)
    return x


# residual block tower tables: ((steps per tower), ...) with trunk
# width and residual scale. 129 in block17 reproduces the reference.
_S1 = (1, 1)
_BLOCKS = {
    "b35": (320, 0.17, (
        ((32, (1, 1), _S1, (0, 0)),),
        ((32, (1, 1), _S1, (0, 0)), (32, (3, 3), _S1, (1, 1))),
        ((32, (1, 1), _S1, (0, 0)), (48, (3, 3), _S1, (1, 1)),
         (64, (3, 3), _S1, (1, 1))))),
    "b17": (1088, 0.1, (
        ((192, (1, 1), _S1, (0, 0)),),
        ((129, (1, 1), _S1, (0, 0)), (160, (1, 7), _S1, (1, 2)),
         (192, (7, 1), _S1, (2, 1))))),
    "b8": (2080, 0.2, (
        ((192, (1, 1), _S1, (0, 0)),),
        ((192, (1, 1), _S1, (0, 0)), (224, (1, 3), _S1, (0, 1)),
         (256, (3, 1), _S1, (1, 0))))),
}


def _res_block(x, name, kind, act=True):
    trunk, scale, towers = _BLOCKS[kind]
    mix = sym.Concat(*[_chain(x, "%s_t%d" % (name, i), steps)
                       for i, steps in enumerate(towers)],
                     name=name + "_concat")
    up = _conv(mix, name + "_up", trunk, (1, 1), act=False)
    x = x + scale * up
    return sym.Activation(x, act_type="relu") if act else x


def get_symbol(num_classes=1000, dropout=0.2, **_):
    x = sym.Variable("data")
    x = _chain(x, "stem", ((32, (3, 3), (2, 2), (0, 0)),
                           (32, (3, 3), _S1, (0, 0)),
                           (64, (3, 3), _S1, (1, 1))))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _chain(x, "stem2", ((80, (1, 1), _S1, (0, 0)),
                            (192, (3, 3), _S1, (0, 0))))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")

    # mixed 5b: bring the trunk to 320 channels at 35x35
    t0 = _conv(x, "m5b_1x1", 96, (1, 1))
    t1 = _chain(x, "m5b_5x5", ((48, (1, 1), _S1, (0, 0)),
                               (64, (5, 5), _S1, (2, 2))))
    t2 = _chain(x, "m5b_d3", ((64, (1, 1), _S1, (0, 0)),
                              (96, (3, 3), _S1, (1, 1)),
                              (96, (3, 3), _S1, (1, 1))))
    tp = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg")
    tp = _conv(tp, "m5b_pool", 64, (1, 1))
    x = sym.Concat(t0, t1, t2, tp, name="m5b_concat")

    for i in range(10):
        x = _res_block(x, "a%d" % i, "b35")

    # reduction to 17x17 / 1088
    r0 = _conv(x, "ra_3x3", 384, (3, 3), stride=(2, 2))
    r1 = _chain(x, "ra_d3", ((256, (1, 1), _S1, (0, 0)),
                             (256, (3, 3), _S1, (1, 1)),
                             (384, (3, 3), (2, 2), (0, 0))))
    rp = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = sym.Concat(r0, r1, rp, name="ra_concat")

    for i in range(20):
        x = _res_block(x, "b%d" % i, "b17")

    # reduction to 8x8 / 2080
    r0 = _chain(x, "rb_a", ((256, (1, 1), _S1, (0, 0)),
                            (384, (3, 3), (2, 2), (0, 0))))
    r1 = _chain(x, "rb_b", ((256, (1, 1), _S1, (0, 0)),
                            (288, (3, 3), (2, 2), (0, 0))))
    r2 = _chain(x, "rb_c", ((256, (1, 1), _S1, (0, 0)),
                            (288, (3, 3), _S1, (1, 1)),
                            (320, (3, 3), (2, 2), (0, 0))))
    rp = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = sym.Concat(r0, r1, r2, rp, name="rb_concat")

    for i in range(9):
        x = _res_block(x, "c%d" % i, "b8")
    x = _res_block(x, "c9", "b8", act=False)

    x = _conv(x, "final", 1536, (1, 1))
    x = sym.Pooling(x, kernel=(8, 8), global_pool=True, pool_type="avg")
    x = sym.Flatten(x)
    if dropout > 0:
        x = sym.Dropout(x, p=dropout)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")
