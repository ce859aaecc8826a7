"""Inception-v4 (Szegedy et al. 2016) in the symbol API — the
PyTorch twin of ``mxnet_tpu/models/inception_v4.py`` (same graph and names).

Reference counterpart:
example/image-classification/symbols/inception-v4.py (same tower
widths, incl. its deliberate paper deviations). Expects 299x299
inputs.

Towers are written as specs — ("c", filters, kernel, stride, pad) conv
steps or ("max"/"avg",) pools — and interpreted by `_tower`; blocks are
tuples of towers concatenated on channels.
"""
from __future__ import annotations

from .. import symbol as sym


def _tower(x, name, spec):
    for i, step in enumerate(spec):
        if step[0] in ("max", "avg"):
            stride = step[1] if len(step) > 1 else (1, 1)
            pad = (1, 1) if stride == (1, 1) else (0, 0)
            x = sym.Pooling(x, kernel=(3, 3), stride=stride, pad=pad,
                            pool_type=step[0])
            continue
        _, nf, kernel, stride, pad = step
        x = sym.Convolution(x, num_filter=nf, kernel=kernel,
                            stride=stride, pad=pad, no_bias=True,
                            name="%s_c%d" % (name, i))
        x = sym.BatchNorm(x, eps=2e-5, name="%s_c%d_bn" % (name, i))
        x = sym.Activation(x, act_type="relu")
    return x


def _block(x, name, towers):
    return sym.Concat(*[_tower(x, "%s_t%d" % (name, i), t)
                        for i, t in enumerate(towers)],
                      name=name + "_concat")


_S1, _S2 = (1, 1), (2, 2)


def _c(nf, k, stride=_S1, pad=(0, 0)):
    return ("c", nf, k, stride, pad)


# the four repeated block shapes (output channels: A 384, B 1024, C 1536)
_A = ((("avg",), _c(96, (1, 1))),
      (_c(96, (1, 1)),),
      (_c(64, (1, 1)), _c(96, (3, 3), pad=(1, 1))),
      (_c(64, (1, 1)), _c(96, (3, 3), pad=(1, 1)),
       _c(96, (3, 3), pad=(1, 1))))
_RED_A = ((("max", _S2),),
          (_c(384, (3, 3), _S2),),
          (_c(192, (1, 1)), _c(224, (3, 3), pad=(1, 1)),
           _c(256, (3, 3), _S2)))
_B = ((("avg",), _c(128, (1, 1))),
      (_c(384, (1, 1)),),
      (_c(192, (1, 1)), _c(224, (1, 7), pad=(0, 3)),
       _c(256, (7, 1), pad=(3, 0))),
      (_c(192, (1, 1)), _c(192, (1, 7), pad=(0, 3)),
       _c(224, (7, 1), pad=(3, 0)), _c(224, (1, 7), pad=(0, 3)),
       _c(256, (7, 1), pad=(3, 0))))
_RED_B = ((("max", _S2),),
          (_c(192, (1, 1)), _c(192, (3, 3), _S2)),
          (_c(256, (1, 1)), _c(256, (1, 7), pad=(0, 3)),
           _c(320, (7, 1), pad=(3, 0)), _c(320, (3, 3), _S2)))


def _block_c(x, name):
    """C block: two of its towers FORK after a shared prefix, so it
    doesn't fit the linear-tower table."""
    t0 = _tower(x, name + "_t0", (("avg",), _c(256, (1, 1))))
    t1 = _tower(x, name + "_t1", (_c(256, (1, 1)),))
    s2 = _tower(x, name + "_t2", (_c(384, (1, 1)),))
    t2a = _tower(s2, name + "_t2a", (_c(256, (1, 3), pad=(0, 1)),))
    t2b = _tower(s2, name + "_t2b", (_c(256, (3, 1), pad=(1, 0)),))
    s3 = _tower(x, name + "_t3", (_c(384, (1, 1)),
                                  _c(448, (1, 3), pad=(0, 1)),
                                  _c(512, (3, 1), pad=(1, 0))))
    t3a = _tower(s3, name + "_t3a", (_c(256, (3, 1), pad=(1, 0)),))
    t3b = _tower(s3, name + "_t3b", (_c(256, (1, 3), pad=(0, 1)),))
    return sym.Concat(t0, t1, t2a, t2b, t3a, t3b, name=name + "_concat")


def _stem(x):
    x = _tower(x, "stem1", (_c(32, (3, 3), _S2), _c(32, (3, 3)),
                            _c(64, (3, 3), pad=(1, 1))))
    x = _block(x, "stem2", ((("max", _S2),), (_c(96, (3, 3), _S2),)))
    x = _block(x, "stem3", (
        (_c(64, (1, 1)), _c(96, (3, 3))),
        (_c(64, (1, 1)), _c(64, (7, 1), pad=(3, 0)),
         _c(64, (1, 7), pad=(0, 3)), _c(96, (3, 3)))))
    return _block(x, "stem4", ((_c(192, (3, 3), _S2),),
                               (("max", _S2),)))


def get_symbol(num_classes=1000, dropout=0.2, **_):
    x = _stem(sym.Variable("data"))
    for i in range(4):
        x = _block(x, "a%d" % i, _A)
    x = _block(x, "red_a", _RED_A)
    for i in range(7):
        x = _block(x, "b%d" % i, _B)
    x = _block(x, "red_b", _RED_B)
    for i in range(3):
        x = _block_c(x, "c%d" % i)
    x = sym.Pooling(x, kernel=(8, 8), global_pool=True, pool_type="avg")
    x = sym.Flatten(x)
    if dropout > 0:
        x = sym.Dropout(x, p=dropout)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")
