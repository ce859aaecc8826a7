"""VGG 11/13/16/19 (Simonyan & Zisserman 2014) in the symbol API — the
PyTorch twin of ``mxnet_tpu/models/vgg.py`` (same graph and names).

Reference counterpart: example/image-classification/symbols/vgg.py."""
from __future__ import annotations

from .. import symbol as sym

# number of 3x3 conv layers per block, by depth
_PLANS = {11: (1, 1, 2, 2, 2), 13: (2, 2, 2, 2, 2), 16: (2, 2, 3, 3, 3),
          19: (2, 2, 4, 4, 4)}
_WIDTHS = (64, 128, 256, 512, 512)


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False, **_):
    if num_layers not in _PLANS:
        raise ValueError("VGG depth must be one of %s" %
                         sorted(_PLANS))
    data = sym.Variable("data")
    x = data
    for b, (reps, width) in enumerate(zip(_PLANS[num_layers], _WIDTHS),
                                      start=1):
        for r in range(1, reps + 1):
            name = "conv%d_%d" % (b, r)
            x = sym.Convolution(x, num_filter=width, kernel=(3, 3),
                                pad=(1, 1), name=name)
            if batch_norm:
                x = sym.BatchNorm(x, name="bn%d_%d" % (b, r))
            x = sym.Activation(x, act_type="relu")
        x = sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")

    x = sym.Flatten(x)
    for i in (6, 7):
        x = sym.FullyConnected(x, num_hidden=4096, name="fc%d" % i)
        x = sym.Activation(x, act_type="relu")
        x = sym.Dropout(x, p=0.5)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(x, name="softmax")
