"""GoogLeNet / Inception-v1 (Szegedy et al. 2014) in the symbol API — the
PyTorch twin of ``mxnet_tpu/models/googlenet.py`` (same graph and names).

Reference counterpart: example/image-classification/symbols/googlenet.py
(plain conv+relu towers, no BatchNorm — inception-bn is the BN variant).
Expects 224x224 inputs."""
from __future__ import annotations

from .. import symbol as sym

# inception mix table: name -> (1x1, 3x3reduce, 3x3, 5x5reduce, 5x5,
# pool-proj); a "P" row is a stride-2 3x3 max-pool between stages.
_STAGES = (
    ("in3a", (64, 96, 128, 16, 32, 32)),
    ("in3b", (128, 128, 192, 32, 96, 64)),
    "P",
    ("in4a", (192, 96, 208, 16, 48, 64)),
    ("in4b", (160, 112, 224, 24, 64, 64)),
    ("in4c", (128, 128, 256, 24, 64, 64)),
    ("in4d", (112, 144, 288, 32, 64, 64)),
    ("in4e", (256, 160, 320, 32, 128, 128)),
    "P",
    ("in5a", (256, 160, 320, 32, 128, 128)),
    ("in5b", (384, 192, 384, 48, 128, 128)),
)


def _conv(x, name, nf, kernel, stride=(1, 1), pad=(0, 0)):
    x = sym.Convolution(x, num_filter=nf, kernel=kernel, stride=stride,
                        pad=pad, name=name)
    return sym.Activation(x, act_type="relu")


def _mix(x, name, widths):
    n1, r3, n3, r5, n5, proj = widths
    t1 = _conv(x, name + "_1x1", n1, (1, 1))
    t3 = _conv(x, name + "_3x3r", r3, (1, 1))
    t3 = _conv(t3, name + "_3x3", n3, (3, 3), pad=(1, 1))
    t5 = _conv(x, name + "_5x5r", r5, (1, 1))
    t5 = _conv(t5, name + "_5x5", n5, (5, 5), pad=(2, 2))
    tp = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="max")
    tp = _conv(tp, name + "_proj", proj, (1, 1))
    return sym.Concat(t1, t3, t5, tp, name=name + "_concat")


def get_symbol(num_classes=1000, **_):
    x = sym.Variable("data")
    x = _conv(x, "conv1", 64, (7, 7), stride=(2, 2), pad=(3, 3))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _conv(x, "conv2", 64, (1, 1))
    x = _conv(x, "conv3", 192, (3, 3), pad=(1, 1))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    for entry in _STAGES:
        if entry == "P":
            x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2),
                            pool_type="max")
        else:
            x = _mix(x, *entry)
    x = sym.Pooling(x, kernel=(7, 7), global_pool=True, pool_type="avg")
    x = sym.Flatten(x)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")
