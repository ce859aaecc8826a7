"""ResNet symbol builder (v1 and v2/pre-activation) — the PyTorch twin
of ``mxnet_tpu/models/resnet.py``.

Same graph, layer table and parameter names (reference API:
example/image-classification/symbols/resnet.py, ``get_symbol(num_classes,
num_layers, image_shape, ...)``; He et al. 2015/2016), NCHW in the
symbol, so a checkpoint of either package binds in the other. Mixed
precision is the trainer's ``compute_dtype``.
"""
from __future__ import annotations

from .. import symbol as sym


def residual_unit_v1(data, num_filter, stride, dim_match, name,
                     bottle_neck=True, bn_mom=0.9, memonger=False):
    """One residual unit, ORIGINAL (v1, post-activation) form:
    conv->bn->relu chains, projection shortcut from the raw input,
    relu AFTER the add (reference symbols/resnet-v1.py:residual_unit).
    """
    def cbr(x, nf, kernel, stride_, pad, idx, act=True):
        x = sym.Convolution(data=x, num_filter=nf, kernel=kernel,
                            stride=stride_, pad=pad, no_bias=True,
                            name="%s_conv%d" % (name, idx))
        x = sym.BatchNorm(data=x, fix_gamma=False, eps=2e-5,
                          momentum=bn_mom, name="%s_bn%d" % (name, idx))
        if act:
            x = sym.Activation(data=x, act_type="relu",
                               name="%s_relu%d" % (name, idx))
        return x

    if bottle_neck:
        body = cbr(data, int(num_filter * 0.25), (1, 1), stride,
                   (0, 0), 1)
        body = cbr(body, int(num_filter * 0.25), (3, 3), (1, 1),
                   (1, 1), 2)
        body = cbr(body, num_filter, (1, 1), (1, 1), (0, 0), 3,
                   act=False)
    else:
        body = cbr(data, num_filter, (3, 3), stride, (1, 1), 1)
        body = cbr(body, num_filter, (3, 3), (1, 1), (1, 1), 2,
                   act=False)
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(data=data, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride,
                                   no_bias=True, name=name + "_sc")
        shortcut = sym.BatchNorm(data=shortcut, fix_gamma=False,
                                 eps=2e-5, momentum=bn_mom,
                                 name=name + "_sc_bn")
    return sym.Activation(data=body + shortcut, act_type="relu",
                          name=name + "_out")


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottle_neck=True, bn_mom=0.9, memonger=False):
    """One residual unit, pre-activation (v2) form (reference
    symbols/resnet.py:residual_unit)."""
    if bottle_neck:
        bn1 = sym.BatchNorm(data=data, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu",
                              name=name + "_relu1")
        conv1 = sym.Convolution(data=act1, num_filter=int(num_filter * 0.25),
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu",
                              name=name + "_relu2")
        conv2 = sym.Convolution(data=act2, num_filter=int(num_filter * 0.25),
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(data=conv2, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn3")
        act3 = sym.Activation(data=bn3, act_type="relu",
                              name=name + "_relu3")
        conv3 = sym.Convolution(data=act3, num_filter=num_filter,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(data=act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    else:
        bn1 = sym.BatchNorm(data=data, fix_gamma=False, momentum=bn_mom,
                            eps=2e-5, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu",
                              name=name + "_relu1")
        conv1 = sym.Convolution(data=act1, num_filter=num_filter,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(data=conv1, fix_gamma=False, momentum=bn_mom,
                            eps=2e-5, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu",
                              name=name + "_relu2")
        conv2 = sym.Convolution(data=act2, num_filter=num_filter,
                                kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(data=act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc")
        return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9, memonger=False, version=2):
    """Assemble a ResNet (reference symbols/resnet.py:resnet; version=1
    selects the original post-activation units of symbols/resnet-v1.py)."""
    unit_fn = residual_unit if version == 2 else residual_unit_v1
    num_unit = len(units)
    assert num_unit == num_stages
    data = sym.Variable(name="data")
    data = sym.identity(data=data, name="id")
    (nchannel, height, width) = image_shape
    if height <= 32:  # cifar-style stem
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
        if version == 1:
            # v1 units consume an ACTIVATED trunk (v2's pre-activation
            # units supply their own leading BN+relu)
            body = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                                 momentum=bn_mom, name="bn0")
            body = sym.Activation(data=body, act_type="relu",
                                  name="relu0")
    else:  # imagenet stem
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name="bn0")
        body = sym.Activation(data=body, act_type="relu", name="relu0")
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type="max")

    for i in range(num_stages):
        body = unit_fn(
            body, filter_list[i + 1],
            (1 if i == 0 else 2, 1 if i == 0 else 2), False,
            name="stage%d_unit%d" % (i + 1, 1), bottle_neck=bottle_neck,
            bn_mom=bn_mom, memonger=memonger)
        for j in range(units[i] - 1):
            body = unit_fn(body, filter_list[i + 1], (1, 1), True,
                                 name="stage%d_unit%d" % (i + 1, j + 2),
                                 bottle_neck=bottle_neck, bn_mom=bn_mom,
                                 memonger=memonger)
    if version == 2:
        # v2 trunk ends pre-activation: close with BN+relu
        body = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name="bn1")
        body = sym.Activation(data=body, act_type="relu", name="relu1")
    pool1 = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(data=pool1)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")


def get_symbol(num_classes, num_layers, image_shape, conv_workspace=256,
               dtype="float32", version=2, **kwargs):
    """ResNet symbol factory (reference symbols/resnet.py:get_symbol) —
    same layer-count table. version=1 builds the original
    post-activation form (reference symbols/resnet-v1.py)."""
    version = int(version)
    if version not in (1, 2):
        raise ValueError("resnet version must be 1 or 2, got %r"
                         % (version,))
    image_shape = [int(l) for l in image_shape.split(",")] \
        if isinstance(image_shape, str) else list(image_shape)
    (nchannel, height, width) = image_shape
    if height <= 28:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError("no experiments done on num_layers %d" %
                             num_layers)
        units = per_unit * num_stages
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        num_stages = 4
        units_map = {
            18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3], 200: [3, 24, 36, 3],
            269: [3, 30, 48, 8]}
        if num_layers not in units_map:
            raise ValueError("no experiments done on num_layers %d" %
                             num_layers)
        units = units_map[num_layers]

    return resnet(units=units, num_stages=num_stages,
                  filter_list=filter_list, num_classes=num_classes,
                  image_shape=image_shape, bottle_neck=bottle_neck,
                  version=version)
