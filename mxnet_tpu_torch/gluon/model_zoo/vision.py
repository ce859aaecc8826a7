"""Gluon vision model zoo (reference:
python/mxnet/gluon/model_zoo/vision/__init__.py:101+ and the per-family
modules: alexnet, densenet, inception, resnet (v1+v2), squeezenet, vgg).

Zero-egress: ``pretrained=True`` loads from the LOCAL model store
(model_store.get_model_file — ``$MXNET_HOME/models`` or
``~/.mxnet/models``); there is no weights host to download from. The
architectures match the reference's topologies so reference-trained
.params files load directly.
"""
from __future__ import annotations

from . import model_store
from .. import nn
from ..block import HybridBlock

__all__ = ["get_model", "alexnet", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "squeezenet1_0", "squeezenet1_1",
           "densenet121", "densenet161", "densenet169", "densenet201",
           "inception_v3", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25",
           "AlexNet", "ResNetV1", "ResNetV2", "VGG", "SqueezeNet",
           "DenseNet", "Inception3", "MobileNet"]


def _load_pretrained(net, name, pretrained, root=None, ctx=None):
    """pretrained=True: fill ``net`` from the local model store
    (reference pattern: get_model_file + load_params at the end of each
    factory, e.g. model_zoo/vision/alexnet.py)."""
    if pretrained:
        net.load_params(model_store.get_model_file(name, root), ctx=ctx)
    return net


# ---------------------------------------------------------------------------
# AlexNet (reference model_zoo/vision/alexnet.py)
# ---------------------------------------------------------------------------

class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                            padding=2, activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Flatten())
            self.classifier = nn.HybridSequential(prefix="")
            with self.classifier.name_scope():
                self.classifier.add(nn.Dense(4096, activation="relu"))
                self.classifier.add(nn.Dropout(0.5))
                self.classifier.add(nn.Dense(4096, activation="relu"))
                self.classifier.add(nn.Dropout(0.5))
                self.classifier.add(nn.Dense(classes))

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.classifier(x)
        return x


def alexnet(pretrained=False, classes=1000, root=None, ctx=None,
            **kwargs):
    return _load_pretrained(AlexNet(classes=classes, **kwargs),
                            "alexnet", pretrained, root, ctx)


# ---------------------------------------------------------------------------
# ResNet v1/v2 (reference model_zoo/vision/resnet.py)
# ---------------------------------------------------------------------------

def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1,
                                strides=stride))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels, 1, channels)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride,
                                        use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride,
                                        use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        x = self.bn3(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv3(x)
        return x + residual


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


resnet_spec = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
               34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
               50: ("bottle_neck", [3, 4, 6, 3],
                    [64, 256, 512, 1024, 2048]),
               101: ("bottle_neck", [3, 4, 23, 3],
                     [64, 256, 512, 1024, 2048]),
               152: ("bottle_neck", [3, 8, 36, 3],
                     [64, 256, 512, 1024, 2048])}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [{"basic_block": BasicBlockV1,
                          "bottle_neck": BottleneckV1},
                         {"basic_block": BasicBlockV2,
                          "bottle_neck": BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, root=None,
               ctx=None, **kwargs):
    block_type, layers, channels = resnet_spec[num_layers]
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    net = resnet_class(block_class, layers, channels, **kwargs)
    return _load_pretrained(net, "resnet%d_v%d" % (num_layers, version),
                            pretrained, root, ctx)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)


# ---------------------------------------------------------------------------
# VGG (reference model_zoo/vision/vgg.py)
# ---------------------------------------------------------------------------

class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = self._make_features(layers, filters,
                                                batch_norm)
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       bias_initializer="zeros"))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       bias_initializer="zeros"))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal",
                                   bias_initializer="zeros")

    def _make_features(self, layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3,
                                         padding=1,
                                         weight_initializer="xavier",
                                         bias_initializer="zeros"))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, root=None, ctx=None,
            **kwargs):
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, **kwargs)
    name = "vgg%d%s" % (num_layers,
                        "_bn" if kwargs.get("batch_norm") else "")
    return _load_pretrained(net, name, pretrained, root, ctx)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(19, **kwargs)


# ---------------------------------------------------------------------------
# SqueezeNet (reference model_zoo/vision/squeezenet.py)
# ---------------------------------------------------------------------------

def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    paths = _FireExpand(expand1x1_channels, expand3x3_channels)
    out.add(paths)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class _FireExpand(HybridBlock):
    def __init__(self, expand1x1_channels, expand3x3_channels, **kwargs):
        super().__init__(**kwargs)
        self.p1 = _make_fire_conv(expand1x1_channels, 1)
        self.p3 = _make_fire_conv(expand3x3_channels, 3, 1)

    def hybrid_forward(self, F, x):
        return F.Concat(self.p1(x), self.p3(x), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        assert version in ["1.0", "1.1"], \
            "Unsupported SqueezeNet version {version}: 1.0 or 1.1 " \
            "expected".format(version=version)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_make_fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(_make_fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def squeezenet1_0(pretrained=False, root=None, ctx=None, **kwargs):
    return _load_pretrained(SqueezeNet("1.0", **kwargs),
                            "squeezenet1.0", pretrained, root, ctx)


def squeezenet1_1(pretrained=False, root=None, ctx=None, **kwargs):
    return _load_pretrained(SqueezeNet("1.1", **kwargs),
                            "squeezenet1.1", pretrained, root, ctx)


# ---------------------------------------------------------------------------
# DenseNet (reference model_zoo/vision/densenet.py)
# ---------------------------------------------------------------------------

def _make_dense_block(num_layers, bn_size, growth_rate, dropout,
                      stage_index):
    out = nn.HybridSequential(prefix="stage%d_" % stage_index)
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseLayer(growth_rate, bn_size, dropout))
    return out


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                                use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):
        out = self.body(x)
        return F.Concat(x, out, dim=1)


def _make_transition(num_output_features):
    out = nn.HybridSequential(prefix="")
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                        strides=2, padding=3,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(_make_transition(num_features // 2))
                    num_features = num_features // 2
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.AvgPool2D(pool_size=7))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, pretrained=False, root=None, ctx=None,
                 **kwargs):
    num_init_features, growth_rate, block_config = \
        densenet_spec[num_layers]
    net = DenseNet(num_init_features, growth_rate, block_config,
                   **kwargs)
    return _load_pretrained(net, "densenet%d" % num_layers, pretrained,
                            root, ctx)


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)


# ---------------------------------------------------------------------------
# Inception v3 (reference model_zoo/vision/inception.py)
# ---------------------------------------------------------------------------

def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {}
        for i, value in enumerate(setting):
            if value is not None:
                kwargs[setting_names[i]] = value
        out.add(_make_basic_conv(**kwargs))
    return out


class _Concurrent(HybridBlock):
    """Parallel branches concatenated on channel axis."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        return F.Concat(*[block(x) for block in self._children], dim=1)


def _make_A(pool_features, prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (64, 1, None, None)))
        out.add(_make_branch(None, (48, 1, None, None),
                             (64, 5, None, 2)))
        out.add(_make_branch(None, (64, 1, None, None),
                             (96, 3, None, 1), (96, 3, None, 1)))
        out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (384, 3, 2, None)))
        out.add(_make_branch(None, (64, 1, None, None),
                             (96, 3, None, 1), (96, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None)))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None),
                             (320, 3, 2, None)))
        out.add(_make_branch(None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


class _InceptionE(HybridBlock):
    def __init__(self, prefix=None, **kwargs):
        super().__init__(prefix=prefix, **kwargs)
        with self.name_scope():
            self.b1 = _make_branch(None, (320, 1, None, None))
            self.b2_stem = _make_branch(None, (384, 1, None, None))
            self.b2a = _make_branch(None, (384, (1, 3), None, (0, 1)))
            self.b2b = _make_branch(None, (384, (3, 1), None, (1, 0)))
            self.b3_stem = _make_branch(None, (448, 1, None, None),
                                        (384, 3, None, 1))
            self.b3a = _make_branch(None, (384, (1, 3), None, (0, 1)))
            self.b3b = _make_branch(None, (384, (3, 1), None, (1, 0)))
            self.b4 = _make_branch("avg", (192, 1, None, None))

    def hybrid_forward(self, F, x):
        o1 = self.b1(x)
        s2 = self.b2_stem(x)
        o2 = F.Concat(self.b2a(s2), self.b2b(s2), dim=1)
        s3 = self.b3_stem(x)
        o3 = F.Concat(self.b3a(s3), self.b3b(s3), dim=1)
        o4 = self.b4(x)
        return F.Concat(o1, o2, o3, o4, dim=1)


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32,
                                               kernel_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=32,
                                               kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80,
                                               kernel_size=1))
            self.features.add(_make_basic_conv(channels=192,
                                               kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_InceptionE("E1_"))
            self.features.add(_InceptionE("E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def inception_v3(pretrained=False, root=None, ctx=None, **kwargs):
    return _load_pretrained(Inception3(**kwargs), "inceptionv3",
                            pretrained, root, ctx)


# ---------------------------------------------------------------------------
# MobileNet (reference model_zoo/vision/mobilenet.py — later refs; depthwise
# conv exercises grouped convolution on the MXU)
# ---------------------------------------------------------------------------

class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                self._add_conv(int(32 * multiplier), 3, 2, 1)
                dw_channels = [int(x * multiplier) for x in
                               [32, 64] + [128] * 2 + [256] * 2 +
                               [512] * 6 + [1024]]
                channels = [int(x * multiplier) for x in
                            [64] + [128] * 2 + [256] * 2 + [512] * 6 +
                            [1024] * 2]
                strides = [1, 2] * 3 + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    self._add_conv_dw(dwc, c, s)
                self.features.add(nn.GlobalAvgPool2D())
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def _add_conv(self, channels, kernel=1, stride=1, pad=0, num_group=1):
        self.features.add(nn.Conv2D(channels, kernel, stride, pad,
                                    groups=num_group, use_bias=False))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))

    def _add_conv_dw(self, dw_channels, channels, stride):
        self._add_conv(dw_channels, 3, stride, 1, num_group=dw_channels)
        self._add_conv(channels)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def mobilenet1_0(pretrained=False, root=None, ctx=None, **kwargs):
    return _load_pretrained(MobileNet(1.0, **kwargs), "mobilenet1.0",
                            pretrained, root, ctx)


def mobilenet0_75(pretrained=False, root=None, ctx=None, **kwargs):
    return _load_pretrained(MobileNet(0.75, **kwargs), "mobilenet0.75",
                            pretrained, root, ctx)


def mobilenet0_5(pretrained=False, root=None, ctx=None, **kwargs):
    return _load_pretrained(MobileNet(0.5, **kwargs), "mobilenet0.5",
                            pretrained, root, ctx)


def mobilenet0_25(pretrained=False, root=None, ctx=None, **kwargs):
    return _load_pretrained(MobileNet(0.25, **kwargs), "mobilenet0.25",
                            pretrained, root, ctx)


_models = {"resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
           "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
           "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
           "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
           "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
           "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
           "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn,
           "vgg16_bn": vgg16_bn, "vgg19_bn": vgg19_bn,
           "alexnet": alexnet,
           "densenet121": densenet121, "densenet161": densenet161,
           "densenet169": densenet169, "densenet201": densenet201,
           "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
           "inceptionv3": inception_v3,
           "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
           "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25}


def get_model(name, **kwargs):
    """Get a model by name (reference
    model_zoo/vision/__init__.py:get_model)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            "Model %s is not supported. Available options are\n\t%s" % (
                name, "\n\t".join(sorted(_models.keys()))))
    return _models[name](**kwargs)
