"""Model zoo of the port (symbolic builders): LeNet, MLP, ResNet (v1 and
v2), ResNeXt, AlexNet, VGG, MobileNet, GoogLeNet, Inception-BN,
Inception-v3, Inception-v4, Inception-ResNet-v2 and the transformer LM.

``get_symbol(network, **kw)`` keeps the JAX package's catalog names and
aliases (``mxnet_tpu/models/__init__.py``); an unknown name raises
``ValueError`` as there.
"""
from . import alexnet
from . import googlenet
from . import inception_bn
from . import inception_resnet_v2
from . import inception_v3
from . import inception_v4
from . import lenet
from . import mlp
from . import mobilenet
from . import resnet
from . import resnext
from . import transformer
from . import vgg


class _ResnetV1:
    """'resnet-v1' catalog entry: resnet.get_symbol(version=1)."""
    @staticmethod
    def get_symbol(**kwargs):
        kwargs.setdefault("version", 1)
        return resnet.get_symbol(**kwargs)


_CATALOG = {
    "lenet": lenet, "mlp": mlp, "resnet": resnet, "alexnet": alexnet,
    "vgg": vgg, "mobilenet": mobilenet, "resnext": resnext,
    "googlenet": googlenet,
    "resnet-v1": _ResnetV1, "resnet_v1": _ResnetV1,
    "inception-bn": inception_bn, "inception_bn": inception_bn,
    "inception-v3": inception_v3, "inception_v3": inception_v3,
    "inception-v4": inception_v4, "inception_v4": inception_v4,
    "inception-resnet-v2": inception_resnet_v2,
    "inception_resnet_v2": inception_resnet_v2,
    "transformer": transformer,
}


def get_symbol(network, **kwargs):
    """Build a model symbol by name (the reference train_imagenet.py
    --network flag pattern)."""
    try:
        module = _CATALOG[network]
    except KeyError:
        raise ValueError("unknown network %r; choose from %s"
                         % (network, sorted(_CATALOG)))
    return module.get_symbol(**kwargs)
