"""Model zoo of the port (symbolic builders): ResNet (v1 and v2),
AlexNet, VGG, Inception-BN, Inception-v3 (the whole of bench.py's image
table) and the transformer LM.

``get_symbol(network, **kw)`` keeps the JAX package's catalog names
(``mxnet_tpu/models/__init__.py``); the networks not ported yet raise
``NotImplementedError`` naming the ROADMAP item that brings them, and an
unknown name raises ``ValueError`` as there.
"""
from . import alexnet
from . import inception_bn
from . import inception_v3
from . import resnet
from . import transformer
from . import vgg


class _ResnetV1:
    """'resnet-v1' catalog entry: resnet.get_symbol(version=1)."""
    @staticmethod
    def get_symbol(**kwargs):
        kwargs.setdefault("version", 1)
        return resnet.get_symbol(**kwargs)


_CATALOG = {
    "resnet": resnet, "resnet-v1": _ResnetV1, "resnet_v1": _ResnetV1,
    "alexnet": alexnet, "vgg": vgg,
    "inception-bn": inception_bn, "inception_bn": inception_bn,
    "inception-v3": inception_v3, "inception_v3": inception_v3,
    "transformer": transformer,
}

# the JAX package's other catalog entries, ported with the model families
_NOT_PORTED = (
    "lenet", "mlp", "mobilenet", "resnext", "googlenet",
    "inception-v4", "inception_v4", "inception-resnet-v2",
    "inception_resnet_v2")


def get_symbol(network, **kwargs):
    """Build a model symbol by name (the reference train_imagenet.py
    --network flag pattern)."""
    if network in _NOT_PORTED:
        raise NotImplementedError(
            "network %r is not ported to the PyTorch package yet (ROADMAP "
            "Queue A item 10, the remaining models)" % (network,))
    try:
        module = _CATALOG[network]
    except KeyError:
        raise ValueError("unknown network %r; choose from %s"
                         % (network, sorted(set(_CATALOG)
                                            | set(_NOT_PORTED))))
    return module.get_symbol(**kwargs)
