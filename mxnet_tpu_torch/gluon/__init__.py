"""Gluon — the imperative high-level API, the PyTorch twin of
``mxnet_tpu/gluon`` (reference: python/mxnet/gluon/):
Parameter/Block/HybridBlock/Trainer + nn/rnn layers, losses, data
pipeline and model zoo."""
from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import rnn
from . import loss
from . import data
from . import utils
from . import model_zoo
