"""Gluon neural-network layers (reference: python/mxnet/gluon/nn/)."""
from .basic_layers import *
from .conv_layers import *
