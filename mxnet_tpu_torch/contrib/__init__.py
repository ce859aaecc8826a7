"""Contrib: experimental / bridge modules (reference
python/mxnet/contrib/)."""
from . import tensorboard  # noqa: F401
