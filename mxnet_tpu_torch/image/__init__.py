"""Image IO + augmentation, the PyTorch package's copy of
``mxnet_tpu/image`` (reference: python/mxnet/image/ and the C++ pipeline
src/io/iter_image_recordio_2.cc)."""
from .image import *
from . import image
from .detection import ImageDetIter, CreateDetAugmenter
