"""Gluon data API (reference: python/mxnet/gluon/data/)."""
from .dataset import Dataset, ArrayDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader
from . import vision
