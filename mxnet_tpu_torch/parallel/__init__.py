"""Parallel/distributed execution — the PyTorch twin of
``mxnet_tpu/parallel/``. This slice ports the single-device training
step (``TrainStep``, ``make_train_step``); the mesh and sharding
layouts, ring attention, pipeline, MoE and ``dist`` come with ROADMAP
Queue A item 9.
"""
from .trainer import make_train_step, TrainStep  # noqa: F401
