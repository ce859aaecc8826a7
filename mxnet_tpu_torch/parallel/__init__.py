"""Parallel/distributed execution — the PyTorch twin of
``mxnet_tpu/parallel/``: the single-device training step and its fit
loop (``TrainStep``, ``make_train_step``) and the fit loop's step-indexed
fault injection (``resilience``); the mesh and sharding layouts, ring
attention, pipeline, MoE, ``dist`` and the rest of ``resilience`` come
with ROADMAP Queue A item 9.
"""
from .trainer import make_train_step, TrainStep  # noqa: F401
