"""Learning-rate schedulers — a copy of ``mxnet_tpu/lr_scheduler.py``
(reference: python/mxnet/lr_scheduler.py), which holds no JAX.

Schedulers are host-side Python, called with the global update count
(``Optimizer.update``, ``TrainStep.fit``); the lr enters each update as
a scalar, so a schedule never changes the step's shapes.

Unlike the reference (which walks a mutable counter forward on every
call), these compute the lr in closed form from ``num_update`` alone:
safe to pickle mid-run, to query out of order (resuming from a
checkpoint at an arbitrary update count), and to replay independently
on several workers.
"""
from __future__ import annotations

import bisect
import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base: maps num_update -> lr (reference lr_scheduler.py:LRScheduler)."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError("must override this")

    def _announce(self, num_update, lr):
        # log once per distinct lr value, mirroring the reference's
        # step-transition messages without replaying its counter walk
        if getattr(self, "_last_logged", None) != lr:
            self._last_logged = lr
            logging.info("lr schedule: update %d -> %.5e", num_update, lr)


class FactorScheduler(LRScheduler):
    """lr = base_lr * factor^k, k = completed `step`-sized intervals,
    floored at stop_factor_lr (reference lr_scheduler.py:FactorScheduler)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update):
        k = max(0, num_update - 1) // self.step
        lr = max(self.base_lr * self.factor ** k, self.stop_factor_lr)
        self._announce(num_update, lr)
        return lr


class MultiFactorScheduler(LRScheduler):
    """lr decays by `factor` at each boundary in the sorted `step` list
    (reference lr_scheduler.py:MultiFactorScheduler)."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of ints")
        if any(s < 1 for s in step) or any(
                b <= a for a, b in zip(step, step[1:])):
            raise ValueError("step must be an increasing list of ints >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step = step
        self.factor = factor

    def __call__(self, num_update):
        # boundaries crossed = how many entries are < num_update
        k = bisect.bisect_left(self.step, num_update)
        lr = self.base_lr * self.factor ** k
        self._announce(num_update, lr)
        return lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to zero over max_update steps (present in later
    reference versions; included for the image-classification recipes)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        if int(max_update) < 1:
            raise ValueError("max_update must be >= 1")
        self.max_update = int(max_update)
        self.power = pwr

    def __call__(self, num_update):
        frac = min(float(num_update), self.max_update) / self.max_update
        return self.base_lr * (1.0 - frac) ** self.power


class CosineScheduler(LRScheduler):
    """Linear warmup then cosine decay (a default of vision recipes;
    an extension beyond the reference's catalog)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0,
                 warmup_steps=0, warmup_begin_lr=0.0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.final_lr = final_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            frac = num_update / max(1, self.warmup_steps)
            return self.warmup_begin_lr + frac * (
                self.base_lr - self.warmup_begin_lr)
        span = max(1, self.max_update - self.warmup_steps)
        t = min(num_update - self.warmup_steps, span)
        cos = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return self.final_lr + cos * (self.base_lr - self.final_lr)
