"""Global PRNG state — the PyTorch twin of ``mxnet_tpu/random.py``
(reference: python/mxnet/random.py, src/resource.cc kRandom pools).

The stream is the JAX package's: ONE threefry key (``_threefry``, bit-
compatible with ``jax.random``), split on every draw. ``seed(s)`` sets
it to ``PRNGKey(s)``; ``next_key()`` splits off a key for one eager op
call or one graph run (the graph folds each rng node's uid into it), so
``mx.random.seed(s)`` followed by the same calls gives the same bits in
both packages. Keys are numpy ``uint32[2]`` on the host; only a draw
over a shape runs on a device.

``numpy_rng`` is the host-side ``np.random.default_rng(s)`` of the same
seed, as in the JAX package, for the initializers' fills.
"""
from __future__ import annotations

import threading

import numpy as np

from ._threefry import PRNGKey, fold_in, random_bits, split

__all__ = ["seed", "next_key", "fork_key", "numpy_rng", "PRNGKey", "split",
           "fold_in", "random_bits"]

_state = threading.local()
_DEFAULT_SEED = 0


def numpy_rng():
    """Host-side numpy Generator tied to the same seed stream — used by
    initializers (host-side fills)."""
    if not hasattr(_state, "np_rng"):
        _state.np_rng = np.random.default_rng(_DEFAULT_SEED)
    return _state.np_rng


def _key():
    if not hasattr(_state, "key"):
        _state.key = PRNGKey(_DEFAULT_SEED)
    return _state.key


def seed(seed_state):
    """Seed all of the framework's random streams."""
    global _DEFAULT_SEED
    _DEFAULT_SEED = int(seed_state)
    _state.key = PRNGKey(int(seed_state))
    _state.np_rng = np.random.default_rng(int(seed_state))


def next_key():
    """Split off a fresh key from the global stream."""
    _state.key, sub = split(_key())
    return sub


def fork_key(n):
    """n independent keys."""
    keys = split(_key(), n + 1)
    _state.key = keys[0]
    return keys[1:]
