"""Global PRNG state — the PyTorch twin of ``mxnet_tpu/random.py``
(reference: python/mxnet/random.py, src/resource.cc kRandom pools).

``seed(s)`` reseeds two streams. The host-side numpy Generator
(``numpy_rng``) is ``np.random.default_rng(s)`` exactly as in the JAX
package, so initializers fill bit-identical values in both packages from
one seed. The device-side stream hands out integer seeds (``next_key``,
``fork_key``) from a ``torch.Generator``: the training step and the graph
fold them per node into generators of their own. Those are torch's bits,
not jax's threefry bits, so random ops agree with the JAX package in
distribution, not value.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["seed", "next_key", "fork_key", "numpy_rng"]

_state = threading.local()
_DEFAULT_SEED = 0
_SEED_BOUND = 2 ** 63 - 1


def numpy_rng():
    """Host-side numpy Generator tied to the same seed stream — used by
    initializers (host-side fills)."""
    if not hasattr(_state, "np_rng"):
        _state.np_rng = np.random.default_rng(_DEFAULT_SEED)
    return _state.np_rng


def _generator():
    if not hasattr(_state, "gen"):
        _state.gen = torch.Generator().manual_seed(_DEFAULT_SEED)
    return _state.gen


def seed(seed_state):
    """Seed all of the framework's random streams."""
    global _DEFAULT_SEED
    _DEFAULT_SEED = int(seed_state)
    _state.gen = torch.Generator().manual_seed(int(seed_state))
    _state.np_rng = np.random.default_rng(int(seed_state))


def next_key():
    """A fresh integer seed from the global stream."""
    return int(torch.randint(0, _SEED_BOUND, (1,),
                             generator=_generator()).item())


def fork_key(n):
    """n independent integer seeds."""
    return [int(x) for x in torch.randint(0, _SEED_BOUND, (int(n),),
                                          generator=_generator())]
