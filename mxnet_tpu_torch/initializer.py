"""Weight initializers — the port's copy of ``mxnet_tpu/initializer.py``.

Reference: python/mxnet/initializer.py (726 LoC; classes at :375-675).
Initializers fill host-side numpy and the caller transfers once — init
is not a hot path, and host-side fills keep the device free of
per-parameter tiny kernels. The fills draw from ``random.numpy_rng()``,
the same ``np.random.default_rng(seed)`` stream as the JAX package, so
after ``mx.random.seed(s)`` both packages initialize bit-identical
values. Descriptor-driven dispatch (by name suffix:
weight/bias/gamma/beta/...) matches the reference's
``Initializer.__call__`` protocol. ``FusedRNN`` unpacks the fused RNN
blob through ``rnn.FusedRNNCell``'s layout, fills each gate array, and
packs it back.
"""
from __future__ import annotations

import json
import re

import numpy as np

from .base import string_types
from . import registry as _registry
from . import random as _random

__all__ = ["InitDesc", "InitPatternError", "Initializer", "register",
           "Zero", "One", "Constant", "Uniform", "Normal", "Orthogonal",
           "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias", "Load", "Mixed"]


class InitPatternError(ValueError):
    """A parameter name matched no known *weight/*bias/*gamma/*beta
    suffix. Distinct type so callers that fall back to a plain weight
    fill (gluon deferred init) don't swallow genuine initializer
    ValueErrors (bad shape etc.)."""


class InitDesc(str):
    """Name + attrs descriptor of a parameter to initialize
    (reference initializer.py:InitDesc)."""
    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer (reference initializer.py:Initializer).

    Subclasses implement ``_init_weight``; dispatch by name pattern mirrors
    the reference's ``__call__``. Constructor kwargs are recorded for
    ``dumps()`` and auto-assigned as attributes."""

    # parameter-name suffix -> fill method; checked in order, first match
    # wins (reference dispatches the same suffixes in its __call__)
    _SUFFIX_FILLS = (
        ("weight", "_init_weight"),
        ("bias", "_init_bias"),
        ("gamma", "_init_gamma"),
        ("beta", "_init_beta"),
        ("min", "_init_zero"),
        ("max", "_init_one"),
        ("moving_mean", "_init_zero"),
        ("running_mean", "_init_zero"),
        ("moving_var", "_init_one"),
        ("running_var", "_init_one"),
        ("moving_inv_var", "_init_zero"),
        ("moving_avg", "_init_zero"),
    )

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self.__dict__.update(kwargs)
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose = verbose
        if print_func is None:
            def asum_stat(x):
                return str((np.abs(x).sum() / x.size,))
            print_func = asum_stat
        self._print_func = print_func
        return self

    def _verbose_print(self, desc, init, arr):
        if self._verbose and self._print_func:
            import logging
            logging.info("Initialized %s as %s: %s", desc, init,
                         self._print_func(arr))

    def dumps(self):
        """JSON [name, kwargs] — reference initializer.py:dumps."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        """Initialize ``arr`` (mutated via [:] assignment) per ``desc``."""
        if not isinstance(desc, string_types):
            raise TypeError("desc must be a string / InitDesc")
        if isinstance(desc, InitDesc) and desc.global_init is None:
            desc.global_init = self

        init = getattr(desc, "attrs", {}).get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr)
            self._verbose_print(desc, init, arr)
            return

        name = desc.lower()
        for suffix, meth in self._SUFFIX_FILLS:
            if name.endswith(suffix):
                getattr(self, meth)(desc, arr)
                if suffix == "weight":
                    self._verbose_print(desc, "weight", arr)
                return
        self._init_default(desc, arr)

    # -- fill helpers (each mutates the NDArray in place) -------------------
    @staticmethod
    def _set(arr, value):
        arr[:] = value

    def _init_zero(self, _, arr):
        self._set(arr, np.zeros(arr.shape, dtype=np.float32))

    def _init_one(self, _, arr):
        self._set(arr, np.ones(arr.shape, dtype=np.float32))

    def _init_bias(self, _, arr):
        self._init_zero(_, arr)

    def _init_gamma(self, _, arr):
        self._init_one(_, arr)

    def _init_beta(self, _, arr):
        self._init_zero(_, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override _init_weight")

    def _init_default(self, name, arr):
        raise InitPatternError(
            "Unknown initialization pattern for %s. Default initialization "
            "is now limited to *weight/*bias/*gamma/*beta. Either assign a "
            "name to the variable matching those patterns, or use "
            "mx.sym.Variable(init=mx.init.*) to set initialization." % name)


# generic registry (reference registry.py + initializer.register)
register = _registry.get_register_func(Initializer, "initializer")
alias = _registry.get_alias_func(Initializer, "initializer")
create = _registry.get_create_func(Initializer, "initializer")


def _rand(shape, sampler, *args):
    """Host-side sample via the framework seed (mx.random.seed coherent)."""
    return sampler(_random.numpy_rng(), *args, shape)


@register
@alias("zeros")
class Zero(Initializer):
    def __init__(self):
        super().__init__()

    def _init_weight(self, _, arr):
        self._set(arr, np.zeros(arr.shape, np.float32))


@register
@alias("ones")
class One(Initializer):
    def __init__(self):
        super().__init__()

    def _init_weight(self, _, arr):
        self._set(arr, np.ones(arr.shape, np.float32))


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)

    def _init_weight(self, _, arr):
        self._set(arr, np.full(arr.shape, self.value, np.float32))


@register
class Uniform(Initializer):
    """U(-scale, scale) — reference initializer.py:Uniform."""
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)

    def _init_weight(self, _, arr):
        self._set(arr, _rand(arr.shape, lambda r, lo, hi, s:
                             r.uniform(lo, hi, s), -self.scale, self.scale))


@register
class Normal(Initializer):
    """N(0, sigma) — reference initializer.py:Normal."""
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)

    def _init_weight(self, _, arr):
        self._set(arr, _rand(arr.shape,
                             lambda r, s, sh: r.normal(0.0, s, sh),
                             self.sigma))


@register
class Orthogonal(Initializer):
    """Orthogonal matrix init (reference initializer.py:Orthogonal;
    Saxe et al. / Exact solutions to nonlinear dynamics)."""
    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        rng = _random.numpy_rng()
        if self.rand_type == "uniform":
            tmp = rng.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = rng.normal(0.0, 1.0, (nout, nin))
        u, _s, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        self._set(arr, (self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Xavier/Glorot (reference initializer.py:Xavier)."""

    _FACTORS = {"avg": lambda fi, fo: (fi + fo) / 2.0,
                "in": lambda fi, fo: fi,
                "out": lambda fi, fo: fo}

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=float(magnitude))

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError(
                "Xavier needs a >=2D parameter, got %s for %s"
                % (shape, name))
        # fan counts over the receptive field for conv-style kernels
        rfield = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        try:
            factor = self._FACTORS[self.factor_type](shape[1] * rfield,
                                                     shape[0] * rfield)
        except KeyError:
            raise ValueError("factor_type must be avg/in/out")
        scale = np.sqrt(self.magnitude / factor)
        rng = _random.numpy_rng()
        if self.rnd_type == "uniform":
            self._set(arr, rng.uniform(-scale, scale, shape))
        elif self.rnd_type == "gaussian":
            self._set(arr, rng.normal(0, scale, shape))
        else:
            raise ValueError("rnd_type must be uniform/gaussian")


@register
class MSRAPrelu(Xavier):
    """He init for PReLU nets (reference initializer.py:MSRAPrelu)."""
    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernel (reference initializer.py:Bilinear)."""
    def __init__(self):
        super().__init__()

    def _init_weight(self, _, arr):
        weight = np.zeros(int(np.prod(arr.shape)), dtype=np.float32)
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        self._set(arr, weight.reshape(shape))


@register
class LSTMBias(Initializer):
    """Init LSTM bias with forget gate bias (reference
    initializer.py:LSTMBias): gate order is [i, f, o, c]."""
    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = np.zeros(arr.shape, np.float32)
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)


class Load:
    """Init from a dict of arrays, falling back to ``default_init``
    (reference initializer.py:Load)."""
    def __init__(self, param, default_init=None, verbose=False):
        # strip the nd.save "arg:"/"aux:" prefixes
        self.param = {k.split(":", 1)[-1] if k[:4] in ("arg:", "aux:")
                      else k: v for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def _log(self, name, how):
        if self.verbose:
            import logging
            logging.info("param %s initialized %s", name, how)

    def __call__(self, name, arr):
        src = self.param.get(name)
        if src is not None:
            if tuple(arr.shape) != tuple(src.shape):
                raise ValueError(
                    "loaded shape %s does not match parameter %s shape %s"
                    % (tuple(src.shape), name, tuple(arr.shape)))
            arr[:] = src
            self._log(name, "from loaded params")
        elif self.default_init is not None:
            self.default_init(name, arr)
            self._log(name, "by fallback initializer")
        else:
            raise ValueError(
                "%s absent from loaded params and no default_init given"
                % name)


class Mixed:
    """Name-pattern-routed mixed initializer (reference
    initializer.py:Mixed)."""
    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("need one initializer per pattern")
        self.map = [(re.compile(p), init)
                    for p, init in zip(patterns, initializers)]

    def __call__(self, name, arr):
        init = next((i for prog, i in self.map if prog.match(name)), None)
        if init is None:
            raise ValueError(
                'no pattern matched parameter %s (add a catch-all ".*" '
                "pattern with a default initializer)" % name)
        init(name, arr)


@register
class FusedRNN(Initializer):
    """Initialize packed fused-RNN parameter blobs by unpacking to
    per-gate weights, initializing each, and repacking
    (reference initializer.py:FusedRNN)."""
    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = _registry.get_registry(Initializer)[klass.lower()](**kwargs)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .rnn import rnn_cell
        cell = rnn_cell.FusedRNNCell(self._num_hidden, self._num_layers,
                                     self._mode, self._bidirectional,
                                     forget_bias=self._forget_bias,
                                     prefix="")
        init_fn = self._init or getattr(desc, "global_init", None)
        if init_fn is None:
            raise ValueError(
                "FusedRNN(init=None) needs an InitDesc with global_init")
        blob = np.array(arr.asnumpy() if hasattr(arr, "asnumpy") else arr,
                        dtype=np.float32).reshape(-1)
        entries, _ = cell._blob_slices(cell._infer_input_size(blob.size))
        # the JAX package's order: each unpacked gate array in blob order
        for name, sl, shape in entries:
            piece = blob[sl].reshape(shape).copy()
            if self._mode == "lstm" and name.endswith("_f_bias"):
                # forget-gate bias lives in the i2h bias (same convention
                # as LSTMCell + LSTMBias); h2h forget bias stays zero
                piece[:] = self._forget_bias if "i2h" in name else 0.0
            else:
                # fresh attrs: inheriting the parent's __init__ attr would
                # re-dispatch back into this initializer
                init_fn(InitDesc(name, global_init=getattr(
                    desc, "global_init", None)), piece)
            blob[sl] = piece.reshape(-1)
        arr[:] = blob.reshape(arr.shape)
