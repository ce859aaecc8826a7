"""Gluon Parameter / ParameterDict — the PyTorch twin of
``mxnet_tpu/gluon/parameter.py`` (reference:
python/mxnet/gluon/parameter.py, 606 LoC).

A parameter owns ONE NDArray, placed on the first context it is
initialized on (``gpu(0)`` by default, as every entry point of the
port); ``list_ctx`` reports the contexts it was given, as the JAX
package's does. Its data is a marked variable of ``autograd``: the
torch tensor behind it is a leaf tagged with its owner
(``autograd._leaf_for``), so a ``backward`` through eager ops or a
hybridized graph reaches it, and every write (an optimizer update,
``set_data``, a load) gives the array a fresh leaf. ``save``/``load``
use ``nd.save``'s format, the JAX package's, both ways.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import autograd
from .. import initializer as init_mod
from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray import NDArray
from .. import ndarray as nd

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """Error for unfinished deferred initialization (reference
    parameter.py:DeferredInitializationError)."""


class Parameter:
    """A Block parameter (reference parameter.py:Parameter).

    Supports deferred initialization: shape may contain 0s until the first
    forward infers them."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._data = None
        self._grad = None
        self._deferred_init = ()
        self._ctx = None
        self._grad_req = None
        self.grad_req = grad_req

    def __repr__(self):
        s = "Parameter {name} (shape={shape}, dtype={dtype})"
        return s.format(name=self.name, shape=self.shape, dtype=self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req %r not in write/add/null" % (req,))
        if not self._differentiable:
            req = "null"
        if self._grad_req != req:
            self._grad_req = req
            if req == "null":
                self._grad = None
                if self._data is not None:
                    # no longer a variable: a plain tensor, no gradient
                    self._data._grad, self._data._grad_req = None, "null"
                    self._data._data = self._data._data.detach()
            elif self._data is not None and self._grad is None:
                self._init_grad()
            elif self._data is not None:
                self._data._grad_req = req

    def _check_initialized(self, ctx=None):
        if self._data is not None:
            return
        if self._deferred_init:
            raise DeferredInitializationError(
                "parameter %s is deferred-initialized: its shape is only "
                "known after the first forward pass, so run one batch "
                "through the block before touching its arrays" % self.name)
        raise RuntimeError(
            "parameter %s was never initialized — call .initialize() (via "
            "Block.collect_params(), which also covers child blocks)"
            % self.name)

    def _load_init(self, data, ctx):
        """Initialize from loaded data (reference
        parameter.py:_load_init)."""
        known = self.shape or ()
        if any(want not in (0, got)
               for want, got in zip(known, data.shape)):
            raise ValueError(
                "saved array for %s has shape %s, parameter wants %s"
                % (self.name, tuple(data.shape), self.shape))
        if self.dtype and np.dtype(self.dtype) != np.dtype(data.dtype):
            data = data.astype(self.dtype)
        if self._data is None:
            # a deferred parameter keeps the contexts it was given
            if ctx is None and self._deferred_init:
                ctx = self._deferred_init[1]
            self._init_impl(data, ctx)
        else:
            self.set_data(data)
        self._deferred_init = ()

    def _finish_deferred_init(self):
        """Finish deferred init (reference
        parameter.py:_finish_deferred_init)."""
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        self._deferred_init = ()
        # shape () is a valid scalar; None or any 0-dim means unknown
        if self.shape is None or int(np.prod(self.shape)) <= 0:
            raise ValueError(
                "parameter %s still has unknown shape %s after deferred "
                "init; give the block explicit in_units/in_channels"
                % (self.name, self.shape))

        with autograd.pause():
            data = nd.zeros(self.shape, ctx=ctx[0], dtype=self.dtype)
            # an explicit per-param initializer overrides via the
            # __init__ attr; otherwise the default dispatches by name
            # suffix (so SymbolBlock-created *_gamma/*_beta/aux params
            # get their conventional fills, not e.g. Xavier). Names
            # matching no suffix fall back to the default's weight fill.
            attrs = {"__init__": init} if init is not None else {}
            desc = init_mod.InitDesc(self.name, attrs)
            filler = init_mod.create(default_init)
            try:
                filler(desc, data)
            except init_mod.InitPatternError:
                # name matches no suffix convention -> weight fill; any
                # other ValueError is a real error and propagates
                filler._init_weight(desc, data)
            self._init_impl(data, ctx)

    def _init_impl(self, data, ctx_list):
        """Set data: one array, on the first of ``ctx_list`` (the current
        context when None)."""
        if isinstance(ctx_list, Context):
            ctx_list = [ctx_list]
        ctx_list = ctx_list or [current_context()]
        if not isinstance(data, NDArray):
            data = nd.array(data, ctx=ctx_list[0], dtype=self.dtype)
        elif data.context != ctx_list[0]:
            data = data.as_in_context(ctx_list[0])
        else:
            data = NDArray(data._data.detach())
        self._data = data
        self._ctx = ctx_list
        self.shape = tuple(data.shape)
        if self._grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        self._grad = nd.zeros_like(self._data)
        autograd.mark_variables([self._data], [self._grad],
                                grad_reqs=self._grad_req)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize data+grad (reference parameter.py:initialize)."""
        if self._data is not None and not force_reinit:
            warnings.warn("parameter %s already initialized; pass "
                          "force_reinit=True to redo" % self.name,
                          stacklevel=2)
            return
        self._data = self._grad = None
        default_init = default_init or init_mod.Uniform()
        ctx = [ctx] if isinstance(ctx, Context) else \
            (ctx or [current_context()])
        shape_known = self.shape is not None and \
            int(np.prod(self.shape)) > 0
        if not shape_known and not self.allow_deferred_init:
            raise ValueError("parameter %s has unknown shape %s and "
                             "allow_deferred_init is off"
                             % (self.name, self.shape))
        # keep "no explicit initializer" as None so _finish can fall
        # back to the default's name-suffix dispatch
        self._deferred_init = (init or self.init, ctx, default_init)
        if shape_known:
            self._finish_deferred_init()

    def reset_ctx(self, ctx):
        """Re-place on new context(s) (reference
        parameter.py:reset_ctx)."""
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data is not None:
            self._data = self._data.as_in_context(ctx[0])
            self._ctx = ctx
        elif self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)
        else:
            raise ValueError("Cannot reset context for Parameter %s "
                             "because it has not been initialized." %
                             self.name)

    def set_data(self, data):
        """Assign new data (reference parameter.py:set_data)."""
        assert self._data is not None, \
            "Parameter %s has not been initialized" % self.name
        dst = self._data._data
        src = data._data.detach() if isinstance(data, NDArray) else \
            torch.as_tensor(np.asarray(data))
        self._data._set_data(src.to(device=dst.device, dtype=dst.dtype))

    def data(self, ctx=None):
        """The data array (reference parameter.py:data)."""
        self._check_initialized(ctx)
        return self._data

    def list_data(self):
        self._check_initialized()
        return [self._data]

    def grad(self, ctx=None):
        """The gradient buffer (reference parameter.py:grad)."""
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter %s because "
                "grad_req='null'" % self.name)
        self._check_initialized(ctx)
        return self._grad

    def list_grad(self):
        self._check_initialized()
        assert self._grad is not None, \
            "Parameter %s does not have gradients because grad_req='null'" \
            % self.name
        return [self._grad]

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return self._deferred_init[1]
            raise RuntimeError("Parameter %s has not been initialized" %
                               self.name)
        return self._ctx or [current_context()]

    def zero_grad(self):
        """Zero the gradient buffer (reference parameter.py:zero_grad)."""
        if self._grad is None:
            return
        self._grad._set_data(torch.zeros_like(self._grad._data))

    def var(self):
        """Symbol of this parameter (reference parameter.py:var)."""
        from .. import symbol
        return symbol.var(self.name, shape=self.shape, dtype=self.dtype,
                          lr_mult=self.lr_mult, wd_mult=self.wd_mult,
                          init=self.init)

    def cast(self, dtype):
        """Cast data/grad to a new dtype (reference
        parameter.py:cast)."""
        self.dtype = dtype
        if self._data is None:
            return
        with autograd.pause():
            self._data = self._data.astype(dtype)
            if self._grad is not None:
                self._grad = self._grad.astype(dtype)
                autograd.mark_variables([self._data], [self._grad],
                                        grad_reqs=self._grad_req)


class ParameterDict:
    """Dict of Parameters with prefix + shared-dict lookup (reference
    parameter.py:ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}  # insertion-ordered
        self._shared = shared

    def __repr__(self):
        s = "{name}(\n{content}\n)"
        name = self._prefix + " " if self._prefix else ""
        return s.format(name=name, content="\n".join(
            [repr(v).replace("\n", "\n  ") for v in self.values()]))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._shared._params[name]
        return None

    @staticmethod
    def _merge_shapes(want, have):
        """Unify two shapes where 0 means 'unknown'; None if they
        conflict."""
        if len(want) != len(have):
            return None
        merged = []
        for a, b in zip(want, have):
            if a and b and a != b:
                return None
            merged.append(a or b)
        return tuple(merged)

    def get(self, name, **kwargs):
        """Get or create parameter `prefix+name`; on a hit, reconcile the
        requested attrs with the stored ones (reference
        parameter.py:get)."""
        name = self.prefix + name
        param = self._get_impl(name)
        if param is None:
            param = self._params[name] = Parameter(name, **kwargs)
            return param
        for k, v in kwargs.items():
            stored = getattr(param, k, None)
            if stored is None:
                setattr(param, k, v)
                continue
            if k == "shape" and v is not None:
                merged = self._merge_shapes(tuple(v), tuple(stored))
                if merged is not None:
                    param.shape = merged
                    continue
            elif k == "dtype" and np.dtype(v) == np.dtype(stored):
                continue
            if v is not None and v != stored:
                raise ValueError(
                    "parameter %s already exists with %s=%s; requested "
                    "%s is incompatible" % (name, k, stored, v))
        return param

    def update(self, other):
        """Merge another ParameterDict (reference
        parameter.py:update)."""
        for k, v in other.items():
            mine = self._params.setdefault(k, v)
            if mine is not v:
                raise ValueError("both dicts own a different parameter "
                                 "named %s" % k)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize all (reference parameter.py:initialize)."""
        if init is None:
            init = init_mod.Uniform()
        if verbose:
            init.set_verbosity(verbose=verbose)
        for _, v in self.items():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set an attribute on all parameters (reference
        parameter.py:setattr)."""
        for v in self.values():
            setattr(v, name, value)

    def _check_prefix(self, prefix, what):
        bad = [n for n in self.keys() if not n.startswith(prefix)]
        if bad:
            raise ValueError("%s=%r does not prefix parameter %s"
                             % (what, prefix, bad[0]))

    def save(self, filename, strip_prefix=""):
        """Save to .params file (reference parameter.py:save)."""
        if strip_prefix:
            self._check_prefix(strip_prefix, "strip_prefix")
        nd.save(filename, {p.name[len(strip_prefix):]: p.data()
                           for p in self.values()})

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load from .params file (reference parameter.py:load)."""
        if restore_prefix:
            self._check_prefix(restore_prefix, "restore_prefix")
        loaded = {restore_prefix + k: v
                  for k, v in nd.load(filename).items()}
        missing = set(self.keys()) - set(loaded)
        if missing and not allow_missing:
            raise ValueError("file %s lacks parameters: %s"
                             % (filename, sorted(missing)))
        for name, arr in loaded.items():
            if name in self._params:
                self._params[name]._load_init(arr, ctx)
            elif not ignore_extra:
                raise ValueError("file %s has unexpected parameter %s "
                                 "(pass ignore_extra=True to skip)"
                                 % (filename, name))
