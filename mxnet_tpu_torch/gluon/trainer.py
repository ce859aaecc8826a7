"""Gluon Trainer — the PyTorch twin of ``mxnet_tpu/gluon/trainer.py``
(reference surface: python/mxnet/gluon/trainer.py).

Each Parameter is ONE array, so the reference's push/pull tree reduces
to an optional kvstore round trip (``model._create_kvstore``: none on one
local device). ``step`` applies the optimizer through its ``Updater``
one parameter at a time, as the JAX Trainer does: each update is the
registry's fused update op (``sgd_mom_update``, ``adam_update`` ...) on
that parameter's tensors. ``save_states`` writes the port's pickle of
the updater's states and the optimizer; ``load_states`` reads it with
the parameter server's unpickler, which resolves only builtins, numpy
and this package, so a JAX package's optimizer pickle is refused.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..model import _create_kvstore
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _as_param_list(params):
    if isinstance(params, (dict, ParameterDict)):
        params = list(params.values())
    if not isinstance(params, (list, tuple)):
        raise ValueError(
            "Trainer expects a list or dict of Parameters; got %r"
            % (type(params),))
    for p in params:
        if not isinstance(p, Parameter):
            raise ValueError(
                "Trainer expects Parameters; the list contains %r"
                % (type(p),))
    return list(params)


class Trainer:
    """Drives one optimizer over a parameter set; ``step(batch_size)``
    rescales summed gradients and applies the fused update."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None):
        self._params = _as_param_list(params)
        self._ctx = self._common_context()
        kwargs = dict(optimizer_params or {})
        self._scale = kwargs.get("rescale_grad", 1.0)

        by_index = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if kwargs:
                raise AssertionError(
                    "optimizer_params must be None when optimizer is an "
                    "Optimizer instance (configure the instance instead)")
            self._optimizer = optimizer
            self._optimizer.param_dict = by_index
        else:
            self._optimizer = opt.create(optimizer, param_dict=by_index,
                                         **kwargs)
        self._updater = opt.get_updater(self._optimizer)

        self._kvstore_kind = kvstore
        self._kvstore_obj = None
        self._update_on_kvstore = False
        self._kv_initialized = False

    def _common_context(self):
        """All params must live on one context set (the reference
        requirement; with one logical copy it is a sanity check)."""
        seen = None
        for p in self._params:
            ctx = p.list_ctx()
            if seen is not None and ctx != seen:
                raise AssertionError(
                    "Parameter %s lives on %s but earlier parameters "
                    "live on %s — initialize all parameters on one "
                    "context set" % (p.name, ctx, seen))
            seen = ctx
        return seen

    def _ensure_kvstore(self):
        if self._kv_initialized:
            return
        weights = {p.name: p.data() for p in self._params}
        kv, update_on_kv = _create_kvstore(
            self._kvstore_kind, len(self._ctx or [None]), weights)
        if kv is not None:
            # the reference's gluon Trainer forces the local-updater mode
            # for dist kvstores (trainer.py:106-107); with one logical
            # parameter copy that mode is always the correct one
            update_on_kv = False
            for i, p in enumerate(self._params):
                kv.init(i, p.data())
        self._kvstore_obj = kv
        self._update_on_kvstore = update_on_kv
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One update over every trainable parameter; gradients are
        divided by ``batch_size`` (gluon losses sum over the batch)."""
        self._ensure_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size

        # ignore_stale_grad is accepted for API compatibility; stale-grad
        # bookkeeping (_fresh_grad) is a post-0.11 reference feature.
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if self._kvstore_obj is not None:
                self._kvstore_obj.push(i, p.list_grad(), priority=-i)
                target = p.list_data() if self._update_on_kvstore \
                    else p.list_grad()
                self._kvstore_obj.pull(i, target, priority=-i)
                if self._update_on_kvstore:
                    continue
            self._updater(i, p.grad(), p.data())

    def save_states(self, fname):
        """Serialize updater + optimizer state to ``fname`` (the
        optimizer without its parameters: ``load_states`` points it at
        this Trainer's)."""
        self._ensure_kvstore()
        params, self._optimizer.param_dict = self._optimizer.param_dict, {}
        try:
            blob = self._updater.get_states(dump_optimizer=True)
        finally:
            self._optimizer.param_dict = params
        with open(fname, "wb") as f:
            f.write(blob)

    def load_states(self, fname):
        """Restore updater + optimizer state saved by save_states;
        ``pickle.UnpicklingError`` for a file that names a class outside
        builtins, numpy and this package."""
        from ..parallel.ps_async import _loads
        self._ensure_kvstore()
        with open(fname, "rb") as f:
            states = _loads(f.read())
        if isinstance(states, tuple) and len(states) == 2:
            self._updater.states, self._updater.optimizer = states
        else:
            self._updater.states = states
        self._updater.states_synced = dict.fromkeys(
            self._updater.states, False)
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
