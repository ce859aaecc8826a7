"""SequentialModule — a chain of modules, each feeding the next; the
PyTorch twin of ``mxnet_tpu/module/sequential_module.py`` (reference
python/mxnet/module/sequential_module.py): add() with take_labels /
auto_wiring metas, chained bind/forward, reversed backward with gradient
hand-off, per-module optimizers.
"""
from __future__ import annotations

import logging

from ..initializer import Uniform
from .base_module import BaseModule


class SequentialModule(BaseModule):
    """Container chaining several modules head-to-tail."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"
    _KNOWN_METAS = frozenset({META_TAKE_LABELS, META_AUTO_WIRING})

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._meta_keys = set(self._KNOWN_METAS)  # kept for API parity

    def add(self, module, **kwargs):
        """Append a module. Metas: take_labels (this module consumes the
        chain's labels), auto_wiring (rename incoming data to this
        module's data_names)."""
        unknown = set(kwargs) - self._KNOWN_METAS
        assert not unknown, "Unknown meta %s, a typo?" % sorted(unknown)
        self._modules.append(module)
        self._metas.append(dict(kwargs))
        # topology changed: all derived state is stale
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    def _takes_labels(self, i):
        return bool(self._metas[i].get(self.META_TAKE_LABELS))

    # -- shape/name surface ------------------------------------------------
    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    # -- params ------------------------------------------------------------
    def get_params(self):
        """Union of every chained module's parameters."""
        self._require()
        arg_all, aux_all = {}, {}
        for module in self._modules:
            args, auxs = module.get_params()
            arg_all.update(args)
            aux_all.update(auxs)
        return arg_all, aux_all

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"

        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init,
                               allow_extra=allow_extra)
        self._assert_unique_param_names()
        self.params_initialized = True

    def _assert_unique_param_names(self):
        """A name claimed by two chained modules would silently alias."""
        seen_arg, seen_aux = {}, {}
        for i, module in enumerate(self._modules):
            args, auxs = module.get_params()
            for seen, names in ((seen_arg, args), (seen_aux, auxs)):
                for name in names:
                    assert name not in seen, (
                        "Duplicated parameter name: %s in layer %d (%s) "
                        "and in layer %d" % (name, i,
                                             type(module).__name__,
                                             seen[name]))
                    seen[name] = i

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Bind each module, wiring output shapes into the next one."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, "Shared module is not supported"
        assert self._modules, "Attempting to bind an empty SequentialModule"

        self.binded = True
        self.for_training, self.inputs_need_grad = \
            for_training, inputs_need_grad
        self._label_shapes = label_shapes

        flowing = data_shapes
        label_used = False
        for i, module in enumerate(self._modules):
            if self._metas[i].get(self.META_AUTO_WIRING):
                names = module.data_names
                assert len(names) == len(flowing)
                flowing = [(new, shape) for new, (_, shape) in
                           zip(names, flowing)]
            module.bind(
                data_shapes=flowing,
                label_shapes=label_shapes if self._takes_labels(i)
                else None,
                for_training=for_training,
                # interior modules always need input grads to pass back
                inputs_need_grad=bool(for_training and
                                      (inputs_need_grad or i > 0)),
                force_rebind=force_rebind, shared_module=None,
                grad_req=grad_req)
            label_used = label_used or self._takes_labels(i)
            flowing = module.output_shapes

        if not label_used:
            self._label_shapes = None

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate",
                                          0.01),), force_init=False):
        self._require()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    # -- compute -----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """Run the chain, rebatching each module's outputs as the next
        module's data."""
        from .. import io
        self._require()

        # shallow clone so bucket_key/pad/index survive while data is
        # swapped stage to stage
        batch = io.DataBatch(data=data_batch.data, label=data_batch.label,
                             pad=data_batch.pad, index=data_batch.index,
                             bucket_key=data_batch.bucket_key,
                             provide_data=data_batch.provide_data,
                             provide_label=data_batch.provide_label)
        last = len(self._modules) - 1
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i == last:
                break
            batch.data = module.get_outputs()
            batch.provide_data = [(name, out.shape) for (name, _), out in
                                  zip(module.output_shapes, batch.data)]

    def backward(self, out_grads=None):
        """Reverse pass: each module's input grads become the previous
        module's head grads."""
        self._require()
        for i in range(len(self._modules) - 1, -1, -1):
            self._modules[i].backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = self._modules[i].get_input_grads()

    def update(self):
        self._require(optimizer=True)
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):  # noqa: D102
        self._require()
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):  # noqa: D102
        self._require(inputs_grad=True)
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._require()
        for i, module in enumerate(self._modules):
            if self._takes_labels(i):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
