"""BucketingModule — variable-length inputs through a module a bucket,
the buckets sharing one parameter set; the PyTorch twin of
``mxnet_tpu/module/bucketing_module.py`` (reference
python/mxnet/module/bucketing_module.py).

Each bucket binds its own executor for its shapes; the parameters are
shared by reference through the default bucket's module, which also owns
the optimizer (the others borrow it). The computation surface is
inherited from DelegatingModule and steered by switch_bucket.
"""
from __future__ import annotations

import logging
import warnings

from ..initializer import Uniform
from .base_module import DelegatingModule, _check_input_names
from .module import Module


class BucketingModule(DelegatingModule):
    """Drives a sym_gen(bucket_key) -> (symbol, data_names, label_names)
    factory, creating one shared-parameter Module per bucket."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key

        # validate names once against the default bucket's symbol
        head_sym, head_data, head_label = sym_gen(default_bucket_key)
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])
        _check_input_names(head_sym, list(head_data or []), "data", True)
        _check_input_names(head_sym, list(head_label or []), "label",
                           False)
        _check_input_names(head_sym, self._state_names, "state", True)
        _check_input_names(head_sym, self._fixed_param_names,
                           "fixed_param", True)

        self._context = context
        self._work_load_list = work_load_list
        self._params_dirty = False
        self._reset_bind()

    # -- DelegatingModule hook ---------------------------------------------
    def _active_module(self):
        return self._curr_module

    def _new_module(self, bucket_key):
        """Instantiate the Module for one bucket."""
        sym, d_names, l_names = self._sym_gen(bucket_key)
        return Module(sym, d_names, l_names, logger=self.logger,
                      context=self._context,
                      work_load_list=self._work_load_list,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    # -- shape/name surface ------------------------------------------------
    @property
    def data_names(self):
        return (self._curr_module.data_names if self.binded
                else self._sym_gen(self._default_bucket_key)[1])

    @property
    def output_names(self):
        return (self._curr_module.output_names if self.binded
                else self._sym_gen(
                    self._default_bucket_key)[0].list_outputs())

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    # -- params ------------------------------------------------------------
    def get_params(self):
        self._require()
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        if not force_init and self.params_initialized:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def set_params(self, arg_params, aux_params,
                   allow_missing=False, force_init=True,
                   allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=False,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if not force_init and self.params_initialized:
            warnings.warn("Parameters already initialized and "
                          "force_init=False. set_params call ignored.",
                          stacklevel=2)
            return
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        self._params_dirty = True       # host copies not updated yet
        self.params_initialized = True

    # -- bind/buckets ------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Bind the default bucket; later buckets bind lazily against it."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"

        self.for_training, self.inputs_need_grad = \
            for_training, inputs_need_grad
        self.binded = True

        head = self._new_module(self._default_bucket_key)
        head.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                  force_rebind=False, shared_module=None, grad_req=grad_req)
        self._buckets = {self._default_bucket_key: head}
        self._curr_module = head
        self._curr_bucket_key = self._default_bucket_key

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = self._curr_bucket_key = None

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make bucket_key current, binding its module on first use with
        parameters shared from the default bucket."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            module = self._new_module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[
                            self._default_bucket_key],
                        grad_req=self._curr_module._grad_req)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def _switch_to(self, data_batch):
        self.switch_bucket(data_batch.bucket_key,
                           data_batch.provide_data,
                           data_batch.provide_label)

    def prepare(self, data_batch):
        """Pre-bind the upcoming batch's bucket without making it
        current."""
        self._require()
        current = self._curr_bucket_key
        self._switch_to(data_batch)
        self.switch_bucket(current, None, None)

    def forward(self, data_batch, is_train=None):
        """Switch to the batch's bucket, then run it."""
        self._require()
        self._switch_to(data_batch)
        self._curr_module.forward(data_batch, is_train=is_train)

    def update(self):
        self._params_dirty = True
        super().update()

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate",
                                          0.01),), force_init=False):
        """The current (default) bucket owns the optimizer; all other
        buckets borrow it."""
        self._require()
        if not force_init and self.optimizer_initialized:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        for module in self._buckets.values():
            if module is not self._curr_module:
                module.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        assert self.binded
        for module in self._buckets.values():
            module.install_monitor(mon)
