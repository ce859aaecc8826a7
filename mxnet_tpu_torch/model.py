"""Model helpers — the PyTorch twin of ``mxnet_tpu/model.py`` (reference
python/mxnet/model.py): ``BatchEndParam``, the kvstore plumbing of the
Module's update, checkpoints and the legacy ``FeedForward`` API, an
adapter over ``module.Module``.

Checkpoints keep the JAX package's file format: ``prefix-symbol.json``
and ``prefix-NNNN.params`` (the ``.npz`` container, keys prefixed
``arg:`` / ``aux:``), so a checkpoint written by either package loads in
the other.
"""
from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np

from . import guardrail
from . import io
from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym
from .base import string_types
from .context import Context
from .initializer import Uniform
from .ndarray import NDArray

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "FeedForward"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


# params bigger than this make store-side ("on-kvstore") updates a
# bandwidth loss for local training: update on the worker instead
_BIG_PARAM_ELEMS = 16 * 1024 * 1024


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore) (reference model.py:96-135): none on
    one local device, where there is nothing to reduce."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, kvs.KVStore):
        return kvstore, True
    if not isinstance(kvstore, string_types):
        raise TypeError("kvstore must be KVStore, str or None")
    if num_device == 1 and "dist" not in kvstore:
        return None, False
    kv = kvs.create(kvstore)
    on_kv = True
    if kvstore == "local" and any(
            np.prod(p.shape) > _BIG_PARAM_ELEMS
            for p in arg_params.values()):
        on_kv = False
    return kv, on_kv


def _trainable(param_arrays, grad_arrays, param_names=None):
    """(index, name, weights per device, grads per device), skipping
    frozen params (grad None)."""
    for i, (w_list, g_list) in enumerate(zip(param_arrays, grad_arrays)):
        if g_list[0] is not None:
            yield i, param_names[i] if param_names else None, \
                w_list, g_list


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Init the store's entries from the current params (reference
    model.py:_initialize_kvstore)."""
    for idx, name in enumerate(param_names):
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_arrays[idx], priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push the grads, pull the updated weights (reference
    model.py:105-116)."""
    for i, name, w_list, g_list in _trainable(param_arrays, grad_arrays,
                                              param_names):
        kvstore.push(name, g_list, priority=-i)
        kvstore.pull(name, w_list, priority=-i)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The worker-side update, after reducing the grads through the
    kvstore when there is one (reference model.py:_update_params)."""
    for i, name, w_list, g_list in _trainable(param_arrays, grad_arrays,
                                              param_names):
        if kvstore:
            kvstore.push(name, g_list, priority=-i)
            kvstore.pull(name, g_list, priority=-i)
        for dev, (w, g) in enumerate(zip(w_list, g_list)):
            updater(i * num_device + dev, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write prefix-symbol.json + prefix-NNNN.params (reference
    model.py:340). Values are NDArrays or tensors, saved from the host.
    The params file is published crash-durably: written to a temporary
    name, then fsync'd and renamed over the destination."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {"arg:%s" % k: NDArray(v) for k, v in arg_params.items()}
    save_dict.update({"aux:%s" % k: NDArray(v)
                      for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    tmp_name = param_name + ".tmp"
    nd.save(tmp_name, save_dict)
    guardrail.durable_replace(tmp_name, param_name)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """Load (symbol, arg_params, aux_params) from a checkpoint (reference
    model.py:370); the arrays land on the current context."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy training API (reference model.py:FeedForward) as an
    adapter over ``module.Module``, which the reference deprecates it
    for."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=Uniform(0.01),
                 numpy_batch_size=128, arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, **kwargs):
        self.symbol = symbol
        if ctx is None:
            from .context import current_context
            ctx = [current_context()]
        elif isinstance(ctx, Context):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self._module = None

    def _get_module(self, data):
        from .module import Module
        if self._module is None:
            data_names = [d[0] for d in data.provide_data]
            label_names = [lb[0] for lb in data.provide_label] \
                if data.provide_label else []
            self._module = Module(self.symbol, data_names=data_names,
                                  label_names=label_names, context=self.ctx)
        return self._module

    def _iter(self, X, y=None, shuffle=False):
        """An NDArrayIter on this model's device over host arrays (under a
        Context of its own: re-entering the caller's Context object, whose
        scope may be open, would lose the scope it restores)."""
        ctx = self.ctx[0]
        with Context(ctx.device_type, ctx.device_id):
            return io.NDArrayIter(X, y, self.numpy_batch_size,
                                  shuffle=shuffle)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        if not isinstance(X, io.DataIter):
            X = self._iter(X, y, shuffle=True)
        mod = self._get_module(X)
        mod.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=dict(
                    self.kwargs, learning_rate=self.kwargs.get(
                        "learning_rate", 0.01)),
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch or 1, monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        if not isinstance(X, io.DataIter):
            X = self._iter(X)
        mod = self._get_module(X)
        if not mod.binded:
            mod.bind(data_shapes=X.provide_data, for_training=False)
            mod.init_params(self.initializer, arg_params=self.arg_params,
                            aux_params=self.aux_params,
                            allow_missing=False)
        if reset:
            X.reset()
        outputs = []
        for nbatch, batch in enumerate(X):
            if num_batch is not None and nbatch == num_batch:
                break
            mod.forward(batch, is_train=False)
            out = mod.get_outputs()[0].asnumpy()
            pad = batch.pad or 0
            outputs.append(out[:out.shape[0] - pad])
        return np.concatenate(outputs)

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        if not isinstance(X, io.DataIter):
            raise TypeError("score requires a DataIter")
        mod = self._get_module(X)
        if not mod.binded:
            mod.bind(data_shapes=X.provide_data,
                     label_shapes=X.provide_label, for_training=False)
            mod.init_params(self.initializer, arg_params=self.arg_params,
                            aux_params=self.aux_params)
        res = mod.score(X, eval_metric, num_batch=num_batch,
                        batch_end_callback=batch_end_callback, reset=reset)
        return res[0][1]

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        assert epoch is not None
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=Uniform(0.01), eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
