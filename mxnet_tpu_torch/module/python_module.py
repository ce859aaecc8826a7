"""PythonModule — modules written directly in Python, no symbolic graph;
the PyTorch twin of ``mxnet_tpu/module/python_module.py`` (reference
python/mxnet/module/python_module.py): a BaseModule whose forward and
backward the user writes in numpy/NDArray code, for custom loss heads and
glue stages inside SequentialModule chains.
"""
from __future__ import annotations

import logging

from .. import ndarray as nd
from ..initializer import Uniform
from .base_module import BaseModule


class PythonModule(BaseModule):
    """A module with no (or externally-managed) parameters whose compute
    is plain Python. Subclasses override forward/backward and
    _compute_output_shapes."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names) \
            if label_names is not None else None
        self._output_names = output_names
        self._data_shapes = self._label_shapes = self._output_shapes = None

    # read-only views over the recorded names/shapes (defined after the
    # class body; the surface matches BaseModule's abstract properties)

    # -- parameters: none --------------------------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate",
                                          0.01),), force_init=False):
        """Nothing to optimize by default."""
        self.optimizer_initialized = True

    def update(self):
        """No parameters, no update."""

    def update_metric(self, eval_metric, labels):
        """Only meaningful when this module consumes labels (i.e. is a
        loss stage)."""
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Record shapes and derive output shapes; no executor needed."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert grad_req == "write"
        self.for_training, self.inputs_need_grad = \
            for_training, inputs_need_grad
        self._data_shapes, self._label_shapes = data_shapes, label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def install_monitor(self, mon):
        """Nothing to monitor by default."""


for _pub, _priv in (("data_names", "_data_names"),
                    ("output_names", "_output_names"),
                    ("data_shapes", "_data_shapes"),
                    ("label_shapes", "_label_shapes"),
                    ("output_shapes", "_output_shapes")):
    setattr(PythonModule, _pub,
            property(lambda self, a=_priv: getattr(self, a)))


class PythonLossModule(PythonModule):
    """A pass-through loss head: forward stores the incoming scores, and
    backward produces d(loss)/d(scores) via a user grad_func."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        assert len(data_names) == 1 and len(label_names) == 1
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        self._scores = self._labels = self._scores_grad = None
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        # scores pass through unchanged
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):  # noqa: D102
        assert merge_multi_context
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, \
            "For a loss module, out_grads should be None"
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        if self._grad_func is None:
            raise NotImplementedError(
                "supply grad_func or override _backward_impl")
        grad = self._grad_func(self._scores, self._labels)
        self._scores_grad = grad if isinstance(grad, nd.NDArray) \
            else nd.array(grad)

    def get_input_grads(self, merge_multi_context=True):  # noqa: D102
        assert merge_multi_context
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
