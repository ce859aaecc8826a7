"""Module — symbolic training on one executor; the PyTorch twin of
``mxnet_tpu/module/module.py`` (reference python/mxnet/module/module.py):
bind/init_params/init_optimizer/forward/backward/update, checkpoints and
the optimizer-state I/O.

One ``Executor`` on one device runs the whole batch, so the update never
slices or reduces: the optimizer runs on the executor's gradients through
the Updater (the registry's update op a parameter), or on the KVStore
when one is given. ``layout=`` (a ``parallel.sharding.SpecLayout``) runs
the Module over the ranks of its mesh, one context a rank: parameters
live as the layout's shards, the batch splits over its replica axes, and
the update runs on each rank's shards (``executor_group``).
"""
from __future__ import annotations

import logging
import warnings

from .. import context as ctx_mod
from .. import optimizer as opt
from ..context import Context
from ..initializer import Uniform, InitDesc
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint,
                     save_checkpoint)
from .base_module import BaseModule, _check_input_names, _parse_data_desc
from .executor_group import DataParallelExecutorGroup


class Module(BaseModule):
    """Intermediate-level module wrapping a Symbol."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, layout=None):
        """context: one Context (default: the current context, gpu(0)
        unless a ``with mx.cpu():`` scope says otherwise), or a list of
        distinct contexts on one torch device, which must divide the
        batch (one executor computes it whole; distinct CUDA devices in
        one process raise NotImplementedError, ROADMAP Queue A item
        9b.6). layout: a ``parallel.sharding.SpecLayout`` (or a mesh, for
        its heuristic rules) over the ranks of the process group."""
        super().__init__(logger=logger)
        self._layout = layout

        ctxs = context if context is not None else ctx_mod.current_context()
        self._context = [ctxs] if isinstance(ctxs, Context) else list(ctxs)
        self._work_load_list = (list(work_load_list) if work_load_list
                                else [1] * len(self._context))
        assert len(self._work_load_list) == len(self._context)

        self._symbol = symbol
        names = {
            "data": list(data_names or []),
            "label": list(label_names or []),
            "state": list(state_names or []),
            "fixed_param": list(fixed_param_names or []),
        }
        for kind, ns in names.items():
            _check_input_names(symbol, ns, kind, throw=(kind != "label"))

        self._data_names = names["data"]
        self._label_names = names["label"]
        self._state_names = names["state"]
        self._fixed_param_names = names["fixed_param"]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        inputs = set(self._data_names + self._label_names +
                     self._state_names)
        self._param_names = [a for a in symbol.list_arguments()
                             if a not in inputs]

        # host param copies / optimizer plumbing / bound-executor state,
        # all unset until init_params / init_optimizer / bind
        for attr in ("_arg_params", "_aux_params", "_optimizer",
                     "_kvstore", "_update_on_kvstore", "_updater",
                     "_preload_opt_states", "_grad_req", "_exec_group",
                     "_data_shapes", "_label_shapes"):
            setattr(self, attr, None)
        self._params_dirty = False

    # -- checkpointing -----------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """Rebuild a Module from prefix-symbol.json + prefix-NNNN.params."""
        loaded_sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        module = Module(symbol=loaded_sym, **kwargs)
        module._arg_params, module._aux_params = arg_params, aux_params
        module.params_initialized = True
        if load_optimizer_states:
            module._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return module

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write symbol JSON + params (+ optimizer states)."""
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info("Saved optimizer state to \"%s\"", state_name)

    # -- shape surface (simple accessors defined after the class body) ----
    @property
    def output_shapes(self):
        assert self.binded
        exe = self._exec_group.execs[0]
        if exe.outputs:
            return [(n, tuple(o.shape))
                    for n, o in zip(self._output_names, exe.outputs)]
        feed = {d.name: d.shape for d in self._data_shapes}
        for l in self._label_shapes or []:
            feed[l.name] = l.shape
        _, out_shapes, _ = self._symbol.infer_shape(**feed)
        return list(zip(self._output_names, out_shapes))

    # -- parameters --------------------------------------------------------
    def get_params(self):
        """Host-synced (arg_params, aux_params)."""
        self._require()
        if self._params_dirty:
            self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        """Fill parameters from given dicts and/or the initializer, then
        push them to the executor."""
        if not force_init and self.params_initialized:
            warnings.warn("Parameters already initialized and "
                          "force_init=False. init_params call ignored.",
                          stacklevel=2)
            return
        assert self.binded, "call bind before initializing the parameters"

        if self._arg_params is None or self._aux_params is None:
            # host copies of the global arrays (under a layout the
            # executor holds shards)
            arg, aux = {}, {}
            self._exec_group.get_params(arg, aux)
            if self._arg_params is None:
                self._arg_params = arg
            if self._aux_params is None:
                self._aux_params = aux

        attrs = self._symbol.attr_dict()

        def fill(target, source):
            for name in sorted(target):
                arr = target[name]
                given = None if source is None else source.get(name)
                if given is not None:
                    if given is not arr:
                        given.copyto(arr)
                elif source is not None and not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
                elif initializer is not None:
                    initializer(InitDesc(name, attrs.get(name, {})), arr)

        fill(self._arg_params, arg_params)
        fill(self._aux_params, aux_params)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)

    def set_params(self, arg_params, aux_params,
                   allow_missing=False, force_init=True,
                   allow_extra=False):
        """Assign parameter values directly."""
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
        # partial assignment straight to the device copies; host dicts are
        # stale until the next get_params sync
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        self._params_dirty = True
        self.params_initialized = True

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Create the executor group for the given shapes."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if not for_training:
            assert not inputs_need_grad

        self.for_training, self.inputs_need_grad = \
            for_training, inputs_need_grad
        self._grad_req = grad_req
        self.binded = True

        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)

        shared_group = None
        if shared_module is not None:
            assert isinstance(shared_module, Module) and \
                shared_module.binded and shared_module.params_initialized
            shared_group = shared_module._exec_group

        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names,
            layout=self._layout)
        self._total_exec_bytes = self._exec_group._total_exec_bytes

        if shared_module is not None:
            # bucketing: all buckets view one parameter set
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self.params_initialized = True
            if shared_module.optimizer_initialized:
                self.borrow_optimizer(shared_module)
        elif self.params_initialized:
            # re-bind of a trained module: push existing values down
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    def reshape(self, data_shapes, label_shapes=None):
        """Re-bind the executor for new batch shapes (parameters carry
        over)."""
        self._require(params=False)
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)
        self._exec_group.reshape(self._data_shapes, self._label_shapes)

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate",
                                          0.01),), force_init=False):
        """Create the optimizer + kvstore pair for update()."""
        self._require()
        if not force_init and self.optimizer_initialized:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()

        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)

        # reference convention: grads are rescaled by the global batch size
        global_batch = self._exec_group.batch_size
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            global_batch *= kvstore.num_workers

        if isinstance(optimizer, str):
            settings = dict(optimizer_params)
            settings.setdefault("rescale_grad", 1.0 / global_batch)
            optimizer = opt.create(
                optimizer, sym=self.symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **settings)
        else:
            assert isinstance(optimizer, opt.Optimizer)
            if optimizer.rescale_grad != 1.0 / global_batch:
                warnings.warn(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size/"
                    "num_workers (%s vs. %s). Is this intended?"
                    % (optimizer.rescale_grad, 1.0 / global_batch),
                    stacklevel=2)

        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None

        if kvstore:
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Share the optimizer of another module (bucketing)."""
        assert shared_module.optimizer_initialized
        for attr in ("_optimizer", "_kvstore", "_update_on_kvstore",
                     "_updater"):
            setattr(self, attr, getattr(shared_module, attr))
        self.optimizer_initialized = True

    # -- compute -----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """Run the forward; re-binds first when the batch has a new shape
        (the reference's reshape). A training forward drops the previous
        step's graph before it records its own."""
        self._require()

        bound = tuple(d.shape for d in self._data_shapes)
        incoming = tuple(arr.shape for arr in data_batch.data)
        if bound != incoming:
            self.reshape(*self._shapes_of(data_batch, incoming))
        self._exec_group.forward(data_batch, is_train)

    def _shapes_of(self, data_batch, incoming):
        """Derive (data_shapes, label_shapes) for a shape-changing batch."""
        if getattr(data_batch, "provide_data", None):
            dshapes = data_batch.provide_data
        else:
            dshapes = [(d.name, shp) for d, shp in
                       zip(self._data_shapes, incoming)]
        if getattr(data_batch, "provide_label", None):
            lshapes = data_batch.provide_label
        elif getattr(data_batch, "label", None):
            lshapes = [(l.name, arr.shape) for l, arr in
                       zip(self._label_shapes, data_batch.label)]
        else:
            lshapes = None
        return dshapes, lshapes

    def backward(self, out_grads=None):
        self._require()
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer to the executor's gradients."""
        self._require(optimizer=True)
        self._params_dirty = True
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore,
                                      self._param_names)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater,
                           num_device=1,  # one executor, one device
                           kvstore=self._kvstore,
                           param_names=self._param_names)

    def get_outputs(self, merge_multi_context=True):  # noqa: D102
        self._require()
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):  # noqa: D102
        self._require(inputs_grad=True)
        return self._exec_group.get_input_grads(merge_multi_context)

    def get_states(self, merge_multi_context=True):
        self._require()
        return self._exec_group.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        self._require()
        self._exec_group.set_states(states, value)

    def update_metric(self, eval_metric, labels, ok=None):
        self._exec_group.update_metric(eval_metric, labels, ok=ok)

    def _mask_nonfinite(self, inject=None):
        """Guardrail hook for the fit loop: zero non-finite gradients on
        the device before update() and return the all-finite flag (a
        device scalar; no host sync)."""
        return self._exec_group.mask_nonfinite_update(inject=inject)

    def _sync_params_from_devices(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    # -- optimizer state io ------------------------------------------------
    def save_optimizer_states(self, fname):
        self._opt_state_io(fname, save=True)

    def load_optimizer_states(self, fname):
        self._opt_state_io(fname, save=False)

    def _opt_state_io(self, fname, save):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            method = (self._kvstore.save_optimizer_states if save
                      else self._kvstore.load_optimizer_states)
            method(fname)
        elif save:
            with open(fname, "wb") as fout:
                fout.write(self._updater.get_states())
        else:
            with open(fname, "rb") as fin:
                self._updater.set_states(fin.read())

    def install_monitor(self, mon):
        self._require(params=False)
        self._exec_group.install_monitor(mon)

    def prepare(self, data_batch):
        """Stage the upcoming batch: start its copy to the device now so
        it overlaps the step in flight."""
        if self.binded and self._exec_group is not None:
            self._exec_group.stage_batch(data_batch)


def _view(attr, needs_bind=False):
    def get(self):
        if needs_bind:
            assert self.binded
        return getattr(self, attr)
    return property(get)


Module.data_names = _view("_data_names")
Module.label_names = _view("_label_names")
Module.output_names = _view("_output_names")
Module.data_shapes = _view("_data_shapes", needs_bind=True)
Module.label_shapes = _view("_label_shapes", needs_bind=True)
