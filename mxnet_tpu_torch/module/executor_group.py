"""DataParallelExecutorGroup on one device a rank — the PyTorch twin of
``mxnet_tpu/module/executor_group.py``.

Reference: python/mxnet/module/executor_group.py (600 LoC): it slices
each batch across contexts, binds an executor a device and reduces the
grads through the KVStore. The JAX package does not slice the batch in
Python: one executor computes the whole batch, partitioned over a device
mesh when it is given several contexts or a layout, and the grads it
exposes are the reduced grads. Here one ``Executor`` runs on this rank's
device. Several contexts must be distinct and divide the batch; when
they all name one torch device (``cpu(i)``: the CPU is one device here)
the one executor computes the whole batch, which is what the JAX package
computes over its devices. Contexts that name distinct CUDA devices in
one process raise ``NotImplementedError`` (ROADMAP Queue A item 9b.6:
it waits for a machine with several GPUs). With ``layout=`` (a
``parallel.sharding.SpecLayout``, or a mesh for its heuristic rules)
every rank binds the same group: the executor
holds this rank's shard of each parameter (the layout's spec) and this
rank's rows of the batch (its replica axes, data × fsdp, split the
global batch, which must divide them); batches come in global and leave
as this rank's rows, parameters go in and come out as global arrays, the
outputs read global (gathered over the replica axes), and the gradients
are the global batch's (``Executor`` sums them over the replica axes).
The views keep the reference's shapes: a list over params of a list over
devices, one device long.
"""
from __future__ import annotations

import logging

import torch

from .. import io
from .. import telemetry as _telemetry
from ..parallel import _comm
from ..parallel import sharding as shd
from .. import trace as _trace
from ..base import MXNetError
from ..executor import Executor
from ..ndarray import NDArray, array, zeros


def _merge_multi_context(outputs, major_axis):
    """Kept for API parity: one executor's outputs are already merged
    (reference executor_group.py:_merge_multi_context)."""
    return outputs


class DataParallelExecutorGroup:
    """The group managing the (one) executor of a Module (reference
    executor_group.py:99)."""

    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None, layout=None):
        self._check_contexts(contexts)
        self._layout = shd.as_layout(layout)
        if layout is not None and not isinstance(
                getattr(self._layout, "mesh", None), shd.Mesh):
            raise TypeError(
                "Module(layout=%s): pass a parallel.sharding.SpecLayout "
                "(or a make_mesh mesh)" % type(layout).__name__)
        self._mesh = None if layout is None else self._layout.mesh
        # name -> spec of each parameter's shard under the layout
        self._pspec = {}
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = fixed_param_names or []
        self.state_names = state_names or []
        self.logger = logger

        # bucketing executors share their input arrays by shape
        self.shared_data_arrays = shared_group.shared_data_arrays \
            if shared_group is not None else {}

        if grad_req != "null" and for_training:
            data_names = [d[0] for d in data_shapes]
            self.grad_req = {}
            for k in self.arg_names:
                if k in self.param_names:
                    self.grad_req[k] = ("null" if k in self.fixed_param_names
                                        else grad_req)
                elif k in data_names:
                    self.grad_req[k] = grad_req if inputs_need_grad \
                        else "null"
                else:
                    self.grad_req[k] = "null"
        else:
            self.grad_req = {k: "null" for k in self.arg_names}

        self._staged = None   # (batch object, feeds) placed ahead
        self._total_exec_bytes = 0
        self.batch_size = None
        self.execs = []       # one long, for API parity
        self.data_arrays = None
        self.label_arrays = None
        self.param_arrays = None
        self.grad_arrays = None
        self.aux_arrays = None
        self.input_grad_arrays = None
        self.data_shapes = None
        self.label_shapes = None
        self.num_outputs = None

        self.bind_exec(data_shapes, label_shapes, shared_group)

    @staticmethod
    def _check_contexts(contexts):
        """Several contexts must be distinct (as the JAX package's
        ``_build_mesh`` requires) and name one torch device: one
        executor then computes the whole batch."""
        if len(contexts) <= 1:
            return
        seen = []
        for c in contexts:
            if c in seen:
                raise MXNetError(
                    "duplicate device %r in contexts %r — each "
                    "data-parallel context must map to a distinct device"
                    % (c, contexts))
            seen.append(c)
        devices = {c.torch_device() for c in contexts}
        if len(devices) > 1:
            raise NotImplementedError(
                "a Module over contexts on %d distinct devices %r in one "
                "process waits for a machine with several GPUs (ROADMAP "
                "Queue A item 9b.6); run one process a GPU with a dist "
                "kvstore instead" % (len(devices), contexts))

    # -- binding -----------------------------------------------------------
    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        """Bind the executor (reference executor_group.py:bind_exec).
        Params and aux of a previous bind with unchanged shapes carry
        over; a shared group's (bucketing) are adopted by reference, so
        every bucket reads and updates the same arrays."""
        ctx = self.contexts[0]
        self.batch_size = data_shapes[0].shape[0] \
            if isinstance(data_shapes[0], io.DataDesc) \
            else data_shapes[0][1][0]
        self.data_shapes = [x if isinstance(x, io.DataDesc)
                            else io.DataDesc(*x) for x in data_shapes]
        self.label_shapes = [x if isinstance(x, io.DataDesc)
                             else io.DataDesc(*x) for x in label_shapes] \
            if label_shapes is not None else None
        self.data_names = [x.name for x in self.data_shapes]
        self.label_names = [x.name for x in self.label_shapes] \
            if self.label_shapes is not None else []

        input_shapes = {d.name: d.shape for d in self.data_shapes}
        input_types = {d.name: d.dtype for d in self.data_shapes}
        for lb in self.label_shapes or []:
            input_shapes[lb.name] = lb.shape
            input_types[lb.name] = lb.dtype
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        arg_types, _, aux_types = self.symbol.infer_type(**input_types)
        batch_names = set(input_shapes)
        if len(self.contexts) > 1 and \
                self.batch_size % len(self.contexts) != 0:
            raise MXNetError(
                "batch size %d must be divisible by the number of batch "
                "shards %d (mesh data-parallel)"
                % (self.batch_size, len(self.contexts)))
        if self._layout is not None:
            n = 1
            for a in self._layout.batch_axes:
                n *= self._mesh.shape[a]
            if self.batch_size % n != 0:
                raise MXNetError(
                    "batch size %d must be divisible by the number of "
                    "batch shards %d (mesh data-parallel)"
                    % (self.batch_size, n))
            local = []
            for name, shape in zip(self.arg_names, arg_shapes):
                if name in batch_names:
                    shape = shd.local_shape(
                        shape, self._layout.batch_nsharding(len(shape)),
                        self._mesh)
                elif name in self.param_names:
                    self._pspec[name] = self._layout.param_nsharding(
                        name, tuple(shape))
                    shape = shd.local_shape(shape, self._pspec[name],
                                            self._mesh)
                local.append(tuple(shape))
            arg_shapes = local

        prev_args = self.execs[0].arg_dict if self.execs else {}
        prev_aux = self.execs[0].aux_dict if self.execs else {}
        shared_args = shared_group.execs[0].arg_dict if shared_group \
            else {}
        shared_aux = shared_group.execs[0].aux_dict if shared_group \
            else {}

        args = {}
        for name, shape, dtype in zip(self.arg_names, arg_shapes, arg_types):
            if name in self.param_names and name in prev_args and \
                    tuple(prev_args[name].shape) == tuple(shape):
                args[name] = prev_args[name]
            elif name in self.param_names and name in shared_args:
                if tuple(shared_args[name].shape) != tuple(shape):
                    # a bucket-dependent param shape would fork the
                    # parameter set
                    raise MXNetError(
                        "bucketing: param %r has shape %s in this "
                        "bucket but %s in the shared (default) bucket "
                        "— parameters must be bucket-invariant"
                        % (name, tuple(shape),
                           tuple(shared_args[name].shape)))
                args[name] = shared_args[name]
            elif name in self.shared_data_arrays and \
                    tuple(self.shared_data_arrays[name].shape) == \
                    tuple(shape):
                args[name] = self.shared_data_arrays[name]
            else:
                args[name] = zeros(shape, ctx=ctx, dtype=dtype)
                if name not in self.param_names:
                    self.shared_data_arrays[name] = args[name]

        def _aux_for(n, s, t):
            if n in prev_aux and tuple(prev_aux[n].shape) == tuple(s):
                return prev_aux[n]
            if n in shared_aux:
                if tuple(shared_aux[n].shape) != tuple(s):
                    raise MXNetError(
                        "bucketing: aux state %r has shape %s in this "
                        "bucket but %s in the shared (default) bucket"
                        % (n, tuple(s), tuple(shared_aux[n].shape)))
                return shared_aux[n]
            return zeros(s, ctx=ctx, dtype=t)

        aux = [_aux_for(n, s, t)
               for n, s, t in zip(self.aux_names, aux_shapes, aux_types)]

        # one param-sized grad set for all buckets (the reference's
        # shared_exec reuses args_grad too): update() consumes a bucket's
        # grads right after its backward, and grad_req="add" accumulates
        # across buckets
        shared_grads = shared_group.execs[0].grad_dict if shared_group \
            else {}
        args_grad = None
        if any(self.grad_req.get(n, "null") != "null"
               for n in self.arg_names):
            args_grad = {}
            for name in self.arg_names:
                if self.grad_req.get(name, "null") == "null":
                    continue
                g = shared_grads.get(name)
                if g is not None and \
                        tuple(g.shape) == tuple(args[name].shape):
                    args_grad[name] = g
                else:
                    args_grad[name] = zeros(tuple(args[name].shape), ctx=ctx,
                                            dtype=args[name].dtype)

        executor = Executor(self.symbol, ctx=ctx,
                            args=[args[n] for n in self.arg_names],
                            args_grad=args_grad,
                            grad_req=self.grad_req, aux_states=aux,
                            mesh=self._mesh, param_specs=self._pspec,
                            batch_names=sorted(batch_names))
        self.execs = [executor]

        self.param_arrays = [[executor.arg_dict[n]]
                             for n in self.param_names]
        self.grad_arrays = [[executor.grad_dict[n]]
                            if self.grad_req.get(n, "null") != "null"
                            else [None]
                            for n in self.param_names]
        self.aux_arrays = [[a] for a in executor.aux_arrays]
        self.data_arrays = [[(slice(0, self.batch_size),
                              executor.arg_dict[n])]
                            for n in self.data_names]
        self.label_arrays = [[(slice(0, self.batch_size),
                               executor.arg_dict[n])]
                             for n in self.label_names]
        self.input_grad_arrays = [[executor.grad_dict[n]]
                                  for n in self.data_names] \
            if self.inputs_need_grad else None
        self.num_outputs = len(self.symbol.list_outputs())

    def reshape(self, data_shapes, label_shapes):
        """Rebind for new shapes (reference executor_group.py:reshape)."""
        if data_shapes == self.data_shapes and \
                label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes, reshape=True)

    # -- params ------------------------------------------------------------
    def set_params(self, arg_params, aux_params, allow_extra=False):
        """Copy params into the bound executor (reference
        executor_group.py:set_params); under a layout each global array
        is placed as this rank's shard."""
        if self._layout is not None and arg_params:
            arg_params = {n: self._place(n, v)
                          for n, v in arg_params.items()}
        self.execs[0].copy_params_from(arg_params, aux_params,
                                       allow_extra_params=allow_extra)

    def _place(self, name, value):
        spec = self._pspec.get(name)
        if not spec:
            return value
        t = value._data if isinstance(value, NDArray) else \
            array(value, ctx=self.contexts[0])._data
        return NDArray(shd.place(t, spec, self._mesh))

    def get_params(self, arg_params, aux_params):
        """Copy the current params out into the given dicts (reference
        executor_group.py:get_params)."""
        for name in self.param_names:
            arr = self.execs[0].arg_dict[name]
            spec = self._pspec.get(name)
            if spec:
                arr = NDArray(shd.gather(arr._data, spec, self._mesh))
            arg_params[name] = arr.copy()
        for name in self.aux_names:
            aux_params[name] = self.execs[0].aux_dict[name].copy()

    # -- compute -----------------------------------------------------------
    def _build_feeds(self, data_batch, is_train):
        """The batch's arrays on the executor's device (an asynchronous
        copy; nothing blocks here)."""
        device = self.execs[0]._device

        def place(arr):
            t = arr._data if isinstance(arr, NDArray) else \
                array(arr, ctx=self.contexts[0])._data
            if self._layout is not None:
                # this rank's rows of the global batch
                t = shd.place(t, self._layout.batch_nsharding(t.dim()),
                              self._mesh)
            return NDArray(t.to(device, non_blocking=True))

        feeds = {name: place(arr)
                 for name, arr in zip(self.data_names, data_batch.data)}
        if (is_train or self.label_names) and data_batch.label is not None:
            for name, arr in zip(self.label_names, data_batch.label):
                feeds[name] = place(arr)
        return feeds

    def stage_batch(self, data_batch, is_train=None):
        """Place an upcoming batch now, so its copy overlaps the step in
        flight; forward() adopts it when handed the same batch object.
        The staging wall time feeds the ``module.stage_ms`` histogram."""
        if is_train is None:
            is_train = self.for_training
        with _telemetry.histogram("module.stage_ms").timer(), \
                _trace.span("module.stage"):
            self._staged = (data_batch,
                            self._build_feeds(data_batch, is_train))

    def forward(self, data_batch, is_train=None):
        """Load the batch and run the forward (reference
        executor_group.py:forward)."""
        if is_train is None:
            is_train = self.for_training
        staged = self._staged
        if staged is not None and staged[0] is data_batch:
            feeds = staged[1]
            self._staged = None
        else:
            feeds = self._build_feeds(data_batch, is_train)
        self.execs[0].forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        """The backward over the executor's kept graph (reference
        executor_group.py:backward)."""
        assert self.for_training, "re-bind with for_training=True to run " \
            "backward"
        self.execs[0].backward(out_grads=out_grads)

    def _global_outputs(self):
        """The outputs; under a layout each output holding batch rows is
        gathered over the replica axes into the global batch's."""
        exe = self.execs[0]
        outs = list(exe.outputs)
        flags = getattr(exe._eval_fn, "out_batched", None)
        if self._layout is None or flags is None:
            return outs
        spec = self._layout.batch_nsharding(1)
        return [NDArray(shd.gather(o._data, spec, self._mesh)) if b else o
                for o, b in zip(outs, flags)]

    def get_outputs(self, merge_multi_context=True):
        outs = [[o] for o in self._global_outputs()]
        if merge_multi_context:
            return [o[0] for o in outs]
        return outs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        grads = [[self.execs[0].grad_dict[n]] for n in self.data_names]
        if merge_multi_context:
            return [g[0] for g in grads]
        return grads

    def get_states(self, merge_multi_context=True):
        return []

    def set_states(self, states=None, value=None):
        assert not states and not value

    def mask_nonfinite_update(self, inject=None):
        """The device-side guardrail of the Module's fit: an all-finite
        flag over this step's param gradients and outputs, and the
        non-finite gradients zeroed on the device (``torch.where``:
        ``nan * 0`` is NaN) so update() cannot ingest them. The flag
        comes from ``ops.optimizer_kernels.norm_finite`` (one reduction
        over every tensor; the multi-tensor kernel on the card). Nothing
        blocks: the fit loop reads the flag at the dispatch window's
        wait. ``inject`` (the ``nan@N`` fault hook) multiplies the
        gradients where the flag is taken. Returns the flag as a 0-d
        bool device tensor (None when nothing has gradients)."""
        from ..ops import optimizer_kernels as _mt

        exe = self.execs[0]
        grad_dict = exe.grad_dict
        holders = [grad_dict[n] for n in self.param_names
                   if grad_dict.get(n) is not None]
        grads = [g._data for g in holders]
        outs = [o._data for o in exe.outputs]
        if not grads and not outs:
            return None
        with torch.no_grad():
            _, ok, _ = _mt.norm_finite(
                grads, outs, inject=1.0 if inject is None else inject)
            if self._mesh is not None:
                # every rank masks the step if any rank's part is not
                # finite
                ok = ok.clone()
                _comm.all_reduce_([ok], self._mesh,
                                  tuple(self._mesh.axis_names), "min")
            for holder, g in zip(holders, grads):
                holder._set_data(torch.where(ok, g, 0.0))
        return ok

    def update_metric(self, eval_metric, labels, ok=None):
        """Update the metric with the current outputs (reference
        executor_group.py:update_metric), on the device where the metric
        has a device implementation; ``ok`` (the guardrail's flag) masks
        the batch's device stats."""
        labels_ = {name: lb for name, lb in
                   zip(self.label_names, labels or [])}
        preds = dict(zip(self.symbol.list_outputs(),
                         self._global_outputs()))
        eval_metric.update_dict(labels_, preds, device=True, ok=ok)

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)
