"""Graph evaluation and the ``Executor`` — the PyTorch twin of
``mxnet_tpu/executor.py`` without Custom-op host callbacks and XLA cost
analysis.

The JAX package lowers a Symbol to one pure function that ``jax.jit``
compiles. Here the same function (``_graph_eval_fn``) runs eagerly, op by
op, on whatever device its inputs live on; each intermediate is released
after its last consumer, so memory follows the live set as XLA's buffer
planning does there. Aux states are threaded by ``state_inputs``, and
every rng-drawing node gets ``fold_in(rng, uid)`` of the run's threefry
key and its topological uid, as there, so its draws are the JAX
package's bits.

The forward-and-backward of a bound graph is one path, used by both the
``Executor`` and ``TrainStep``: ``_record_forward`` runs the graph under
autograd from fresh leaves for the arguments that take gradients, and
``_backward`` takes their gradients with ``torch.autograd.grad``, ones
being the head cotangent by default (the reference's convention; the
loss heads scale by it). ``forward_backward`` is the two in one call.

``Executor.forward(is_train=True)`` keeps the autograd graph for
``backward()``, and ``backward()`` keeps it too, so that a second
``backward()`` after one forward works as it does in the reference; the
next forward, or a forward with ``is_train=False``, drops it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import profiler as _profiler
from ._threefry import as_key, fold_in
from .base import MXNetError
from .context import current_context

__all__ = ["Executor", "forward_backward"]


def _shard_check(mesh, spec, shape, strict=True):
    """Validate a ``__shard__`` (strict) or ``__shard_hint__`` (lenient)
    spec against a node output's global ``shape``, with the JAX package's
    messages: an axis the mesh lacks or a dim the axes do not divide
    raises under ``strict`` and is skipped otherwise. Tensors here are
    this rank's batch rows, whole on their other dims, so a valid spec
    changes no number (the JAX constraint changes none either)."""
    from .parallel.sharding import parse_spec
    from .parallel._comm import entry_axes
    parts = parse_spec(spec)
    if len(parts) > len(shape):
        return      # an annotation written for a different-rank tensor
    for dim, entry in enumerate(parts):
        axes = entry_axes(entry)
        if not axes:
            continue
        missing = [a for a in axes if a not in mesh.axis_names]
        if missing:
            if not strict:
                return
            raise MXNetError("__shard__ axis %r not in mesh axes %r"
                             % (missing[0], mesh.axis_names))
        n_shards = int(np.prod([mesh.shape[a] for a in axes]))
        if shape[dim] % n_shards != 0:
            if not strict:
                return
            raise MXNetError(
                "__shard__=%r: dim %d of shape %r not divisible by mesh "
                "axes %r (total shards %d)"
                % (spec, dim, tuple(shape), axes, n_shards))


def _node_shard_spec(node, group2spec):
    """The sharding annotation of a node, if any: explicit __shard__ wins,
    else its ctx_group's entry in group2spec."""
    attrs = node.misc_attrs
    spec = attrs.get("__shard__")
    if spec is not None:
        return spec
    group = attrs.get("__ctx_group__") or attrs.get("ctx_group")
    if group is not None and group2spec:
        return group2spec.get(group)
    return None


def _column_parallel(node, specs, mesh):
    """(mesh, axis, bias_split) when ``node`` is a FullyConnected whose
    weight variable is split on dim 0 over one tensor-parallel axis (and
    whole on its other dims): it then runs column-parallel on the
    rank's slice (``ops.nn``); else None."""
    from .parallel.sharding import MODEL_AXES
    if node.op.name != "FullyConnected" or len(node.inputs) < 2:
        return None
    w = node.inputs[1][0]
    spec = specs.get(w.name) if w.op is None else None
    if not spec or len(spec) != 1 or spec[0] not in MODEL_AXES or \
            mesh.shape[spec[0]] == 1:
        return None
    bias_split = False
    if len(node.inputs) > 2:
        b = node.inputs[2][0]
        bias_split = b.op is None and specs.get(b.name) == spec
    return (mesh, spec[0], bias_split)


def _graph_eval_fn(symbol, capture=None, mesh=None, param_specs=None,
                   batch_names=None, group2spec=None):
    """Build the function evaluating `symbol`'s graph.

    Returns fn(arg_vals: dict name->tensor, aux_vals: dict, rng: a
    threefry key (an int seeds ``PRNGKey``), is_train: bool) -> (tuple
    outputs, dict new_aux).

    capture: debugging hook called with (node_name, [outputs]) for every
    node (the Monitor path).

    mesh: a ``parallel.sharding`` mesh the graph runs over: it is the
    ambient mesh (``ops._mesh_ctx.use_mesh``) while the graph runs, so
    the mesh-aware ops (``seq_axis``, ``expert_axis``, the batch-global
    routes under the replica axes) take their parallel forms.

    param_specs: {name: spec} of the arguments given as this rank's
    shard (a dict the caller may fill later, as placement happens).
    Each reaches its consumers whole through the param gather
    (``_comm.param_gather``), except the weight (and a bias split the
    same way) of a FullyConnected the layout splits on dim 0 over
    ``tp``/``model``: that op runs column-parallel on the slice.

    batch_names: the arguments that hold this rank's rows of the batch
    on dim 0. With them the evaluator tracks which tensors hold batch
    rows and, under an active replica axis, runs the batch reductions
    globally and refuses the ops that would mix rows
    (``ops._batch_global``, ROADMAP Queue C 17).

    The ``__shard__`` attribute (or a ``__ctx_group__``'s entry in
    ``group2spec``) is read strictly and ``__shard_hint__`` leniently, on
    the output's global shape (``_shard_check``)."""
    from .symbol.symbol import _topo_order
    from .ops import _batch_global
    from .ops._mesh_ctx import replica_of, use_tp
    from .parallel._comm import entry_axes
    from .parallel.sharding import GATHERED_AXES

    entries = symbol._entries
    order = _topo_order(entries)
    node_uid = {id(n): i for i, n in enumerate(order)}
    # free each node's outputs after its last consumer (graph outputs
    # are kept to the end)
    last_use = {}
    for pos, node in enumerate(order):
        for (m, _i) in node.inputs:
            last_use[id(m)] = pos
    for (n, _i) in entries:
        last_use[id(n)] = len(order)
    release_at = {}
    for nid, pos in last_use.items():
        release_at.setdefault(pos, []).append(nid)
    specs = param_specs if param_specs is not None else {}
    batch_names = frozenset(batch_names or ())
    annotated = mesh is not None and any(
        "__shard__" in n.misc_attrs or "__shard_hint__" in n.misc_attrs or
        (group2spec and ("__ctx_group__" in n.misc_attrs or
                         "ctx_group" in n.misc_attrs))
        for n in order)

    def eval_fn(arg_vals, aux_vals, rng, is_train):
        """(outputs, new_aux); under the replica axes ``out_batched`` then
        says which outputs hold this rank's batch rows."""
        if mesh is None:
            return _eval_body(arg_vals, aux_vals, rng, is_train)
        from .ops._mesh_ctx import use_mesh
        with use_mesh(mesh):
            return _eval_body(arg_vals, aux_vals, rng, is_train)

    def _whole(node, local, gathered):
        spec = specs.get(node.name)
        if not spec or node.is_aux or not all(
                a in GATHERED_AXES for e in spec for a in entry_axes(e)):
            # replicated, or split over an axis its op reads split
            # (an expert stack over 'expert')
            return local
        if id(node) not in gathered:
            from .parallel._comm import param_gather
            gathered[id(node)] = param_gather(local, mesh, spec)
        return gathered[id(node)]

    def _eval_body(arg_vals, aux_vals, rng, is_train):
        rng = as_key(rng)
        env = {}
        gathered = {}
        aux_out = dict(aux_vals)
        rep = replica_of(mesh) if batch_names else None
        batched = set()         # ids of nodes whose outputs hold batch rows
        device = next((v.device for v in arg_vals.values()), None)
        for pos, node in enumerate(order):
            if node.op is None:
                env[id(node)] = [aux_out[node.name] if node.is_aux
                                 else arg_vals[node.name]]
                if rep is not None and node.name in batch_names:
                    batched.add(id(node))
                if capture is not None:
                    capture(node.name, env[id(node)])
                continue
            tp = _column_parallel(node, specs, mesh) if specs else None
            xs = []
            for slot, (m, i) in enumerate(node.inputs):
                v = env[id(m)][i]
                # a column-parallel FullyConnected reads its weight (and a
                # bias split with it) as this rank's slice
                local = tp is not None and (slot == 1 or
                                            (slot == 2 and tp[2]))
                if m.op is None and specs and not local:
                    v = _whole(m, v, gathered)
                xs.append(v)
            attrs = dict(node.attrs)
            if node.op.takes_is_train:
                attrs["is_train"] = is_train
            if node.op.needs_rng:
                attrs["rng"] = fold_in(rng, node_uid[id(node)])
            if not xs and device is not None:
                attrs["device"] = device     # a creation op
            in_b = [id(m) in batched for (m, _i) in node.inputs]
            if tp is not None:
                with use_tp(tp):
                    raw = node.op.fn(*xs, **attrs)
                out_b = any(in_b)
            elif rep is not None:
                raw, out_b = _batch_global.run(node.op, xs, attrs, in_b, rep)
            else:
                raw, out_b = node.op.fn(*xs, **attrs), False
            del xs
            outs = list(raw) if isinstance(raw, (tuple, list)) else [raw]
            n_state = node.op.num_state
            if n_state:
                state_outs = outs[-n_state:]
                outs = outs[:-n_state]
                # state_inputs index the FULL signature; node.inputs holds
                # only the active (arg_select-filtered) args — map by name
                active = node.op.active_args(node.attrs)
                for slot, val in zip(node.op.state_inputs, state_outs):
                    sname = node.op.arg_names[slot]
                    if sname not in active:
                        continue
                    m, _i = node.inputs[active.index(sname)]
                    if m.op is None and m.is_aux:
                        aux_out[m.name] = val
            if out_b:
                batched.add(id(node))
            if annotated:
                _check_annotations(node, outs, out_b)
            if capture is not None:
                capture(node.name, outs)
            env[id(node)] = outs
            for nid in release_at.get(pos, ()):
                env.pop(nid, None)
                gathered.pop(nid, None)
        outputs = tuple(env[id(n)][i] for (n, i) in entries)
        if rep is not None:
            eval_fn.out_batched = [id(n) in batched for (n, _i) in entries]
            outputs = tuple(o if id(n) in batched
                            else _batch_global.scale_replicated(o, rep)
                            for o, (n, _i) in zip(outputs, entries))
        return outputs, aux_out

    def _check_annotations(node, outs, out_b):
        rep = replica_of(mesh)
        k = rep.n if (rep is not None and out_b) else 1
        spec = _node_shard_spec(node, group2spec)
        hint = node.misc_attrs.get("__shard_hint__")
        for o in outs:
            shape = (o.shape[0] * k,) + tuple(o.shape[1:]) if o.dim() \
                else ()
            if spec is not None:
                _shard_check(mesh, spec, shape)
            elif hint is not None:
                _shard_check(mesh, hint, shape, strict=False)

    return eval_fn


# ---------------------------------------------------------------------------
# the one forward-and-backward path (Executor and TrainStep)
# ---------------------------------------------------------------------------

def _record_forward(eval_fn, arg_vals, aux_vals, rng, wrt, cast=None,
                    remat=False):
    """Run the graph in training mode under autograd, differentiable in
    the arguments named by ``wrt`` (float ones; fresh leaves of their
    values). ``cast`` maps the leaves to what the graph reads (TrainStep's
    compute-dtype cast; linear, so the gradients come back in the
    leaves' dtype). ``remat``: keep no activation of the forward and
    run it again during the backward
    (``torch.utils.checkpoint.checkpoint``, non-reentrant), as
    ``jax.checkpoint`` does in the JAX package; rng nodes draw from pure
    threefry keys, so the recomputed Dropout masks are the same bits.
    Returns (outputs, new_aux, leaves by name)."""
    leaves = {n: arg_vals[n].detach().requires_grad_(True) for n in wrt
              if arg_vals[n].is_floating_point()}
    names = list(leaves)

    def run(*tensors):
        vals = dict(arg_vals)
        given = dict(zip(names, tensors))
        vals.update(cast(given) if cast is not None else given)
        return eval_fn(vals, aux_vals, rng, True)

    with torch.enable_grad():
        if remat:
            from torch.utils.checkpoint import checkpoint
            outs, new_aux = checkpoint(run, *[leaves[n] for n in names],
                                       use_reentrant=False)
        else:
            outs, new_aux = run(*[leaves[n] for n in names])
    return outs, new_aux, leaves


def _backward(outs, leaves, out_grads=None, retain_graph=False):
    """Gradients of the recorded outputs by leaf name, zeros where an
    argument does not reach them. ``out_grads``: one cotangent an output
    (None: ones, the reference's head-grad convention; a one-element
    tensor is broadcast over its output, as the loss scale is)."""
    heads, cots = [], []
    for i, o in enumerate(outs):
        if not o.requires_grad:
            continue
        heads.append(o)
        g = None if out_grads is None else out_grads[i]
        if g is not None:
            g = g.to(device=o.device, dtype=o.dtype)
            g = g.reshape(()).expand(o.shape) if g.numel() == 1 \
                and o.numel() != 1 else g.reshape(o.shape)
        cots.append(torch.ones_like(o) if g is None else g)
    names = list(leaves)
    grads = torch.autograd.grad(
        heads, [leaves[n] for n in names], cots, allow_unused=True,
        retain_graph=retain_graph) if heads and names else \
        [None] * len(names)
    return {n: torch.zeros_like(leaves[n]) if g is None else g
            for n, g in zip(names, grads)}


def forward_backward(eval_fn, arg_vals, aux_vals, rng, wrt, cast=None,
                     out_grads=None, remat=False):
    """(outputs, new_aux, grads by name): ``_record_forward`` then
    ``_backward`` in one call, the graph freed by the backward.
    ``out_grads``: one head cotangent an output (None: ones; the loss
    scaler passes its scale, ``full_like(o, scale)``). ``remat``: see
    ``_record_forward``."""
    outs, new_aux, leaves = _record_forward(eval_fn, arg_vals, aux_vals,
                                            rng, wrt, cast, remat=remat)
    grads = _backward(outs, leaves, out_grads=out_grads)
    return tuple(o.detach() for o in outs), new_aux, grads


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

def _tensor_like(value, ref):
    """``value`` (NDArray, tensor or array-like) as a tensor with ref's
    device and dtype."""
    from .ndarray.ndarray import NDArray, _from_numpy
    if isinstance(value, NDArray):
        t = value._data.detach()
    elif isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        t = _from_numpy(np.asarray(value))
    return t.to(device=ref.device, dtype=ref.dtype, copy=True)


class Executor:
    """Executor over a bound symbol graph (reference graph_executor.h:57;
    the JAX package's ``Executor``)."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None, group2ctx=None,
                 mesh=None, param_specs=None, batch_names=None):
        """mesh, param_specs, batch_names: run over the ranks of a mesh
        (``_graph_eval_fn``'s arguments): the arrays named in
        ``param_specs`` hold this rank's shard, those in ``batch_names``
        this rank's rows of the batch; ``backward`` sums each parameter's
        gradient over the replica axes it is not split on, so the
        gradient arrays hold the global batch's gradient of the shard
        (the Module under a layout)."""
        self._symbol = symbol
        self._group2ctx = dict(group2ctx or {})
        # group2ctx: entries whose value is a partition spec (a string
        # or a P tuple) check the outputs of the nodes of that
        # ``ctx_group`` as ``__shard__`` does under a mesh; Context
        # values (the reference's device placement) have no analogue in
        # one program and change nothing, as in the JAX package
        from .context import Context
        self._group2spec = {g: v for g, v in self._group2ctx.items()
                            if not isinstance(v, Context)}
        self._ctx = ctx if ctx is not None else current_context()
        self._device = self._ctx.torch_device()
        self._monitor_callback = None
        self._monitor_all = False

        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        self._arg_names = arg_names
        self._aux_names = aux_names

        self.arg_arrays = self._align("args", args, arg_names)
        self.aux_arrays = self._align("aux_states", aux_states, aux_names,
                                      allow_missing=not aux_names)

        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null") for n in arg_names}

        from .ndarray.ndarray import zeros_like
        if args_grad is None:
            self.grad_arrays = [
                zeros_like(a) if self._grad_req[n] != "null" else None
                for n, a in zip(arg_names, self.arg_arrays)]
        else:
            self.grad_arrays = self._align("args_grad", args_grad,
                                           arg_names, allow_missing=True)
            for i, n in enumerate(arg_names):
                if self.grad_arrays[i] is None and \
                        self._grad_req[n] != "null":
                    self._grad_req[n] = "null"

        self._mesh = mesh
        self._param_specs = dict(param_specs or {})
        self._batch_names = tuple(batch_names or ())
        self._eval_fn = self._graph_fn()
        self._grad_names = [n for n in arg_names
                            if self._grad_req[n] != "null"]
        self.outputs = []
        self._graph = None      # (recorded outputs, leaves) of a train forward

    # -- construction helpers ----------------------------------------------
    def _graph_fn(self, capture=None):
        return _graph_eval_fn(self._symbol, capture=capture, mesh=self._mesh,
                              param_specs=self._param_specs,
                              batch_names=self._batch_names
                              if self._mesh is not None else None,
                              group2spec=self._group2spec)

    def _sum_over_replicas(self, grads):
        """Each parameter's gradient summed over the replica axes its
        spec does not split it on (in place; batch inputs keep their
        rows' gradients)."""
        from .ops._mesh_ctx import replica_of
        from .parallel import _comm
        rep = replica_of(self._mesh)
        if rep is None:
            return
        by_axes = {}
        for n, g in grads.items():
            if n in self._batch_names:
                continue
            used = {a for e in self._param_specs.get(n, ())
                    for a in _comm.entry_axes(e)}
            axes = tuple(a for a in rep.axes if a not in used)
            by_axes.setdefault(axes, []).append(g)
        with torch.no_grad():
            for axes, gs in by_axes.items():
                _comm.all_reduce_(gs, self._mesh, axes)

    def _on_device(self, v):
        from .ndarray.ndarray import NDArray, array
        if v is None:
            return None
        if not isinstance(v, NDArray):
            return array(v, ctx=self._ctx)
        return v if v._data.device == self._device else \
            v.as_in_context(self._ctx)

    def _align(self, what, values, names, allow_missing=False):
        if values is None:
            if allow_missing:
                return [None] * len(names)
            raise MXNetError("%s must be provided for %r" % (what, names))
        if isinstance(values, dict):
            out = []
            for n in names:
                if n in values:
                    out.append(self._on_device(values[n]))
                elif allow_missing:
                    out.append(None)
                else:
                    raise MXNetError("%s: missing entry for %r" % (what, n))
            return out
        values = list(values)
        if len(values) != len(names):
            raise MXNetError("%s: length %d != expected %d"
                             % (what, len(values), len(names)))
        return [self._on_device(v) for v in values]

    @staticmethod
    def _simple_bind(symbol, ctx=None, grad_req="write", type_dict=None,
                     group2ctx=None, **kwargs):
        from .ndarray.ndarray import zeros
        ctx = ctx if ctx is not None else current_context()
        arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
        arg_types, _, aux_types = symbol.infer_type(**(type_dict or {}))
        args = [zeros(s, ctx=ctx, dtype=t)
                for s, t in zip(arg_shapes, arg_types)]
        aux = [zeros(s, ctx=ctx, dtype=t)
               for s, t in zip(aux_shapes, aux_types)]
        return Executor(symbol, ctx, args=args, grad_req=grad_req,
                        aux_states=aux, group2ctx=group2ctx)

    # -- dict views ----------------------------------------------------------
    @property
    def arg_dict(self):
        return dict(zip(self._arg_names, self.arg_arrays))

    @property
    def grad_dict(self):
        return dict(zip(self._arg_names, self.grad_arrays))

    @property
    def aux_dict(self):
        return dict(zip(self._aux_names, self.aux_arrays))

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for what, params, table in (("arguments", arg_params, self.arg_dict),
                                    ("aux states", aux_params,
                                     self.aux_dict)):
            for name, arr in (params or {}).items():
                if name in table:
                    dst = table[name]
                    dst._set_data(_tensor_like(arr, dst._data))
                elif not allow_extra_params:
                    raise MXNetError("Found name %r not in %s"
                                     % (name, what))

    def set_monitor_callback(self, callback, monitor_all=False):
        """Install a per-node value callback (reference
        ExecuteMonCallback, graph_executor.h:200), called with each op
        node's outputs (and, with monitor_all, each variable's) as
        (name, NDArray); ``monitor.Monitor.install`` sets it."""
        self._monitor_callback = callback
        self._monitor_all = monitor_all

    # -- execution -----------------------------------------------------------
    def _monitor_active(self):
        if self._monitor_callback is None:
            return False
        mon = getattr(self._monitor_callback, "mon", None)
        return bool(getattr(mon, "activated", True))

    def _eval(self):
        """The graph function for this run: with the Monitor's capture
        hook when a callback is active."""
        if not self._monitor_active():
            return self._eval_fn
        from .ndarray.ndarray import _wrap
        cb = self._monitor_callback
        var_names = set(self._arg_names) | set(self._aux_names)

        def capture(name, outs):
            if not self._monitor_all and name in var_names:
                return
            for i, o in enumerate(outs):
                label = name if len(outs) == 1 else "%s_out%d" % (name, i)
                cb(label, _wrap(o.detach()))

        return self._graph_fn(capture)

    def forward(self, is_train=False, **kwargs):
        """Run the forward (reference MXExecutorForward). kwargs update
        named input arrays. A training forward with gradients requested
        keeps its autograd graph for ``backward()``."""
        from . import random as mx_random
        from .ndarray.ndarray import _wrap
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward argument %r" % k)
            dst = self.arg_dict[k]
            dst._set_data(_tensor_like(v, dst._data))

        arg_vals = {n: a._data.detach() for n, a in zip(self._arg_names,
                                                       self.arg_arrays)}
        aux_vals = {n: a._data.detach() for n, a in zip(self._aux_names,
                                                       self.aux_arrays)}
        rng = mx_random.next_key()
        self._graph = None
        eval_fn = self._eval()
        with _profiler.scope("executor_forward%s" %
                             ("_train" if is_train else ""), "executor"):
            if is_train and self._grad_names:
                outs, new_aux, leaves = _record_forward(
                    eval_fn, arg_vals, aux_vals, rng, self._grad_names)
                self._graph = (outs, leaves)
            else:
                with torch.no_grad():
                    outs, new_aux = eval_fn(arg_vals, aux_vals, rng,
                                            bool(is_train))
        if is_train:
            for n, a in zip(self._aux_names, self.aux_arrays):
                a._set_data(new_aux[n].detach())
        self.outputs = [_wrap(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Backprop through the graph of the last training forward
        (reference MXExecutorBackwardEx). With no ``out_grads`` each head
        takes an all-ones cotangent. The graph is kept, so backward()
        may run again until the next forward."""
        from .ndarray.ndarray import NDArray
        if self._graph is None:
            raise MXNetError("backward() requires a prior "
                             "forward(is_train=True)")
        outs, leaves = self._graph
        if out_grads is not None:
            if isinstance(out_grads, (NDArray, torch.Tensor, np.ndarray)):
                out_grads = [out_grads]
            out_grads = [None if g is None else _tensor_like(g, o)
                         for g, o in zip(out_grads, outs)]
        with _profiler.scope("executor_backward", "executor"):
            grads = _backward(outs, leaves, out_grads, retain_graph=True)
            self._sum_over_replicas(grads)
        for n, gbuf in zip(self._arg_names, self.grad_arrays):
            if gbuf is None or self._grad_req[n] == "null" or \
                    n not in grads:
                continue
            g = grads[n].detach().to(gbuf._data.dtype)
            gbuf._set_data(gbuf._data + g if self._grad_req[n] == "add"
                           else g)
        return [self.grad_dict[n] for n in self._grad_names]

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for new input shapes (reference
        executor.py:reshape): arrays whose shape is unchanged are shared,
        the others are new zeros."""
        from .ndarray.ndarray import zeros
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def fit(a, s):
            return a if tuple(a.shape) == tuple(s) else \
                zeros(s, ctx=self._ctx, dtype=a.dtype)
        return Executor(self._symbol, self._ctx,
                        args=[fit(a, s) for a, s in zip(self.arg_arrays,
                                                        arg_shapes)],
                        grad_req=dict(self._grad_req),
                        aux_states=[fit(a, s) for a, s in
                                    zip(self.aux_arrays, aux_shapes)],
                        group2ctx=self._group2ctx, mesh=self._mesh,
                        param_specs=self._param_specs,
                        batch_names=self._batch_names)

    def debug_str(self):
        return self._symbol.debug_str()
