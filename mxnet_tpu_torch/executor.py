"""Graph evaluation and the ``Executor`` — the PyTorch twin of
``mxnet_tpu/executor.py`` without the mesh/sharding lowering,
``group2ctx`` specs, Custom-op host callbacks and XLA cost analysis.

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

from ._threefry import as_key, fold_in
from .base import MXNetError
from .context import current_context

__all__ = ["Executor", "forward_backward"]


def _graph_eval_fn(symbol, capture=None, mesh=None):
    """Build the function evaluating `symbol`'s graph.

    Returns fn(arg_vals: dict name->tensor, aux_vals: dict, rng: a
    threefry key (an int seeds ``PRNGKey``), is_train: bool) -> (tuple
    outputs, dict new_aux).

    capture: debugging hook called with (node_name, [outputs]) for every
    node (the Monitor path).

    mesh: a ``parallel.sharding`` mesh the graph runs over: it is the
    ambient mesh (``ops._mesh_ctx.use_mesh``) while the graph runs, so
    the mesh-aware ops (``seq_axis``, ``expert_axis``, the reductions
    over the batch under ``data``) take their parallel forms. The
    ``__shard__``/``__shard_hint__`` attributes are the JAX package's
    GSPMD constraints and are read nowhere here (ROADMAP Queue A item
    9b): tensors stay local."""
    from .symbol.symbol import _topo_order

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

    def eval_fn(arg_vals, aux_vals, rng, is_train):
        if mesh is None:
            return _eval_body(arg_vals, aux_vals, rng, is_train)
        from .ops._mesh_ctx import use_mesh
        with use_mesh(mesh):
            return _eval_body(arg_vals, aux_vals, rng, is_train)

    def _eval_body(arg_vals, aux_vals, rng, is_train):
        rng = as_key(rng)
        env = {}
        aux_out = dict(aux_vals)
        device = next((v.device for v in arg_vals.values()), None)
        for pos, node in enumerate(order):
            if node.op is None:
                env[id(node)] = [aux_out[node.name] if node.is_aux
                                 else arg_vals[node.name]]
                if capture is not None:
                    capture(node.name, env[id(node)])
                continue
            xs = [env[id(m)][i] for (m, i) in node.inputs]
            attrs = dict(node.attrs)
            if node.op.takes_is_train:
                attrs["is_train"] = is_train
            if node.op.needs_rng:
                attrs["rng"] = fold_in(rng, node_uid[id(node)])
            if not xs and device is not None:
                attrs["device"] = device     # a creation op
            raw = node.op.fn(*xs, **attrs)
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
            if capture is not None:
                capture(node.name, outs)
            env[id(node)] = outs
            for nid in release_at.get(pos, ()):
                env.pop(nid, None)
        outputs = tuple(env[id(n)][i] for (n, i) in entries)
        return outputs, aux_out

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
                 grad_req="write", aux_states=None, group2ctx=None):
        if group2ctx:
            raise NotImplementedError(
                "Executor(group2ctx=...) places graph groups on a device "
                "mesh by GSPMD constraints, which is not ported yet "
                "(ROADMAP Queue A item 9b)")
        self._symbol = symbol
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

        self._eval_fn = _graph_eval_fn(symbol)
        self._grad_names = [n for n in arg_names
                            if self._grad_req[n] != "null"]
        self.outputs = []
        self._graph = None      # (recorded outputs, leaves) of a train forward

    # -- construction helpers ----------------------------------------------
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

        return _graph_eval_fn(self._symbol, capture=capture)

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
        grads = _backward(outs, leaves, out_grads, retain_graph=True)
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
                                    zip(self.aux_arrays, aux_shapes)])

    def debug_str(self):
        return self._symbol.debug_str()
