"""The training step and its fit loop — the PyTorch twin of
``mxnet_tpu/parallel/trainer.py``'s ``TrainStep``, on one device or over
a mesh of ``torch.distributed`` ranks.

The JAX package compiles forward, backward and the fused optimizer
update into one ``jax.jit`` program. Here the same step runs eagerly:
the Executor's forward-and-backward (``executor.forward_backward``: the
Symbol graph under autograd with ``is_train=True``, then
``torch.autograd.grad`` with ones, or the loss scale, as head
cotangents), then one update of every parameter
(``ops.optimizer_kernels.opt_update``: on the card, the multi-tensor
kernel for Adam and SGD, one launch a 256 parameters, float32 or
bfloat16; the registry's update op parameter by parameter for the other
optimizers and on the CPU).
The semantics are those of the JAX step: ``compute_dtype`` casts the
parameters and the real-valued data (never labels or inputs that feed an
Embedding, found from the graph), gradients come back in float32 through
the cast, aux states keep their own dtype, ``rescale_grad`` defaults to
1/batch, and ``clip_norm`` bounds the global norm of the rescaled
gradient (``ops.optimizer_kernels.norm_finite``: one reduction over
every gradient, a launch a 256 tensors and one to sum the partials). ``donate=True`` updates the state tensors in place
(the JAX package donates their buffers); ``donate=False`` leaves them
untouched. ``remat=True`` recomputes the forward during the backward.

``fit`` is the JAX package's fit loop: epochs over a DataIter, the
metric accumulated on the device (``metric.device_update`` after each
step, masked by the step's finite flag), the guardrail (on by default:
a non-finite step is masked on the device, rollback, loss scaling),
preemption checkpoints and resume, telemetry and trace spans, and a
bounded dispatch window whose wait is the one blocking host sync a
step. ``save_state`` / ``load_state`` write and read the JAX package's
``.npz`` layout, so a checkpoint of either package loads in the other.

``export`` writes the step as the JAX package's flat artifact (its
``.train.meta.json`` keys and values and ``.state.npz`` layout) plus what
the port needs to rebuild the step, since a StableHLO program cannot run
without JAX. ``CompiledTrainStep.load`` rebuilds it from those files
alone; on the card, its first ``step`` captures the step as one CUDA
graph, which every later ``step`` replays.

``mesh=`` (``sharding.make_mesh`` over the ranks of ``dist.init``) or
``layout=`` (a ``sharding.SpecLayout``, which carries its mesh) runs the
step over ranks: every rank runs the graph on its own tensors, and the
graph's mesh-aware ops take their parallel forms (``seq_axis``: ring
attention; ``expert_axis``: the all_to_all MoE; the whole batch's
reductions under the replica axes; a FullyConnected whose weight splits
on dim 0 over ``tp``/``model``: column-parallel). ``place_batch`` keeps
this rank's rows of the global batch over the replica axes (``data``,
and ``fsdp`` under a layout, merged ``data`` major) and the whole batch
over the other axes. Each parameter lives as this rank's shard of its
layout spec (the heuristic rules of a bare mesh, or the layout's rules
and auto rule), and the graph reads it whole through the param gather
(``_comm.param_gather``) or, column-parallel, as its slice. The
gradients of a step are summed over the replica axes (the JAX step's
gradient is the global batch's: a sum, with ``rescale_grad`` defaulting
to 1 / the global batch), except over an axis the parameter is split on,
which its gather's backward has summed already; the guardrail's finite
flag is the minimum over the replica axes and ``clip_norm`` reads the
summed gradients. ``optimizer_sharding='zero1'`` keeps each optimizer
state 1/N over the replica axes (``layout.opt_nsharding(zero=True)``):
the update runs on this rank's slice of each parameter shard and the
shard is all-gathered after it; the update is elementwise, so the
trajectory is the replicated update's, bit for bit. A step's outputs are
this rank's rows. ``save_state`` and ``export`` write the global arrays
(gathered over the axes; rank 0 writes), so a checkpoint restores onto
another mesh or layout.
"""
from __future__ import annotations

import json
import logging
from collections import deque

import numpy as np
import torch

from .. import guardrail as _guardrail
from .. import telemetry as _telemetry
from .. import trace as _trace
from .._threefry import PRNGKey, fold_in
from ..base import gc_paused, torch_dtype
from ..context import context_of, cpu, current_context
from ..executor import _graph_eval_fn, forward_backward
from ..ndarray import array
from ..ops import optimizer_kernels as _mt
from ..ops._mesh_ctx import replica_of
from ..ops.custom import refuse_capture
from . import _comm
from . import sharding as shd

__all__ = ["make_train_step", "TrainStep", "CompiledTrainStep"]

# the meta key holding what the port needs to rebuild an exported step
# (every other key of the meta is the JAX package's)
_REBUILD_KEY = "torch_step"

# fused optimizer ops: name -> (#state tensors, op name)
_OPT_OPS = {
    "sgd": (1, "sgd_mom_update"),       # momentum (0.0 => plain sgd math)
    "adam": (2, "adam_update"),
    "rmsprop": (1, "rmsprop_update"),
    "ftrl": (2, "ftrl_update"),
    "signum": (0, "signsgd_update"),
}


def _tensor(x, device):
    """A tensor on ``device`` from an NDArray, tensor or array-like
    (``nd.array``'s rules: float64 and int64 host arrays become float32
    and int32, as ``jnp.asarray`` makes them without x64)."""
    return array(x, ctx=context_of(device)).handle


def _nd_wrap(x):
    from ..ndarray.ndarray import _wrap
    return _wrap(x)


def _newest_readable(candidates, loader, torn_excs, logger):
    """Newest-first checkpoint scan (a copy of
    ``mxnet_tpu/module/base_module.py``'s): (path, loader(path)) for the
    first candidate the loader can read, warning and falling back past
    files torn by a crash mid-save. (None, None) when nothing is
    readable. A model/optimizer mismatch must fail loudly, so the torn
    set never holds ValueError here."""
    for path in reversed(candidates):
        try:
            return path, loader(path)
        except torn_excs as e:
            logger.warning("checkpoint %s unreadable (%s); trying the "
                           "previous one", path, e)
    return None, None


def _to_numpy(t):
    """A host copy for a checkpoint: bf16 as the JAX package writes it
    (ml_dtypes bfloat16 lands in ``.npz`` as 2-byte void), others as
    they are."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(a, path, key):
    """A checkpoint array as a tensor. 2-byte void entries are bf16 bits
    (how ``np.savez`` stores ml_dtypes bfloat16, which the JAX package
    writes); any other void or object array fails loudly."""
    if a.dtype.kind == "V":
        if a.dtype.itemsize != 2:
            raise ValueError("checkpoint %s entry %r has raw dtype %s; "
                             "only 2-byte bfloat16 bits are readable"
                             % (path, key, a.dtype))
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.int16)).view(torch.bfloat16)
    if a.dtype.kind not in "biuf":
        raise ValueError("checkpoint %s entry %r has dtype %s"
                         % (path, key, a.dtype))
    return torch.from_numpy(np.ascontiguousarray(a))


class _Placed(dict):
    """A batch ``place_batch`` placed (this rank's slice): placing it
    again is the identity, as ``jax.device_put`` of a placed array is."""


class _SimpleBatchEnd:
    """BatchEndParam-compatible namespace for Speedometer-style
    callbacks (reference model.py:BatchEndParam). ``locals`` carries the
    loop's ``state``, ``outs`` and ``placed`` batch, as the reference's
    ``locals()`` does."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


class _InFlight:
    """One dispatched step of the fit loop's window: an event recorded
    after it on the card, and its finite flag copied to pinned host
    memory behind it, so the wait for step t-K reads step t-K's flag
    without waiting for the steps queued after it."""

    def __init__(self, flag, device):
        self.flag = flag
        self.event = None
        if device.type == "cuda":
            if flag is not None:
                host = torch.empty((), dtype=torch.bool, pin_memory=True)
                host.copy_(flag, non_blocking=True)
                self.flag = host
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        """Block until the step ran; its finite flag (True unguarded)."""
        if self.event is not None:
            self.event.synchronize()
        return True if self.flag is None else bool(self.flag)


class TrainStep:
    """A training step on one device.

    state = (params: dict, opt_state: dict name -> tuple, aux: dict)
    step(state, batch, lr, rng) -> (state, outputs)

    rng is a threefry key (``mx.random.PRNGKey(s)``, numpy ``uint32[2]``)
    as in the JAX package, whose graph folds each rng node's uid into it
    (Dropout's masks are then the JAX package's bits); an int ``s`` is
    taken as ``PRNGKey(s)``.
    """

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), optimizer="sgd",
                 optimizer_params=None, mesh=None, donate=True,
                 compute_dtype=None, remat=None, optimizer_sharding=None,
                 clip_norm=None, layout=None, ctx=None):
        """compute_dtype: cast params and real-valued data to this dtype
        for forward and backward (e.g. 'bfloat16') while master weights,
        gradients and optimizer state stay float32.

        remat: recompute the forward during the backward (gradient
        mirroring, reference MXNET_BACKWARD_DO_MIRROR): activation memory
        traded for recompute. Default: the MXNET_BACKWARD_DO_MIRROR knob.

        clip_norm: clip gradients by global norm before the optimizer
        (the norm of the gradient after rescale_grad).

        ctx: the device of this rank (default: the current context, gpu(0)
        unless a ``with mx.cpu():`` scope says otherwise).

        mesh: a ``sharding.make_mesh`` mesh (see the module doc); its
        heuristic rules place the parameters. layout: a
        ``sharding.SpecLayout`` (it carries its own mesh; don't also pass
        ``mesh=``): parameters and optimizer state placed by its rules,
        the batch over its data axes (data × fsdp). optimizer_sharding:
        None or 'zero1' (the optimizer state 1/N over the replica
        axes)."""
        from .. import config as _config
        if layout is not None:
            if not isinstance(getattr(layout, "mesh", None), shd.Mesh):
                raise TypeError("TrainStep(layout=%s): pass a "
                                "parallel.sharding.SpecLayout"
                                % type(layout).__name__)
            if mesh is not None and mesh is not layout.mesh:
                raise ValueError(
                    "pass either layout= or mesh=, not both — the "
                    "layout carries its own mesh")
            mesh = layout.mesh
        if mesh is not None and not isinstance(mesh, shd.Mesh):
            raise TypeError("TrainStep(mesh=%s): pass a mesh of "
                            "parallel.sharding.make_mesh"
                            % type(mesh).__name__)
        self.symbol = symbol
        self.mesh = mesh
        # one placement seam for the registry (SpecLayout) and the
        # heuristic rules of a bare mesh; None = one device
        self._layout = layout if layout is not None \
            else shd.as_layout(mesh)
        self._spec_layout = layout
        if optimizer_sharding not in (None, "zero1"):
            raise ValueError("optimizer_sharding must be None or 'zero1', "
                             "got %r" % (optimizer_sharding,))
        if optimizer_sharding == "zero1" and (
                self._layout is None or not self._layout.zero_axes):
            raise ValueError(
                "optimizer_sharding='zero1' needs a replica axis to "
                "shard the optimizer state over: a bare mesh= with a "
                "'data' axis, or a layout=SpecLayout(...) (which folds "
                "over 'data' and 'fsdp') — got mesh axes %r"
                % (None if mesh is None else list(mesh.axis_names)))
        self.optimizer_sharding = optimizer_sharding
        # the replica axes the batch splits over (the gradient sum's)
        self._rep = replica_of(mesh)
        self._n_rep = 1 if self._rep is None else self._rep.n
        self.compute_dtype = (None if compute_dtype is None
                              else torch_dtype(compute_dtype))
        self.remat = bool(remat) if remat is not None else \
            bool(_config.get("MXNET_BACKWARD_DO_MIRROR"))
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.input_names = self.data_names + self.label_names
        self.param_names = [n for n in self.arg_names
                            if n not in self.input_names]
        self.opt_name = optimizer
        self.opt_params = dict(optimizer_params or {})
        if optimizer not in _OPT_OPS:
            raise ValueError("TrainStep supports fused optimizers %r"
                             % sorted(_OPT_OPS))
        if clip_norm is not None and not float(clip_norm) > 0:
            # "not > 0" (rather than "<= 0") also rejects NaN
            raise ValueError("clip_norm must be positive, got %r"
                             % (clip_norm,))
        self.clip_norm = None if clip_norm is None else float(clip_norm)
        self._n_state, self._opt_op = _OPT_OPS[optimizer]
        # data inputs that carry token/category ids (feed an Embedding)
        # must NOT be cast to the compute dtype: bf16's 8-bit significand
        # aliases ids >= 256. Found from the graph, not by name.
        self._id_inputs = self._embedding_fed_inputs(symbol) \
            & set(self.data_names)
        self.device = (ctx or current_context()).torch_device()
        self._global_shape = {}
        # name -> spec of each parameter and of its optimizer state
        self._pspec = {}
        self._ospec = {}
        self._eval_fn = _graph_eval_fn(
            symbol, mesh=mesh, param_specs=self._pspec,
            batch_names=self.input_names if mesh is not None else None)
        self._donate = bool(donate)
        # last fit's guardrail outcome: masked_steps/rollbacks/lr_mult
        # ({} until a guarded fit ran) — tests and relaunchers read it
        self.guard_report = {}

    @staticmethod
    def _embedding_fed_inputs(symbol):
        """Variable names whose value feeds an Embedding lookup's data
        slot somewhere in the graph (ids, not numbers)."""
        nodes = json.loads(symbol.tojson()).get("nodes", [])
        out = set()
        for n in nodes:
            if n.get("op") == "Embedding" and n.get("inputs"):
                src = nodes[n["inputs"][0][0]]
                if src.get("op") == "null":
                    out.add(src["name"])
        return out

    # -- state -------------------------------------------------------------
    def init_state(self, initializer, batch_shapes, batch_dtypes=None,
                   dtype=None, arg_params=None, aux_params=None):
        """(params, opt_state, aux) on this step's device.

        initializer: an ``initializer.Initializer`` applied host-side,
        from the ``mx.random`` numpy stream (every rank of a mesh draws
        the same global arrays, then keeps its slice). arg_params /
        aux_params: values (NDArray, tensor or array, global shapes) to
        adopt instead; optimizer state starts at zero either way."""
        from ..initializer import InitDesc
        from ..ndarray import zeros as nd_zeros

        host = torch.device("cpu")
        arg_params = {k: _tensor(v, host)
                      for k, v in (arg_params or {}).items()}
        aux_params = {k: _tensor(v, host)
                      for k, v in (aux_params or {}).items()}
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(
            **dict(batch_shapes))
        name2shape = dict(zip(self.arg_names, arg_shapes))
        aux2shape = dict(zip(self.aux_names, aux_shapes))

        params, opt_state, aux = {}, {}, {}
        for n in self.param_names:
            if n in arg_params:
                v = arg_params[n]
                if tuple(v.shape) != tuple(name2shape[n]):
                    raise ValueError(
                        "arg_params[%r] has shape %r, symbol wants %r"
                        % (n, tuple(v.shape), tuple(name2shape[n])))
            else:
                arr = nd_zeros(name2shape[n], ctx=cpu())
                initializer(InitDesc(n), arr)
                v = arr.handle
            if dtype is not None:
                v = v.to(torch_dtype(dtype))
            self._set_specs(n, tuple(v.shape))
            # a copy: donated updates must not write into the caller's
            # arrays
            params[n] = shd.place(v, self._pspec[n], self.mesh).to(
                self.device, copy=True)
            opt_state[n] = tuple(
                torch.zeros(shd.local_shape(v.shape, self._ospec[n],
                                            self.mesh),
                            dtype=params[n].dtype, device=self.device)
                for _ in range(self._n_state))
        for n in self.aux_names:
            if n in aux_params:
                v = aux_params[n]
            else:
                v = (torch.ones if n.endswith("var") else torch.zeros)(
                    tuple(aux2shape[n]), dtype=torch.float32)
            aux[n] = v.to(self.device, copy=True)
        if self._spec_layout is not None:
            self._report_layout(params, opt_state)
        return params, opt_state, aux

    def _report_layout(self, params, opt_state):
        """The layout gauges at placement (shape math, no device sync):
        ``gspmd.sharded_params`` (parameters held as a shard) and
        ``gspmd.opt_state_bytes_per_dev`` (this rank's optimizer-state
        bytes); the whole report is ``describe_layout()``."""
        sharded = sum(1 for n, v in params.items()
                      if v.numel() < np.prod(self._global_shape[n]))
        opt_bytes = sum(s.numel() * s.element_size()
                        for states in opt_state.values() for s in states)
        _telemetry.gauge("gspmd.sharded_params").set(sharded)
        _telemetry.gauge("gspmd.opt_state_bytes_per_dev").set(opt_bytes)
        _telemetry.journal_event(
            "layout.bind", mesh=dict(self.mesh.shape), params=len(params),
            sharded_params=sharded, opt_state_bytes_per_dev=opt_bytes,
            rules=len(self._spec_layout.rules))

    def describe_layout(self):
        """The layout's per-parameter placement report (which rule
        claimed each parameter, global -> per-rank shard shapes), filled
        by ``init_state``/``load_state``."""
        if self._layout is None:
            return "no mesh/layout bound (single-device step)"
        return self._layout.describe()

    def _set_specs(self, name, shape):
        """Record the parameter's spec and its optimizer state's (the
        zero1 spec under optimizer_sharding='zero1'), from its global
        shape."""
        self._global_shape[name] = tuple(shape)
        if self.mesh is None:
            self._pspec[name] = self._ospec[name] = ()
            return
        lay = self._layout
        self._pspec[name] = lay.param_nsharding(name, shape)
        self._ospec[name] = lay.opt_nsharding(
            name, shape, zero=self.optimizer_sharding == "zero1")

    def _zero_extra(self, name):
        """The spec that zero1 splits the rank's parameter shard by
        further (the replica axes the optimizer state folds in beyond the
        parameter's own spec, each the minor axis of its entry), or None
        when the state is the shard itself."""
        pspec, ospec = self._pspec.get(name, ()), self._ospec.get(name, ())
        extra, real = [], False
        for d, entry in enumerate(ospec):
            have = _comm.entry_axes(pspec[d]) if d < len(pspec) else ()
            more = _comm.entry_axes(entry)[len(have):]
            real = real or any(self.mesh.shape[a] > 1 for a in more)
            extra.append(more if len(more) > 1 else
                         (more[0] if more else None))
        return tuple(extra) if real else None

    def _grad_axes(self, name):
        """The replica axes the parameter's gradient still sums over: all
        but those its spec splits it on (its gather's backward summed
        those)."""
        used = {a for e in self._pspec.get(name, ())
                for a in _comm.entry_axes(e)}
        return tuple(a for a in self._rep.axes if a not in used)

    def place_batch(self, batch):
        """Move batch arrays to the step's device once, before the step
        loop, so the host-to-device copy is not repaid every step. Under
        the replica axes (data, fsdp) this rank keeps its rows of each
        array's dim 0 (the global batch splits over them, data major);
        the other axes take the whole batch. A batch placed already is
        returned as it is."""
        if isinstance(batch, _Placed):
            return batch
        out = _Placed()
        for k, v in batch.items():
            t = _tensor(v, self.device) if self._n_rep == 1 else \
                _tensor(v, torch.device("cpu"))
            if self._n_rep > 1:
                spec = self._layout.batch_nsharding(t.dim())
                t = shd.place(t, spec, self.mesh).to(self.device)
            out[k] = t
        return out

    def _raw_feed(self, batch):
        """Named feed dict from a DataBatch (NDArrays unwrap to their
        tensors; no host round trip)."""
        feed = dict(zip(self.data_names, batch.data))
        if batch.label is not None:
            feed.update(zip(self.label_names, batch.label))
        return feed

    def make_placer(self):
        """place_fn for ``io.PrefetchingIter(place_fn=...)``: assembles
        the named feed and places it on the step's device, so batch t+1's
        copy runs on the prefetch thread while step t computes. ``fit``
        picks the result up from ``batch.placed``."""
        def place(batch):
            return self.place_batch(self._raw_feed(batch))
        return place

    def _stage(self, batch):
        """(batch, placed-feed): reuse an io-layer placement when the
        iterator staged one, else place it now."""
        placed = getattr(batch, "placed", None)
        if placed is None:
            placed = self.place_batch(self._raw_feed(batch))
        return batch, placed

    # -- the step ----------------------------------------------------------
    def _grads(self, params, aux, batch, rng, head_scale=None):
        """(outputs, new_aux, grads): the Executor's one forward-and-
        backward (``executor.forward_backward``) over the parameters,
        float32 gradients by name. ``head_scale`` (a 0-d device tensor,
        the loss scale) is every head's cotangent; None means ones."""
        cdt = self.compute_dtype
        feed = dict(batch)
        cast = None
        if cdt is not None:
            # compute-dtype cast: params + real-valued data only; the cast
            # is linear, so the gradients come back float32
            for k in self.data_names:
                if k not in self._id_inputs:
                    feed[k] = feed[k].to(cdt)

            def cast(leaves):
                return {k: v.to(cdt) for k, v in leaves.items()}
        out_grads = None
        if head_scale is not None:
            n_out = len(self.symbol.list_outputs())
            out_grads = [head_scale] * n_out
        outs, new_aux, grads = forward_backward(
            self._eval_fn, {**feed, **params}, aux, rng, self.param_names,
            cast=cast, out_grads=out_grads, remat=self.remat)
        if cdt is not None:
            # aux states (BN moving stats) keep their own dtype
            new_aux = {k: v.to(aux[k].dtype) for k, v in new_aux.items()}
        return outs, new_aux, grads

    def _step(self, state, batch, lr, rng, guard=None, inject=1.0):
        """One step: ((params, opt_state, aux), outs), and the finite
        flag (a 0-d bool tensor) third when ``guard`` (a
        ``guardrail.GuardSpec``) is given.

        The guarded step: guardrail state rides ``aux`` under reserved
        ``__gr_*`` keys and is stripped before the graph sees it; the
        head cotangent is the loss scale when the spec has a scaler;
        ``inject`` (1.0, or NaN on a ``nan@N`` step) multiplies the
        gradients where the finite flag is taken (a NaN clears the flag,
        so the masked update never reads it); the flag covers the scaled
        gradients and the loss outputs; the gradients are unscaled exactly and clipped;
        the whole update (params, optimizer state, aux) is masked on the
        device when the flag is false, and the scaler's next state
        follows the flag. ``norm_finite`` computes the flag, the clip
        scale and the norm in one reduction over every gradient."""
        params, opt_state, aux = state
        gr_state = {k: v for k, v in aux.items()
                    if k.startswith(_guardrail.GR_PREFIX)}
        if gr_state:
            aux = {k: v for k, v in aux.items()
                   if not k.startswith(_guardrail.GR_PREFIX)}
        attrs = dict(self.opt_params)
        if "rescale_grad" not in attrs and self.data_names:
            # Module.init_optimizer's default: the effective lr does not
            # scale with the batch unless the caller overrides
            attrs["rescale_grad"] = 1.0 / (
                batch[self.data_names[0]].shape[0] * self._n_rep)
        scaler = guard.scaler if guard is not None else None
        scale = gr_state[_guardrail.SCALE_KEY] if scaler is not None \
            else None
        outs, new_aux, grads = self._grads(params, aux, batch, rng,
                                           head_scale=scale)
        names = self.param_names
        with torch.no_grad():
            glist = [grads.pop(n) for n in names]
            if self._rep is not None:
                # the global batch's gradient: a sum over the replica
                # axes the parameter is not split on
                by_axes = {}
                for n, g in zip(names, glist):
                    by_axes.setdefault(self._grad_axes(n), []).append(g)
                for axes, gs in by_axes.items():
                    _comm.all_reduce_(gs, self.mesh, axes)
            inv = None if scale is None else 1.0 / scale
            finite = gscale = None
            if guard is not None or self.clip_norm is not None:
                _, ok, gs = _mt.norm_finite(
                    glist, list(outs) if guard is not None else (),
                    inject=inject if guard is not None else 1.0,
                    inv_scale=inv,
                    rescale=float(attrs.get("rescale_grad", 1.0)),
                    clip_norm=self.clip_norm)
                finite = ok if guard is not None else None
                if finite is not None and self._rep is not None:
                    # every rank masks the step if any rank's loss is
                    # not finite
                    finite = finite.clone()
                    _comm.all_reduce_([finite], self.mesh, self._rep.axes,
                                      "min")
                gscale = gs if self.clip_norm is not None else None
            if self.optimizer_sharding == "zero1":
                new_params, new_opt = self._zero1_update(
                    params, opt_state, glist, lr, attrs, finite, gscale,
                    inv)
            else:
                new_w, new_s = _mt.opt_update(
                    self._opt_op, [params[n] for n in names], glist,
                    [opt_state[n] for n in names], lr, attrs, flag=finite,
                    gscale=gscale, inv_scale=inv, donate=self._donate)
                new_params = dict(zip(names, new_w))
                new_opt = dict(zip(names, new_s))
            del glist
            if finite is not None:
                new_aux = {k: torch.where(finite, v, aux[k])
                           for k, v in new_aux.items()}
                if scaler is not None:
                    new_scale, new_good = scaler.next_state(
                        gr_state[_guardrail.SCALE_KEY],
                        gr_state[_guardrail.GOOD_KEY], finite)
                    new_gr = {_guardrail.SCALE_KEY: new_scale,
                              _guardrail.GOOD_KEY: new_good}
                    if self._donate:
                        for k, v in new_gr.items():
                            gr_state[k].copy_(v)
                    else:
                        gr_state = new_gr
            if self._donate:
                for k, v in new_aux.items():
                    if v is not aux[k]:
                        aux[k].copy_(v)
                new_aux = {k: aux[k] for k in new_aux}
        new_aux = {**new_aux, **gr_state}
        if guard is not None:
            return (new_params, new_opt, new_aux), outs, finite
        return (new_params, new_opt, new_aux), outs

    def _zero1_update(self, params, opt_state, glist, lr, attrs, finite,
                      gscale, inv):
        """ZeRO-1: the update of this rank's slice of every parameter
        shard whose state folds in more replica axes (the whole shard
        for the others), in one ``opt_update``; then each such shard is
        all-gathered over those axes."""
        names = self.param_names
        mesh = self.mesh
        dspec = {}
        ws, gs, ss = [], [], []
        for n, g in zip(names, glist):
            spec = self._zero_extra(n)
            w = params[n]
            if spec is not None:
                dspec[n] = spec
                # a view of the shard when the split dim is 0 (updated
                # in place under donation), else a copy
                w = shd.place(w, spec, mesh)
                g = shd.place(g, spec, mesh)
            ws.append(w)
            gs.append(g)
            ss.append(opt_state[n])
        new_w, new_s = _mt.opt_update(
            self._opt_op, ws, gs, ss, lr, attrs, flag=finite,
            gscale=gscale, inv_scale=inv, donate=self._donate)
        new_params = {}
        for n, w in zip(names, new_w):
            if n in dspec:
                full = shd.gather(w, dspec[n], mesh)
                if self._donate:
                    params[n].copy_(full)
                    full = params[n]
                w = full
            new_params[n] = w
        return new_params, dict(zip(names, new_s))

    def __call__(self, state, batch, lr, rng):
        return self._step(state, self.place_batch(batch), lr, rng)

    def export(self, prefix, state, batch):
        """Write the step for ``CompiledTrainStep.load``:

            prefix.train.meta.json   the JAX package's flat layout (state,
                                     batch and output names, shapes,
                                     dtypes; the same keys and values),
                                     plus ``torch_step``: the symbol's
                                     JSON, the optimizer and its params,
                                     compute_dtype, clip_norm, remat, the
                                     data and label names
            prefix.state.npz         the state in flat order (``s%05d``,
                                     ``step_count``)

        Flat order: params (sorted), the optimizer slots of each param,
        aux (sorted). The JAX package also writes the step as a StableHLO
        program, which runs only under JAX: here the step is rebuilt from
        the meta. Under a mesh every rank calls it and rank 0 writes the
        global arrays. Returns the meta's path."""
        refuse_capture(self.symbol, "TrainStep.export")
        state = self._global_state(state)
        params, opt_state, aux = state
        pn = sorted(params)
        an = sorted(aux)
        batch_names = list(self.data_names) + [
            k for k in sorted(batch) if k not in self.data_names]
        state_flat = [_to_numpy(t) for t in _flat_state(state, pn, an)]
        batch_vals = [_host_array(batch[n]) for n in batch_names]
        outputs = self.symbol.list_outputs()
        meta = {
            "param_names": pn,
            "n_opt_slots": self._n_state,
            "aux_names": an,
            "batch_names": batch_names,
            "batch_shapes": {n: list(np.shape(v)) for n, v in
                             zip(batch_names, batch_vals)},
            "batch_dtypes": {n: str(v.dtype) for n, v in
                             zip(batch_names, batch_vals)},
            "n_state_leaves": len(state_flat),
            "n_outputs": len(outputs),
            "output_names": outputs,
            _REBUILD_KEY: {
                "symbol": self.symbol.tojson(),
                "optimizer": self.opt_name,
                "optimizer_params": self.opt_params,
                "compute_dtype": None if self.compute_dtype is None
                else str(self.compute_dtype).replace("torch.", ""),
                "clip_norm": self.clip_norm,
                "remat": self.remat,
                "data_names": self.data_names,
                "label_names": self.label_names,
            },
        }
        if self._writer():
            with open(prefix + ".train.meta.json", "w") as f:
                json.dump(meta, f)
            np.savez(prefix + ".state.npz", step_count=np.int64(0),
                     **{"s%05d" % i: a for i, a in enumerate(state_flat)})
        self._barrier()
        return prefix + ".train.meta.json"

    def _metric_fused_step(self, metric, guard=None):
        """The step followed by the metric's device update of the batch's
        outputs: ``step_with_metric(state, placed, lr, rng, mstats,
        inject)`` -> (state, outs, mstats, flag). The stats stay on the
        device (a guarded step's are masked by its finite flag: a masked
        step contributes to neither ``sum`` nor ``num``), so an epoch
        runs without a device-to-host read."""
        label_names = list(self.label_names)

        def step_with_metric(state, placed, lr, rng, mstats, inject=1.0):
            flag = None
            if guard is not None:
                state, outs, flag = self._step(state, placed, lr, rng,
                                               guard=guard, inject=inject)
            else:
                state, outs = self._step(state, placed, lr, rng)
            stats = metric.device_update(
                [placed[n] for n in label_names], list(outs))
            if self._rep is not None:
                # the whole batch's sums
                _comm.all_reduce_(_tree_leaves(stats), self.mesh,
                                  self._rep.axes)
            if flag is not None:
                stats = _guardrail.mask_stats(stats, flag)
            if mstats is not None:
                stats = _tree_add(mstats, stats)
            return state, outs, stats, flag

        return step_with_metric

    def fit(self, train_data, num_epoch, initializer=None, lr=0.01,
            lr_scheduler=None, eval_metric="acc", state=None,
            arg_params=None, aux_params=None, checkpoint_prefix=None,
            checkpoint_period=1, resume=True, batch_end_callback=None,
            epoch_end_callback=None, seed=0, logger=None,
            fuse_metric=None, dispatch_ahead=None):
        """Module.fit for the step: epochs over a DataIter, metric
        tracking, periodic checkpointing and crash resume (reference
        base_module.py:fit), on this step.

        The loop is pipelined: batch t+1 is placed while step t runs,
        the metric accumulates on the device (when it has a device
        impl; the one host read is ``metric.get()`` at epoch end), and a
        bounded window keeps at most MXNET_DISPATCH_AHEAD steps queued on
        the card by waiting for the step K back: at most one blocking
        host sync a step.

        fuse_metric: None (auto: on the device when the metric has a
            device impl) | True | False (False = host metric path).
        dispatch_ahead: the window; default MXNET_DISPATCH_AHEAD (2).
        train_data: DataIter yielding DataBatch.
        lr_scheduler: callable(update_count) -> lr.
        checkpoint_prefix: save_state to ``prefix_NNNN`` each
            ``checkpoint_period`` epochs; with resume=True the newest
            readable checkpoint is loaded and training continues after
            it (the update counter too, from its ``.meta.json``).
        seed: step t's key is ``fold_in(PRNGKey(seed), t)``.

        Guardrails (MXNET_GUARDRAIL, default on): each step computes an
        all-finite flag over the loss outputs and gradients on the
        device and masks a non-finite step's update there; the flag is
        read at the window's wait. After MXNET_MAX_BAD_STEPS consecutive
        masked steps the loop restores the newest readable checkpoint
        (the lr times MXNET_ROLLBACK_LR_FACTOR) and raises
        NumericalDivergence once MXNET_MAX_ROLLBACKS is spent. With a
        checkpoint_prefix, SIGTERM or SIGINT requests a checkpoint at the
        next step boundary and the process exits with code
        guardrail.EXIT_PREEMPTED; a rerun with resume=True continues
        from that step. MXNET_LOSS_SCALE enables (dynamic) loss scaling.

        Returns (state, final_metric_value); the metric is None when a
        resumed run has no epochs left."""
        from .. import config as _config
        from .. import metric as metric_mod
        from .. import profiler as _profiler
        from ..initializer import Uniform

        log = logger or logging.getLogger(__name__)
        metric = metric_mod.create(eval_metric) \
            if not hasattr(eval_metric, "update") else eval_metric

        begin_epoch = 0
        n_update = 0
        skip_batches = 0
        if checkpoint_prefix and resume:
            found = self._scan_checkpoints(checkpoint_prefix, log)
            if found is not None:
                state, begin_epoch, n_update, skip_batches = found
        if begin_epoch >= num_epoch:
            log.info("checkpoints already cover all %d epochs; "
                     "nothing to train", num_epoch)
            return state, None
        if state is None:
            shapes = {}
            for name, shape in (train_data.provide_data
                                + train_data.provide_label):
                shapes[name] = tuple(shape)
            state = self.init_state(initializer or Uniform(0.01),
                                    shapes, arg_params=arg_params,
                                    aux_params=aux_params)

        guard = _guardrail.FitGuard.create(
            logger=log, checkpointing=bool(checkpoint_prefix))
        spec = guard.spec
        state = self._ensure_scaler_state(state, spec)

        ahead = dispatch_ahead if dispatch_ahead is not None \
            else _config.get("MXNET_DISPATCH_AHEAD")
        ahead = max(1, int(ahead))
        use_dev = bool(getattr(metric, "supports_device_update", False))
        fuse = use_dev if fuse_metric is None else bool(fuse_metric)
        fuse = fuse and use_dev
        fused_step = self._metric_fused_step(metric, spec) if fuse else None

        # telemetry: the journal and trace handles are hoisted out of the
        # loop — when both are off, the loop pays nothing; all of it is
        # host wall clock and adds no blocking host sync
        jr = _telemetry.journal()
        tr = _trace.tracer()
        timed = jr is not None or tr is not None
        step_hist = _telemetry.histogram("trainstep.step_ms") \
            if jr is not None else None
        _telemetry.journal_event("fit.start", loop="trainstep",
                                 num_epoch=num_epoch,
                                 begin_epoch=begin_epoch)
        compile_logged = False

        rng = PRNGKey(seed)
        inflight = deque()

        def drain_one():
            # the one blocking sync a step: the dispatch window's wait.
            # With the guardrail on it reads the step's finite flag
            item = inflight.popleft()
            _profiler.count_host_sync("dispatch_window")
            finite = item.wait()
            if spec is not None:
                guard.policy.record(finite)

        last_val = None
        with guard.shutdown_scope():
            epoch = begin_epoch
            while epoch < num_epoch:
                train_data.reset()
                metric.reset()
                mstats = None
                batches = iter(train_data)
                if skip_batches:
                    log.info("mid-epoch resume: skipping %d already-"
                             "trained batches of epoch %d",
                             skip_batches, epoch)
                    for _ in range(skip_batches):
                        if next(batches, None) is None:
                            break
                    skip_batches = 0
                nxt = next(batches, None)
                staged = None if nxt is None else self._stage(nxt)
                nbatch = 0
                t_iter = _telemetry.now_ms() if timed else 0.0
                try:
                    while staged is not None:
                        inject = guard.poll_faults() \
                            if spec is not None or \
                            guard.shutdown is not None else 1.0
                        if guard.preempt_requested():
                            self._preempt_exit(
                                checkpoint_prefix, epoch, nbatch,
                                state, n_update, log)
                        batch, placed = staged
                        # the step span carries the journal's step seq
                        ssp = _trace.start_span(
                            "train.step", loop="trainstep",
                            step=n_update, epoch=epoch) \
                            if tr is not None else None
                        cur_lr = (lr_scheduler(n_update) if lr_scheduler
                                  else lr) * guard.lr_mult
                        step_rng = fold_in(rng, n_update)
                        flag = None
                        t_disp = _telemetry.now_ms() if jr is not None \
                            else 0.0
                        with _profiler.step_scope(n_update):
                            if fuse:
                                state, outs, mstats, flag = fused_step(
                                    state, placed, cur_lr, step_rng,
                                    mstats, inject)
                                # the metric VIEWS the live epoch totals,
                                # so get() works mid-epoch (Speedometer)
                                # at the cost of that caller's one sync
                                metric.set_device_stats(mstats)
                            elif spec is not None:
                                state, outs, flag = self._step(
                                    state, placed, cur_lr, step_rng,
                                    guard=spec, inject=inject)
                            else:
                                state, outs = self._step(
                                    state, placed, cur_lr, step_rng)
                        n_update += 1
                        if jr is not None and not compile_logged:
                            # the first step builds and loads the kernels
                            compile_logged = True
                            _telemetry.journal_event(
                                "compile", site="TrainStep.fit",
                                wall_ms=round(
                                    _telemetry.now_ms() - t_disp, 3))
                        inflight.append(_InFlight(flag, self.device))
                        # stage batch t+1: its copy overlaps the step just
                        # queued on the card
                        t_data = _telemetry.now_ms() if timed else 0.0
                        nxt = next(batches, None)
                        staged = None if nxt is None \
                            else self._stage(nxt)
                        data_ms = _telemetry.now_ms() - t_data \
                            if timed else 0.0
                        if not fuse:
                            # the host metric path (this rank's rows
                            # under a data axis)
                            labels = batch.label if self._n_rep == 1 \
                                else [_nd_wrap(placed[n])
                                      for n in self.label_names]
                            metric.update(labels,
                                          [_nd_wrap(o) for o in outs])
                        t_win = _telemetry.now_ms() if timed else 0.0
                        while len(inflight) > ahead:
                            drain_one()
                        if timed:
                            # boundary-to-boundary iteration wall: the
                            # sum over an epoch is the epoch's wall
                            now_ = _telemetry.now_ms()
                            if jr is not None:
                                step_hist.observe(now_ - t_iter)
                                _telemetry.journal_step(
                                    loop="trainstep", step=n_update - 1,
                                    epoch=epoch,
                                    wall_ms=round(now_ - t_iter, 3),
                                    data_wait_ms=round(data_ms, 3),
                                    window_wait_ms=round(now_ - t_win,
                                                         3),
                                    samples=int(placed[
                                        self.data_names[0]].shape[0])
                                    if self.data_names else 0)
                            if tr is not None:
                                _trace.add_span("step.data_wait",
                                                t_data,
                                                t_data + data_ms,
                                                parent=ssp)
                                _trace.add_span("step.window_wait",
                                                t_win, now_,
                                                parent=ssp)
                            t_iter = now_
                        _trace.end_span(ssp)
                        if batch_end_callback:
                            batch_end_callback(_SimpleBatchEnd(
                                epoch, nbatch, metric,
                                locals={"state": state, "outs": outs,
                                        "placed": placed}))
                        del outs
                        nbatch += 1
                    if spec is not None:
                        # drain the window so a bad tail is seen BEFORE
                        # this epoch's checkpoint is published
                        while inflight:
                            drain_one()
                except _guardrail.RollbackNeeded:
                    # the jump abandoned the open step span
                    _trace.unwind()
                    state, epoch, n_update, skip_batches = \
                        self._rollback(checkpoint_prefix, guard, log)
                    state = self._ensure_scaler_state(state, spec)
                    inflight.clear()
                    continue
                name, val = metric.get()     # the one blocking read
                last_val = val
                log.info("Epoch[%d] Train-%s=%f", epoch, name, val)
                if jr is not None:
                    _telemetry.journal_event("epoch.end",
                                             loop="trainstep",
                                             epoch=epoch, steps=nbatch)
                # device-memory watermark: at epoch boundaries only
                _profiler.sample_device_memory("epoch.end")
                if checkpoint_prefix and \
                        (epoch + 1) % checkpoint_period == 0:
                    self._save_fit_checkpoint(checkpoint_prefix, epoch,
                                              state, n_update)
                if epoch_end_callback:
                    epoch_end_callback(epoch, state)
                epoch += 1
        self.guard_report = guard.report()
        return state, last_val

    # -- fit plumbing (checkpoint scan / publish / rollback / preempt) -----
    def _ensure_scaler_state(self, state, spec):
        """Seed the loss scaler's device state into aux when enabled
        and absent (fresh runs and checkpoints from unscaled runs)."""
        if spec is None or spec.scaler is None:
            return state
        params, opt_state, aux = state
        if _guardrail.SCALE_KEY in aux:
            return state
        aux = dict(aux)
        aux.update(spec.scaler.init_aux(self.device))
        _telemetry.gauge("guardrail.loss_scale").set(
            spec.scaler.init_scale)
        return params, opt_state, aux

    def _scan_checkpoints(self, checkpoint_prefix, log):
        """Newest readable ``prefix_NNNN.npz`` → (state, begin_epoch,
        n_update, skip_batches), or None. A preemption boundary
        checkpoint (meta carries epoch/nbatch) resumes INSIDE the epoch
        it interrupted, at the exact step."""
        import glob as _glob
        import re as _re
        import zipfile as _zipfile

        found = sorted(
            p for p in _glob.glob(checkpoint_prefix + "_*.npz")
            if _re.search(r"_\d{4}\.npz$", p))
        # a model/optimizer MISMATCH (ValueError) is NOT in the torn
        # set: it must fail loudly, not fall back silently
        path, loaded = _newest_readable(
            found, lambda p: self.load_state(p[:-len(".npz")]),
            (OSError, EOFError, _zipfile.BadZipFile), log)
        if path is None:
            return None
        latest = path[:-len(".npz")]
        begin_epoch = int(latest.rsplit("_", 1)[1]) + 1
        n_update = 0
        skip_batches = 0
        try:
            with open(latest + ".meta.json") as f:
                meta = json.load(f)
            n_update = int(meta["n_update"])
            if "nbatch" in meta:
                begin_epoch = int(meta["epoch"])
                skip_batches = int(meta["nbatch"])
        except (OSError, ValueError, KeyError):
            log.warning(
                "%s.meta.json missing/unreadable; lr schedule "
                "and rng folds restart from update 0", latest)
        log.info("resumed %s (continuing at epoch %d, update %d%s)",
                 latest, begin_epoch, n_update,
                 ", batch %d" % skip_batches if skip_batches else "")
        return loaded, begin_epoch, n_update, skip_batches

    def _save_fit_checkpoint(self, prefix, epoch, state, n_update,
                             extra_meta=None):
        ck = "%s_%04d" % (prefix, epoch)
        meta = {"n_update": n_update}
        if extra_meta:
            meta.update(extra_meta)

        def write_meta():
            tmp = ck + ".meta.json.tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f)
            _guardrail.durable_replace(tmp, ck + ".meta.json")

        self.save_state(ck, state, also=write_meta)
        return ck

    # -- the state as global arrays (checkpoints, export) ------------------
    def _writer(self):
        """True on the rank that writes files (rank 0 of the mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self):
        if self.mesh is not None and self.mesh.size > 1:
            import torch.distributed as dist
            dist.barrier()

    def _place_flat(self, meta, flat):
        """An export's flat global state as this rank's shards."""
        pn, k = meta["param_names"], meta["n_opt_slots"]
        out = list(flat)
        for i, n in enumerate(pn):
            self._set_specs(n, tuple(flat[i].shape))
            out[i] = shd.place(flat[i], self._pspec[n], self.mesh)
            for j in range(k):
                at = len(pn) + i * k + j
                out[at] = shd.place(flat[at], self._ospec[n], self.mesh)
        return out

    def _global_state(self, state):
        """(params, opt_state, aux) as the global arrays: each split
        tensor gathered over its axes (a collective under a mesh)."""
        if self.mesh is None:
            return state
        params, opt_state, aux = state
        missing = [n for n in params if n not in self._pspec]
        if missing:
            raise ValueError("state holds params %r this step did not "
                             "place (init_state or load_state places them)"
                             % missing[:4])
        gp = {n: shd.gather(v, self._pspec[n], self.mesh)
              for n, v in params.items()}
        go = {n: tuple(shd.gather(t, self._ospec[n], self.mesh) for t in ss)
              for n, ss in opt_state.items()}
        return gp, go, dict(aux)

    def _rollback(self, checkpoint_prefix, guard, log):
        """Escalation: restore the newest readable checkpoint after
        MXNET_MAX_BAD_STEPS consecutive masked steps. Raises
        NumericalDivergence when no checkpoint exists or the rollback
        budget is spent."""
        if not checkpoint_prefix:
            guard.policy.no_checkpoint("no checkpoint_prefix "
                                       "configured")
        guard.policy.begin_rollback()
        found = self._scan_checkpoints(checkpoint_prefix, log)
        if found is None:
            guard.policy.no_checkpoint(
                "no readable checkpoint under %r" % checkpoint_prefix)
        state, begin_epoch, n_update, skip = found
        log.warning(
            "guardrail: rolled back to the newest finite checkpoint "
            "(epoch %d, update %d); lr multiplier now %g "
            "(rollback %d/%d)", begin_epoch, n_update,
            guard.policy.lr_mult, guard.policy.rollbacks_done,
            guard.policy.max_rollbacks)
        return state, begin_epoch, n_update, skip

    def _preempt_exit(self, prefix, epoch, nbatch, state, n_update,
                      log):
        """Graceful-shutdown endgame: publish the boundary checkpoint
        (meta records the exact step) and exit EXIT_PREEMPTED so a
        relauncher rerunning the same command resumes seamlessly."""
        if prefix:
            ck = self._save_fit_checkpoint(
                prefix, epoch, state, n_update,
                {"epoch": epoch, "nbatch": nbatch})
            _telemetry.counter("guardrail.preempt_checkpoints").inc()
            _telemetry.journal_event("guardrail.preempt_checkpoint",
                                     loop="trainstep", epoch=epoch,
                                     nbatch=nbatch)
            log.warning(
                "preemption: boundary checkpoint %s written at epoch "
                "%d batch %d (update %d); exiting with code %d",
                ck, epoch, nbatch, n_update, _guardrail.EXIT_PREEMPTED)
        raise SystemExit(_guardrail.EXIT_PREEMPTED)

    def save_state(self, prefix, state, also=None):
        """Checkpoint (params, opt_state, aux) to ``prefix.npz`` in the
        JAX package's layout (keys ``p:<name>``, ``o<i>:<name>``,
        ``a:<name>``; bf16 as the 2-byte void entries ml_dtypes
        bfloat16 becomes in ``.npz``), published durably: written aside,
        fsynced, renamed, the directory fsynced. Under a mesh every rank
        calls it: the state is gathered into the global arrays and rank 0
        writes them (then ``also()``, if given), before every rank goes
        on."""
        params, opt_state, aux = self._global_state(state)
        if not self._writer():
            self._barrier()
            return prefix + ".npz"
        if _guardrail.SCALE_KEY in aux:
            # the checkpoint read materializes the scale on the host
            # anyway: the one place the gauge updates without a sync of
            # its own
            _telemetry.gauge("guardrail.loss_scale").set(
                float(aux[_guardrail.SCALE_KEY]))
        blob = {}
        for n, v in params.items():
            blob["p:%s" % n] = _to_numpy(v)
        for n, states in opt_state.items():
            for i, s in enumerate(states):
                blob["o%d:%s" % (i, n)] = _to_numpy(s)
        for n, v in aux.items():
            blob["a:%s" % n] = _to_numpy(v)
        tmp = prefix + ".npz.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **blob)
        _guardrail.durable_replace(tmp, prefix + ".npz")
        if also is not None:
            also()
        self._barrier()
        return prefix + ".npz"

    def load_state(self, prefix):
        """Restore a save_state checkpoint (of either package) onto this
        step's device; under a mesh each rank keeps its slices of the
        global arrays, whatever mesh wrote them. Mismatched checkpoints
        (another model's params or aux, another optimizer's state-slot
        count) fail loudly."""
        path = prefix + ".npz"
        params, opt_state, aux = {}, {}, {}
        slots = {}
        with np.load(path, allow_pickle=False) as blob:
            for key in blob.files:
                kind, name = key.split(":", 1)
                t = _from_numpy(blob[key], path, key)
                if kind == "p":
                    self._set_specs(name, tuple(t.shape))
                    t = shd.place(t, self._pspec[name], self.mesh)
                elif kind != "a" and self.mesh is not None:
                    self._set_specs(name, tuple(t.shape))
                    t = shd.place(t, self._ospec[name], self.mesh)
                t = t.to(self.device)
                if kind == "p":
                    params[name] = t
                elif kind == "a":
                    aux[name] = t
                else:
                    slots.setdefault(name, {})[int(kind[1:])] = t

        def _mismatch(what, names):
            raise ValueError("checkpoint %s %s %r — saved from a "
                             "different model/optimizer"
                             % (path, what, sorted(names)))

        if set(params) != set(self.param_names):
            missing = set(self.param_names) - set(params)
            _mismatch("is missing params" if missing else
                      "has unknown params",
                      missing or set(params) - set(self.param_names))
        # guardrail state (loss scale etc.) rides aux under reserved
        # __gr_* keys; it is optional — not part of the model contract
        aux_model = {n for n in aux
                     if not n.startswith(_guardrail.GR_PREFIX)}
        if aux_model != set(self.aux_names):
            missing = set(self.aux_names) - aux_model
            _mismatch("is missing aux states" if missing else
                      "has unknown aux states",
                      missing or aux_model - set(self.aux_names))
        for n in self.param_names:
            saved = slots.get(n, {})
            if sorted(saved) != list(range(self._n_state)):
                raise ValueError(
                    "checkpoint %s has optimizer slots %r for %r; this "
                    "step's %r optimizer needs exactly %d — resuming "
                    "across optimizers would silently corrupt the "
                    "trajectory" % (path, sorted(saved), n,
                                    self.opt_name, self._n_state))
            opt_state[n] = tuple(saved[i] for i in range(self._n_state))
        if self._spec_layout is not None:
            self._report_layout(params, opt_state)
        return params, opt_state, aux


def _flat_state(state, param_names, aux_names):
    """The export's flat order: params, the optimizer slots of each
    param, aux."""
    params, opt_state, aux = state
    flat = [params[n] for n in param_names]
    for n in param_names:
        flat.extend(opt_state[n])
    flat.extend(aux[n] for n in aux_names)
    return flat


def _host_array(v):
    """A batch value as a host numpy array (NDArray, tensor or
    array-like)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    return np.asarray(v)


class CompiledTrainStep:
    """Runs an exported training step, rebuilt from its files alone
    (``prefix.train.meta.json`` and ``prefix.state.npz``): no symbol or
    optimizer is passed in. The surface is the JAX package's
    ``CompiledTrainStep``: ``step(batch, lr, seed=None)`` feeds a batch,
    runs one update and returns the outputs as numpy (bf16 ones as
    float32); ``seed`` defaults to the running step count, and the step's
    key is ``PRNGKey(seed)``.

    The state lives in static device tensors, updated in place. On the
    card the first ``step`` runs the step on a side stream (the warm-up,
    which is that step's update), then captures the step as one
    ``torch.cuda.CUDAGraph`` whose inputs are static tensors: the batch,
    the seed (the key is built from it inside the graph) and the lr (the
    multi-tensor update reads it on the device). Every later ``step``
    copies its batch in, writes its seed and lr and replays the graph. A
    capture that fails raises; nothing falls back to running the step
    eagerly. On the CPU (``ctx=mx.cpu()``) the same object runs the step
    directly, each call."""

    def __init__(self, train_step, meta, state_flat, step_count=0):
        self._train = train_step
        self._meta = meta
        self._step_count = int(step_count)
        device = train_step.device
        self._state = [t.to(device, copy=True) for t in state_flat]
        self._graph = None
        self._static = None      # (batch, seed, lr, outputs) of the graph
        self._pinned = None
        self.capture_ms = None

    @classmethod
    def load(cls, prefix, ctx=None, mesh=None):
        """Rebuild the step exported under ``prefix`` on ``ctx`` (default:
        the current context, gpu(0) unless a ``with mx.cpu():`` scope
        says otherwise). ``mesh``: run the step over the ranks of a
        ``sharding.make_mesh`` mesh (its heuristic rules place the state;
        ``step`` takes the global batch and keeps this rank's rows). On
        the CPU the step runs eagerly over the mesh each call. On CUDA a
        mesh of more than one rank raises: the collectives of a captured
        step need NCCL with one GPU a rank, and over gloo (ranks sharing a
        GPU) every collective syncs the host through pinned buffers,
        which a CUDA graph cannot hold."""
        import os

        if mesh is not None and mesh.size > 1 and \
                (ctx or current_context()).device_type == "gpu":
            raise NotImplementedError(
                "CompiledTrainStep over a mesh of %d ranks on CUDA: a "
                "captured step's collectives need NCCL with one GPU a rank "
                "(backend %r here; over gloo every collective syncs the "
                "host through pinned buffers, which a CUDA graph cannot "
                "hold); run TrainStep over the mesh instead"
                % (mesh.size, mesh.backend))

        from ..symbol import load_json
        meta_path = prefix + ".train.meta.json"
        meta = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        if meta is None or _REBUILD_KEY not in meta:
            if os.path.exists(prefix + ".train.stablehlo"):
                raise ValueError(
                    "%s holds a training step exported by the JAX package "
                    "(a StableHLO program, which runs only under JAX) and "
                    "no %r entry in its meta; export the step with the "
                    "PyTorch package's TrainStep.export" % (prefix,
                                                            _REBUILD_KEY))
            raise ValueError("%s is no exported training step: %s has no "
                             "%r entry" % (prefix, meta_path, _REBUILD_KEY))
        spec = meta[_REBUILD_KEY]
        step = TrainStep(load_json(spec["symbol"]),
                         data_names=spec["data_names"],
                         label_names=spec["label_names"],
                         optimizer=spec["optimizer"],
                         optimizer_params=spec["optimizer_params"],
                         compute_dtype=spec["compute_dtype"],
                         remat=spec["remat"], clip_norm=spec["clip_norm"],
                         mesh=mesh, ctx=ctx)
        path = prefix + ".state.npz"
        with np.load(path, allow_pickle=False) as blob:
            state = [_from_numpy(blob["s%05d" % i], path, "s%05d" % i)
                     for i in range(meta["n_state_leaves"])]
            count = int(blob["step_count"]) \
                if "step_count" in blob.files else 0
        if mesh is not None:
            state = step._place_flat(meta, state)
        return cls(step, meta, state, step_count=count)

    @property
    def batch_names(self):
        return list(self._meta["batch_names"])

    @property
    def batch_shapes(self):
        return {n: tuple(s) for n, s in
                self._meta["batch_shapes"].items()}

    @property
    def device(self):
        return self._train.device

    def _unflat(self):
        meta = self._meta
        pn, an = meta["param_names"], meta["aux_names"]
        k = meta["n_opt_slots"]
        flat = self._state
        params = dict(zip(pn, flat[:len(pn)]))
        i = len(pn)
        opt_state = {}
        for n in pn:
            opt_state[n] = tuple(flat[i:i + k])
            i += k
        return params, opt_state, dict(zip(an, flat[i:i + len(an)]))

    def _run(self, batch, lr, seed):
        """The unguarded step on the state tensors, in place; the key is
        ``PRNGKey(seed)`` (a device key for a device seed)."""
        state, outs = self._train._step(self._unflat(), batch, lr,
                                        PRNGKey(seed))
        for old, new in zip(self._state, _flat_state(
                state, self._meta["param_names"], self._meta["aux_names"])):
            if new is not old:
                old.copy_(new)
        return outs

    def _feed(self, batch):
        missing = [n for n in self._meta["batch_names"] if n not in batch]
        if missing:
            raise ValueError("batch missing inputs: %s" % missing)
        feed = {}
        for n in self._meta["batch_names"]:
            a = np.asarray(_host_array(batch[n]),
                           dtype=self._meta["batch_dtypes"][n])
            want = tuple(self._meta["batch_shapes"][n])
            if a.shape != want:
                raise ValueError("input %r: shape %s, exported %s"
                                 % (n, a.shape, want))
            feed[n] = torch.from_numpy(np.ascontiguousarray(a))
        return feed

    def _capture(self, feed, lr, seed):
        """Warm up on a side stream (this step's update), then capture
        the step into one CUDA graph over static inputs."""
        if self._train._opt_op not in _mt.MT_OPS:
            raise ValueError(
                "a captured step reads its lr on the device, which only the "
                "multi-tensor update does (%s); the %r optimizer's update "
                "reads it on the host" % (sorted(_mt.MT_OPS),
                                          self._train.opt_name))
        dev = self.device
        batch = {n: t.to(dev) for n, t in feed.items()}
        seed_t = torch.full((), seed, dtype=torch.int64, device=dev)
        lr_t = torch.full((), float(np.float32(lr)), dtype=torch.float32,
                          device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            outs = self._run(batch, lr_t, seed_t)
            outs = [o.clone() for o in outs]
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = _telemetry.now_ms()
        with gc_paused(), torch.cuda.graph(graph):
            static_outs = self._run(batch, lr_t, seed_t)
        torch.cuda.synchronize(dev)
        self.capture_ms = _telemetry.now_ms() - t0
        self._graph = graph
        self._static = (batch, seed_t, lr_t, list(static_outs))
        self._pinned = {n: torch.empty_like(t, pin_memory=True)
                        for n, t in feed.items()}
        return outs

    def step(self, batch, lr, seed=None):
        """One training step. batch: dict name -> array of the exported
        shapes. Returns the step's outputs (loss heads) as numpy."""
        feed = self._feed(batch)
        if seed is None:
            seed = self._step_count
        seed = int(seed) & 0xFFFFFFFF
        if self.device.type != "cuda":
            outs = self._run(self._train.place_batch(feed), float(lr), seed)
        elif self._graph is None:
            outs = self._capture(feed, lr, seed)
        else:
            static_batch, seed_t, lr_t, outs = self._static
            for n, t in feed.items():
                self._pinned[n].copy_(t)
                static_batch[n].copy_(self._pinned[n], non_blocking=True)
            seed_t.fill_(seed)
            lr_t.fill_(float(np.float32(lr)))
            self._graph.replay()
        self._step_count += 1
        return [(o.float() if o.dtype == torch.bfloat16 else o)
                .detach().cpu().numpy().copy() for o in outs]

    def get_params(self):
        """The current parameters by name, as numpy (bf16 as float32);
        the global arrays under a mesh (a collective)."""
        params, _, _ = self._train._global_state(self._unflat())
        return {n: (t.float() if t.dtype == torch.bfloat16 else t)
                .detach().cpu().numpy() for n, t in params.items()}

    def get_param_shape(self, name):
        """Shape of a parameter without a copy."""
        pn = self._meta["param_names"]
        if name not in pn:
            raise KeyError("unknown param %r; params: %s"
                           % (name, sorted(pn)))
        return self._train._global_shape.get(
            name, tuple(self._state[pn.index(name)].shape))

    def save_state(self, prefix):
        """``prefix.state.npz`` in the exported layout, with the step
        count, so a reloaded step continues the default seeds (under a
        mesh every rank calls it and rank 0 writes the global arrays)."""
        flat = _flat_state(self._train._global_state(self._unflat()),
                           self._meta["param_names"],
                           self._meta["aux_names"])
        if self._train._writer():
            np.savez(prefix + ".state.npz",
                     step_count=np.int64(self._step_count),
                     **{"s%05d" % i: _to_numpy(t)
                        for i, t in enumerate(flat)})
        self._train._barrier()
        return prefix + ".state.npz"


def _tree_leaves(t):
    if isinstance(t, dict):
        return [x for k in t for x in _tree_leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _tree_leaves(v)]
    return [t]


def _tree_add(a, b):
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_add(x, y) for x, y in zip(a, b))
    return a + b


def make_train_step(symbol, **kwargs):
    """Factory: TrainStep (see class docs)."""
    return TrainStep(symbol, **kwargs)
