"""The training step on one device — the PyTorch twin of
``mxnet_tpu/parallel/trainer.py``'s ``TrainStep`` without its mesh.

The JAX package compiles forward, backward and the fused optimizer
update into one ``jax.jit`` program. Here the same step runs eagerly:
the Executor's forward-and-backward (``executor.forward_backward``: the
Symbol graph under autograd with ``is_train=True``, then
``torch.autograd.grad`` with ones as head cotangents), then the
registry's fused update op per parameter.
The semantics are those of the JAX step: ``compute_dtype`` casts the
parameters and the real-valued data (never labels or inputs that feed an
Embedding, found from the graph), gradients come back in float32 through
the cast, aux states keep their own dtype, ``rescale_grad`` defaults to
1/batch, and ``clip_norm`` bounds the global norm of the rescaled
gradient. ``donate=True`` updates the state tensors in place (the JAX
package donates their buffers); ``donate=False`` leaves them untouched.

Not in this slice (ROADMAP Queue A items 4, 8 and 9): the device mesh,
sharding layouts and the sharded optimizer, which raise
``NotImplementedError``; rematerialisation, which raises too; ``fit``
with the fused metric, the guardrail's masking and loss scaler;
``export`` / ``CompiledTrainStep``; ``save_state`` / ``load_state``.
"""
from __future__ import annotations

import json

import torch

from ..base import torch_dtype
from ..context import context_of, cpu, current_context
from ..executor import _graph_eval_fn, forward_backward
from ..ndarray import array
from ..ops.registry import get_op

__all__ = ["make_train_step", "TrainStep"]

# fused optimizer ops: name -> (#state tensors, op name)
_OPT_OPS = {
    "sgd": (1, "sgd_mom_update"),       # momentum (0.0 => plain sgd math)
    "adam": (2, "adam_update"),
    "rmsprop": (1, "rmsprop_update"),
    "ftrl": (2, "ftrl_update"),
    "signum": (0, "signsgd_update"),
}


def _not_ported(what, item):
    raise NotImplementedError(
        "%s is not ported to the PyTorch package yet (ROADMAP %s)"
        % (what, item))


def _tensor(x, device):
    """A tensor on ``device`` from an NDArray, tensor or array-like
    (``nd.array``'s rules: float64 and int64 host arrays become float32
    and int32, as ``jnp.asarray`` makes them without x64)."""
    return array(x, ctx=context_of(device)).handle


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

        clip_norm: clip gradients by global norm before the optimizer
        (the norm of the gradient after rescale_grad).

        ctx: the device (default: the current context, gpu(0) unless a
        ``with mx.cpu():`` scope says otherwise).

        mesh / layout / optimizer_sharding / remat are not ported yet
        and raise NotImplementedError."""
        for arg, value in (("mesh", mesh), ("layout", layout),
                           ("optimizer_sharding", optimizer_sharding)):
            if value is not None:
                _not_ported("TrainStep(%s=...)" % arg,
                            "Queue A item 9, the parallel axes")
        if remat:
            _not_ported("TrainStep(remat=True)",
                        "Queue A item 4, rematerialisation")
        self.symbol = symbol
        self.compute_dtype = (None if compute_dtype is None
                              else torch_dtype(compute_dtype))
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
        self._eval_fn = _graph_eval_fn(symbol)
        self._donate = bool(donate)

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
        from the ``mx.random`` numpy stream. arg_params / aux_params:
        values (NDArray, tensor or array) to adopt instead; optimizer
        state starts at zero either way."""
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
            # a copy: donated updates must not write into the caller's
            # arrays
            params[n] = v.to(self.device, copy=True)
            opt_state[n] = tuple(torch.zeros_like(params[n])
                                 for _ in range(self._n_state))
        for n in self.aux_names:
            if n in aux_params:
                v = aux_params[n]
            else:
                v = (torch.ones if n.endswith("var") else torch.zeros)(
                    tuple(aux2shape[n]), dtype=torch.float32)
            aux[n] = v.to(self.device, copy=True)
        return params, opt_state, aux

    def place_batch(self, batch):
        """Move batch arrays to the step's device once, before the step
        loop, so the host-to-device copy is not repaid every step."""
        return {k: _tensor(v, self.device) for k, v in batch.items()}

    # -- the step ----------------------------------------------------------
    def _grads(self, params, aux, batch, rng):
        """(outputs, new_aux, grads): the Executor's one forward-and-
        backward (``executor.forward_backward``: ones as head cotangents)
        over the parameters, float32 gradients by name."""
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
        outs, new_aux, grads = forward_backward(
            self._eval_fn, {**feed, **params}, aux, rng, self.param_names,
            cast=cast)
        if cdt is not None:
            # aux states (BN moving stats) keep their own dtype
            new_aux = {k: v.to(aux[k].dtype) for k, v in new_aux.items()}
        return outs, new_aux, grads

    def __call__(self, state, batch, lr, rng):
        params, opt_state, aux = state
        batch = self.place_batch(batch)
        attrs = dict(self.opt_params)
        if "rescale_grad" not in attrs and self.data_names:
            # Module.init_optimizer's default: the effective lr does not
            # scale with the batch unless the caller overrides
            attrs["rescale_grad"] = 1.0 / batch[self.data_names[0]].shape[0]
        outs, new_aux, grads = self._grads(params, aux, batch, rng)

        with torch.no_grad():
            if self.clip_norm is not None:
                # bound the EFFECTIVE gradient's global norm (after
                # rescale_grad, i.e. the per-example mean)
                rescale = float(attrs.get("rescale_grad", 1.0))
                gnorm = rescale * torch.sqrt(sum(
                    torch.sum(torch.square(g.float()))
                    for g in grads.values()))
                gscale = torch.clamp(
                    self.clip_norm / torch.clamp_min(gnorm, 1e-12), max=1.0)
                grads = {n: (g * gscale).to(g.dtype)
                         for n, g in grads.items()}

            opt_fn = get_op(self._opt_op).fn
            new_params, new_opt = {}, {}
            for n in self.param_names:
                res = opt_fn(params[n], grads.pop(n), *opt_state[n],
                             lr=float(lr), **attrs)
                new_p = res[0] if self._n_state else res
                new_s = tuple(res[1:]) if self._n_state else ()
                if self._donate:
                    params[n].copy_(new_p)
                    for s, ns in zip(opt_state[n], new_s):
                        s.copy_(ns)
                    new_p, new_s = params[n], opt_state[n]
                new_params[n], new_opt[n] = new_p, tuple(new_s)
            if self._donate:
                for k, v in new_aux.items():
                    if v is not aux[k]:
                        aux[k].copy_(v)
                new_aux = {k: aux[k] for k in new_aux}
        return (new_params, new_opt, new_aux), outs


def make_train_step(symbol, **kwargs):
    """Factory: TrainStep (see class docs)."""
    return TrainStep(symbol, **kwargs)
