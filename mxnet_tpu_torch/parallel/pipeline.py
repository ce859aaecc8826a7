"""Pipeline parallelism — stages split over a mesh axis, GPipe microbatch
schedule; the PyTorch twin of ``mxnet_tpu/parallel/pipeline.py``.

Each rank on the ``pipe`` axis runs ONE stage's parameters; microbatches
stream through, activations hop to the next stage over
``_comm.ppermute``. The bubble is the standard (S-1)/(M+S-1) GPipe
fraction. The schedule is differentiable: wrap it in a loss and
``backward`` runs through the rotations' inverse permutations, so the
same function serves training and inference.
"""
from __future__ import annotations

import inspect

import torch

from .._threefry import PRNGKey, as_key, fold_in
from . import _comm

__all__ = ["pipeline_apply", "pipeline_from_symbol"]


def _flatten(tree):
    """(leaves, rebuild) of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [x for p in parts for x in p[0]], rebuild


class _GPipe(torch.autograd.Function):
    """The GPipe schedule with its backward written out: the reverse
    schedule sends each stage input's cotangent back one rank (the
    forward rotation's inverse permutation) tick by tick, so every rank
    runs the same collectives in the same order whatever its stage
    reads (stage 0 reads the stream, the others their carry)."""

    @staticmethod
    def forward(ctx, stage, mesh, axis, n_ticks, stream, *leaves):
        S = mesh.shape[axis] if mesh is not None else 1
        me = _comm.axis_index(mesh, axis)
        M = stream.shape[0]
        perm = [(j, (j + 1) % S) for j in range(S)]
        train = any(x.requires_grad for x in (stream,) + leaves)
        mine = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        carry = torch.zeros(stream.shape[1:], dtype=stream.dtype,
                            device=stream.device)
        ticks = []
        outs = torch.zeros_like(stream)
        for t in range(n_ticks):
            if me == 0:
                # stage 0 ingests microbatch t (zeros once the stream ends)
                x = stream[t] if t < M else torch.zeros_like(carry)
            else:
                x = carry
            x = x.detach().requires_grad_(train)
            with torch.set_grad_enabled(train):
                y = stage(mine, x, t)
            ticks.append((x, y))
            # microbatch t reaches the last stage at tick t + S - 1
            slot = t - (S - 1)
            if me == S - 1 and slot >= 0:
                outs[slot] = y.detach()
            if t < n_ticks - 1:
                carry = _comm._raw_ppermute(y.detach(), mesh, axis, perm) \
                    if S > 1 else y.detach()
        ctx.run = (mesh, axis, ticks, mine, M)
        # replicate the last stage's collected outputs to every rank
        return _comm._raw_all_reduce(outs, mesh.group(axis)) \
            if S > 1 else outs

    @staticmethod
    def backward(ctx, g):
        mesh, axis, ticks, mine, M = ctx.run
        S = mesh.shape[axis] if mesh is not None else 1
        me = _comm.axis_index(mesh, axis)
        inv = [((j + 1) % S, j) for j in range(S)]
        dparams = [torch.zeros_like(p) for p in mine]
        dstream = torch.zeros((M,) + tuple(g.shape[1:]), dtype=g.dtype,
                              device=g.device)
        dcarry = None
        wrt = [p for p in mine if p.requires_grad]
        for t in reversed(range(len(ticks))):
            x, y = ticks[t]
            dy = torch.zeros_like(y)
            if dcarry is not None:
                # the next stage's cotangent of the carry it read
                dy = dy + (_comm._raw_ppermute(dcarry, mesh, axis, inv)
                           if S > 1 else dcarry)
            slot = t - (S - 1)
            if me == S - 1 and slot >= 0:
                dy = dy + g[slot]
            grads = torch.autograd.grad(y, [x] + wrt, dy,
                                        allow_unused=True)
            dx = grads[0] if grads[0] is not None else torch.zeros_like(x)
            gi = iter(grads[1:])
            for i, p in enumerate(mine):
                if p.requires_grad:
                    d = next(gi)
                    if d is not None:
                        dparams[i] += d
            if me == 0:
                if t < M:
                    dstream[t] += dx
                # stage 0 never read a carry: nothing goes back
                dcarry = torch.zeros_like(dx)
            else:
                dcarry = dx
        ctx.run = None
        # every rank holds the stream: its cotangent sums over the axis
        if S > 1:
            dstream = _comm._raw_all_reduce(dstream, mesh.group(axis))
        return (None, None, None, None, dstream,
                *(d if p.requires_grad else None
                  for d, p in zip(dparams, mine)))


def pipeline_apply(stage_fn, stage_params, microbatches, mesh,
                   axis_name="pipe"):
    """Run ``stage_fn`` composed over S pipeline stages.

    stage_fn(params_i, x) -> y: one stage's computation; every stage
        must map (mb, ...) -> (mb, ...) of the same shape and dtype. A
        stage_fn whose THIRD positional parameter has no default also
        receives the schedule tick t (an int) — combine it with the
        rank's ``axis_index`` for per-(stage, microbatch) randomness.
    stage_params: a tree (dict, list, tuple) whose leaves have leading
        dim S: stage i's slice is row i, and rank i of the axis runs it
        (its gradient comes back whole on every rank).
    microbatches: (M, mb, ...) — M microbatches streamed through, the
        same on every rank of the axis.
    Returns (M, mb, ...): stage S-1's outputs for every microbatch, the
    same on every rank of the axis.

    Equivalent to ``for p in stages: x = stage_fn(p, x)`` per
    microbatch."""
    S = mesh.shape[axis_name] if mesh is not None else 1
    M = microbatches.shape[0]
    # tick is passed only to a stage_fn whose THIRD parameter is a plain
    # positional without a default
    pos = [p for p in inspect.signature(stage_fn).parameters.values()
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    takes_tick = len(pos) >= 3 and pos[2].default is pos[2].empty
    leaves, rebuild = _flatten(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != S:
            raise ValueError("stage_params leaves need a leading stage "
                             "dim of %d (the %r axis), got shape %r"
                             % (S, axis_name, tuple(leaf.shape)))
    # this rank's stage: row i of each leaf (its cotangent all-gathers)
    mine = [_comm.scatter_to_axis(leaf, mesh, axis_name, 0)[0]
            for leaf in leaves]

    def stage(params, x, t):
        p = rebuild(params)
        return stage_fn(p, x, t) if takes_tick else stage_fn(p, x)

    return _GPipe.apply(stage, mesh, axis_name, M + S - 1, microbatches,
                        *mine)


def pipeline_from_symbol(layer_sym, stage_params, microbatches, mesh,
                         axis_name="pipe", data_name="data",
                         is_train=False, rng=None):
    """GPipe over a SYMBOL-defined stage — pipeline parallelism for the
    symbolic API.

    layer_sym: a Symbol mapping input ``data_name`` of shape (mb, ...) to
        a single same-shape/dtype output — e.g.
        ``models.transformer.get_stage_symbol``. Must carry no auxiliary
        states (the rotating schedule has no slot for them; use
        LayerNorm-style stages).
    stage_params: dict name -> (S, ...) stacked per-stage values for
        every non-data argument of ``layer_sym`` (stage i's slice is row
        i).
    microbatches: (M, mb, ...) streamed through all S stages.
    Returns (M, mb, ...), differentiable; same contract as
    ``pipeline_apply``."""
    from ..executor import _graph_eval_fn

    if layer_sym.list_auxiliary_states():
        raise ValueError(
            "pipeline stages cannot carry auxiliary states %r — the GPipe "
            "schedule has no slot for cross-microbatch mutable state"
            % layer_sym.list_auxiliary_states())
    if data_name not in layer_sym.list_arguments():
        raise ValueError(
            "data_name %r is not an argument of the stage symbol (has %r) "
            "— the microbatch stream would be ignored"
            % (data_name, layer_sym.list_arguments()))
    arg_names = [n for n in layer_sym.list_arguments() if n != data_name]
    missing = set(arg_names) - set(stage_params)
    if missing:
        raise ValueError("stage_params missing %r" % sorted(missing))
    if len(layer_sym.list_outputs()) != 1:
        raise ValueError("a pipeline stage must have exactly 1 output, "
                         "got %r" % layer_sym.list_outputs())

    eval_fn = _graph_eval_fn(layer_sym)
    key = as_key(rng) if rng is not None else PRNGKey(0)
    stage = _comm.axis_index(mesh, axis_name)

    def stage_fn(params, x, t):
        # distinct randomness per (stage, tick): dropout masks must not
        # repeat across stages or microbatches
        k = fold_in(fold_in(key, stage), t)
        outs, _aux = eval_fn({**params, data_name: x}, {}, k, is_train)
        return outs[0]

    return pipeline_apply(stage_fn,
                          {n: stage_params[n] for n in arg_names},
                          microbatches, mesh, axis_name=axis_name)
