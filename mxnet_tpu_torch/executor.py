"""Graph evaluation — the PyTorch twin of ``mxnet_tpu/executor.py``'s
``_graph_eval_fn``, without the mesh/sharding lowering.

The JAX package lowers a Symbol to one pure function that ``jax.jit``
compiles. Here the same function runs eagerly, op by op, on whatever
device its inputs live on; each intermediate is released after its last
consumer, so memory follows the live set as XLA's buffer planning does
there. Aux states are threaded by ``state_inputs`` and every rng-drawing
node gets its own generator folded from the run's seed and the node's
topological uid, as there. The ``Executor`` (bind, backward, the fused
training forward) comes with ROADMAP Queue A item 3.
"""
from __future__ import annotations

import torch

__all__ = ["_graph_eval_fn"]


def _node_generator(seed, uid, device):
    """A generator for node ``uid`` of a run seeded ``seed``: the torch
    stand-in for ``jax.random.fold_in(rng, uid)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + uid) & 0x7FFFFFFFFFFFFFFF)
    return gen


def _graph_eval_fn(symbol):
    """Build the function evaluating `symbol`'s graph.

    Returns fn(arg_vals: dict name->tensor, aux_vals: dict, seed: int,
    is_train: bool) -> (tuple outputs, dict new_aux)."""
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

    def eval_fn(arg_vals, aux_vals, seed, is_train):
        env = {}
        aux_out = dict(aux_vals)
        for pos, node in enumerate(order):
            if node.op is None:
                env[id(node)] = [aux_out[node.name] if node.is_aux
                                 else arg_vals[node.name]]
                continue
            xs = [env[id(m)][i] for (m, i) in node.inputs]
            attrs = dict(node.attrs)
            if node.op.takes_is_train:
                attrs["is_train"] = is_train
            if node.op.needs_rng:
                attrs["rng"] = _node_generator(seed, node_uid[id(node)],
                                               xs[0].device)
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
            env[id(node)] = outs
            for nid in release_at.get(pos, ()):
                env.pop(nid, None)
        outputs = tuple(env[id(n)][i] for (n, i) in entries)
        return outputs, aux_out

    return eval_fn
