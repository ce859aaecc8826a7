"""Mixture-of-experts FFN with expert parallelism — the PyTorch twin of
``mxnet_tpu/parallel/moe.py`` (Switch-style top-1 routing, Shazeer et al.
2017; Fedus et al. 2021).

Top-1 routing with capacity dropping: a token's float32 softmax over
``x @ gate_w`` picks its expert (``argmax``, first index on ties) and its
gate (the max probability); slots in each expert's capacity buffer go
first come, first served through a cumsum of the one-hot, and tokens
past the capacity contribute zeros (the residual around the layer passes
them through). The dispatch is one ``index_add`` into the (E, cap, D)
buffers and the combine one gather, with no host read, so a captured
CUDA graph (the decode step) holds them. The expert products are
``torch.einsum`` (batched GEMMs), as they are plain jnp in the JAX
package.

``dense_moe`` is the single-program form. ``moe_ffn`` is the expert-
parallel form over a mesh axis: each rank routes its T/n tokens (the
capacity comes from the LOCAL token count, so it drops other tokens than
``dense_moe`` over the same tokens — compare each with its own twin),
packs them into per-expert buffers, exchanges them with one
``_comm.all_to_all``, runs its resident experts, and sends the results
back with a second one.
"""
from __future__ import annotations

import math

import torch

from . import _comm

__all__ = ["moe_ffn", "dense_moe"]


def _capacity(n_tokens, capacity_factor, num_experts):
    return max(1, int(math.ceil(n_tokens * float(capacity_factor)
                                / num_experts)))


def _hits(idx, n):
    """(n, N) int32: row e marks the tokens routed to expert e (the
    transposed one-hot, by comparison: ``F.one_hot`` checks its range
    with a host read, which a captured graph cannot hold; expert-major,
    so the slot cumsum runs along the contiguous token dim)."""
    return (torch.arange(n, device=idx.device)[:, None] == idx[None, :]).to(
        torch.int32)


def _route(x, gate_w, num_experts, capacity, offset=None):
    """Top-1 routing of local tokens: (expert, slot, keep, gate) per
    token. ``offset`` (E,) adds the tokens earlier ranks of a data axis
    routed to each expert, so slots follow the global token order."""
    probs = torch.softmax(x.float() @ gate_w.float(), dim=-1)
    gate = probs.amax(dim=-1)
    expert = torch.argmax(probs, dim=-1)
    hits = _hits(expert, num_experts)
    slot = ((torch.cumsum(hits, dim=1, dtype=torch.int32) - 1)
            * hits).sum(0)
    rank_slot = slot if offset is None else slot + offset[expert]
    keep = rank_slot < capacity
    return expert, slot, keep, gate


def _dispatch(x, expert, slot, keep, num_buckets, cap):
    """Scatter kept tokens into (num_buckets, cap, D) capacity buffers."""
    slot = slot.clamp(0, cap - 1)
    idx = expert * cap + slot
    vals = torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    disp = torch.zeros((num_buckets * cap, x.shape[-1]), dtype=x.dtype,
                       device=x.device).index_add(0, idx, vals)
    return disp.reshape(num_buckets, cap, x.shape[-1])


def _combine(y, expert, slot, keep, gate, dtype):
    """Gather each token's expert output back, gated; dropped tokens
    zero."""
    cap = y.shape[1]
    idx = expert * cap + slot.clamp(0, cap - 1)
    out = y.reshape(-1, y.shape[-1]).index_select(0, idx) \
        * gate[:, None].to(dtype)
    return torch.where(keep[:, None], out,
                       torch.zeros((), dtype=out.dtype,
                                   device=out.device)).to(dtype)


def _experts(tokens, w1, w2):
    h = torch.relu(torch.einsum("ecd,edh->ech", tokens, w1))
    return torch.einsum("ech,ehd->ecd", h, w2)


def dense_moe(x, gate_w, w1, w2, capacity_factor=1.25):
    """Single-program Switch MoE: route the tokens into capacity buffers,
    run every expert's FFN, combine.

    x (N, D); gate_w (D, E); w1 (E, D, H); w2 (E, H, D) -> (N, D);
    capacity-dropped tokens zero."""
    N = x.shape[0]
    E = gate_w.shape[1]
    cap = _capacity(N, capacity_factor, E)
    expert, slot, keep, gate = _route(x, gate_w, E, cap)
    disp = _dispatch(x, expert, slot, keep, E, cap)
    return _combine(_experts(disp, w1, w2), expert, slot, keep, gate,
                    x.dtype)


def dense_moe_over_data(x, gate_w, w1, w2, mesh, axis_name="data",
                        capacity_factor=1.25):
    """``dense_moe`` of the whole batch when each rank of ``axis_name``
    (an axis, or a tuple of axes merged major first: the replica axes)
    holds a contiguous slice of its tokens (the data-parallel step): the
    capacity comes from the global token count and slots follow the
    global token order (each expert's count on earlier ranks offsets this
    rank's slots), as the JAX package's one global program routes them.
    The experts run on this rank's kept tokens only."""
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    n, me = 1, 0
    for a in axes:
        n *= mesh.shape[a]
        me = me * mesh.shape[a] + mesh.axis_index(a)
    N = x.shape[0]
    E = gate_w.shape[1]
    cap = _capacity(N * n, capacity_factor, E)
    with torch.no_grad():
        probs = torch.softmax(x.float() @ gate_w.float(), dim=-1)
        counts = _hits(torch.argmax(probs, dim=-1), E).sum(1)
        every = _comm.gather_local(counts[None].contiguous(),
                                   ((axes if len(axes) > 1 else axes[0]),),
                                   mesh)
        offset = every[:me].sum(0)
    expert, slot, keep, gate = _route(x, gate_w, E, cap, offset=offset)
    # a kept token's local slot is below both the capacity and N
    local_cap = min(cap, N)
    disp = _dispatch(x, expert, slot, keep, E, local_cap)
    return _combine(_experts(disp, w1, w2), expert, slot, keep, gate,
                    x.dtype)


def moe_ffn(x, gate_w, w1, w2, mesh, axis_name="expert",
            capacity_factor=1.25):
    """Expert-parallel MoE FFN.

    x: (T, D) tokens, whole on every rank of ``axis_name``; each rank
    routes its T/n of them. gate_w: (D, E) router weights (replicated).
    w1: (E, D, H), w2: (E, H, D) expert weights — whole, or this rank's
    E/n experts (rank i holds experts [i·E/n, (i+1)·E/n), as a parameter
    on the mesh does). Returns the whole (T, D) on every rank;
    capacity-dropped tokens yield 0."""
    n = mesh.shape[axis_name] if mesh is not None else 1
    E = gate_w.shape[1]
    if E % n:
        raise ValueError("num_experts %d must divide over %d devices"
                         % (E, n))
    El = E // n
    if n > 1 and w1.shape[0] == E:
        w1 = _comm.scatter_to_axis(w1, mesh, axis_name, 0)
        w2 = _comm.scatter_to_axis(w2, mesh, axis_name, 0)
    if w1.shape[0] != El or w2.shape[0] != El:
        raise ValueError("expert weights hold %d and %d experts; %d (all) "
                         "or %d (this rank's) expected"
                         % (w1.shape[0], w2.shape[0], E, El))
    xl = _comm.scatter_to_axis(x, mesh, axis_name, 0)
    gw = _comm.copy_to_axis(gate_w, mesh, axis_name)
    Tl, D = xl.shape
    cap = _capacity(Tl, capacity_factor, E)
    expert, slot, keep, gate = _route(xl, gw, E, cap)
    disp = _dispatch(xl, expert, slot, keep, E, cap)
    # exchange: rank d keeps the buffers of its El resident experts from
    # every sender -> (n senders, El, cap, D)
    recv = _comm.all_to_all(disp.reshape(n, El, cap, D), mesh, axis_name,
                            0, 0)
    tokens = recv.transpose(0, 1).reshape(El, n * cap, D)
    y = _experts(tokens, w1, w2)                       # (El, n*cap, D)
    # back to sender-major and home to the owning ranks
    y = y.reshape(El, n, cap, D).transpose(0, 1)
    back = _comm.all_to_all(y, mesh, axis_name, 0, 0)
    # group-major flatten IS the global expert order
    mine = back.reshape(E, cap, D)
    out = _combine(mine, expert, slot, keep, gate, xl.dtype)
    return _comm.gather_from_axis(out, mesh, axis_name, 0)


def moe_ffn_reference(x, gate_w, w1, w2, n, capacity_factor=1.25):
    """``moe_ffn``'s result in one process, by its per-rank rule: the
    tokens split into n contiguous chunks, each routed by ``dense_moe``
    with the capacity of its own count, over the whole expert weights."""
    return torch.cat([dense_moe(c, gate_w, w1, w2, capacity_factor)
                      for c in x.chunk(n, dim=0)], dim=0)
