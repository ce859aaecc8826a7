"""Ring attention — sequence parallelism over a mesh axis; the PyTorch
twin of ``mxnet_tpu/parallel/ring.py``.

The standard ring schedule (Liu et al., Ring Attention, 2023): queries
stay put, key/value blocks rotate around the axis (``_comm.ppermute``:
``batch_isend_irecv`` on NCCL, through pinned host buffers on gloo), and
each visiting block runs the port's ``flash_attention_with_lse`` — the
hand-written Hopper kernels on the card, bf16 or exact float32 — whose
(o, lse) results merge by a logsumexp. Gradients flow through the same
kernels' backward with the lse cotangent, and through the rotations'
inverse permutations.

``ring_attention`` takes (B, H, T, D) tensors that every rank of the axis
holds whole (the replicated activations of this port's mesh: see
``_comm``), keeps this rank's T/n rows (``scatter_to_axis``), runs the
ring, and gathers the output (``gather_from_axis``), so the caller sees
the whole result. ``ring_attention_local`` is the ring body over this
rank's shards alone.

The causal mask over GLOBAL positions reduces, for equal shards, to three
whole-block cases on the visiting block id: src < me fully visible, src
== me the ordinary diagonal, src > me skipped. The windowed (banded) ring
is unrolled over the visiting-block distance t, each step's band offset
t·Tb a kernel argument, and runs only r = min(n-1, (window-2)//Tb + 1)
rotations: a window reaches at most r predecessor blocks. A query row with
no valid key in a visiting block gets o = 0 and lse ≈ -1e30 from the
kernels (ROADMAP Queue C 1), so the merge weights it by exp(lse - lse_total)
= 0 and the ring's result equals the JAX package's even where one block's
does not.
"""
from __future__ import annotations

import torch

from . import _comm

__all__ = ["ring_attention", "ring_attention_local"]

_NEG_INF = -1e30


def _merge(o_acc, lse_acc, o_b, lse_b):
    lse = torch.logaddexp(lse_acc, lse_b)
    w_a = torch.exp(lse_acc - lse)[..., None]
    w_b = torch.exp(lse_b - lse)[..., None]
    return o_acc * w_a + o_b.float() * w_b, lse


def _skip(q3):
    return (torch.zeros(q3.shape, dtype=torch.float32, device=q3.device),
            torch.full(q3.shape[:2], _NEG_INF, dtype=torch.float32,
                       device=q3.device))


def _ring_local(q, k, v, mesh, axis_name, causal, scale):
    from ..ops.attention import flash_attention_with_lse
    n = mesh.shape[axis_name] if mesh is not None else 1
    me = _comm.axis_index(mesh, axis_name)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if causal and Tq != Tk:
        raise ValueError("causal ring attention needs equal sequence "
                         "shards (Tq=%d, Tk=%d)" % (Tq, Tk))
    q3 = q.reshape(B * H, Tq, D)

    def block_attend(k_cur, v_cur, src):
        k3 = k_cur.reshape(B * H, Tk, D)
        v3 = v_cur.reshape(B * H, Tk, D)
        if causal and src > me:
            return _skip(q3)
        return flash_attention_with_lse(q3, k3, v3, scale=scale,
                                        causal=bool(causal and src == me))

    o_acc, lse_acc = _skip(q3)
    perm = [(j, (j + 1) % n) for j in range(n)]
    k_cur, v_cur = k, v
    for t in range(n):
        o_b, lse_b = block_attend(k_cur, v_cur, (me - t) % n)
        o_acc, lse_acc = _merge(o_acc, lse_acc, o_b, lse_b)
        if t < n - 1:
            # rotate K/V to the next neighbour; the last visiting block
            # is consumed without a wasted rotation
            k_cur = _comm.ppermute(k_cur, mesh, axis_name, perm)
            v_cur = _comm.ppermute(v_cur, mesh, axis_name, perm)
    # a rank that skipped the last visiting block still runs its
    # rotation's backward
    o_acc = _comm.tie(o_acc, k_cur, v_cur) if k_cur is not k else o_acc
    return o_acc.reshape(B, H, Tq, D).to(q.dtype)


def _ring_local_windowed(q, k, v, mesh, axis_name, scale, window):
    from ..ops.attention import flash_attention_with_lse
    n = mesh.shape[axis_name] if mesh is not None else 1
    me = _comm.axis_index(mesh, axis_name)
    B, H, Tq, D = q.shape
    Tb = k.shape[2]
    if Tq != Tb:
        raise ValueError("windowed ring attention needs equal sequence "
                         "shards (Tq=%d, Tk=%d)" % (Tq, Tb))
    q3 = q.reshape(B * H, Tq, D)
    r = 0 if window <= 1 else min(n - 1, (window - 2) // Tb + 1)
    o_acc, lse_acc = _skip(q3)
    perm = [(j, (j + 1) % n) for j in range(n)]
    k_cur, v_cur = k, v
    for t in range(r + 1):
        if me >= t:
            # a rank whose t-th predecessor wraps past position 0 has no
            # such block (causal)
            o_b, lse_b = flash_attention_with_lse(
                q3, k_cur.reshape(B * H, Tb, D),
                v_cur.reshape(B * H, Tb, D), scale=scale, causal=True,
                window=window, band_offset=t * Tb)
        else:
            o_b, lse_b = _skip(q3)
        o_acc, lse_acc = _merge(o_acc, lse_acc, o_b, lse_b)
        if t < r:
            k_cur = _comm.ppermute(k_cur, mesh, axis_name, perm)
            v_cur = _comm.ppermute(v_cur, mesh, axis_name, perm)
    # a rank that skipped the last visiting block still runs its
    # rotation's backward
    o_acc = _comm.tie(o_acc, k_cur, v_cur) if k_cur is not k else o_acc
    return o_acc.reshape(B, H, Tq, D).to(q.dtype)


def ring_attention_local(q, k, v, mesh, axis_name="sp", causal=False,
                         scale=None, window=0):
    """The ring over this rank's (B, H, T/n, D) shards (rank i holds rows
    [i·T/n, (i+1)·T/n)); returns this rank's output rows."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window and not causal:
        raise ValueError("window attention requires causal=True")
    if window:
        return _ring_local_windowed(q, k, v, mesh, axis_name,
                                    float(scale), int(window))
    return _ring_local(q, k, v, mesh, axis_name, bool(causal),
                       float(scale))


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False,
                   scale=None, window=0):
    """Sequence-parallel attention over (B, H, T, D) tensors that every
    rank of ``axis_name`` holds whole; T splits over the axis inside, and
    the whole output comes back on every rank.

    window > 0 (causal only) runs the BANDED ring: each rank visits only
    the predecessor blocks its window reaches, so both compute and ring
    communication scale with the window, not the context."""
    if window and not causal:
        raise ValueError("window attention requires causal=True")
    qs, ks, vs = (_comm.scatter_to_axis(x, mesh, axis_name, 2)
                  for x in (q, k, v))
    out = ring_attention_local(qs, ks, vs, mesh, axis_name, causal=causal,
                               scale=scale, window=window)
    return _comm.gather_from_axis(out, mesh, axis_name, 2)
