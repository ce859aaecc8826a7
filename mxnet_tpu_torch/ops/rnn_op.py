"""Fused multi-layer RNN op — the PyTorch twin of
``mxnet_tpu/ops/rnn_op.py`` (reference: the cuDNN RNN operator,
src/operator/rnn-inl.h:124).

The parameter blob keeps the reference's cuDNN packing, so FusedRNNCell
pack/unpack and trained checkpoints are interchangeable with the JAX
package's:

  all weights (layer-major, direction-inner): W_i2h(G*H, in), W_h2h(G*H, H)
  then all biases: b_i2h(G*H), b_h2h(G*H)

Gate order: lstm [i, f, c, o], gru [r, z, n] (cuDNN's and torch's order,
equal to the unfused cells'); the gru candidate is
``n = tanh(xn + r * hn)`` with ``hn`` including ``b_h2h``.

Route: torch's fused recurrence (``torch._VF.lstm``, ``gru``,
``rnn_tanh``, ``rnn_relu``) with each (layer, direction)'s weights passed
as views of the blob, so the gradient flows back into the blob through
the views. It runs natively on the CPU and through cuDNN on CUDA; a CUDA
tensor cuDNN does not accept raises rather than taking another route.
The blob's layout (all weights before all biases) is not cuDNN's, so
cuDNN copies the weights into its own buffer on every call. Inter-layer
dropout draws the JAX package's threefry masks (``fold_in(rng, layer)``),
so under training with ``p > 0`` the layers run one call each with the
mask between them; cuDNN's own dropout is never used. ``_rnn_reference``
is the plain per-step loop that mirrors the JAX package's scan.
"""
from __future__ import annotations

import torch

from .. import _threefry
from ..base import MXNetError
from .registry import register

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _layer_param_sizes(mode, input_size, state_size, num_layers,
                       bidirectional):
    """Per-(layer, direction) weight/bias sizes in blob order."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    sizes = []
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * dirs
        for _d in range(dirs):
            sizes.append(("w_i2h", gates * state_size * isz,
                          (gates * state_size, isz)))
            sizes.append(("w_h2h", gates * state_size * state_size,
                          (gates * state_size, state_size)))
    for layer in range(num_layers):
        for _d in range(dirs):
            sizes.append(("b_i2h", gates * state_size,
                          (gates * state_size,)))
            sizes.append(("b_h2h", gates * state_size,
                          (gates * state_size,)))
    return sizes


def rnn_param_size(mode, input_size, state_size, num_layers,
                   bidirectional):
    """Total packed parameter count (FusedRNNCell needs this)."""
    return sum(s for _, s, _ in _layer_param_sizes(
        mode, input_size, state_size, num_layers, bidirectional))


def _unpack_params(params, mode, input_size, state_size, num_layers,
                   bidirectional):
    """Split the flat blob into {(layer, dir): dict of views}."""
    sizes = _layer_param_sizes(mode, input_size, state_size, num_layers,
                               bidirectional)
    if params.numel() != sum(s for _, s, _ in sizes):
        raise MXNetError(
            "RNN: a parameter blob of %d values for a %s of %d layers, "
            "input %d, state %d%s needs %d" % (
                params.numel(), mode, num_layers, input_size, state_size,
                ", bidirectional" if bidirectional else "",
                sum(s for _, s, _ in sizes)))
    dirs = 2 if bidirectional else 1
    order = [(layer, d) for layer in range(num_layers)
             for d in range(dirs)]
    out = {ld: {} for ld in order}
    pos = 0
    # the weights of every (layer, direction), then their biases
    for i, (kind, size, shape) in enumerate(sizes):
        out[order[(i // 2) % len(order)]][kind] = \
            params[pos:pos + size].view(shape)
        pos += size
    return out


def _cell_step(mode):
    """One-step transition: (params, carry, x_t) -> (new carry, output)."""
    if mode in ("rnn_relu", "rnn_tanh"):
        act = torch.tanh if mode == "rnn_tanh" else torch.relu

        def step(p, carry, x_t):
            (h,) = carry
            pre = x_t @ p["w_i2h"].T + p["b_i2h"] + \
                h @ p["w_h2h"].T + p["b_h2h"]
            h2 = act(pre)
            return (h2,), h2
        return step
    if mode == "lstm":
        def step(p, carry, x_t):
            h, c = carry
            pre = x_t @ p["w_i2h"].T + p["b_i2h"] + \
                h @ p["w_h2h"].T + p["b_h2h"]
            i_g, f_g, c_g, o_g = torch.chunk(pre, 4, dim=-1)
            c2 = torch.sigmoid(f_g) * c + \
                torch.sigmoid(i_g) * torch.tanh(c_g)
            h2 = torch.sigmoid(o_g) * torch.tanh(c2)
            return (h2, c2), h2
        return step
    if mode == "gru":
        def step(p, carry, x_t):
            (h,) = carry
            xi = x_t @ p["w_i2h"].T + p["b_i2h"]
            hh = h @ p["w_h2h"].T + p["b_h2h"]
            xr, xz, xn = torch.chunk(xi, 3, dim=-1)
            hr, hz, hn = torch.chunk(hh, 3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h2 = (1 - z) * n + z * h
            return (h2,), h2
        return step
    raise ValueError("unknown RNN mode %r" % mode)


def _full_batch(s, batch):
    """An initial state with a broadcast batch dim of 1 (the symbolic
    toolkit's begin_state zeros) expanded to the batch, contiguous."""
    if s.shape[1] != batch:
        s = s.expand(s.shape[0], batch, *s.shape[2:])
    return s.contiguous()


def _dropout(x, p, rng, layer):
    """The JAX op's inter-layer mask: bernoulli(fold_in(rng, layer))."""
    from ._mesh_ctx import replica
    if replica() is not None:
        raise MXNetError(
            "RNN: inter-layer dropout under the replica mesh axes would "
            "draw each rank's mask over its own batch columns (the batch "
            "is axis 1 of the (T, N, C) data): set p=0 or train on one "
            "rank")
    keep = 1.0 - p
    mask = _threefry.bernoulli(_threefry.fold_in(rng, layer), keep,
                               tuple(x.shape), x.device)
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def _setup(data, parameters, state, state_cell, state_size, num_layers,
           bidirectional, mode):
    if mode not in _GATES:
        raise ValueError("unknown RNN mode %r" % mode)
    _seq, batch, input_size = data.shape
    params = _unpack_params(parameters, mode, input_size, int(state_size),
                            int(num_layers), bidirectional)
    h0 = _full_batch(state, batch)
    c0 = _full_batch(state_cell, batch) if mode == "lstm" else None
    return params, h0, c0


def _outputs(x, hs, cs, mode, state_outputs):
    if not state_outputs:
        return x
    if mode == "lstm":
        return x, hs, cs
    return x, hs


def _rnn_reference(data, parameters, state, state_cell=None, state_size=0,
                   num_layers=1, bidirectional=False, mode="lstm", p=0.0,
                   state_outputs=False, is_train=False, rng=None, **_):
    """The plain version: a per-step loop over every (layer, direction),
    as the JAX package's scan steps, with the same masks."""
    params, h0, c0 = _setup(data, parameters, state, state_cell,
                            state_size, num_layers, bidirectional, mode)
    dirs = 2 if bidirectional else 1
    step = _cell_step(mode)
    x = data
    out_h, out_c = [], []
    for layer in range(num_layers):
        layer_outs = []
        for d in range(dirs):
            sidx = layer * dirs + d
            carry = (h0[sidx], c0[sidx]) if mode == "lstm" else (h0[sidx],)
            ys = [None] * x.shape[0]
            for t in (range(x.shape[0] - 1, -1, -1) if d == 1
                      else range(x.shape[0])):
                carry, ys[t] = step(params[(layer, d)], carry, x[t])
            layer_outs.append(torch.stack(ys))
            out_h.append(carry[0])
            if mode == "lstm":
                out_c.append(carry[1])
        x = torch.cat(layer_outs, dim=-1) if dirs == 2 else layer_outs[0]
        if is_train and p > 0 and layer < num_layers - 1 and \
                rng is not None:
            x = _dropout(x, p, rng, layer)
    return _outputs(x, torch.stack(out_h),
                    torch.stack(out_c) if out_c else None, mode,
                    state_outputs)


def _fused(x, params, layers, dirs, mode, h0, c0):
    """One torch fused-recurrence call over ``layers`` (consecutive)."""
    flat = []
    for layer in layers:
        for d in range(dirs):
            p = params[(layer, d)]
            flat += [p["w_i2h"], p["w_h2h"], p["b_i2h"], p["b_h2h"]]
    sl = slice(layers[0] * dirs, (layers[-1] + 1) * dirs)
    hx = (h0[sl], c0[sl]) if mode == "lstm" else h0[sl]
    # train=True keeps cuDNN's reserve space for the backward; no
    # dropout is ever asked of it
    return getattr(torch._VF, mode)(
        x, hx, flat, True, len(layers), 0.0, torch.is_grad_enabled(),
        dirs == 2, False)


@register("RNN", arg_names=("data", "parameters", "state", "state_cell"),
          takes_is_train=True, needs_rng=True,
          defaults={"state_size": 0, "num_layers": 1,
                    "bidirectional": False, "mode": "lstm", "p": 0.0,
                    "state_outputs": False, "lstm_state_clip_min": None,
                    "lstm_state_clip_max": None})
def _rnn_op(data, parameters, state, state_cell=None, state_size=0,
            num_layers=1, bidirectional=False, mode="lstm", p=0.0,
            state_outputs=False, is_train=False, rng=None, **_):
    """data: (T, N, input); state: (L*D, N, H) or (L*D, 1, H); lstm also
    state_cell. Returns the last layer's (T, N, D*H) outputs, and under
    ``state_outputs`` the final h (and c) of every (layer, direction)."""
    if data.is_cuda and not torch.backends.cudnn.is_acceptable(data):
        raise MXNetError(
            "RNN on CUDA runs through cuDNN, which does not accept this "
            "input (%s; torch.backends.cudnn.enabled=%s)"
            % (data.dtype, torch.backends.cudnn.enabled))
    params, h0, c0 = _setup(data, parameters, state, state_cell,
                            state_size, num_layers, bidirectional, mode)
    dirs = 2 if bidirectional else 1
    num_layers = int(num_layers)
    masked = is_train and p > 0 and rng is not None and num_layers > 1
    groups = [[layer] for layer in range(num_layers)] if masked \
        else [list(range(num_layers))]
    x, hs, cs = data, [], []
    for layers in groups:
        res = _fused(x, params, layers, dirs, mode, h0, c0)
        x = res[0]
        hs.append(res[1])
        if mode == "lstm":
            cs.append(res[2])
        if masked and layers[-1] < num_layers - 1:
            x = _dropout(x, p, rng, layers[-1])
    return _outputs(x, torch.cat(hs), torch.cat(cs) if cs else None, mode,
                    state_outputs)
