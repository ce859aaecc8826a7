"""Gated linear-attention / SSM block — the PyTorch twin of
``mxnet_tpu/ops/ssm.py``, both execution forms of one recurrence:

    S_t = a_t * S_{t-1} + k_t (x) v_t        (per-head matrix state)
    o_t = q_t . S_t                          (read AFTER the update)

with a data-dependent decay a_t = sigmoid(g_t + gate_bias) per head per
token. Training and prefill run the CHUNKED-SCAN form (``ssm_chunk_scan``:
fixed-width chunks, each an inter-chunk term from the carried state plus
an intra-chunk masked-decay score matrix; a Python loop threads the
(B, H, hd, hd) state across chunks, differentiable through torch
autograd). Decode runs the RECURRENT form (``ssm_recurrent_step``: one
rank-1 update and one read a token, O(1) in sequence length).

BIT-IDENTICAL STATE RULE: both forms derive the decay through
``_log_decay`` and exponentiate the log (never ``sigmoid``), and both
update and read the state with the same products on operands of the same
shapes and layouts. A width-1 chunk's output and exit state are therefore
bit for bit the recurrent step's, on the CPU and on the card, which lets
a state blob pass from the chunked prefill to the recurrent decode with
no drift. Against the JAX package the two agree to the last few ulps
(``F.logsigmoid`` against ``jax.nn.log_sigmoid``, torch's float32 sums
against XLA's). On the card the products follow
``MXNET_MATMUL_PRECISION`` (``highest``: no TF32).

The cached op ignores ``pos``: the recurrence carries its own position.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["ssm_chunk_scan", "ssm_recurrent_step"]


def _log_decay(gate, gate_bias):
    """log a_t = log_sigmoid(g_t + gate_bias), float32: THE decay rule of
    both forms (exp(log_sigmoid(x)) is not bit for bit sigmoid(x))."""
    return F.logsigmoid(gate.float() + gate_bias)


def _check_ssm_shapes(query, key, value, gate, state=None):
    B, H, T, D = query.shape
    if key.shape != query.shape or value.shape != query.shape:
        raise ValueError(
            "SSM q/k/v must share one (B, H, T, hd) shape: got q=%r k=%r "
            "v=%r" % (tuple(query.shape), tuple(key.shape),
                      tuple(value.shape)))
    if tuple(gate.shape) != (B, H, T):
        raise ValueError(
            "SSM gate must be (B, H, T) per-head per-token decay logits: "
            "got %r for q=%r" % (tuple(gate.shape), tuple(query.shape)))
    if state is not None and tuple(state.shape) != (B, H, D, D):
        raise ValueError("SSM state must be (B, H, hd, hd) = %r: got %r"
                         % ((B, H, D, D), tuple(state.shape)))


def _operands(query, key, value, scale):
    """q * scale, k, v as contiguous float32 (B, H, T, hd): the one layout
    both forms compute on."""
    return ((query.float() * scale).contiguous(), key.float().contiguous(),
            value.float().contiguous())


def ssm_chunk_scan(query, key, value, gate, state=None, chunk=64,
                   gate_bias=4.0, scale=None):
    """Chunked-scan (training / prefill) form.

    query/key/value: (B, H, T, hd); gate: (B, H, T); state: (B, H, hd, hd)
    float32 or None for zeros. Returns (out (B, H, T, hd) in query's
    dtype, new_state float32). A ragged last chunk is padded with la = 0
    (decay 1), k = v = 0: exact, the padding leaves the state and the real
    rows untouched. Within a chunk row t reads the carried state decayed
    by exp(L_t) plus the masked scores (q_t.k_s) exp(L_t - L_s) for
    s <= t (L the inclusive cumsum of log decays); the log decay is
    zeroed before the exp where s > t, so no inf * 0 arises."""
    B, H, T, D = query.shape
    _check_ssm_shapes(query, key, value, gate, state)
    if scale is None:
        scale = D ** -0.5
    dev = query.device
    S = torch.zeros((B, H, D, D), dtype=torch.float32, device=dev) \
        if state is None else state.float()
    qf, kf, vf = _operands(query, key, value, scale)

    W = max(1, min(int(chunk), T))
    nc = -(-T // W)
    pad = nc * W - T
    if pad:
        qf, kf, vf = (F.pad(x, (0, 0, 0, pad)) for x in (qf, kf, vf))
    mask = torch.tril(torch.ones((W, W), dtype=torch.bool, device=dev))
    outs = []
    for c in range(nc):
        sl = slice(c * W, (c + 1) * W)
        q_c, k_c, v_c = (x[:, :, sl].contiguous() for x in (qf, kf, vf))
        # the log decay of this chunk's tokens alone, on a contiguous
        # (B, H, W) slice: a width-1 chunk takes the recurrent step's
        # exact elementwise path (the CPU's vector and scalar exp/log can
        # differ in the last bit)
        la_c = _log_decay(gate[:, :, sl].contiguous(), gate_bias)
        if la_c.shape[-1] < W:
            la_c = F.pad(la_c, (0, W - la_c.shape[-1]))
        L = torch.cumsum(la_c, dim=-1)                   # (B, H, W)
        inter = torch.exp(L)[..., None] * torch.matmul(q_c, S)
        s_qk = torch.matmul(q_c, k_c.transpose(-1, -2))  # (B, H, W, W)
        decay = L[..., :, None] - L[..., None, :]        # L_t - L_s
        scores = torch.where(
            mask, s_qk * torch.exp(torch.where(mask, decay, 0.0)), 0.0)
        outs.append(inter + torch.matmul(scores, v_c))
        Llast = L[..., -1]                               # (B, H)
        kd = k_c * torch.exp(Llast[..., None] - L)[..., None]
        S = torch.exp(Llast)[..., None, None] * S + torch.matmul(
            kd.transpose(-1, -2), v_c)
    out = torch.cat(outs, dim=2)[:, :, :T]
    return out.to(query.dtype), S


def ssm_recurrent_step(query, key, value, gate, state, gate_bias=4.0,
                       scale=None):
    """Recurrent (decode) form, Tnew == 1: one rank-1 state update and
    one state read. It follows ``ssm_chunk_scan``'s width-1 chunk
    expression for expression (the same ``_log_decay``, the exp of the
    log, the same products on the same layouts), so its output and exit
    state are bit for bit a width-1 chunk's."""
    B, H, Tn, D = query.shape
    if Tn != 1:
        raise ValueError(
            "ssm_recurrent_step is the single-token fused form (got "
            "Tnew=%d); use ssm_chunk_scan for multi-token prefill" % Tn)
    _check_ssm_shapes(query, key, value, gate, state)
    if scale is None:
        scale = D ** -0.5
    S = state.float()
    qf, kf, vf = _operands(query, key, value, scale)
    a = torch.exp(_log_decay(gate.contiguous(), gate_bias))   # (B, H, 1)
    inter = a[..., None] * torch.matmul(qf, S)
    s_qk = torch.matmul(qf, kf.transpose(-1, -2))       # (B, H, 1, 1)
    out = inter + torch.matmul(s_qk, vf)
    S = a[..., None] * S + torch.matmul(kf.transpose(-1, -2), vf)
    return out.to(query.dtype), S


@register("_contrib_SSMScan", arg_names=("query", "key", "value", "gate"),
          defaults={"scale": None, "gate_bias": 4.0, "chunk": 64})
def _ssm_scan_op(query, key, value, gate, scale=None, gate_bias=4.0,
                 chunk=64, **_):
    """(B, H, T, hd) gated linear attention over a zero state — the
    TRAINING form, differentiable through the chunk loop; ``chunk`` trades
    the intra-chunk products against the loop's length, not the math."""
    out, _state = ssm_chunk_scan(query, key, value, gate, state=None,
                                 chunk=int(chunk),
                                 gate_bias=float(gate_bias), scale=scale)
    return out


@register("_contrib_SSMCached",
          arg_names=("query", "key", "value", "gate", "state", "pos"),
          state_inputs=(4,), nondiff_inputs=(5,), differentiable=False,
          defaults={"scale": None, "gate_bias": 4.0, "chunk": 64,
                    "max_len": 0})
def _ssm_cached_op(query, key, value, gate, state, pos, scale=None,
                   gate_bias=4.0, chunk=64, **_):
    """Incremental-decode SSM over a carried (B, H, hd, hd) float32 state
    aux (no length axis). Dispatch is on Tnew = query.shape[2]: prefill
    (Tnew > 1) runs the chunked scan from the carried state, decode
    (Tnew == 1) the recurrent step; both under the bit-identical rule.
    ``pos`` is accepted and ignored; ``max_len`` only mirrors the cached
    attention ops' attrs. The new state is written into ``state`` in
    place (a captured decode step keeps it at one address). Returns
    (out, state)."""
    del pos
    if query.shape[2] == 1:
        out, new = ssm_recurrent_step(query, key, value, gate, state,
                                      gate_bias=float(gate_bias),
                                      scale=scale)
    else:
        out, new = ssm_chunk_scan(query, key, value, gate, state=state,
                                  chunk=int(chunk),
                                  gate_bias=float(gate_bias), scale=scale)
    return out, state.copy_(new)
