"""Connectionist Temporal Classification loss — the PyTorch twin of
``mxnet_tpu/ops/ctc.py``.

Reference semantics: src/operator/contrib/ctc_loss.cc (warp-ctc backed):
  data (T, B, C) activations (softmax applied internally), label (B, L)
  integer matrix, optional data_lengths/label_lengths (B,) inputs, and
  blank_label in {"first", "last"}:
    first: channel 0 is blank, labels use 1..C-1, label padding value 0
    last:  channel C-1 is blank, labels use 0..C-2, label padding value -1
  output: per-example negative log likelihood (B,).

The JAX package computes it with ``optax.ctc_loss``; ``_ctc_nll`` is the
same log-space alpha recursion in plain torch under autograd, step for
step: ``log_softmax`` over the classes, ``log_epsilon = -1e5`` standing
for log(0) (so an impossible alignment gives a large finite loss, not
``inf``), padded frames holding their state, and the repeat-label rule
(no emit-to-blank-skip between two equal labels).
``torch.nn.functional.ctc_loss`` is a different function (``inf`` on an
impossible alignment, other padding conventions) and is not used.
"""
from __future__ import annotations

import torch

from .registry import register, set_arg_select

LOG_EPSILON = -1e5


class _LogAddExp(torch.autograd.Function):
    """``jnp.logaddexp`` with its derivative rule, ``exp(x - out)``. The
    rule reads the rounded output: near log(0) = -1e5 a float32 ulp is
    about 0.008, so it and torch.logaddexp's own rule give gradients up
    to 1% apart there (an impossible alignment). The inputs here are
    log-probabilities, never +inf, so jnp's +inf guard is not needed."""

    @staticmethod
    def forward(ctx, x1, x2):
        out = torch.logaddexp(x1, x2)
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x1, x2, out = ctx.saved_tensors
        return g * torch.exp(x1 - out), g * torch.exp(x2 - out)


_logaddexp = _LogAddExp.apply


def _shift_add(phi, added):
    """``phi[:, 1:]`` log-added with ``added``; ``phi[:, 0]`` kept."""
    return torch.cat([phi[:, :1], _logaddexp(phi[:, 1:], added)], dim=-1)


def _ctc_nll(logits, logit_paddings, labels, label_paddings, blank_id=0,
             log_epsilon=LOG_EPSILON):
    """optax.ctc_loss: logits (B, T, K), labels (B, N) int, right-padded,
    label_paddings (B, N) of 0/1, logit_paddings (B, T) of 0/1 or None
    for none. Returns the (B,) loss."""
    B, T, K = logits.shape
    N = labels.shape[1]
    dtype = torch.promote_types(logits.dtype, torch.float32)
    logprobs = torch.log_softmax(logits, dim=-1).to(dtype)
    labellens = N - label_paddings.sum(dim=1).to(torch.int64)
    repeat = torch.zeros((B, N), dtype=dtype, device=logits.device)
    repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).to(dtype)
    lp_phi = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1)
    lp_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(
        B, T, N).to(torch.int64)).transpose(0, 1)          # (T, B, N)
    # a padded frame keeps the state: optax's pad * prev + (1 - pad) *
    # next, which for 0/1 pads and finite values is this select
    pads = None if logit_paddings is None else \
        (logit_paddings > 0).transpose(0, 1)[:, :, None]
    no_repeat = (1.0 - repeat) * log_epsilon
    repeat = repeat * log_epsilon

    phi = torch.full((B, N + 1), log_epsilon, dtype=dtype,
                     device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), log_epsilon, dtype=dtype, device=logits.device)
    for t in range(T):
        # emit-to-blank epsilon transition, except before a repeated label
        prev_phi = _shift_add(phi, emit + repeat)
        next_emit = _logaddexp(prev_phi[:, :-1] + lp_emit[t],
                               emit + lp_emit[t])
        next_phi = _shift_add(prev_phi + lp_phi[t],
                              emit + lp_phi[t] + no_repeat)
        if pads is None:
            emit, phi = next_emit, next_phi
        else:
            emit = torch.where(pads[t], emit, next_emit)
            phi = torch.where(pads[t], phi, next_phi)
    # the last epsilon transition
    phi = _shift_add(phi, emit)
    return -phi.gather(1, labellens[:, None])[:, 0]


@register("CTCLoss",
          arg_names=("data", "label", "data_lengths", "label_lengths"),
          aliases=("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"),
          nondiff_inputs=(1, 2, 3),
          defaults={"use_data_lengths": False, "use_label_lengths": False,
                    "blank_label": "first"})
def _ctc_loss(data, label, *lens, use_data_lengths=False,
              use_label_lengths=False, blank_label="first", **_):
    # optional length inputs arrive positionally in active-arg order
    # (arg_select below drops the inactive ones from the signature)
    lens = list(lens)
    data_lengths = lens.pop(0) if use_data_lengths and lens else None
    label_lengths = lens.pop(0) if use_label_lengths and lens else None
    T, B, C = data.shape
    logits = data.transpose(0, 1)                         # (B, T, C)
    dev = data.device

    logit_pad = None
    if use_data_lengths and data_lengths is not None:
        steps = torch.arange(T, device=dev)[None, :]
        logit_pad = (steps >= data_lengths[:, None].to(torch.int32)
                     ).to(logits.dtype)

    lab = label.to(torch.int32)
    if blank_label == "first":
        blank_id = 0
        pad_mask_src = lab == 0
    else:
        blank_id = C - 1
        pad_mask_src = lab < 0
        lab = torch.clamp(lab, min=0)

    if use_label_lengths and label_lengths is not None:
        pos = torch.arange(lab.shape[1], device=dev)[None, :]
        label_pad = (pos >= label_lengths[:, None].to(torch.int32)
                     ).to(logits.dtype)
    else:
        label_pad = pad_mask_src.to(logits.dtype)
    lab = torch.where(label_pad > 0, 0, lab)

    return _ctc_nll(logits, logit_pad, lab, label_pad, blank_id=blank_id)


def _ctc_args(attrs):
    names = ["data", "label"]
    if attrs.get("use_data_lengths"):
        names.append("data_lengths")
    if attrs.get("use_label_lengths"):
        names.append("label_lengths")
    return tuple(names)


set_arg_select("CTCLoss", _ctc_args)
