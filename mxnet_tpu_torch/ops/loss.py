"""Output/loss heads with custom backward semantics — the whole of
``mxnet_tpu/ops/loss.py``: ``SoftmaxOutput``, ``MakeLoss``, the three
regression heads, ``SVMOutput``, ``IdentityAttachKLSparseReg`` and the
fused projection + cross-entropy ``_contrib_ChunkedSoftmaxCE``.

These ops' backward passes are NOT the vjp of their forward
(SoftmaxOutput forwards softmax but backprops the cross-entropy
gradient), so each is a ``torch.autograd.Function``. Every head
multiplies its emitted gradient by the incoming cotangent (the head-grad
scale contract): the training step passes ones, and a scaled cotangent
(dynamic loss scaling) scales the whole backprop chain. Labels get no
gradient. The backward computes in the output's dtype throughout, as the
JAX package does — under bf16 that includes the ``valid`` count, which
is a bf16 sum (16376 valid tokens count as 16384).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .registry import register


def _data_ranks():
    """The replica (``_mesh_ctx.Replica``: the active ``data`` and
    ``fsdp`` axes, which split the batch over ranks) and its rank count,
    else (None, 1)."""
    from ._mesh_ctx import replica
    rep = replica()
    return rep, (1 if rep is None else rep.n)


def _batch_total(count):
    """A count over this rank's batch rows as the whole batch's: summed
    over the active replica axes (a forward-time collective; no
    gradient)."""
    rep, n = _data_ranks()
    if rep is None:
        return count
    from ..parallel import _comm
    out = count.detach().clone()
    _comm.all_reduce_([out], rep.mesh, rep.axes)
    return out


def _norm_factor(normalization, label, valid_mask=None):
    """The head's gradient divisor over the WHOLE batch (under the replica
    axes each rank holds 1/n of it)."""
    _, n = _data_ranks()
    if normalization == "batch":
        return float(label.shape[0] * n) if label.dim() else 1.0
    if normalization == "valid" and valid_mask is not None:
        return torch.clamp_min(_batch_total(torch.sum(valid_mask)), 1.0)
    if normalization == "valid":
        return float(label.numel() * n)
    return 1.0


def _one_hot(idx, nclass, dtype):
    """``jax.nn.one_hot``: an index outside [0, nclass) (the ignore
    label -1 among them) gives an all-zero row."""
    return (idx.unsqueeze(-1) == torch.arange(nclass, device=idx.device)
            ).to(dtype)


class _SoftmaxOutputFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, attrs):
        axis = 1 if attrs["multi_output"] else -1
        # softmax statistics always in f32 (bf16 inputs would lose
        # probability mass); output back in the input dtype
        p = torch.softmax(data.float(), dim=axis).to(data.dtype)
        ctx.save_for_backward(p, label)
        ctx.attrs = attrs
        # the divisor is taken here, where every rank runs the head, so
        # a count over a data axis is a forward-time collective
        ctx.norm = None
        if attrs["normalization"] != "null":
            valid = (label != attrs["ignore_label"]).to(p.dtype) \
                if attrs["use_ignore"] else None
            ctx.norm = _norm_factor(attrs["normalization"], label, valid)
        return p

    @staticmethod
    def backward(ctx, g):
        p, l = ctx.saved_tensors
        a = ctx.attrs
        multi = a["multi_output"]
        nclass = p.shape[1 if multi else -1]
        onehot = _one_hot(l.to(torch.int32).long(), nclass, p.dtype)
        if multi:
            onehot = torch.movedim(onehot, -1, 1)
        elif onehot.shape != p.shape:
            onehot = onehot.reshape(p.shape)
        if a["smooth_alpha"]:
            onehot = onehot * (1 - a["smooth_alpha"]) + \
                a["smooth_alpha"] / nclass
        grad = p - onehot
        if a["use_ignore"]:
            keep = (l != a["ignore_label"]).to(p.dtype)
            if multi:
                keep_b = keep.unsqueeze(1)
            else:
                keep_b = keep.reshape(tuple(l.shape)
                                      + (1,) * (p.dim() - l.dim()))
            grad = grad * keep_b
        grad = grad * (a["grad_scale"]
                       / (1.0 if ctx.norm is None else ctx.norm))
        grad = grad * g.to(grad.dtype)
        return grad.to(p.dtype), None, None


@register("SoftmaxOutput", arg_names=("data", "label"), nondiff_inputs=(1,),
          aliases=("Softmax",),
          defaults={"grad_scale": 1.0, "ignore_label": -1.0,
                    "multi_output": False, "use_ignore": False,
                    "preserve_shape": False, "normalization": "null",
                    "out_grad": False, "smooth_alpha": 0.0})
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0, **_):
    return _SoftmaxOutputFn.apply(data, label, {
        "grad_scale": grad_scale, "ignore_label": ignore_label,
        "multi_output": multi_output, "use_ignore": use_ignore,
        "normalization": normalization, "smooth_alpha": smooth_alpha})


class _RegressionFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, fwd_fn, grad_fn, grad_scale):
        out = fwd_fn(data)
        ctx.save_for_backward(out, label)
        ctx.grad_fn, ctx.grad_scale = grad_fn, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, l = ctx.saved_tensors
        grad = ctx.grad_fn(out, l.reshape(out.shape)) * ctx.grad_scale
        grad = grad * g.to(grad.dtype)
        return grad.to(out.dtype), None, None, None, None


def _regression(name, fwd_fn, grad_fn):
    @register(name, arg_names=("data", "label"), nondiff_inputs=(1,),
              defaults={"grad_scale": 1.0})
    def _f(data, label, grad_scale=1.0, **_):
        return _RegressionFn.apply(data, label, fwd_fn, grad_fn,
                                   grad_scale)
    return _f


_regression("LinearRegressionOutput", torch.clone, lambda o, l: o - l)
_regression("MAERegressionOutput", torch.clone,
            lambda o, l: torch.sign(o - l))
_regression("LogisticRegressionOutput", torch.sigmoid, lambda o, l: o - l)


class _MakeLossFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, grad_scale, valid_thresh, normalization):
        ctx.save_for_backward(data)
        # the divisor over the WHOLE batch, taken here as SoftmaxOutput
        # takes its own (a count over a data axis is a forward-time
        # collective)
        if normalization == "batch":
            ctx.scale = grad_scale / (data.shape[0] * _data_ranks()[1])
        elif normalization == "valid":
            ctx.scale = grad_scale / torch.clamp_min(_batch_total(
                torch.sum((data > valid_thresh).to(data.dtype))), 1.0)
        else:
            ctx.scale = grad_scale
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        return g.to(d.dtype) * ctx.scale, None, None, None


@register("MakeLoss", arg_names=("data",),
          defaults={"grad_scale": 1.0, "valid_thresh": 0.0,
                    "normalization": "null"})
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0,
               normalization="null", **_):
    return _MakeLossFn.apply(data, grad_scale, valid_thresh, normalization)


class _SVMOutputFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.attrs = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        d, l = ctx.saved_tensors
        margin, reg, use_linear = ctx.attrs
        li = l.to(torch.int32).long()
        onehot = _one_hot(li, d.shape[-1], d.dtype)
        score_y = torch.gather(d, -1, li[:, None])
        viol = ((margin - (score_y - d)) > 0) & (onehot == 0)
        if use_linear:
            grad = viol.to(d.dtype)
        else:
            grad = 2 * torch.clamp_min(margin - (score_y - d), 0) * \
                viol.to(d.dtype)
        grad = grad - onehot * torch.sum(grad, dim=-1, keepdim=True)
        grad = grad * reg * g.to(grad.dtype)
        return grad, None, None, None, None


@register("SVMOutput", arg_names=("data", "label"), nondiff_inputs=(1,),
          defaults={"margin": 1.0, "regularization_coefficient": 1.0,
                    "use_linear": False})
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False, **_):
    """Forwards the scores; backprops the (squared, or linear) hinge
    loss's gradient (reference svm_output.cc)."""
    return _SVMOutputFn.apply(data, label, margin,
                              regularization_coefficient, use_linear)


@register("IdentityAttachKLSparseReg", arg_names=("data",),
          defaults={"sparseness_target": 0.1, "penalty": 0.001,
                    "momentum": 0.9})
def _identity_kl(data, **_):
    return data


def _chunk_nll(x_c, weight, bias, l_c, k_c, scale):
    """Per-row NLL of one chunk, scaled: float32 logits (products
    accumulated in float32 whatever the input dtype)."""
    logits = torch.matmul(x_c.float(), weight.float().t()) + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, torch.clamp(
        l_c, 0, weight.shape[0] - 1)[:, None])[:, 0]
    return (lse - picked) * k_c * scale


@register("_contrib_ChunkedSoftmaxCE",
          arg_names=("data", "weight", "bias", "label"),
          nondiff_inputs=(3,),
          defaults={"chunk": 2048, "grad_scale": 1.0,
                    "ignore_label": -1.0, "use_ignore": False,
                    "normalization": "valid"})
def _chunked_softmax_ce(data, weight, bias, label, chunk=2048,
                        grad_scale=1.0, ignore_label=-1.0,
                        use_ignore=False, normalization="valid", **_):
    """Fused projection + softmax cross-entropy over row chunks: the
    output is the per-row loss (already scaled by grad_scale / norm, as
    SoftmaxOutput's backward), float32. Each chunk is checkpointed, so
    no more than (chunk, V) logits live at once in the forward or the
    backward, as the JAX op's checkpointed map."""
    N = data.shape[0]
    chunk = max(1, min(int(chunk), N))
    lab = label.reshape(-1).to(torch.int64)
    if use_ignore:
        keep = (lab != int(ignore_label)).to(torch.float32)
    else:
        keep = torch.ones(N, dtype=torch.float32, device=data.device)
    norm = _norm_factor(normalization, lab, keep)
    scale = grad_scale / norm
    outs = []
    for start in range(0, N, chunk):
        args = (data[start:start + chunk], weight, bias,
                lab[start:start + chunk], keep[start:start + chunk], scale)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_chunk_nll, *args, use_reentrant=False))
        else:
            outs.append(_chunk_nll(*args))
    return torch.cat(outs)
