"""Neural-network layer ops ported so far — ``FullyConnected``,
``Convolution``, ``Pooling``, ``BatchNorm``, ``LayerNorm``,
``Activation``, ``SoftmaxActivation`` — with the semantics of
``mxnet_tpu/ops/nn.py``.

The matrix products go to ``torch.matmul`` and the convolutions to
``F.conv2d``/``conv3d`` (cuBLAS and cuDNN on the card), as the JAX
package leaves them to XLA. Pooling builds the JAX package's explicit
padding (the ``full`` convention's extra high-side pad, an average over
the unpadded elements of each window) rather than torch's ``ceil_mode``
and ``count_include_pad``. BatchNorm keeps every route of the JAX op:
two-pass statistics under autograd (the default), contraction
statistics (``MXNET_BN_STATS``), the one-pass closed-form core
(``MXNET_BN_IMPL=onepass``) and the hand-written CUDA kernels
(``MXNET_BN_PALLAS=1``, ``ops/bn_kernels.py``); the knobs are read at
call time. Deconvolution, Dropout and the other layers wait (ROADMAP
Queue A item 2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config as _config
from .bn_kernels import bn_train_kernels
from .registry import register


def _pair(v, n=2):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


@register("FullyConnected", arg_names=("data", "weight", "bias"),
          defaults={"num_hidden": 0, "no_bias": False, "flatten": True})
def _fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True, **_):
    x = data.reshape(data.shape[0], -1) if flatten else data
    if weight.dtype != x.dtype:
        weight = weight.to(x.dtype)
    # weight layout (num_hidden, in), as the reference stores it
    out = torch.matmul(x, weight.t())
    if not no_bias and bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# Convolution — NCHW/OIHW (NCDHW/OIDHW), grouped via groups=num_group
# ---------------------------------------------------------------------------

@register("Convolution", arg_names=("data", "weight", "bias"),
          aliases=("Convolution_v1",),
          defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                    "num_filter": 0, "num_group": 1, "no_bias": False,
                    "workspace": 1024, "cudnn_tune": None,
                    "cudnn_off": False, "layout": None})
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=0, num_group=1, no_bias=False, **_):
    nd = len(kernel) if kernel else data.dim() - 2
    stride = _pair(stride, nd) if stride else (1,) * nd
    dilate = _pair(dilate, nd) if dilate else (1,) * nd
    pad = _pair(pad, nd) if pad else (0,) * nd
    if nd == 1:
        # lifted to 2-D, as the JAX op lifts it
        out = _convolution(data[..., None], weight[..., None], None,
                           kernel=(kernel[0], 1), stride=(stride[0], 1),
                           dilate=(dilate[0], 1), pad=(pad[0], 0),
                           num_filter=num_filter, num_group=num_group,
                           no_bias=True)[..., 0]
        if not no_bias and bias is not None:
            out = out + bias.reshape((1, -1, 1))
        return out
    if weight.dtype != data.dtype:
        # mixed precision: compute in the activation dtype
        weight = weight.to(data.dtype)
    conv = F.conv2d if nd == 2 else F.conv3d
    out = conv(data, weight, None, stride=stride, padding=pad,
               dilation=dilate, groups=num_group)
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


# ---------------------------------------------------------------------------
# Pooling — max / avg / sum over explicit padding
# ---------------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_sum(x, kernel, stride):
    """Sum over each (unpadded-input) window: avg_pool with divisor 1,
    1-D lifted to 2-D (avg_pool1d has no divisor_override)."""
    if len(kernel) == 1:
        return _window_sum(x[..., None], kernel + (1,), stride + (1,))[..., 0]
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def _pad_spatial(x, padding, value):
    """F.pad with per-spatial-dim (low, high) pairs, first dim first."""
    flat = []
    for lo, hi in reversed(padding):
        flat += [lo, hi]
    return F.pad(x, flat, value=value) if any(flat) else x


@register("Pooling", arg_names=("data",), aliases=("Pooling_v1",),
          defaults={"kernel": (), "pool_type": "max", "stride": (),
                    "pad": (), "global_pool": False,
                    "pooling_convention": "valid", "cudnn_off": False})
def _pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
             global_pool=False, pooling_convention="valid", **_):
    nd = data.dim() - 2
    if global_pool:
        axes = tuple(range(2, data.dim()))
        if pool_type == "max":
            return torch.amax(data, dim=axes, keepdim=True)
        return torch.mean(data, dim=axes, keepdim=True)
    kernel = _pair(kernel, nd)
    stride = _pair(stride, nd) if stride else (1,) * nd
    pad = _pair(pad, nd) if pad else (0,) * nd
    if pooling_convention == "full":
        # ceil mode as the JAX op builds it: extra padding on the high
        # side only (not torch's ceil_mode, whose window rule differs)
        padding = []
        for i in range(nd):
            size = data.shape[2 + i]
            span = size + 2 * pad[i] - kernel[i]
            out_f = -(-span // stride[i]) + 1
            extra = max(0, (out_f - 1) * stride[i] + kernel[i] - size
                        - 2 * pad[i])
            padding.append((pad[i], pad[i] + extra))
    else:
        padding = [(p, p) for p in pad]
    if pool_type == "max":
        if nd == 2 and data.is_floating_point() and \
                _config.get("MXNET_POOL_DENSE_BWD"):
            return _MaxPool2dDenseBwd.apply(data, kernel, stride,
                                            tuple(padding))
        if all(lo == hi and 2 * lo <= k
               for (lo, hi), k in zip(padding, kernel)):
            # torch's own padding acts as -inf and saves a padded copy
            return _MAX_POOL[nd](data, kernel, stride,
                                 padding=tuple(lo for lo, _ in padding))
        if data.is_floating_point():
            low = float("-inf")
        else:
            low = torch.iinfo(data.dtype).min
        return _MAX_POOL[nd](_pad_spatial(data, padding, low), kernel,
                             stride)
    if pool_type in ("avg", "sum"):
        summed = _window_sum(_pad_spatial(data, padding, 0.0), kernel,
                             stride)
        if pool_type == "sum":
            return summed
        # divide by the count of UNPADDED elements in each window
        ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                          device=data.device)
        counts = _window_sum(_pad_spatial(ones, padding, 0.0), kernel,
                             stride)
        return summed / counts
    raise ValueError("unknown pool_type %r" % pool_type)


class _MaxPool2dDenseBwd(torch.autograd.Function):
    """2-D max pooling whose backward splits dy equally among a window's
    tied maxima (dy/count each) in kh*kw dense strided passes, the twin
    of the JAX package's ``_max_pool2d_dense_bwd``; off ties it equals
    the one-winner backward."""

    @staticmethod
    def forward(ctx, x, kernel, stride, pad2):
        y = F.max_pool2d(_pad_spatial(x, pad2, float("-inf")), kernel,
                         stride)
        ctx.save_for_backward(x, y)
        ctx.attrs = (kernel, stride, pad2)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        (kh, kw), (sh, sw), ((pt, pb), (pl, pr)) = ctx.attrs
        OH, OW = y.shape[2], y.shape[3]
        xp = _pad_spatial(x.float(), ((pt, pb), (pl, pr)), float("-inf"))
        yf = y.float()
        HP, WP = xp.shape[2], xp.shape[3]

        def view(t, a, b):      # the windows' (a, b) elements
            return t[:, :, a:a + sh * (OH - 1) + 1:sh,
                     b:b + sw * (OW - 1) + 1:sw]

        count = torch.zeros_like(yf)
        for a in range(kh):
            for b in range(kw):
                count = count + (view(xp, a, b) == yf).float()
        share = dy.float() / count
        dxp = torch.zeros_like(xp)
        for a in range(kh):
            for b in range(kw):
                view(dxp, a, b).add_(torch.where(view(xp, a, b) == yf,
                                                 share, 0.0))
        dx = dxp[:, :, pt:HP - pb, pl:WP - pr]
        return dx.to(x.dtype), None, None, None


# ---------------------------------------------------------------------------
# BatchNorm — aux moving stats are state; every route of the JAX op.
# fn returns (out[, mean, inv_std], new_moving_mean, new_moving_var)
# ---------------------------------------------------------------------------

class _BnOnePass(torch.autograd.Function):
    """The one-pass core (``MXNET_BN_IMPL=onepass``), the twin of the
    JAX package's ``_bn_train_core``: shifted sibling sums for the
    statistics and the textbook closed-form backward, with the mean/var
    outputs' own cotangents folded into dx."""

    @staticmethod
    def forward(ctx, x, g, b, eps, red, bshape):
        m = 1
        for i in red:
            m *= x.shape[i]
        xf = x.float()
        # the shift: the first sample's channel mean
        cb = torch.mean(xf.narrow(red[0], 0, 1), dim=red, keepdim=True)
        c = cb.reshape(-1)
        s1 = torch.sum(xf - cb, dim=red)
        s2 = torch.sum(torch.square(xf - cb), dim=red)
        mean_s = s1 / m
        mean = c + mean_s
        var = torch.clamp_min(s2 / m - torch.square(mean_s), 0.0)
        inv = torch.rsqrt(var + eps)
        y = ((xf - mean.reshape(bshape))
             * (inv.reshape(bshape) * g.reshape(bshape).float())
             + b.reshape(bshape).float()).to(x.dtype)
        ctx.save_for_backward(x, g, mean, inv)
        ctx.attrs = (red, bshape, m, b.dtype)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, g, mean, inv = ctx.saved_tensors
        red, bshape, m, beta_dtype = ctx.attrs
        dy = dy.float()
        xc = x.float() - mean.reshape(bshape)
        db = torch.sum(dy, dim=red)
        dgx = torch.sum(dy * xc, dim=red) * inv
        k = (g.float() * inv) / m
        dx = (k.reshape(bshape)
              * (m * dy - db.reshape(bshape)
                 - xc * (inv * dgx).reshape(bshape))
              + (dmean.float() / m).reshape(bshape)
              + (2.0 / m) * xc * dvar.float().reshape(bshape)).to(x.dtype)
        return dx, dgx.to(g.dtype), db.to(beta_dtype), None, None, None


def _bn_dot_ok(data, axis):
    """MXNET_BN_STATS=dot|auto: statistics as contractions, 4-D axis-1
    only; auto only where C >= 2*H*W and H*W >= 128."""
    stats = _config.get("MXNET_BN_STATS")
    ok = stats in ("dot", "auto") and data.dim() == 4 and axis == 1
    if ok and stats == "auto":
        hw = data.shape[2] * data.shape[3]
        ok = data.shape[1] >= 2 * hw and hw >= 128
    return ok


@register("BatchNorm", arg_names=("data", "gamma", "beta", "moving_mean",
                                  "moving_var"),
          aliases=("BatchNorm_v1",), takes_is_train=True,
          state_inputs=(3, 4),
          defaults={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                    "use_global_stats": False, "output_mean_var": False,
                    "axis": 1, "cudnn_off": False})
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, is_train=False, **_):
    axis = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != axis)
    bshape = tuple(data.shape[axis] if i == axis else 1
                   for i in range(data.dim()))
    # fix_gamma: a constant ones, so gamma gets no gradient
    g = torch.ones_like(gamma) if fix_gamma else gamma
    # statistics in f32 whatever the compute dtype; the output in the
    # input's dtype
    if is_train and not use_global_stats:
        if _config.get("MXNET_BN_PALLAS") and data.dim() == 4 \
                and axis == 1:
            out, mean, var = bn_train_kernels(data, g, beta, float(eps))
        elif _config.get("MXNET_BN_IMPL") == "onepass":
            out, mean, var = _BnOnePass.apply(data, g, beta, float(eps),
                                              red, bshape)
        else:
            xf = data.float()
            if _bn_dot_ok(data, axis):
                N, C, H, W = data.shape
                m = N * H * W
                x3 = xf.reshape(N, C, H * W)
                ones = torch.ones((N, H * W), dtype=xf.dtype,
                                  device=data.device)
                s1 = torch.einsum("ncx,nx->c", x3, ones)
                s2 = torch.einsum("ncx,ncx->c", x3, x3)
                mean = s1 / m
                var = torch.clamp_min(s2 / m - torch.square(mean), 0.0)
            else:
                mean = torch.mean(xf, dim=red)
                var = torch.var(xf, dim=red, correction=0)
            inv = torch.rsqrt(var.reshape(bshape) + eps)
            out = ((xf - mean.reshape(bshape)) * inv
                   * g.reshape(bshape).float()
                   + beta.reshape(bshape).float()).to(data.dtype)
        new_mm = moving_mean * momentum + mean * (1 - momentum)
        new_mv = moving_var * momentum + var * (1 - momentum)
    else:
        xf = data.float()
        mean = moving_mean.float()
        var = moving_var.float()
        new_mm, new_mv = moving_mean, moving_var
        inv = torch.rsqrt(var.reshape(bshape) + eps)
        out = ((xf - mean.reshape(bshape)) * inv
               * g.reshape(bshape).float()
               + beta.reshape(bshape).float()).to(data.dtype)
    # the moving stats leave the graph (lax.stop_gradient): kept attached
    # they would hold each step's graph alive through the aux
    new_mm, new_mv = new_mm.detach(), new_mv.detach()
    if output_mean_var:
        return out, mean, torch.rsqrt(var + eps), new_mm, new_mv
    return out, new_mm, new_mv


@register("LayerNorm", arg_names=("data", "gamma", "beta"),
          defaults={"axis": -1, "eps": 1e-5, "output_mean_var": False})
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5,
                output_mean_var=False, **_):
    mean = torch.mean(data, dim=axis, keepdim=True)
    # population variance, as jnp.var
    var = torch.var(data, dim=axis, keepdim=True, correction=0)
    out = (data - mean) * torch.rsqrt(var + eps)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    out = out * gamma.reshape(bshape) + beta.reshape(bshape)
    if output_mean_var:
        return out, torch.squeeze(mean, axis), torch.squeeze(var, axis)
    return out


@register("Activation", arg_names=("data",),
          defaults={"act_type": "relu"})
def _activation(data, act_type="relu", **_):
    if act_type == "relu":
        # jnp.maximum's gradient: 0.5 to each side at a tie (x == 0),
        # where clamp_min would pass all of it
        return torch.maximum(data, data.new_zeros(()))
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return data / (1 + torch.abs(data))
    raise ValueError("unknown act_type %r" % act_type)


@register("SoftmaxActivation", arg_names=("data",),
          defaults={"mode": "instance"})
def _softmax_activation(data, mode="instance", **_):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)
