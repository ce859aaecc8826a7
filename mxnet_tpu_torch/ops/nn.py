"""Neural-network layer ops — the whole of ``mxnet_tpu/ops/nn.py``:
``FullyConnected``, ``Convolution``, ``Deconvolution``, ``Pooling``,
``BatchNorm``, ``InstanceNorm``, ``LayerNorm``, ``Activation``,
``LeakyReLU``, ``SoftmaxActivation``, ``Dropout``, ``LRN``,
``UpSampling``, ``Crop`` and the ``Sequence*`` ops, with its semantics.

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
call time. Under the replica axes (``data``, ``fsdp``) every route
computes the whole batch's statistics: two-pass sums all-reduced, and
the one-pass and kernel routes shifted by the global batch's first
sample (replica rank 0's) with their shifted sums all-reduced. Dropout and rrelu draw from the threefry key the caller
passes (``rng``), so their masks are the JAX package's bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config as _config
from .. import _threefry
from .bn_kernels import _replica_total, bn_train_kernels
from .registry import register


def _pair(v, n=2):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


@register("FullyConnected", arg_names=("data", "weight", "bias"),
          defaults={"num_hidden": 0, "no_bias": False, "flatten": True})
def _fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True, **_):
    """Under a layout that splits the weight on dim 0 over a
    tensor-parallel axis (the executor announces it, ``_mesh_ctx.tp_form``)
    the op runs column-parallel, Megatron's f and g:
    ``gather_from_axis(linear(copy_to_axis(x), W_slice, b_slice))``, the
    bias added after the gather when it is not split with the weight."""
    from ._mesh_ctx import tp_form
    x = data.reshape(data.shape[0], -1) if flatten else data
    if weight.dtype != x.dtype:
        weight = weight.to(x.dtype)
    form = tp_form()
    if form is not None:
        from ..parallel import _comm
        mesh, axis, bias_split = form
        out = torch.matmul(_comm.copy_to_axis(x, mesh, axis), weight.t())
        if not no_bias and bias is not None and bias_split:
            out = out + bias
        out = _comm.gather_from_axis(out, mesh, axis, out.dim() - 1)
        if not no_bias and bias is not None and not bias_split:
            out = out + bias
        return out
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


@register("Deconvolution", arg_names=("data", "weight", "bias"),
          defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                    "adj": (), "target_shape": (), "num_filter": 0,
                    "num_group": 1, "no_bias": True, "workspace": 512,
                    "cudnn_tune": None, "cudnn_off": False, "layout": None})
def _deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), target_shape=(), num_filter=0,
                   num_group=1, no_bias=True, **_):
    """The transposed convolution (the gradient of Convolution by its
    input), weight (in_c, out_c / g, k...) as the reference stores it;
    ``adj`` pads the high side. ``target_shape`` is taken and unused,
    as in the JAX op."""
    nd = len(kernel) if kernel else 2
    stride = _pair(stride, nd) if stride else (1,) * nd
    dilate = _pair(dilate, nd) if dilate else (1,) * nd
    pad = _pair(pad, nd) if pad else (0,) * nd
    adj = _pair(adj, nd) if adj else (0,) * nd
    if weight.dtype != data.dtype:
        weight = weight.to(data.dtype)
    conv_t = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
              3: F.conv_transpose3d}[nd]
    out = conv_t(data, weight, None, stride=stride, padding=pad,
                 output_padding=adj, groups=num_group, dilation=dilate)
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
    outputs' own cotangents folded into dx. Under the replica ``rep``
    the shift is replica rank 0's first sample's (the global batch's
    first sample) and the shifted sums, and the backward's sums, are
    all-reduced; gamma's and beta's gradients stay this rank's part."""

    @staticmethod
    def forward(ctx, x, g, b, eps, red, bshape, rep):
        m = 1 if rep is None else rep.n
        for i in red:
            m *= x.shape[i]
        xf = x.float()
        # the shift: the first sample's channel mean
        cb = torch.mean(xf.narrow(red[0], 0, 1), dim=red, keepdim=True)
        if rep is not None:
            # replica rank 0's: the global batch's first sample
            cb = _replica_total(cb if rep.index == 0
                                else torch.zeros_like(cb), rep)
        c = cb.reshape(-1)
        s1 = torch.sum(xf - cb, dim=red)
        s2 = torch.sum(torch.square(xf - cb), dim=red)
        if rep is not None:
            s1, s2 = _replica_total(s1, rep), _replica_total(s2, rep)
        mean_s = s1 / m
        mean = c + mean_s
        var = torch.clamp_min(s2 / m - torch.square(mean_s), 0.0)
        inv = torch.rsqrt(var + eps)
        y = ((xf - mean.reshape(bshape))
             * (inv.reshape(bshape) * g.reshape(bshape).float())
             + b.reshape(bshape).float()).to(x.dtype)
        ctx.save_for_backward(x, g, mean, inv)
        ctx.attrs = (red, bshape, m, b.dtype, rep)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, g, mean, inv = ctx.saved_tensors
        red, bshape, m, beta_dtype, rep = ctx.attrs
        dy = dy.float()
        xc = x.float() - mean.reshape(bshape)
        db = torch.sum(dy, dim=red)
        dgx = torch.sum(dy * xc, dim=red) * inv
        db_all, dgx_all = db, dgx
        dmean, dvar = dmean.float(), dvar.float()
        if rep is not None:
            db_all, dgx_all, dmean, dvar = (
                _replica_total(t, rep) for t in (db, dgx, dmean, dvar))
        k = (g.float() * inv) / m
        dx = (k.reshape(bshape)
              * (m * dy - db_all.reshape(bshape)
                 - xc * (inv * dgx_all).reshape(bshape))
              + (dmean / m).reshape(bshape)
              + (2.0 / m) * xc * dvar.reshape(bshape)).to(x.dtype)
        return dx, dgx.to(g.dtype), db.to(beta_dtype), None, None, None, \
            None


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
        from ._mesh_ctx import replica
        rep = replica()
        if rep is not None and _config.get("MXNET_BN_PALLAS") and \
                data.dim() == 4 and axis == 1:
            # the kernels over the whole batch: the shift from replica
            # rank 0, the shifted sums all-reduced (ops/bn_kernels.py)
            out, mean, var = bn_train_kernels(data, g, beta, float(eps),
                                              rep=rep)
        elif rep is not None and _config.get("MXNET_BN_IMPL") == "onepass":
            out, mean, var = _BnOnePass.apply(data, g, beta, float(eps),
                                              red, bshape, rep)
        elif rep is not None:
            # the whole batch's statistics, two-pass, as the JAX
            # package's one global program computes them
            xf = data.float()
            m = rep.n
            for i in red:
                m *= data.shape[i]
            mean = _global_sum(torch.sum(xf, dim=red), rep) / m
            var = _global_sum(torch.sum(torch.square(
                xf - mean.reshape(bshape)), dim=red), rep) / m
            inv = torch.rsqrt(var.reshape(bshape) + eps)
            out = ((xf - mean.reshape(bshape)) * inv
                   * g.reshape(bshape).float()
                   + beta.reshape(bshape).float()).to(data.dtype)
        elif _config.get("MXNET_BN_PALLAS") and data.dim() == 4 \
                and axis == 1:
            out, mean, var = bn_train_kernels(data, g, beta, float(eps))
        elif _config.get("MXNET_BN_IMPL") == "onepass":
            out, mean, var = _BnOnePass.apply(data, g, beta, float(eps),
                                              red, bshape, None)
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


@register("InstanceNorm", arg_names=("data", "gamma", "beta"),
          defaults={"eps": 1e-3})
def _instance_norm(data, gamma, beta, eps=1e-3, **_):
    red = tuple(range(2, data.dim()))
    mean = torch.mean(data, dim=red, keepdim=True)
    var = torch.var(data, dim=red, keepdim=True, correction=0)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


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


@register("LeakyReLU", arg_names=("data", "gamma"), needs_rng=True,
          takes_is_train=True,
          defaults={"act_type": "leaky", "slope": 0.25,
                    "lower_bound": 0.125, "upper_bound": 0.334})
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, is_train=False,
                rng=None, **_):
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 and data.dim() > 1 else gamma
        return torch.where(data >= 0, data, g * data)
    if act_type == "rrelu":
        if is_train:
            s = _threefry.uniform(rng, data.shape, data.dtype, lower_bound,
                                  upper_bound, data.device)
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data >= 0, data, s * data)
    raise ValueError("unknown act_type %r" % act_type)


def _batch_slice(data):
    """(offset, total) of ``data``'s elements in the flat whole batch
    when the replica axes split dim 0 over ranks, else (0, None)."""
    from ._mesh_ctx import replica
    rep = replica()
    if rep is None:
        return 0, None
    n = data.numel()
    return rep.index * n, n * rep.n


def _global_sum(x, rep):
    """``x`` summed over the ranks of the replica ``rep``, with a summed
    cotangent (the statistic is the whole batch's, and each rank's loss
    covers its own rows)."""
    from ..parallel import _comm
    return _comm.global_sum(x, rep.mesh, rep.axes)


# ---------------------------------------------------------------------------
# Dropout — the mask from the caller's threefry key
# ---------------------------------------------------------------------------

@register("Dropout", arg_names=("data",), needs_rng=True,
          takes_is_train=True,
          defaults={"p": 0.5, "mode": "training"})
def _dropout(data, p=0.5, mode="training", is_train=False, rng=None, **_):
    """Keeps each element with probability 1 - p (a float32 uniform
    below it, ``jax.random.bernoulli``) and scales it by 1 / (1 - p);
    the identity when p <= 0 or outside training (mode "always" drops
    at inference too). Under the replica axes the tensor is this rank's
    slice of the batch (dim 0), and its mask is that slice of the whole
    batch's mask: the threefry counters of its own elements."""
    if p <= 0 or (not is_train and mode != "always"):
        return data
    keep = 1.0 - p
    offset, total = _batch_slice(data)
    mask = _threefry.bernoulli(rng, keep, tuple(data.shape), data.device,
                               offset=offset, total=total)
    return torch.where(mask, data / keep, 0.0).to(data.dtype)


# ---------------------------------------------------------------------------
# LRN — reference lrn-inl.h: the padded channel-window sum of squares
# ---------------------------------------------------------------------------

@register("LRN", arg_names=("data",),
          defaults={"alpha": 1e-4, "beta": 0.75, "knorm": 2.0, "nsize": 5})
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **_):
    sq = torch.square(data)
    half = nsize // 2
    sq_pad = F.pad(sq, (0, 0) * (data.dim() - 2) + (half, half))
    window = torch.zeros_like(sq)
    for i in range(nsize):
        # the JAX op's order of sums: slice 0 first
        window = window + sq_pad.narrow(1, i, data.shape[1])
    return data / torch.pow(knorm + alpha / nsize * window, beta)


# ---------------------------------------------------------------------------
# UpSampling / Crop
# ---------------------------------------------------------------------------

@register("UpSampling", arg_names=None,
          defaults={"scale": 1, "sample_type": "nearest", "num_args": 1,
                    "num_filter": 0, "multi_input_mode": "concat",
                    "workspace": 512})
def _upsampling(*args, scale=1, sample_type="nearest",
                multi_input_mode="concat", **_):
    """Nearest repeats each pixel ``scale`` times a side; bilinear
    resizes the first input to ``scale`` times its size in float32
    (half-pixel centres, ``jax.image.resize``, which has no antialias
    when upsampling)."""
    outs = []
    data = args[0]
    h, w = data.shape[2] * scale, data.shape[3] * scale
    for x in (args if sample_type == "nearest" else args[:1]):
        if sample_type == "nearest":
            out = torch.repeat_interleave(
                torch.repeat_interleave(x, scale, dim=2), scale, dim=3)
        else:
            out = F.interpolate(x.float(), size=(h, w), mode="bilinear",
                                align_corners=False).to(x.dtype)
        outs.append(out)
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == "sum":
        return sum(outs)
    return torch.cat(outs, dim=1)


@register("Crop", arg_names=None,
          defaults={"num_args": 1, "offset": (0, 0), "h_w": (0, 0),
                    "center_crop": False})
def _crop(*args, offset=(0, 0), h_w=(0, 0), center_crop=False, **_):
    data = args[0]
    if len(args) == 2:
        h, w = args[1].shape[2], args[1].shape[3]
    else:
        h, w = h_w
    if center_crop:
        oy = (data.shape[2] - h) // 2
        ox = (data.shape[3] - w) // 2
    else:
        oy, ox = offset
    return data[:, :, oy:oy + h, ox:ox + w]


# ---------------------------------------------------------------------------
# Sequence ops — reference src/operator/sequence_*.cc
# ---------------------------------------------------------------------------

@register("SequenceMask", arg_names=("data", "sequence_length"),
          nondiff_inputs=(1,),
          defaults={"use_sequence_length": False, "value": 0.0, "axis": 0})
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0, **_):
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[:, None] < sequence_length[None, :].to(torch.int32)
    if axis == 1:
        mask = mask.t()
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register("SequenceLast", arg_names=("data", "sequence_length"),
          nondiff_inputs=(1,),
          defaults={"use_sequence_length": False, "axis": 0})
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0, **_):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    idx = sequence_length.to(torch.int64) - 1
    batch = torch.arange(data.shape[1 - axis], device=data.device)
    if axis == 0:
        return data[idx, batch]
    return data[batch, idx]


@register("SequenceReverse", arg_names=("data", "sequence_length"),
          nondiff_inputs=(1,),
          defaults={"use_sequence_length": False, "axis": 0})
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0, **_):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = sequence_length.to(torch.int64)[None, :]
    rev_idx = torch.where(steps < lens, lens - 1 - steps, steps)
    batch = torch.arange(data.shape[1], device=data.device)[None, :]
    return data[rev_idx, batch]
