"""Training BatchNorm over the hand-written Hopper kernels — the PyTorch
twin of ``mxnet_tpu/ops/bn_pallas.py``.

Four kernels (``csrc/bn_train.cu``), each the port of one TPU kernel of
that file, over an NCHW input viewed as (N, C, H*W):

* ``bn_stats`` (``_stats_kernel``): the shifted sibling sums
  s1 = sum(x - c) and s2 = sum((x - c)^2) per channel, in f32;
* ``bn_apply`` (``_apply_kernel``): y = a * x + b per channel;
* ``bn_bwd_reduce`` (``_bwd_reduce_kernel``): db = sum(dy) and
  dxc = sum(dy * (x - mean)) per channel, in f32;
* ``bn_bwd_dx`` (``_bwd_dx_kernel``): dx = a * dy + c2 * (x - mean) + b.

Each entry launches its kernel on CUDA tensors (``bn_stats_cuda`` ...,
each with a ``.launches`` counter) or raises; on CPU (and meta) tensors
it runs the kernel's plain PyTorch version (``_stats_reference`` ...),
which takes the kernel's arguments and computes in f32 with the same
rounding points. Nothing falls back from one to the other. Inputs are
f32 or bf16; ``dy`` has x's dtype and ``y``/``dx`` come out in it.

``bn_train_kernels(x, g, beta, eps)`` is the twin of ``bn_train_pallas``:
(y, mean, var) with the closed-form backward as a
``torch.autograd.Function``. The shift c is the first sample's channel
mean, taken in plain torch outside the kernels as in the JAX package,
and keeps E[x^2] - E[x]^2 accurate when |mean| >> std. Under the replica
axes (``rep=``) the same kernels compute the whole batch's statistics
from all-reduced partial sums.
"""
from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx",
           "bn_stats_cuda", "bn_apply_cuda", "bn_bwd_reduce_cuda",
           "bn_bwd_dx_cuda", "bn_train_kernels"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, for CPU and meta tensors)
# ---------------------------------------------------------------------------

def _stats_reference(x3, c):
    """(s1, s2) per channel of (N, C, HW) ``x3`` about the (C,) shift."""
    xc = x3.float() - c[None, :, None]
    return xc.sum(dim=(0, 2)), (xc * xc).sum(dim=(0, 2))


def _apply_reference(x3, a, b):
    """y = x * a + b per channel, in f32, rounded once to x's dtype."""
    return (x3.float() * a[:, None] + b[:, None]).to(x3.dtype)


def _bwd_reduce_reference(dy3, x3, mean):
    """(db, dxc) = (sum(dy), sum(dy * (x - mean))) per channel."""
    dy = dy3.float()
    return (dy.sum(dim=(0, 2)),
            (dy * (x3.float() - mean[:, None])).sum(dim=(0, 2)))


def _bwd_dx_reference(dy3, x3, a, c2, b, mean, out_dtype=None):
    """dx = dy * a + (x - mean) * c2 + b per channel, in f32, rounded
    once to ``out_dtype`` (default x's dtype)."""
    xc = x3.float() - mean[:, None]
    dx = dy3.float() * a[:, None] + xc * c2[:, None] + b[:, None]
    return dx.to(out_dtype or x3.dtype)


# ---------------------------------------------------------------------------
# the CUDA launchers
# ---------------------------------------------------------------------------

def _check_operands(what, x3, same=(), chans=()):
    """Raise on what the kernels do not take: (N, C, HW) x of f32 or bf16
    on a CUDA device, ``same`` tensors of x's shape, dtype and device,
    ``chans`` f32 (C,) vectors on x's device."""
    if x3.dim() != 3:
        raise ValueError("%s: x must be (N, C, HW), got shape %r"
                         % (what, tuple(x3.shape)))
    if x3.dtype not in _DTYPE_CODE:
        raise TypeError("%s: x must be float32 or bfloat16, got %s"
                        % (what, x3.dtype))
    if x3.device.type != "cuda":
        raise ValueError("%s: x must be on a CUDA device, got %s"
                         % (what, x3.device))
    if x3.numel() == 0:
        raise ValueError("%s: empty input of shape %r"
                         % (what, tuple(x3.shape)))
    for name, t in same:
        if (t.shape != x3.shape or t.dtype != x3.dtype
                or t.device != x3.device):
            raise (TypeError if t.dtype != x3.dtype else ValueError)(
                "%s: %s must match x (shape %r, %s, %s), got %r, %s, %s"
                % (what, name, tuple(x3.shape), x3.dtype, x3.device,
                   tuple(t.shape), t.dtype, t.device))
    C = x3.shape[1]
    for name, t in chans:
        if (tuple(t.shape) != (C,) or t.dtype != torch.float32
                or t.device != x3.device):
            raise ValueError("%s: %s must be float32 of shape (%d,) on %s, "
                             "got %r, %s, %s" % (what, name, C, x3.device,
                                                 tuple(t.shape), t.dtype,
                                                 t.device))


def _kernel_operand(x):
    """Contiguous and 16-byte aligned, as the kernels' vector loads need."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(entry, x3, *ptrs):
    """Call one C entry of the library on x's device and current stream;
    raise on a CUDA error."""
    lib = _kernels.load("bn_train")
    N, C, HW = x3.shape
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = getattr(lib, entry)(*[p.data_ptr() for p in ptrs], N, C, HW,
                                 _DTYPE_CODE[x3.dtype], stream)
    _kernels.check(lib, rc, entry)


def _workspace(x3):
    """The (2, C, S) f32 partial sums of a reduction kernel."""
    N, C, HW = x3.shape
    S = _kernels.load("bn_train").bn_slabs(N, C, HW)
    return torch.empty((2, C, S), dtype=torch.float32, device=x3.device)


def bn_stats_cuda(x3, c):
    """Launch the stats kernel: (s1, s2) f32 per channel.
    ``bn_stats_cuda.launches`` counts the launches."""
    _check_operands("bn_stats_cuda", x3, chans=(("c", c),))
    x3, c = _kernel_operand(x3), c.contiguous()
    C = x3.shape[1]
    s1 = torch.empty(C, dtype=torch.float32, device=x3.device)
    s2 = torch.empty_like(s1)
    _launch("bn_stats", x3, x3, c, s1, s2, _workspace(x3))
    bn_stats_cuda.launches += 1
    return s1, s2


bn_stats_cuda.launches = 0


def bn_apply_cuda(x3, a, b):
    """Launch the apply kernel: y = x * a + b in x's dtype.
    ``bn_apply_cuda.launches`` counts the launches."""
    _check_operands("bn_apply_cuda", x3, chans=(("a", a), ("b", b)))
    x3, a, b = _kernel_operand(x3), a.contiguous(), b.contiguous()
    y = torch.empty_like(x3)
    _launch("bn_apply", x3, x3, a, b, y)
    bn_apply_cuda.launches += 1
    return y


bn_apply_cuda.launches = 0


def bn_bwd_reduce_cuda(dy3, x3, mean):
    """Launch the backward reduce kernel: (db, dxc) f32 per channel.
    ``bn_bwd_reduce_cuda.launches`` counts the launches."""
    _check_operands("bn_bwd_reduce_cuda", x3, same=(("dy", dy3),),
                    chans=(("mean", mean),))
    dy3, x3, mean = (_kernel_operand(dy3), _kernel_operand(x3),
                     mean.contiguous())
    C = x3.shape[1]
    db = torch.empty(C, dtype=torch.float32, device=x3.device)
    dxc = torch.empty_like(db)
    _launch("bn_bwd_reduce", x3, dy3, x3, mean, db, dxc, _workspace(x3))
    bn_bwd_reduce_cuda.launches += 1
    return db, dxc


bn_bwd_reduce_cuda.launches = 0


def bn_bwd_dx_cuda(dy3, x3, a, c2, b, mean, out_dtype=None):
    """Launch the dx kernel: dx = dy * a + (x - mean) * c2 + b in x's
    dtype. ``bn_bwd_dx_cuda.launches`` counts the launches."""
    _check_operands("bn_bwd_dx_cuda", x3, same=(("dy", dy3),),
                    chans=(("a", a), ("c2", c2), ("b", b),
                           ("mean", mean)))
    if out_dtype is not None and out_dtype != x3.dtype:
        raise TypeError("bn_bwd_dx_cuda: dx comes out in x's dtype %s, "
                        "not %s" % (x3.dtype, out_dtype))
    dy3, x3 = _kernel_operand(dy3), _kernel_operand(x3)
    a, c2, b, mean = (t.contiguous() for t in (a, c2, b, mean))
    dx = torch.empty_like(x3)
    _launch("bn_bwd_dx", x3, dy3, x3, a, c2, b, mean, dx)
    bn_bwd_dx_cuda.launches += 1
    return dx


bn_bwd_dx_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatch: the kernel on CUDA tensors, the plain version on CPU and meta
# ---------------------------------------------------------------------------

def _dispatch(kernel, reference, x_dev, *args):
    if x_dev.type == "cuda":
        return kernel(*args)
    if x_dev.type in ("cpu", "meta"):
        return reference(*args)
    raise ValueError("the BatchNorm kernels have no implementation for "
                     "device %s" % (x_dev,))


def bn_stats(x3, c):
    return _dispatch(bn_stats_cuda, _stats_reference, x3.device, x3, c)


def bn_apply(x3, a, b):
    return _dispatch(bn_apply_cuda, _apply_reference, x3.device, x3, a, b)


def bn_bwd_reduce(dy3, x3, mean):
    return _dispatch(bn_bwd_reduce_cuda, _bwd_reduce_reference, x3.device,
                     dy3, x3, mean)


def bn_bwd_dx(dy3, x3, a, c2, b, mean, out_dtype=None):
    return _dispatch(bn_bwd_dx_cuda, _bwd_dx_reference, x3.device, dy3, x3,
                     a, c2, b, mean, out_dtype)


# ---------------------------------------------------------------------------
# the training core: bn_train_pallas's contract
# ---------------------------------------------------------------------------

class _BnTrainKernels(torch.autograd.Function):
    """(y, mean, var) of an NCHW batch with the closed-form backward,
    including the mean/var outputs' own cotangents (zero when unused).

    Under the replica ``rep`` (``_mesh_ctx.Replica``: the batch split
    over ranks) the statistics are the whole batch's: the shift is
    replica rank 0's first sample's channel mean (the global batch's
    first sample, a C-length psum masked to that rank), the stats
    kernel's shifted sums and the backward reduce kernel's sums are
    all-reduced, and gamma's and beta's gradients stay this rank's part
    (the step sums them over the replica axes). The kernels are the
    one-rank kernels: they take the shift and the mean as inputs."""

    @staticmethod
    def forward(ctx, x, g, beta, eps, rep):
        N, C, H, W = x.shape
        x3 = x.reshape(N, C, H * W)
        m = N * H * W * (1 if rep is None else rep.n)
        c = x3[0].float().mean(dim=1)      # the shift: first sample's mean
        if rep is not None:
            c = _replica_total(c if rep.index == 0 else torch.zeros_like(c),
                             rep)
        s1, s2 = bn_stats(x3, c)
        if rep is not None:
            s1, s2 = _replica_total(s1, rep), _replica_total(s2, rep)
        mean_s = s1 / m
        mean = c + mean_s
        var = torch.clamp_min(s2 / m - mean_s * mean_s, 0.0)
        inv = torch.rsqrt(var + eps)
        a = g.float() * inv
        b = beta.float() - mean * a
        y = bn_apply(x3, a, b).reshape(x.shape)
        ctx.save_for_backward(x, g, mean, inv)
        ctx.beta_dtype = beta.dtype
        ctx.rep = rep
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, g, mean, inv = ctx.saved_tensors
        rep = ctx.rep
        N, C, H, W = x.shape
        m = N * H * W * (1 if rep is None else rep.n)
        x3 = x.reshape(N, C, H * W)
        # dy stays in its own dtype: the kernels read it as they read x
        dy3 = dy.reshape(N, C, H * W)
        db, dxc = bn_bwd_reduce(dy3, x3, mean)
        dgx = dxc * inv                        # = sum(dy * xhat)
        db_all, dgx_all = db, dgx
        dmean, dvar = dmean.float(), dvar.float()
        if rep is not None:
            db_all, dgx_all, dmean, dvar = (
                _replica_total(t, rep) for t in (db, dgx, dmean, dvar))
        gf = g.float()
        k = gf * inv / m
        a = gf * inv
        c2 = -k * inv * dgx_all + (2.0 / m) * dvar
        b = -k * db_all + dmean / m
        dx = bn_bwd_dx(dy3, x3, a, c2, b, mean, x.dtype).reshape(x.shape)
        return dx, dgx.to(g.dtype), db.to(ctx.beta_dtype), None, None


def _replica_total(t, rep):
    """A per-channel f32 sum over the replica axes ``rep`` (no
    autograd)."""
    from ..parallel import _comm
    out = t.detach().contiguous().clone()
    _comm.all_reduce_([out], rep.mesh, rep.axes)
    return out


def bn_train_kernels(x, g, beta, eps, rep=None):
    """Training BatchNorm of a 4-D NCHW ``x`` over the kernels: returns
    (y in x's dtype, mean f32, var f32), differentiable in x, g and
    beta; dgamma and dbeta come back in g's and beta's dtypes. ``rep``:
    the replica axes the batch splits over (see ``_BnTrainKernels``)."""
    return _BnTrainKernels.apply(x, g, beta, float(eps), rep)
