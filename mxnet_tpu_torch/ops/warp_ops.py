"""Spatial warping / matching ops — GridGenerator, BilinearSampler,
SpatialTransformer, Correlation — the PyTorch twin of
``mxnet_tpu/ops/warp_ops.py`` (reference: src/operator/
grid_generator-inl.h, bilinear_sampler-inl.h, spatial_transformer-inl.h,
correlation-inl.h).

Plain gathers and window arithmetic, as the JAX ops compute them: the
sampler's zero-padded bilinear taps at ``(g + 1) * (size - 1) / 2`` (not
``F.grid_sample``'s corner conventions), and Correlation's wrap-around
shift (``jnp.roll``) before the crop. Gradients with respect to the data
and the grid come from autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .detection_ops import _weak as _c
from .registry import register


# ---------------------------------------------------------------------------
# GridGenerator
# ---------------------------------------------------------------------------

def _affine_grid(theta, H, W):
    """theta (B, 6) row-major 2x3 -> sampling grid (B, 2, H, W) of
    normalized [-1, 1] (x, y) target->source coords."""
    dev, f = theta.device, theta.dtype
    ys = torch.linspace(-1.0, 1.0, H, dtype=f, device=dev)
    xs = torch.linspace(-1.0, 1.0, W, dtype=f, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)])       # (3, H*W)
    out = theta.reshape(-1, 2, 3) @ base                       # (B, 2, H*W)
    return out.reshape(-1, 2, H, W)


@register("GridGenerator", arg_names=("data",),
          defaults={"transform_type": "affine", "target_shape": (0, 0)})
def _grid_generator(data, transform_type="affine", target_shape=(0, 0),
                    **_):
    if transform_type == "affine":
        H, W = int(target_shape[0]), int(target_shape[1])
        return _affine_grid(data, H, W)
    if transform_type == "warp":
        # data (B, 2, H, W) pixel-offset flow -> normalized abs coords
        B, _two, H, W = data.shape
        gy, gx = torch.meshgrid(torch.arange(H, device=data.device),
                                torch.arange(W, device=data.device),
                                indexing="ij")
        x = data[:, 0] + gx
        y = data[:, 1] + gy
        two, one = _c(x, 2.0), _c(x, 1.0)
        xn = two * x / _c(x, max(W - 1, 1)) - one
        yn = two * y / _c(y, max(H - 1, 1)) - one
        return torch.stack([xn, yn], dim=1)
    raise ValueError("unknown transform_type %r" % transform_type)


# ---------------------------------------------------------------------------
# BilinearSampler
# ---------------------------------------------------------------------------

def _bilinear_sample(img, grid):
    """img (B, C, H, W), grid (B, 2, Ho, Wo) normalized -> (B, C, Ho, Wo);
    points outside [-1,1] contribute zero (reference
    bilinear_sampler-inl.h between() boundary handling)."""
    B, C, H, W = img.shape
    one = _c(grid, 1.0)
    x = (grid[:, 0] + one) * (W - 1) / 2.0
    y = (grid[:, 1] + one) * (H - 1) / 2.0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    flat = img.reshape(B, C, H * W)

    def corner(yc, xc, w):
        inside = (xc >= 0) & (xc <= W - 1) & (yc >= 0) & (yc <= H - 1)
        xi = torch.clamp(xc, 0, W - 1).to(torch.int64)
        yi = torch.clamp(yc, 0, H - 1).to(torch.int64)
        idx = (yi * W + xi).reshape(B, 1, -1).expand(B, C, -1)
        val = torch.gather(flat, 2, idx).reshape((B, C) + x.shape[1:])
        return val * (w * inside)[:, None]

    return (corner(y0, x0, (one - dx) * (one - dy)) +
            corner(y0, x0 + one, dx * (one - dy)) +
            corner(y0 + one, x0, (one - dx) * dy) +
            corner(y0 + one, x0 + one, dx * dy))


@register("BilinearSampler", arg_names=("data", "grid"))
def _bilinear_sampler(data, grid, **_):
    return _bilinear_sample(data, grid)


@register("SpatialTransformer", arg_names=("data", "loc"),
          defaults={"target_shape": (0, 0), "transform_type": "affine",
                    "sampler_type": "bilinear"})
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine",
                         sampler_type="bilinear", **_):
    """Affine grid + bilinear sampling fused (reference
    spatial_transformer-inl.h); loc is the (B, 6) localisation output."""
    assert transform_type == "affine" and sampler_type == "bilinear"
    H, W = int(target_shape[0]), int(target_shape[1])
    return _bilinear_sample(data, _affine_grid(loc, H, W))


# ---------------------------------------------------------------------------
# Correlation (FlowNet cost volume)
# ---------------------------------------------------------------------------

@register("Correlation", arg_names=("data1", "data2"),
          defaults={"kernel_size": 1, "max_displacement": 1, "stride1": 1,
                    "stride2": 1, "pad_size": 0, "is_multiply": True})
def _correlation(data1, data2, kernel_size=1, max_displacement=1,
                 stride1=1, stride2=1, pad_size=0, is_multiply=True, **_):
    """Cost volume between two feature maps (correlation-inl.h): for each
    displacement (dy, dx) on the stride2 grid, the sum over a kernel_size
    patch ("SAME" windows) and the channels of data1 * shifted(data2) (or
    |a-b| when is_multiply=False), over K*K*C. Output (B, D*D, Ho, Wo)."""
    B, C, H, W = data1.shape
    K = int(kernel_size)
    rad = (K - 1) // 2
    md, s1, s2, pad = (int(max_displacement), int(stride1), int(stride2),
                      int(pad_size))
    d_grid = 2 * (md // s2) + 1
    border = md + rad
    pH, pW = H + 2 * pad, W + 2 * pad
    Ho = -((pH - 2 * border) // -s1)
    Wo = -((pW - 2 * border) // -s1)

    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    lo = (K - 1) // 2                       # XLA's "SAME": low (K-1)//2

    maps = []
    for i in range(d_grid):
        for j in range(d_grid):
            dy = (i - d_grid // 2) * s2
            dx = (j - d_grid // 2) * s2
            shifted = torch.roll(p2, shifts=(-dy, -dx), dims=(2, 3))
            prod = p1 * shifted if is_multiply else torch.abs(p1 - shifted)
            summed = prod.sum(dim=1, keepdim=True)          # (B,1,pH,pW)
            if K > 1:
                summed = F.conv2d(F.pad(summed, (lo, K - 1 - lo, lo,
                                                 K - 1 - lo)),
                                  summed.new_ones((1, 1, K, K)))
            maps.append(summed[:, 0])
    vol = torch.stack(maps, dim=1)                          # (B,D²,pH,pW)
    # crop the valid region and apply stride1
    ys = border + torch.arange(Ho, device=vol.device) * s1
    xs = border + torch.arange(Wo, device=vol.device) * s1
    vol = vol[:, :, ys][:, :, :, xs]
    return vol / _c(vol, K * K * C)
