#!/usr/bin/env python3
"""How far one float32 convolution (forward, dgrad, wgrad) lands from the
same convolution in float64, on the card through cuDNN and through
PyTorch's own CUDA kernels, and on the CPU, at the shapes of the small
ResNet that chip_smoke.py binds through the Executor.

    python3 tools/conv_precision.py

Needs a CUDA card. Importing the port turns TF32 off (its
MXNET_MATMUL_PRECISION default). cuDNN is switched by
``torch.backends.cudnn.enabled`` alone: ``torch.backends.cudnn.flags()``
would also reset ``allow_tf32`` to its default, True.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import mxnet_tpu_torch  # noqa: E402,F401

# (batch, in channels, height = width, out channels, stride)
SHAPES = ((4, 3, 64, 64, 2), (4, 64, 16, 64, 1), (4, 128, 8, 128, 1),
          (4, 256, 4, 256, 1), (4, 512, 2, 512, 1))


def grads(x, w, dy, stride, device, dtype):
    """(y, dx, dw) of one convolution, as float64 on the host."""
    ks = w.shape[-1]
    xx = x.to(device, dtype).requires_grad_()
    ww = w.to(device, dtype).requires_grad_()
    y = torch.nn.functional.conv2d(xx, ww, stride=stride, padding=ks // 2)
    gx, gw = torch.autograd.grad(y, (xx, ww), dy.to(device, dtype))
    return [t.detach().double().cpu() for t in (y, gx, gw)]


def main():
    if not torch.cuda.is_available():
        sys.exit("conv_precision: no CUDA device")
    print("%s; TF32 for cuDNN %s, for cuBLAS %s" % (
        torch.cuda.get_device_name(0), torch.backends.cudnn.allow_tf32,
        torch.backends.cuda.matmul.allow_tf32))
    torch.manual_seed(0)
    for n, c, hw, k, stride in SHAPES:
        ks = 7 if c == 3 else 3
        x = torch.randn(n, c, hw, hw, dtype=torch.float64)
        w = torch.randn(k, c, ks, ks, dtype=torch.float64) * 0.1
        out = torch.nn.functional.conv2d(x, w, stride=stride,
                                         padding=ks // 2)
        dy = torch.randn(out.shape, dtype=torch.float64)
        ref = grads(x, w, dy, stride, "cpu", torch.float64)
        row = []
        for label, device, cudnn in (("cudnn", "cuda", True),
                                     ("native", "cuda", False),
                                     ("cpu", "cpu", True)):
            torch.backends.cudnn.enabled = cudnn
            got = grads(x, w, dy, stride, device, torch.float32)
            torch.backends.cudnn.enabled = True
            row.append("%s fwd %.2e dgrad %.2e wgrad %.2e" % (
                (label,) + tuple(float((g - r).norm() / r.norm())
                                 for g, r in zip(got, ref))))
        print("N%d C%d HW%d K%d stride %d: %s" % (n, c, hw, k, stride,
                                                  " | ".join(row)),
              flush=True)


if __name__ == "__main__":
    main()
