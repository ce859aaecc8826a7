#!/usr/bin/env python3
"""Time the fused flash backward kernel against variants of its source on
one card, in turns, at the flagship training shape.

    python3 tools/flash_bwd_variants.py [variant.cu ...]

Builds ``mxnet_tpu_torch/csrc/flash_bwd.cu`` ("base") and every variant
source given (each a whole copy of that file, edited) with the same nvcc
flags as ``mxnet_tpu_torch/_kernels.py``, all compiles started together;
prints each build's registers, spills and wgmma serialization warnings;
holds base against the plain versions (``_flash_dq_reference``,
``_flash_dkv_reference``) in six small cases, two launches bit-equal;
then times every library in its own child process (a variant that hangs
the card is killed after 90 s): the flagship shape (B*H 128, T 2048,
D 128, bf16, causal), CUDA events around each launch, median of 10,
base first and last. Needs a CUDA card and nvcc; imports no JAX.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "variants")
FLAGSHIP = (128, 2048, 2048, 128, True)
CHECK = [(2, 256, 256, 128, True, 0, 0), (2, 200, 333, 64, True, 0, 0),
         (2, 100, 130, 16, False, 0, 0), (2, 256, 320, 128, True, 100, 64),
         (2, 128, 128, 32, True, 0, -20), (3, 640, 640, 128, False, 0, 0)]


def sources(argv):
    base = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "flash_bwd.cu")
    return {"base": base, **{os.path.splitext(os.path.basename(p))[0]: p
                             for p in argv}}


def build(srcs):
    from mxnet_tpu_torch import _kernels
    os.makedirs(OUT, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o",
         os.path.join(OUT, "lib%s.so" % name), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in srcs.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        print("build %s: nvcc exit %d" % (name, proc.returncode))
        for m in re.finditer(r"bf16ILi(\d+)E\S*\n\s*\d+ bytes stack frame, "
                             r"(\d+) bytes spill stores, (\d+) bytes spill "
                             r"loads\n.*?Used (\d+) registers", log):
            print("  flash_bwd_bf16<%s>: %s registers, spills %s/%s"
                  % (m.group(1), m.group(4), m.group(2), m.group(3)))
        for line in sorted(set(re.findall(r"\(C75\d\d\)[^']*", log))):
            print("  " + line.strip())
        if proc.returncode:
            print(log[-2000:])


def load(name):
    from mxnet_tpu_torch import _kernels
    lib = ctypes.CDLL(os.path.join(OUT, "lib%s.so" % name))
    _kernels._declare("flash_bwd", lib)
    return lib


def run(lib, q, k, v, do, lse, delta, scale, causal, window=0, off=0):
    import torch
    BH, T, D = q.shape
    dq = torch.zeros_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    acc = torch.empty((BH, T, D), dtype=torch.float32, device=q.device)
    turns = torch.zeros((BH, -(-T // 64)), dtype=torch.int32,
                        device=q.device)
    rc = lib.flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), acc.data_ptr(), turns.data_ptr(), BH, T, k.shape[1],
        D, float(scale), int(causal), window, off, 1,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError("flash_bwd: CUDA error %d" % rc)
    return dq, dk, dv


def inputs(BH, T, Tk, D, causal, window=0, off=0):
    import torch
    from mxnet_tpu_torch.ops import attention as att
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((BH, n, D), generator=gen, device="cuda")
               .bfloat16() for n in (T, Tk, Tk))
    do = torch.randn((BH, T, D), generator=gen, device="cuda").bfloat16()
    o, lse = att.flash_fwd_cuda(q, k, v, D ** -0.5, causal, window, off,
                                want_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, delta, D ** -0.5, causal, window, off


def check(lib):
    import torch
    from mxnet_tpu_torch.ops import attention as att
    worst, same = 0.0, True
    for case in CHECK:
        args = inputs(*case)
        got = run(lib, *args)
        want = (att._flash_dq_reference(*args),
                *att._flash_dkv_reference(*args))
        worst = max([worst] + [float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, want)])
        same &= all(torch.equal(a, b) for a, b in zip(got, run(lib, *args)))
    print("check base: max abs err %.4g over %d cases (bf16), two launches "
          "bit-equal: %s" % (worst, len(CHECK), same), flush=True)


def time_one(name):
    import torch
    lib, args = load(name), inputs(*FLAGSHIP)
    for _ in range(3):
        run(lib, *args)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(10)]
    for a, b in ev:
        a.record()
        run(lib, *args)
        b.record()
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in ev)[5]
    print("time %s: %.4f ms (median of 10, flagship %s)" % (name, ms,
                                                           FLAGSHIP),
          flush=True)


def main():
    if os.environ.get("FLASH_BWD_VARIANT"):
        time_one(os.environ["FLASH_BWD_VARIANT"])
        return
    srcs = sources(sys.argv[1:])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build(srcs)
    check(load("base"))
    order = list(srcs) + ["base"]
    for name in order:
        try:
            subprocess.run([sys.executable, __file__], timeout=90,
                           env={**os.environ, "FLASH_BWD_VARIANT": name})
        except subprocess.TimeoutExpired:
            print("time %s: killed after 90 s" % name, flush=True)


if __name__ == "__main__":
    main()
