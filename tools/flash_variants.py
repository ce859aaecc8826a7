#!/usr/bin/env python3
"""Time a bf16 flash kernel against variants of its source on one card, in
turns, at the flagship shape.

    python3 tools/flash_variants.py --kernel fwd|bwd [--log-dir DIR]
                                    [variant.cu ...]

Builds ``mxnet_tpu_torch/csrc/flash_fwd.cu`` or ``flash_bwd.cu`` ("base")
and every variant source given (each a whole copy of that file, edited,
with the same C interface) with the same nvcc flags as
``mxnet_tpu_torch/_kernels.py``, all compiles started together; prints
each build's registers, spills and wgmma serialization warnings (the
whole nvcc output goes to ``<log-dir>/nvcc_<kernel>_<name>.log``, by
default ``build/variants/``). Then
each library runs in its own child process (a variant that hangs the card
is killed after 90 s), base first and last: it is held against the plain
versions in small cases (the forward against ``_flash_fwd_reference``,
o and lse; the backward against ``_flash_dq_reference`` and
``_flash_dkv_reference``), two launches bit-equal, and timed at the
flagship shape (B*H 128, T 2048, D 128, bf16, causal; the forward with
and without lse, and without the causal mask), CUDA events around each
launch, median of 10. Keep
variants under the gitignored ``build/``. Needs a CUDA card and nvcc;
imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import LSE_TOL, ptxas_warnings  # noqa: E402

CSRC = os.path.join(ROOT, "mxnet_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "variants")
FLAGSHIP = (128, 2048, 2048, 128, True)
# (BH, T, Tk, D, causal, window, band_offset)
CHECK = {
    "bwd": [(2, 256, 256, 128, True, 0, 0), (2, 200, 333, 64, True, 0, 0),
            (2, 100, 130, 16, False, 0, 0),
            (2, 256, 320, 128, True, 100, 64),
            (2, 128, 128, 32, True, 0, -20),
            (3, 640, 640, 128, False, 0, 0)],
    "fwd": [(2, 256, 256, 128, True, 0, 0), (2, 200, 333, 64, True, 0, 0),
            (2, 100, 130, 16, False, 0, 0), (2, 300, 300, 32, True, 0, 0),
            (2, 1000, 1000, 128, True, 200, 0),
            (2, 256, 320, 128, True, 100, 64),
            (2, 256, 256, 128, True, 0, -40),
            (3, 640, 640, 128, False, 0, 0)],
}


def sources(kind, paths):
    base = os.path.join(CSRC, "flash_%s.cu" % kind)
    return {"base": base, **{os.path.splitext(os.path.basename(p))[0]: p
                             for p in paths}}


def build(kind, srcs, logs):
    from mxnet_tpu_torch import _kernels
    os.makedirs(OUT, exist_ok=True)
    os.makedirs(logs, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", CSRC, "-o",
         os.path.join(OUT, "lib%s_%s.so" % (kind, name)), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in srcs.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(logs, "nvcc_%s_%s.log" % (kind, name)),
                  "w") as f:
            f.write(log)
        print("build %s: nvcc exit %d" % (name, proc.returncode))
        for m in re.finditer(r"flash_%s_bf16ILi(\d+)E\S*\n\s*\d+ bytes "
                             r"stack frame, (\d+) bytes spill stores, (\d+) "
                             r"bytes spill loads\n.*?Used (\d+) registers"
                             % kind, log):
            print("  flash_%s_bf16<%s>: %s registers, spills %s/%s"
                  % (kind, m.group(1), m.group(4), m.group(2), m.group(3)))
        for line in ptxas_warnings(log):
            print("  " + line)
        if proc.returncode:
            print(log[-3000:])
    sys.stdout.flush()


def load(kind, name):
    from mxnet_tpu_torch import _kernels
    lib = ctypes.CDLL(os.path.join(OUT, "lib%s_%s.so" % (kind, name)))
    _kernels._declare("flash_" + kind, lib)
    return lib


def run_fwd(lib, q, k, v, scale, causal, window=0, off=0, want_lse=True):
    import torch
    BH, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device) \
        if want_lse else None
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), lse.data_ptr() if want_lse else None,
                       BH, T, k.shape[1], D, float(scale), int(causal),
                       window, off, 1, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError("flash_fwd: CUDA error %d" % rc)
    return o, lse


def run_bwd(lib, q, k, v, do, lse, delta, scale, causal, window=0, off=0):
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


def qkv(BH, T, Tk, D):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    return [torch.randn((BH, n, D), generator=gen, device="cuda").bfloat16()
            for n in (T, Tk, Tk, T)]


def bwd_inputs(BH, T, Tk, D, causal, window=0, off=0):
    from mxnet_tpu_torch.ops import attention as att
    q, k, v, do = qkv(BH, T, Tk, D)
    o, lse = att._flash_fwd_reference(q, k, v, D ** -0.5, causal, window,
                                      off)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, delta, D ** -0.5, causal, window, off


def check(kind, name, lib):
    """Max abs error against the plain versions over the CHECK cases, and
    whether two launches gave the same bits in every case."""
    import torch
    from mxnet_tpu_torch.ops import attention as att
    worst, same, lse_ok = 0.0, True, True
    for BH, T, Tk, D, causal, window, off in CHECK[kind]:
        if kind == "fwd":
            q, k, v, _ = qkv(BH, T, Tk, D)
            args = (q, k, v, D ** -0.5, causal, window, off)
            got = run_fwd(lib, *args)
            ro, rlse = att._flash_fwd_reference(*args)
            le = (got[1] - rlse).abs()
            lse_ok &= bool((le <= LSE_TOL["atol"]
                            + LSE_TOL["rtol"] * rlse.abs()).all())
            worst = max(worst, float((got[0].float() - ro.float()).abs()
                                     .max()))
            again = run_fwd(lib, *args)
        else:
            args = bwd_inputs(BH, T, Tk, D, causal, window, off)
            got = run_bwd(lib, *args)
            want = (att._flash_dq_reference(*args),
                    *att._flash_dkv_reference(*args))
            worst = max([worst] + [float((a.float() - b.float()).abs()
                                         .max()) for a, b in zip(got, want)])
            again = run_bwd(lib, *args)
        same &= all(torch.equal(a, b) for a, b in zip(got, again))
    torch.cuda.synchronize()
    print("check %s: max abs err %.4g over %d cases (bf16)%s, two launches "
          "bit-equal: %s" % (name, worst, len(CHECK[kind]),
                             ", lse within tolerance: %s" % lse_ok
                             if kind == "fwd" else "", same), flush=True)


def events_ms(fn, reps=10):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in ev)[reps // 2]


def time_one(kind, name):
    lib = load(kind, name)
    check(kind, name, lib)
    BH, T, Tk, D, causal = FLAGSHIP
    if kind == "fwd":
        q, k, v, _ = qkv(BH, T, Tk, D)
        args = (lib, q, k, v, D ** -0.5, causal)
        serve = events_ms(lambda: run_fwd(*args, want_lse=False))
        train = events_ms(lambda: run_fwd(*args, want_lse=True))
        full = events_ms(lambda: run_fwd(*args[:-1], False, want_lse=False))
        print("time %s: %.4f ms without lse, %.4f ms with lse; non-causal "
              "%.4f ms (median of 10, flagship %s)"
              % (name, serve, train, full, FLAGSHIP), flush=True)
    else:
        args = bwd_inputs(*FLAGSHIP)
        ms = events_ms(lambda: run_bwd(lib, *args))
        print("time %s: %.4f ms (median of 10, flagship %s)"
              % (name, ms, FLAGSHIP), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("fwd", "bwd"), required=True)
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--log-dir", default=OUT,
                    help="where nvcc's whole output goes")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        time_one(a.kernel, a.child)
        return
    srcs = sources(a.kernel, a.variants)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build(a.kernel, srcs, a.log_dir)
    for name in list(srcs) + ["base"]:
        try:
            subprocess.run([sys.executable, __file__, "--kernel", a.kernel,
                            "--child", name], timeout=90)
        except subprocess.TimeoutExpired:
            print("time %s: killed after 90 s" % name, flush=True)


if __name__ == "__main__":
    main()
