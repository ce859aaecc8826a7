#!/usr/bin/env python3
"""Time a flash kernel against variants of its source on one card, in
turns, at the flagship shape.

    python3 tools/flash_variants.py --kernel fwd|bwd [--dtype float32]
                                    [--with-old REV] [--log-dir DIR]
                                    [variant.cu ...]

Builds ``mxnet_tpu_torch/csrc/flash_fwd.cu`` or ``flash_bwd.cu`` ("base")
and every variant source given (each a whole copy of that file, edited,
with the same C interface; a quoted include resolves first beside the
variant, then in ``csrc/``) with the same nvcc flags as
``mxnet_tpu_torch/_kernels.py``, all compiles started together; prints
each build's registers, spills and wgmma serialization warnings (the
whole nvcc output goes to ``<log-dir>/nvcc_<kernel>_<name>.log``, by
default ``build/variants/``). ``--with-old REV`` adds that git
revision's source as the variant ``old_REV``: ``git show`` writes it,
with the revision's headers, into ``build/variants/REV/`` (gitignored);
where there is no git, as on the card's machine, the files must already
be there (run the tool once with ``--fetch-only`` in a checkout).
Then each library runs in its own child process (a variant that hangs
the card is killed after 90 s), base first and last: it
is held against the plain versions in small cases (the forward against
``_flash_fwd_reference``, o and lse; the backward against
``_flash_dq_reference`` and ``_flash_dkv_reference``; bf16 reports the
worst error, float32 also checks each case against ``chip_smoke.TOL`` and
``LSE_TOL``), two launches bit-equal, and timed at the flagship shape
(B*H 128, T 2048, D 128, causal, in ``--dtype``; the forward with and
without lse, and without the causal mask), CUDA events around each
launch, median of 10 (3 in float32). Keep variants under the gitignored
``build/``. Needs a CUDA card and nvcc; imports no JAX.
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
from chip_smoke import (LSE_TOL, TOL, ptxas_summary,  # noqa: E402
                        ptxas_warnings)

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
# the float32 kernels' tile edges (64-row q tiles, 64-key tiles): T and Tk
# off the tile, T < Tk and T > Tk, T < 64, a window off the tile with a
# ragged tail, a negative band_offset, D = 8 (the padded D = 4), and
# non-causal; the same for both kernels
CHECK_F32 = [(2, 256, 256, 128, True, 0, 0), (3, 200, 333, 64, True, 0, 0),
             (2, 333, 200, 128, True, 0, 0), (2, 40, 40, 128, True, 0, 0),
             (2, 300, 300, 128, True, 100, 0),
             (2, 256, 256, 64, True, 0, -40),
             (2, 130, 97, 8, False, 0, 0),
             (2, 256, 320, 64, True, 128, 64),
             (2, 640, 640, 128, False, 0, 0)]


def old_dir(rev):
    return os.path.join(OUT, rev)


def fetch_old(rev):
    """Write revision ``rev``'s flash sources and csrc headers into
    ``build/variants/<rev>/`` (needs git and a checkout); a no-op where
    they are there already."""
    dst = old_dir(rev)
    if all(os.path.exists(os.path.join(dst, "flash_%s.cu" % k))
           for k in ("fwd", "bwd")):
        return
    os.makedirs(dst, exist_ok=True)
    names = subprocess.run(
        ["git", "ls-tree", "--name-only", rev, "mxnet_tpu_torch/csrc/"],
        cwd=ROOT, capture_output=True, text=True, check=True).stdout.split()
    for path in names:
        base = os.path.basename(path)
        if base.endswith((".cuh", ".h")) or base in ("flash_fwd.cu",
                                                      "flash_bwd.cu"):
            with open(os.path.join(dst, base), "w") as f:
                f.write(subprocess.run(["git", "show", "%s:%s" % (rev, path)],
                                       cwd=ROOT, capture_output=True,
                                       text=True, check=True).stdout)


def sources(kind, paths, old=None):
    base = os.path.join(CSRC, "flash_%s.cu" % kind)
    srcs = {"base": base, **{os.path.splitext(os.path.basename(p))[0]: p
                             for p in paths}}
    if old:
        srcs["old_" + old] = os.path.join(old_dir(old), "flash_%s.cu" % kind)
    return srcs


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
        for line in ptxas_summary(log):
            print("  " + line)
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


def dtype_code(x):
    import torch
    return {torch.float32: 0, torch.bfloat16: 1}[x.dtype]


def run_fwd(lib, q, k, v, scale, causal, window=0, off=0, want_lse=True):
    import torch
    BH, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device) \
        if want_lse else None
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), lse.data_ptr() if want_lse else None,
                       BH, T, k.shape[1], D, float(scale), int(causal),
                       window, off, dtype_code(q),
                       torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError("flash_fwd: CUDA error %d" % rc)
    return o, lse


def run_bwd(lib, q, k, v, do, lse, delta, scale, causal, window=0, off=0):
    """The backward's C entry with the scratch ops/attention.py gives it:
    dq and the turn counters zeroed, dq_acc for bf16 only (an older
    float32 entry ignores both)."""
    import torch
    BH, T, D = q.shape
    dq = torch.zeros_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    acc = torch.empty((BH, T, D), dtype=torch.float32, device=q.device) \
        if q.dtype == torch.bfloat16 else None
    turns = torch.zeros((BH, -(-T // 64)), dtype=torch.int32,
                        device=q.device)
    rc = lib.flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), acc.data_ptr() if acc is not None else None,
        turns.data_ptr(), BH, T, k.shape[1], D, float(scale), int(causal),
        window, off, dtype_code(q), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError("flash_bwd: CUDA error %d" % rc)
    return dq, dk, dv


def qkv(BH, T, Tk, D, dtype):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    return [torch.randn((BH, n, D), generator=gen, device="cuda").to(dtype)
            for n in (T, Tk, Tk, T)]


def bwd_inputs(BH, T, Tk, D, causal, window, off, dtype):
    from mxnet_tpu_torch.ops import attention as att
    q, k, v, do = qkv(BH, T, Tk, D, dtype)
    o, lse = att._flash_fwd_reference(q, k, v, D ** -0.5, causal, window,
                                      off)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, delta, D ** -0.5, causal, window, off


def within(got, want, tol):
    return bool(((got.float() - want.float()).abs()
                 <= tol["atol"] + tol["rtol"] * want.float().abs()).all())


def check(kind, name, lib, dtype):
    """Max abs error against the plain versions over the check cases,
    whether every case is within tolerance (float32: TOL and LSE_TOL),
    and whether two launches gave the same bits in every case."""
    import torch
    from mxnet_tpu_torch.ops import attention as att
    f32 = dtype == torch.float32
    cases = CHECK_F32 if f32 else CHECK[kind]
    tol = TOL["float32"] if f32 else None
    worst, same, ok = 0.0, True, True
    for BH, T, Tk, D, causal, window, off in cases:
        if kind == "fwd":
            q, k, v, _ = qkv(BH, T, Tk, D, dtype)
            args = (q, k, v, D ** -0.5, causal, window, off)
            got = run_fwd(lib, *args)
            ro, rlse = att._flash_fwd_reference(*args)
            ok &= within(got[1], rlse, LSE_TOL)
            if tol:
                ok &= within(got[0], ro, tol)
            worst = max(worst, float((got[0].float() - ro.float()).abs()
                                     .max()))
            again = run_fwd(lib, *args)
        else:
            args = bwd_inputs(BH, T, Tk, D, causal, window, off, dtype)
            got = run_bwd(lib, *args)
            want = (att._flash_dq_reference(*args),
                    *att._flash_dkv_reference(*args))
            worst = max([worst] + [float((a.float() - b.float()).abs()
                                         .max()) for a, b in zip(got, want)])
            if tol:
                ok &= all(within(a, b, tol) for a, b in zip(got, want))
            again = run_bwd(lib, *args)
        same &= all(torch.equal(a, b) for a, b in zip(got, again))
    torch.cuda.synchronize()
    print("check %s: max abs err %.4g over %d cases (%s), within "
          "tolerance: %s, two launches bit-equal: %s"
          % (name, worst, len(cases), str(dtype).replace("torch.", ""),
             ok if (tol or kind == "fwd") else "not checked (bf16)", same),
          flush=True)


def events_ms(fn, reps=10):
    import torch
    for _ in range(2):
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


def time_one(kind, name, dtype_name):
    import torch
    dtype = getattr(torch, dtype_name)
    reps = 3 if dtype == torch.float32 else 10
    lib = load(kind, name)
    check(kind, name, lib, dtype)
    BH, T, Tk, D, causal = FLAGSHIP
    if kind == "fwd":
        q, k, v, _ = qkv(BH, T, Tk, D, dtype)
        args = (lib, q, k, v, D ** -0.5, causal)
        serve = events_ms(lambda: run_fwd(*args, want_lse=False), reps)
        train = events_ms(lambda: run_fwd(*args, want_lse=True), reps)
        full = events_ms(lambda: run_fwd(*args[:-1], False, want_lse=False),
                         reps)
        print("time %s: %.4f ms without lse, %.4f ms with lse; non-causal "
              "%.4f ms (median of %d, flagship %s, %s)"
              % (name, serve, train, full, reps, FLAGSHIP, dtype_name),
              flush=True)
    else:
        args = bwd_inputs(*FLAGSHIP, 0, 0, dtype)
        ms = events_ms(lambda: run_bwd(lib, *args), reps)
        print("time %s: %.4f ms (median of %d, flagship %s, %s)"
              % (name, ms, reps, FLAGSHIP, dtype_name), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("fwd", "bwd"), required=True)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--with-old", metavar="REV",
                    help="also time this git revision's kernel")
    ap.add_argument("--fetch-only", action="store_true",
                    help="write --with-old's sources and stop (no card)")
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--log-dir", default=OUT,
                    help="where nvcc's whole output goes")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        time_one(a.kernel, a.child, a.dtype)
        return
    if a.with_old:
        fetch_old(a.with_old)
    if a.fetch_only:
        return
    srcs = sources(a.kernel, a.variants, a.with_old)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build(a.kernel, srcs, a.log_dir)
    for name in list(srcs) + ["base"]:
        try:
            subprocess.run([sys.executable, __file__, "--kernel", a.kernel,
                            "--dtype", a.dtype, "--child", name],
                           timeout=90)
        except subprocess.TimeoutExpired:
            print("time %s: killed after 90 s" % name, flush=True)


if __name__ == "__main__":
    main()
