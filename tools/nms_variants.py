#!/usr/bin/env python3
"""Time the greedy-NMS kernel against variants of its source on one card,
in turns, at SSD300's two timed shapes; optionally split the earlier
one-block-an-image kernel by phase.

    python3 tools/nms_variants.py [--with-old] [--phases] [--log-dir DIR]
                                  [variant.cu ...]

Builds ``mxnet_tpu_torch/csrc/nms.cu`` ("base") and every variant source
given (each a whole copy of that file, edited, with the same C interface)
with the same nvcc flags as ``mxnet_tpu_torch/_kernels.py``, all compiles
started together, and prints each build's registers and spills (the whole
nvcc output goes to ``<log-dir>/nvcc_nms_<name>.log``, by default
``build/variants/``). ``--with-old`` adds the kernel of commit 0930d9f
(one 1024-thread block an image) as the variant ``old``, from
``build/nms_0930d9f.cu``; in a git checkout that file is written when it
is missing (where git is absent, write it beforehand with ``git show
0930d9f:mxnet_tpu_torch/csrc/nms.cu > build/nms_0930d9f.cu``).

Each library then runs in its own child process (killed after 150 s),
base first and last: ``nms_keep_cuda`` on that library is held against
``_nms_reference`` flag for flag in every ``chip_smoke.NMS_CASES`` case,
then timed at ``ssd300_top400`` and ``ssd300_all`` (B 8, A 8732, the
path's top 400 valid and every row valid): the device time of every
kernel and memset of the call (torch.profiler over 20 warm calls) and CUDA
events around each call (median of 20).

``--phases`` also builds ``mxnet_tpu_torch/csrc/nms.cu`` with
``-DNMS_STAMPS`` ("stamps") and ``tools/nms_phases.cu`` (the old kernel
with clock64() stamps in image 0's block, "phases"), and prints for each,
at both shapes, the time of each phase summed over the live row blocks
(the new kernel: the flag read and box load with the scan over dead
blocks before it, the bits, the walk, the suppression of later rows, the
cluster barrier; the old one: the box load, the bits, the walk, the
compaction, the inter-block step); cycles are converted to time by
%globaltimer over the same run.

Needs a CUDA card and nvcc; imports no JAX. Keep variants under the
gitignored ``build/``.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import ptxas_summary  # noqa: E402

CSRC = os.path.join(ROOT, "mxnet_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "variants")
OLD_COMMIT = "0930d9f"
OLD_SRC = os.path.join(ROOT, "build", "nms_%s.cu" % OLD_COMMIT)
PHASES_SRC = os.path.join(ROOT, "tools", "nms_phases.cu")
TIMED = ("ssd300_top400", "ssd300_all")
CHILD_TIMEOUT = 150


def old_source():
    if not os.path.exists(OLD_SRC):
        src = subprocess.run(
            ["git", "-C", ROOT, "show",
             OLD_COMMIT + ":mxnet_tpu_torch/csrc/nms.cu"],
            capture_output=True, text=True)
        if src.returncode:
            sys.exit("nms_variants: %s is missing and git cannot write it "
                     "(%s)" % (OLD_SRC, src.stderr.strip()))
        os.makedirs(os.path.dirname(OLD_SRC), exist_ok=True)
        with open(OLD_SRC, "w") as f:
            f.write(src.stdout)
    return OLD_SRC


def build(srcs, logs):
    """Compile every {name: (source, extra nvcc flags)} at once."""
    from mxnet_tpu_torch import _kernels
    os.makedirs(OUT, exist_ok=True)
    os.makedirs(logs, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, *flags, "-I", CSRC, "-o",
         os.path.join(OUT, "libnms_%s.so" % name), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, flags) in srcs.items()}
    ok = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(logs, "nvcc_nms_%s.log" % name), "w") as f:
            f.write(log)
        print("build %s: nvcc exit %d" % (name, proc.returncode))
        for line in ptxas_summary(log):
            print("  " + line)
        if proc.returncode:
            print(log[-3000:])
        ok[name] = proc.returncode == 0
    sys.stdout.flush()
    return ok


def load(name):
    from mxnet_tpu_torch import _kernels
    lib = ctypes.CDLL(os.path.join(OUT, "libnms_%s.so" % name))
    if name == "phases":
        c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nms_keep_phases.argtypes = [c_p, c_p, c_p, c_p, c_i, c_i, c_f,
                                        c_i, c_p, c_p]
        lib.nms_keep_phases.restype = c_i
        lib.kernel_error_string.argtypes = [c_i]
        lib.kernel_error_string.restype = ctypes.c_char_p
    elif name in ("base", "stamps"):
        _kernels._declare("nms", lib)
        if name == "stamps":
            lib.nms_read_stamps.argtypes = [ctypes.c_void_p]
            lib.nms_read_stamps.restype = ctypes.c_int
    else:       # a variant: the C entry nms_keep is all it must have
        c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nms_keep.argtypes = [c_p, c_p, c_p, c_p, c_i, c_i, c_f, c_i, c_p]
        lib.nms_keep.restype = c_i
        lib.kernel_error_string.argtypes = [c_i]
        lib.kernel_error_string.restype = ctypes.c_char_p
    if name != "phases":
        # nms_keep_cuda (checks, counter, launch) now runs this library
        _kernels._loaded["nms"] = lib
    return lib


def _kernels_lib():
    from mxnet_tpu_torch import _kernels
    return _kernels._loaded["nms"]


def events_ms(fn, reps=20):
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


def cases():
    import chip_smoke as cs
    return {c[0]: c for c in cs.NMS_CASES}


def inputs(label, seed=5):
    import torch
    import chip_smoke as cs
    _, B, A, n_valid, force, kind = cases()[label]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    boxes, cls, valid = cs.nms_inputs(B, A, n_valid, kind, gen)
    thr = 0.5 if kind == "at_threshold" else cs.SSD_NMS["nms_threshold"]
    return boxes, cls, valid, thr, force


def time_one(name):
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import nms_kernels as nmsk
    load(name)
    bad = []
    for label in cases():
        args = inputs(label)
        keep = nmsk.nms_keep_cuda(*args)
        torch.cuda.synchronize()
        diff = int((keep != nmsk._nms_reference(*args)).sum())
        if diff:
            bad.append("%s (%d flags)" % (label, diff))
    print("check %s: keep masks equal to _nms_reference in %d of %d "
          "NMS_CASES cases%s" % (name, len(cases()) - len(bad), len(cases()),
                                 "; differ: " + ", ".join(bad) if bad else ""),
          flush=True)
    try:
        entry = _kernels_lib().nms_launch_shape
    except AttributeError:          # a variant without the entry
        entry = None
    if entry is not None:
        shape = nmsk.launch_shape(cs.SSD_ANCHORS)
        print("shape %s at A=%d: %s" % (name, cs.SSD_ANCHORS, shape),
              flush=True)
    for label in TIMED:
        args = inputs(label)
        dev = cs.device_ms(lambda: nmsk.nms_keep_cuda(*args), "")
        ev = events_ms(lambda: nmsk.nms_keep_cuda(*args))
        print("time %s %s: %.4f ms device time (every kernel of the call), "
              "%.4f ms by events (median of 20)" % (name, label, dev, ev),
              flush=True)


# where each stamp build keeps its clock64() stamps: %globaltimer at the
# start and end, clock64() at the start and end, the stamp after the
# start's phase, the count of live row blocks, the first block's slot and
# the slots a block; the phases of a block; the slot after the last block
LAYOUTS = {
    "phases": dict(what="the kernel of commit %s, image 0's block", gt=(0, 1),
                   clk=(2, 5), first=(3, "valid pass"), k=4, base=6,
                   stride=5, names=("box load", "bits", "walk",
                                    "compaction", "inter-block"),
                   tail=None),
    "stamps": dict(what="this kernel (nms.cu), image 0's first CTA",
                   gt=(4, 5), clk=(0, 3),
                   first=(1, "valid pass, end and row cache"), k=2, base=8,
                   stride=6, names=("flags and boxes", "bits", "walk",
                                    "suppression", "cluster barrier"),
                   tail=(6, "dead blocks and last barrier")),
}


def split_stamps(s, lay):
    """{phase: cycles} of one run's stamps, and its live row blocks."""
    k = int(s[lay["k"]])
    at, name = lay["first"]
    split = {name: s[at] - s[lay["clk"][0]]}
    split.update((n, 0) for n in lay["names"])
    prev = s[at]
    for b in range(k):
        o = lay["base"] + lay["stride"] * b
        st = s[o:o + len(lay["names"])]
        for n, t0, t1 in zip(lay["names"], [prev] + st[:-1], st):
            split[n] += t1 - t0
        prev = st[-1]
    if lay["tail"]:
        at, name = lay["tail"]
        split[name] = s[at] - prev
        prev = s[at]
    split["write keep"] = s[lay["clk"][1]] - prev
    return split, k


def phases(name):
    """A stamp build split by phase, at both shapes: ``phases`` (the old
    kernel, tools/nms_phases.cu) or ``stamps`` (csrc/nms.cu built with
    -DNMS_STAMPS)."""
    import torch
    from mxnet_tpu_torch.ops import nms_kernels as nmsk
    lib = load(name)
    lay = LAYOUTS[name]
    cap = 4096
    host = (ctypes.c_longlong * cap)()
    for label in TIMED:
        boxes, cls, valid, thr, force = inputs(label)
        B, A = valid.shape
        keep = torch.empty((B, A), dtype=torch.bool, device="cuda")
        stamps = torch.zeros(cap, dtype=torch.int64, device="cuda")
        runs = []
        for rep in range(6):
            if name == "phases":
                rc = lib.nms_keep_phases(
                    boxes.data_ptr(), cls.data_ptr(), valid.data_ptr(),
                    keep.data_ptr(), B, A, float(thr), int(force),
                    stamps.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError("nms_keep_phases: CUDA error %d (%s)"
                                       % (rc, lib.kernel_error_string(rc)
                                          .decode()))
                s = stamps.cpu().tolist()
            else:
                nmsk.nms_keep_cuda(boxes, cls, valid, thr, force)
                torch.cuda.synchronize()
                rc = lib.nms_read_stamps(host)
                if rc:
                    raise RuntimeError("nms_read_stamps: CUDA error %d" % rc)
                s = list(host)
            if rep == 0:
                continue                        # warm-up
            split, k = split_stamps(s, lay)
            g0, g1 = lay["gt"]
            c0, c1 = lay["clk"]
            ns_per_cycle = (s[g1] - s[g0]) / (s[c1] - s[c0])
            runs.append(({n: c * ns_per_cycle / 1e3
                          for n, c in split.items()},
                         (s[g1] - s[g0]) / 1e3, k, 1 / ns_per_cycle))
        med = {n: statistics.median(r[0][n] for r in runs) for n in runs[0][0]}
        total = statistics.median(r[1] for r in runs)
        ghz = statistics.median(r[3] for r in runs)
        k = runs[0][2]
        print("phases %s (%s, median of %d runs, %d live row blocks, SM "
              "clock %.3f GHz by %%globaltimer): %.2f us in the block; %s" % (
                  label, lay["what"].replace("%s", OLD_COMMIT), len(runs), k,
                  ghz, total, "; ".join(
                      "%s %.2f us (%.1f%%%s)" % (
                          n, us, 100 * us / total,
                          ", %.3f us a block" % (us / k)
                          if n in lay["names"] and k else "")
                      for n, us in med.items())), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--with-old", action="store_true",
                    help="add the kernel of commit %s as the variant old"
                    % OLD_COMMIT)
    ap.add_argument("--phases", action="store_true",
                    help="split the old kernel by phase "
                    "(tools/nms_phases.cu)")
    ap.add_argument("--log-dir", default=OUT,
                    help="where nvcc's whole output goes")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child in LAYOUTS:
        phases(a.child)
        return
    if a.child:
        time_one(a.child)
        return
    srcs = {"base": (os.path.join(CSRC, "nms.cu"), ())}
    if a.phases:
        srcs["stamps"] = (os.path.join(CSRC, "nms.cu"), ("-DNMS_STAMPS",))
        srcs["phases"] = (PHASES_SRC, ())
    if a.with_old:
        srcs["old"] = (old_source(), ())
    srcs.update((os.path.splitext(os.path.basename(p))[0], (p, ()))
                for p in a.variants)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ok = build(srcs, a.log_dir)
    for name in list(srcs) + ["base"]:
        if not ok[name]:
            print("time %s: not built" % name, flush=True)
            continue
        try:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", name], timeout=CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            print("time %s: killed after %d s" % (name, CHILD_TIMEOUT),
                  flush=True)


if __name__ == "__main__":
    main()
